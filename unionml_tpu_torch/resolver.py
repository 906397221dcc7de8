"""App-module resolver, a copy of ``unionml_tpu/resolver.py``.

unionml stages are closures built at runtime, so another process cannot
import them by module path. The resolver pattern: serialize ``(app module,
object attribute, stage factory method)``, and at execution time re-import
the app module, find the Model/Dataset object, and call the factory to
rebuild the stage. The serve CLI resolves its ``module:variable`` argument
through :func:`locate`.
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, List, Optional


def locate(app: str, reload: bool = False) -> Any:
    """Import ``module:variable`` and return the variable."""
    module_name, _, attr = app.partition(":")
    if not attr:
        raise ValueError(f"app reference '{app}' must have the form 'module:variable'")
    module = importlib.import_module(module_name)
    if reload:
        module = importlib.reload(module)
    return getattr(module, attr)


def loader_args(app_module: str, obj_name: str, stage_factory: str) -> List[str]:
    """Serialize the recipe for rebuilding a stage in another process."""
    return ["app-module", app_module, "obj-name", obj_name, "stage-factory", stage_factory]


def load_stage(args: List[str], search_path: Optional[str] = None) -> Any:
    """Rebuild a stage from :func:`loader_args` output inside a worker process."""
    _, app_module, _, obj_name, _, stage_factory, *_ = args
    if search_path and search_path not in sys.path:
        sys.path.insert(0, search_path)
    obj = getattr(importlib.import_module(app_module), obj_name)
    return getattr(obj, stage_factory)()
