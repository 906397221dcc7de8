"""Project template rendering for the port's ``init``, a copy of
``unionml_tpu/templating.py``.

Templates live under ``unionml_tpu_torch/templates/<name>/``; ``{{app_name}}``
placeholders are substituted in directory names, file names and UTF-8 file
contents (binary files are copied as they are), the app name is checked
against the reference's pre-generation guard, and the rendered project is
git-initialized when git is available.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path
from typing import List

TEMPLATES_DIR = Path(__file__).parent / "templates"

#: app-name contract: a letter, then letters, digits, '_' and '-'
_APP_NAME_RE = re.compile(r"^[a-zA-Z][_a-zA-Z0-9-]+$")

_PLACEHOLDER = "{{app_name}}"


def list_templates() -> List[str]:
    """Names of the available project templates."""
    if not TEMPLATES_DIR.exists():
        return []
    return sorted(p.name for p in TEMPLATES_DIR.iterdir() if p.is_dir())


def validate_app_name(app_name: str) -> None:
    if not _APP_NAME_RE.match(app_name):
        raise ValueError(
            f"{app_name!r} is not a valid app name: it must start with a letter and "
            "contain only letters, digits, '_' and '-'"
        )


def render_template(template: str, app_name: str, dest_root: Path, git_init: bool = True) -> Path:
    """Render ``templates/<template>`` into ``dest_root/<app_name>``.

    Substitutes ``{{app_name}}`` in paths and UTF-8 file contents; leaves binary files
    untouched. Returns the rendered project directory.
    """
    validate_app_name(app_name)
    src = TEMPLATES_DIR / template
    if not src.is_dir():
        raise ValueError(f"unknown template {template!r}; available: {', '.join(list_templates())}")

    dest = Path(dest_root) / app_name
    if dest.exists():
        raise FileExistsError(f"destination {dest} already exists")

    for path in sorted(src.rglob("*")):
        rel = path.relative_to(src)
        if "__pycache__" in rel.parts:
            continue
        target = dest / Path(*(part.replace(_PLACEHOLDER, app_name) for part in rel.parts))
        if path.is_dir():
            target.mkdir(parents=True, exist_ok=True)
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        try:
            text = path.read_text(encoding="utf-8")
        except UnicodeDecodeError:
            target.write_bytes(path.read_bytes())
            continue
        target.write_text(text.replace(_PLACEHOLDER, app_name), encoding="utf-8")

    if git_init:
        _git_init(dest)
    return dest


def _git_init(project_dir: Path) -> None:
    """Initialize a git repo with an initial commit (best-effort)."""
    try:
        subprocess.run(["git", "init", "-q"], cwd=project_dir, check=True, capture_output=True)
        subprocess.run(["git", "add", "."], cwd=project_dir, check=True, capture_output=True)
        subprocess.run(
            ["git", "-c", "user.email=unionml-tpu@localhost", "-c", "user.name=unionml-tpu", "commit", "-q", "-m",
             "initial commit"],
            cwd=project_dir,
            check=True,
            capture_output=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        pass  # git-init is best-effort
