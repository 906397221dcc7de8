"""Device resolution shared by the port's entry points.

``Llama``, ``Generator`` and ``ContinuousBatcher`` run on the card unless the
caller asks for something else: ``device=None`` means CUDA, and a machine with
no CUDA device raises instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request on a machine without a CUDA device
    raises, naming ``device="cpu"`` as the explicit way to run on the CPU."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run on the CPU explicitly"
            )
        if resolved.index is None:  # pin the index so device comparisons are exact
            resolved = torch.device("cuda", torch.cuda.current_device())
    return resolved


def module_device(module: torch.nn.Module) -> Optional[torch.device]:
    """The device of a module's first parameter (None for a parameterless module)."""
    for param in module.parameters():
        return param.device
    return None
