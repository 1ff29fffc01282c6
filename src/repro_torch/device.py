"""The device an entry point of the port runs on."""
from __future__ import annotations

from typing import Union

import torch


def resolve(device: Union[str, torch.device], who: str) -> torch.device:
    """``torch.device(device)``, raising where CUDA is asked for and absent:
    a ``cuda`` entry point never falls back to the CPU.  ``meta`` is
    accepted for a caller that asks for it (``launch.dryrun``): nothing
    runs there but shape propagation."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device={str(device)!r}) needs a CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{who}: no support for device {dev}; expected cpu, cuda or meta")
    return dev
