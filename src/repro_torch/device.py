"""The device an entry point of the port runs on."""
from __future__ import annotations

from typing import Union

import torch


def resolve(device: Union[str, torch.device], who: str) -> torch.device:
    """``torch.device(device)``, raising where CUDA is asked for and absent:
    a ``cuda`` entry point never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device={str(device)!r}) needs a CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no support for device {dev}; expected cpu or cuda")
    return dev
