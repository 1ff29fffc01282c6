"""Models of the port.  Only DLRM is ported so far; the LM families come
with their own slice."""
from typing import Any

from repro_torch.models.dlrm import DLRM, DLRMConfig


def build_model(cfg: Any, **kwargs) -> DLRM:
    """Model registry: config -> model.  ``kwargs`` go to the model's
    constructor (``tables``, ``seed``, ``device``)."""
    if isinstance(cfg, DLRMConfig):
        return DLRM(cfg, **kwargs)
    raise TypeError(f"no model of the port for {type(cfg).__name__}")


__all__ = ["DLRM", "DLRMConfig", "build_model"]
