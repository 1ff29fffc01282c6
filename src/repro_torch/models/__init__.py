"""Models of the port: DLRM and the dense GQA decoder LM.  The other LM
families (MoE, MLA, vision, SSM, hybrid, encoder-decoder) come with their
own slices."""
from typing import Any, Union

from repro_torch.models.common import MLAConfig, MoEConfig, ModelConfig, SSMConfig
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: Any, **kwargs) -> Union[DLRM, DecoderLM]:
    """Model registry: config -> model.  ``kwargs`` go to the model's
    constructor (DLRM: ``tables``, ``seed``, ``device``; DecoderLM:
    ``device``).  A ``ModelConfig`` of a family the port does not have
    raises ``NotImplementedError``."""
    if isinstance(cfg, DLRMConfig):
        return DLRM(cfg, **kwargs)
    if isinstance(cfg, ModelConfig):
        return DecoderLM(cfg, **kwargs)
    raise TypeError(f"no model of the port for {type(cfg).__name__}")


__all__ = ["DLRM", "DLRMConfig", "DecoderLM", "MLAConfig", "MoEConfig", "ModelConfig",
           "SSMConfig", "build_model"]
