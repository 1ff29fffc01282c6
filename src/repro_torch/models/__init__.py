"""Models of the port: DLRM, the decoder LM (dense, GQA, MLA, MoE and the
vision frontend) and the pure SSM (Mamba-2) LM.  The hybrid and
encoder-decoder families (and the audio frontend) come with their own
slices."""
from typing import Any, Union

from repro_torch.models.common import MLAConfig, MoEConfig, ModelConfig, SSMConfig
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: Any, **kwargs) -> Union[DLRM, DecoderLM]:
    """Model registry: config -> model.  ``kwargs`` go to the model's
    constructor (DLRM: ``tables``, ``seed``, ``device``; the LMs:
    ``device``).  Family "ssm" builds an ``SSMLM``, any other
    ``ModelConfig`` a ``DecoderLM``; one of a family or feature the port
    does not have raises ``NotImplementedError``."""
    if isinstance(cfg, DLRMConfig):
        return DLRM(cfg, **kwargs)
    if isinstance(cfg, ModelConfig):
        if cfg.family == "ssm":
            return SSMLM(cfg, **kwargs)
        return DecoderLM(cfg, **kwargs)
    raise TypeError(f"no model of the port for {type(cfg).__name__}")


__all__ = ["DLRM", "DLRMConfig", "DecoderLM", "MLAConfig", "MoEConfig", "ModelConfig",
           "SSMConfig", "SSMLM", "build_model"]
