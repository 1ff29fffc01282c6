"""Models of the port: DLRM, the decoder LM (dense, GQA, MLA, MoE and the
vision frontend), the pure SSM (Mamba-2) LM, the hybrid (Jamba) LM and
the encoder-decoder LM with the audio frontend stub."""
from typing import Any, Type, Union

from repro_torch.models.common import MLAConfig, MoEConfig, ModelConfig, SSMConfig
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: Any, **kwargs) -> Union[DLRM, DecoderLM]:
    """Model registry: config -> model.  ``kwargs`` go to the model's
    constructor (DLRM: ``tables``, ``seed``, ``device``; the LMs:
    ``device``).  In the reference's order: ``encoder_layers > 0`` builds
    an ``EncDecLM``, family "ssm" an ``SSMLM``, family "hybrid" a
    ``HybridLM``, any other ``ModelConfig`` a ``DecoderLM``; a feature
    the model does not take is ignored, as in the reference, and a config
    the reference's own constructors refuse raises ``ValueError``
    (``transformer.check_family``)."""
    return model_class(cfg)(cfg, **kwargs)


def model_class(cfg: Any) -> Type[Union[DLRM, DecoderLM]]:
    """The class ``build_model`` builds for ``cfg``."""
    if isinstance(cfg, DLRMConfig):
        return DLRM
    if isinstance(cfg, ModelConfig):
        if cfg.encoder_layers > 0:
            return EncDecLM
        if cfg.family == "ssm":
            return SSMLM
        if cfg.family == "hybrid":
            return HybridLM
        return DecoderLM
    raise TypeError(f"no model of the port for {type(cfg).__name__}")


__all__ = ["DLRM", "DLRMConfig", "DecoderLM", "EncDecLM", "HybridLM", "MLAConfig",
           "MoEConfig", "ModelConfig", "SSMConfig", "SSMLM", "build_model", "model_class"]
