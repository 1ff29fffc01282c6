"""The SSM half of the reference's ``repro.models.hybrid``.

Only ``_ssm_prefill_with_state`` is ported: the Mamba-2 prefill that also
returns the final SSM state and the conv tails, which ``SSMLM.prefill``
runs once per layer.  ``HybridLM`` (Jamba) waits for its own slice.
"""
from __future__ import annotations

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import ModelConfig


def _ssm_prefill_with_state(params, x, cfg: ModelConfig):
    """Mamba-2 prefill of one layer: returns the mixer output, the final
    state (B, H, P, N) float32 and the last W-1 rows of the raw (pre-conv)
    x, B and C projections in the compute dtype, which seed the decode
    step's conv windows."""
    w = cfg.ssm.conv_width
    out, state, xi_raw, bv_raw, cv_raw = ssm_lib._mixer(params, x, cfg)
    conv_x, conv_B, conv_C = (t[:, -(w - 1):, :].to(cfg.compute_dtype)
                              for t in (xi_raw, bv_raw, cv_raw))
    return out, state, conv_x, conv_B, conv_C
