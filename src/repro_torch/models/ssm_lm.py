"""Pure SSM language model (Mamba-2): attention-free, FFN-free blocks.

A port of the reference's ``repro.models.ssm_lm.SSMLM`` for serving.  It
is a ``DecoderLM`` whose layers hold ``ln1`` and a Mamba-2 ``mixer``
(``layers.{i}.mixer.wz``, ... under the reference's names), so it inherits
the seeded init (the reference's sorted leaf order and its "scaled"
stacked fan-in) and the parameter layout ``repro_torch.convert`` carries.
The cache keeps the reference's stacked layout: ``state`` (L, B, H, P, N)
float32 and the conv tails ``conv_x``/``conv_B``/``conv_C`` (L, B, W-1, C)
in the compute dtype.  ``decode_step`` ignores ``pos``, as the reference
does, writes every layer's new state and conv tails into the cache it is
given, in place, and returns that cache.  Training (``backbone``, the
loss) waits for the LM-training slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.hybrid import _ssm_prefill_with_state
from repro_torch.models.transformer import DecoderLM

_CACHE = ("state", "conv_x", "conv_B", "conv_C")


class SSMLM(DecoderLM):
    family = "ssm"

    def layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": layers.rmsnorm_spec(cfg.d_model),
            "mixer": ssm_lib.ssm_specs(cfg),
        }

    # -- cache --------------------------------------------------------------

    def abstract_cache(self, batch: int, seq: int) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        """Shape and dtype of each cache entry; ``seq`` is unused (the state
        does not grow with the sequence)."""
        cfg = self.cfg
        s_cfg = cfg.ssm
        n_layers = cfg.num_layers
        din = s_cfg.d_inner(cfg.d_model)
        h = s_cfg.n_heads(cfg.d_model)
        gn = s_cfg.n_groups * s_cfg.d_state
        tail = s_cfg.conv_width - 1
        return {
            "state": ((n_layers, batch, h, s_cfg.head_dim, s_cfg.d_state), torch.float32),
            "conv_x": ((n_layers, batch, tail, din), cfg.compute_dtype),
            "conv_B": ((n_layers, batch, tail, gn), cfg.compute_dtype),
            "conv_C": ((n_layers, batch, tail, gn), cfg.compute_dtype),
        }

    # -- serving ------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Forward over the prompt ``batch["tokens"]`` (B, S): returns the
        last position's logits (B, 1, V) and the stacked SSM cache."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        x = layers.embed_tokens(self.embed, tokens, cfg)
        cache = {name: torch.empty(shape, dtype=dtype, device=self.device)
                 for name, (shape, dtype) in self.abstract_cache(tokens.shape[0], 0).items()}
        for i, lp in enumerate(self.layers):
            hn = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
            mix, *entries = _ssm_prefill_with_state(lp.mixer, hn, cfg)
            for name, t in zip(_CACHE, entries):
                cache[name][i] = t
            x = x + mix
        x = layers.rmsnorm(x, self.ln_f, cfg.rms_eps)
        return layers.output_logits(self.embed, x[:, -1:, :], cfg), cache

    @torch.no_grad()
    def decode_step(self, batch: Dict[str, Any]):
        """One token ``batch["token"]`` (B, 1) against ``batch["cache"]``:
        returns logits (B, 1, V) and the cache, every layer's state and conv
        tails advanced by one position (``batch["pos"]`` is not read)."""
        cfg = self.cfg
        token, cache = batch["token"].to(self.device), batch["cache"]
        x = layers.embed_tokens(self.embed, token, cfg)
        for i, lp in enumerate(self.layers):
            hn = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
            sub = {name: cache[name][i] for name in _CACHE}
            mix, sub = ssm_lib.ssm_decode_step(lp.mixer, hn, sub, cfg)
            for name in _CACHE:
                cache[name][i] = sub[name]
            x = x + mix
        x = layers.rmsnorm(x, self.ln_f, cfg.rms_eps)
        return layers.output_logits(self.embed, x, cfg), cache
