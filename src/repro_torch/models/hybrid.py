"""Jamba-style hybrid: blocks of (attention : Mamba = 1 : 7) with MoE FFNs.

A port of the reference's ``repro.models.hybrid``.  Layers are
grouped into ``block_period``-sized blocks: one attention sublayer at
``attn_index`` and Mamba-2 mixers elsewhere, the FFN of in-block index i a
MoE when ``i % max(moe_period, 1) == 1`` (so ``moe_period`` 0 or 1 gives
no MoE layer, as in the reference) and a SwiGLU MLP otherwise.

The reference scans one stacked tree over the blocks; here the blocks are
an ``nn.ModuleList`` whose parameters keep the reference's names
(``blocks.{j}.sub{i}.mixer.wq``, ``blocks.{j}.sub{i}.ffn.router``, ...),
and ``init`` draws a stacked leaf with the reference's fan-in, the number
of blocks.  The cache keeps the reference's stacked layout: ``k``/``v``
(n_blocks, B, S, KVH, D) in the compute dtype, ``state`` (n_blocks,
block_period - 1, B, H, P, N) float32 and the conv tails ``conv_x``/
``conv_B``/``conv_C`` (n_blocks, block_period - 1, B, W - 1, C).
``decode_step`` writes the cache it is given in place and returns it.
It trains through ``DecoderLM.loss`` with its own ``backbone``: each
block's ``_block_train`` (attention through ``blocked_attention``'s
training route, the Mamba-2 mixers through ``ssd_chunked``'s, the FFNs)
inside ``torch.utils.checkpoint`` under ``cfg.remat``, the MoE
sublayers' aux losses summed.

``_ssm_prefill_with_state`` is the Mamba-2 prefill that also returns the
final SSM state and the conv tails; ``SSMLM.prefill`` runs it too.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import DecoderLM

SSM_CACHE = ("state", "conv_x", "conv_B", "conv_C")


class HybridLM(DecoderLM):
    family = "hybrid"

    @property
    def n_blocks(self) -> int:
        return self.cfg.num_layers // self.cfg.block_period

    def _is_attn(self, i: int) -> bool:
        return i == self.cfg.attn_index

    def _is_moe(self, i: int) -> bool:
        return bool(self.cfg.moe) and (i % max(self.cfg.moe_period, 1) == 1)

    # -- parameters ---------------------------------------------------------

    def block_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        specs: Dict[str, Any] = {}
        for i in range(cfg.block_period):
            specs[f"sub{i}"] = {
                "ln1": layers.rmsnorm_spec(cfg.d_model),
                "ln2": layers.rmsnorm_spec(cfg.d_model),
                "mixer": attn.gqa_specs(cfg) if self._is_attn(i) else ssm_lib.ssm_specs(cfg),
                "ffn": (moe_lib.moe_specs(cfg) if self._is_moe(i)
                        else layers.mlp_specs(cfg.d_model, cfg.d_ff, cfg.param_dtype)),
            }
        return specs

    def param_specs(self) -> Dict[str, Any]:
        return {
            "embed": layers.embed_specs(self.cfg),
            "blocks": self.block_specs(),
            "ln_f": layers.rmsnorm_spec(self.cfg.d_model),
        }

    def stacks(self) -> Dict[str, int]:
        return {"blocks": self.n_blocks}

    # -- training -----------------------------------------------------------

    def _block_train(self, bp, x: torch.Tensor, positions: torch.Tensor):
        """One block's training forward: (x, the sum of its MoE sublayers'
        aux losses)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.block_period):
            sp = bp.get_submodule(f"sub{i}")
            h = layers.rmsnorm(x, sp.ln1, cfg.rms_eps)
            if self._is_attn(i):
                q, k, v = attn.gqa_project_qkv(sp.mixer, h, positions, cfg)
                o = attn.blocked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                           k_chunk=cfg.attn_k_chunk)
                mix = attn.output_projection(o, sp.mixer.wo)
            else:
                mix = ssm_lib.ssm_forward(sp.mixer, h, cfg)
            x = x + mix
            h = layers.rmsnorm(x, sp.ln2, cfg.rms_eps)
            if self._is_moe(i):
                f, a = moe_lib.moe_forward(sp.ffn, h, cfg)
                aux = aux + a
            else:
                f = layers.mlp(sp.ffn, h)
            x = x + f
        return x, aux

    def backbone(self, x: torch.Tensor, positions: torch.Tensor):
        """The blocks over x (B, S, d), then the final norm: (x, the sum of
        the blocks' aux losses)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for bp in self.blocks:
            x, aux_b = self._remat(self._block_train, bp, x, positions)
            aux = aux + aux_b
        return layers.rmsnorm(x, self.ln_f, self.cfg.rms_eps), aux

    # -- cache --------------------------------------------------------------

    def abstract_cache(self, batch: int, seq: int) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        """Shape and dtype of each cache entry."""
        cfg = self.cfg
        s_cfg = cfg.ssm
        lead = (self.n_blocks, cfg.block_period - 1, batch)
        tail = s_cfg.conv_width - 1
        gn = s_cfg.n_groups * s_cfg.d_state
        dt = cfg.compute_dtype
        kv = ((self.n_blocks, batch, seq, cfg.num_kv_heads, cfg.head_dim), dt)
        return {
            "k": kv,
            "v": kv,
            "state": (lead + (s_cfg.n_heads(cfg.d_model), s_cfg.head_dim, s_cfg.d_state),
                      torch.float32),
            "conv_x": (lead + (tail, s_cfg.d_inner(cfg.d_model)), dt),
            "conv_B": (lead + (tail, gn), dt),
            "conv_C": (lead + (tail, gn), dt),
        }

    def cache_logical_axes(self) -> Dict[str, Tuple]:
        kv = ("stack", "batch", "kv_seq", "kv_heads", None)
        return {
            "k": kv,
            "v": kv,
            "state": ("stack", None, "batch", "ssm_heads", None, None),
            "conv_x": ("stack", None, "batch", None, "mlp"),
            "conv_B": ("stack", None, "batch", None, None),
            "conv_C": ("stack", None, "batch", None, None),
        }

    # -- serving ------------------------------------------------------------

    def _ffn_at(self, i: int, sp, hn: torch.Tensor) -> torch.Tensor:
        if self._is_moe(i):
            return moe_lib.moe_forward(sp.ffn, hn, self.cfg)[0]
        return layers.mlp(sp.ffn, hn)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Forward over the prompt ``batch["tokens"]`` (B, S): returns the
        last position's logits (B, 1, V) and the stacked cache."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = layers.embed_tokens(self.embed, tokens, cfg)
        cache = {name: torch.empty(shape, dtype=dtype, device=self.device)
                 for name, (shape, dtype) in self.abstract_cache(b, s).items()}
        for j, bp in enumerate(self.blocks):
            ssm_i = 0
            for i in range(cfg.block_period):
                sp = bp.get_submodule(f"sub{i}")
                hn = layers.rmsnorm(x, sp.ln1, cfg.rms_eps)
                if self._is_attn(i):
                    q, k, v = attn.gqa_project_qkv(sp.mixer, hn, positions, cfg)
                    o = attn.blocked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                               k_chunk=cfg.attn_k_chunk)
                    cache["k"][j] = k
                    cache["v"][j] = v
                    mix = attn.output_projection(o, sp.mixer.wo)
                else:
                    mix, *entries = _ssm_prefill_with_state(sp.mixer, hn, cfg)
                    for name, t in zip(SSM_CACHE, entries):
                        cache[name][j, ssm_i] = t
                    ssm_i += 1
                x = x + mix
                x = x + self._ffn_at(i, sp, layers.rmsnorm(x, sp.ln2, cfg.rms_eps))
        x = layers.rmsnorm(x, self.ln_f, cfg.rms_eps)
        return layers.output_logits(self.embed, x[:, -1:, :], cfg), cache

    @torch.no_grad()
    def decode_step(self, batch: Dict[str, Any]):
        """One token ``batch["token"]`` (B, 1) at position ``batch["pos"]``
        against ``batch["cache"]``: returns logits (B, 1, V) and the cache,
        each block's K/V written at pos (clamped to the cache, as XLA's
        ``dynamic_update_slice`` clamps it; attention still sees pos) and
        its SSM states and conv tails advanced by one position."""
        cfg = self.cfg
        token, pos, cache = batch["token"].to(self.device), int(batch["pos"]), batch["cache"]
        at = min(max(pos, 0), cache["k"].shape[2] - 1)
        x = layers.embed_tokens(self.embed, token, cfg)
        positions = torch.full(token.shape, pos, dtype=torch.int64, device=self.device)
        for j, bp in enumerate(self.blocks):
            ssm_i = 0
            for i in range(cfg.block_period):
                sp = bp.get_submodule(f"sub{i}")
                hn = layers.rmsnorm(x, sp.ln1, cfg.rms_eps)
                if self._is_attn(i):
                    q, k, v = attn.gqa_project_qkv(sp.mixer, hn, positions, cfg)
                    k_c, v_c = cache["k"][j], cache["v"][j]
                    k_c[:, at] = k[:, 0].to(k_c.dtype)
                    v_c[:, at] = v[:, 0].to(v_c.dtype)
                    mix = attn.output_projection(attn.decode_attention(q, k_c, v_c, pos),
                                                 sp.mixer.wo)
                else:
                    sub = {name: cache[name][j, ssm_i] for name in SSM_CACHE}
                    mix, sub = ssm_lib.ssm_decode_step(sp.mixer, hn, sub, cfg)
                    for name in SSM_CACHE:
                        cache[name][j, ssm_i] = sub[name]
                    ssm_i += 1
                x = x + mix
                x = x + self._ffn_at(i, sp, layers.rmsnorm(x, sp.ln2, cfg.rms_eps))
        x = layers.rmsnorm(x, self.ln_f, cfg.rms_eps)
        return layers.output_logits(self.embed, x, cfg), cache


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
