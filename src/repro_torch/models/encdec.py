"""Encoder-decoder transformer (SeamlessM4T backbone; audio frontend stub).

A port of the reference's ``repro.models.encdec``.  The
modality frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, S_enc, d_model).  The encoder
is a stack of full (non-causal) self-attention layers with rope; the
decoder a text LM whose layers add a cross-attention over the encoder's
output, its query and its keys and values plain projections (no rope,
bias or qk_norm).  For training the decoder runs at ``seq // DEC_RATIO``
tokens (speech-to-text compression); its serving cache is as long as
asked.

Parameters keep the reference's names: ``enc_layers.{i}.*``,
``enc_ln_f``, ``dec_layers.{i}.*``, ``ln_f`` and ``embed.*``, the layers
stacked in the reference (fan-in of a stacked leaf: the encoder's or the
decoder's layer count).  The cache keeps the reference's stacked layout,
``k``, ``v``, ``cross_k`` and ``cross_v`` of (L, B, seq, KVH, D) in the
compute dtype.  ``decode_step`` attends over the whole of ``cross_k`` and
``cross_v`` (position ``seq - 1``) and writes the self-attention row of
the cache it is given in place.  ``launch.serve`` decodes against a fresh
zero cache, as the reference's does, so there the cross-attention reads
zeros.

``loss`` is the reference's training objective: ``encode`` the frames,
then ``_decoder_layer`` over the decoder layers (each, and each encoder
layer, inside ``torch.utils.checkpoint`` under ``cfg.remat``; the
attentions take ``blocked_attention``'s training route), the final norm
and the chunked cross-entropy of the labels, unmasked and with no aux
loss.  ``prefill`` runs the same ``_decoder_layer`` and writes the cache
entries it returns.  ``input_specs`` maps ``seq`` to the frame count and
the decoder's tokens to ``max(seq // DEC_RATIO, 128)``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.transformer import DecoderLM

DEC_RATIO = 8


class EncDecLM(DecoderLM):
    family = "encdec"

    # -- parameters ---------------------------------------------------------

    def enc_layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": layers.rmsnorm_spec(cfg.d_model),
            "attn": attn.gqa_specs(cfg),
            "ln2": layers.rmsnorm_spec(cfg.d_model),
            "ffn": layers.mlp_specs(cfg.d_model, cfg.d_ff, cfg.param_dtype),
        }

    def dec_layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": layers.rmsnorm_spec(cfg.d_model),
            "self_attn": attn.gqa_specs(cfg),
            "ln_c": layers.rmsnorm_spec(cfg.d_model),
            "cross_attn": attn.gqa_specs(cfg),
            "ln2": layers.rmsnorm_spec(cfg.d_model),
            "ffn": layers.mlp_specs(cfg.d_model, cfg.d_ff, cfg.param_dtype),
        }

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": layers.embed_specs(cfg),
            "enc_layers": self.enc_layer_specs(),
            "enc_ln_f": layers.rmsnorm_spec(cfg.d_model),
            "dec_layers": self.dec_layer_specs(),
            "ln_f": layers.rmsnorm_spec(cfg.d_model),
        }

    def stacks(self) -> Dict[str, int]:
        return {"enc_layers": self.cfg.encoder_layers, "dec_layers": self.cfg.num_layers}

    # -- cache --------------------------------------------------------------

    def abstract_cache(self, batch: int, seq: int) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        """Shape and dtype of each cache entry."""
        cfg = self.cfg
        kv = ((cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim), cfg.compute_dtype)
        return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv}

    def cache_logical_axes(self) -> Dict[str, Tuple]:
        kv = ("stack", "batch", "kv_seq", "kv_heads", None)
        return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv}

    def input_specs(self, batch: int, seq: int, mode: str = "train") -> Dict[str, Any]:
        """Shape and dtype of each input of a ``mode`` step: ``seq`` frames
        and ``max(seq // DEC_RATIO, 128)`` decoder tokens for "train" and
        "prefill", a cache of ``seq`` for "decode"."""
        cfg = self.cfg
        dec_len = max(seq // DEC_RATIO, 128)
        i32 = torch.int32
        if mode in ("train", "prefill"):
            specs = {"frames": ((batch, seq, cfg.d_model), cfg.compute_dtype),
                     "tokens": ((batch, dec_len), i32)}
            if mode == "train":
                specs["labels"] = ((batch, dec_len), i32)
            return specs
        if mode == "decode":
            return {"token": ((batch, 1), i32), "pos": ((), i32),
                    "cache": self.abstract_cache(batch, seq)}
        raise ValueError(mode)

    # -- encoder, decoder -----------------------------------------------------

    def _encoder_layer(self, lp, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        hn = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
        q, k, v = attn.gqa_project_qkv(lp.attn, hn, positions, cfg)
        o = attn.blocked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk,
                                   k_chunk=cfg.attn_k_chunk, tracer=self.tracer)
        x = x + attn.output_projection(o, lp.attn.wo)
        return x + layers.mlp(lp.ffn, layers.rmsnorm(x, lp.ln2, cfg.rms_eps))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The frames (B, S_enc, d) through the encoder: (B, S_enc, d) in
        the compute dtype."""
        cfg = self.cfg
        x = frames.to(self.device, cfg.compute_dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        for lp in self.enc_layers:
            x = self._remat(self._encoder_layer, lp, x, positions)
        return layers.rmsnorm(x, self.enc_ln_f, cfg.rms_eps)

    @staticmethod
    def _cross_kv(lp, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cross-attention's keys and values over the encoder's output,
        (B, S_enc, KVH, D): plain projections."""
        return (attn._project(enc_out, lp.cross_attn.wk),
                attn._project(enc_out, lp.cross_attn.wv))

    def _decoder_layer(self, lp, x: torch.Tensor, positions: torch.Tensor,
                       enc_out: torch.Tensor):
        """One decoder layer over x (B, S, d): self-attention, then the
        cross-attention over ``enc_out`` (its query from ``ln_c``), then
        the MLP.  Returns (x, the layer's cache entries ``k``, ``v``,
        ``cross_k``, ``cross_v``)."""
        cfg = self.cfg
        hn = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
        q, k, v = attn.gqa_project_qkv(lp.self_attn, hn, positions, cfg)
        o = attn.blocked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                   k_chunk=cfg.attn_k_chunk, tracer=self.tracer)
        x = x + attn.output_projection(o, lp.self_attn.wo)
        hn = layers.rmsnorm(x, lp.ln_c, cfg.rms_eps)
        cq = attn._project(hn, lp.cross_attn.wq)
        ck, cv = self._cross_kv(lp, enc_out)
        co = attn.blocked_attention(cq, ck, cv, causal=False, chunk=cfg.attn_chunk,
                                    k_chunk=cfg.attn_k_chunk, tracer=self.tracer)
        x = x + attn.output_projection(co, lp.cross_attn.wo)
        x = x + layers.mlp(lp.ffn, layers.rmsnorm(x, lp.ln2, cfg.rms_eps))
        return x, {"k": k, "v": v, "cross_k": ck, "cross_v": cv}

    # -- training -----------------------------------------------------------

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training objective: ``batch["frames"]`` (B, S_enc, d)
        encoded, the decoder over ``batch["tokens"]`` (B, S) against
        ``batch["labels"]``: a float32 scalar."""
        cfg = self.cfg
        enc_out = self.encode(batch["frames"])
        tokens = batch["tokens"].to(self.device)
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = layers.embed_tokens(self.embed, tokens, cfg)
        for lp in self.dec_layers:
            x = self._remat(lambda *args: self._decoder_layer(*args)[0], lp, x, positions,
                            enc_out)
        x = layers.rmsnorm(x, self.ln_f, cfg.rms_eps)
        return layers.chunked_softmax_xent(self.embed, x, batch["labels"].to(self.device), cfg)

    # -- serving ------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Encode ``batch["frames"]`` (B, S_enc, d), then run the decoder
        over ``batch["tokens"]`` (B, S): returns the last position's logits
        (B, 1, V) and the stacked cache, ``k``/``v`` over the S tokens and
        ``cross_k``/``cross_v`` over the S_enc frames."""
        cfg = self.cfg
        enc_out = self.encode(batch["frames"])
        tokens = batch["tokens"].to(self.device)
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = layers.embed_tokens(self.embed, tokens, cfg)
        cache = {}
        for name, seq in (("k", s), ("v", s), ("cross_k", enc_out.shape[1]),
                          ("cross_v", enc_out.shape[1])):
            shape, dtype = self.abstract_cache(b, seq)[name]
            cache[name] = torch.empty(shape, dtype=dtype, device=self.device)
        for i, lp in enumerate(self.dec_layers):
            x, entries = self._decoder_layer(lp, x, positions, enc_out)
            for name, t in entries.items():
                cache[name][i] = t
        x = layers.rmsnorm(x, self.ln_f, cfg.rms_eps)
        return layers.output_logits(self.embed, x[:, -1:, :], cfg), cache

    @torch.no_grad()
    def decode_step(self, batch: Dict[str, Any]):
        """One token ``batch["token"]`` (B, 1) at position ``batch["pos"]``
        against ``batch["cache"]``: returns logits (B, 1, V) and the cache
        with each layer's self-attention K/V written at pos (clamped to the
        cache, as XLA's ``dynamic_update_slice`` clamps it; attention still
        sees pos).  The cross-attention reads every row of ``cross_k`` and
        ``cross_v``."""
        cfg = self.cfg
        token, pos, cache = batch["token"].to(self.device), int(batch["pos"]), batch["cache"]
        seq = cache["k"].shape[2]
        at = min(max(pos, 0), seq - 1)
        x = layers.embed_tokens(self.embed, token, cfg)
        positions = torch.full(token.shape, pos, dtype=torch.int64, device=self.device)
        for i, lp in enumerate(self.dec_layers):
            hn = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
            q, k, v = attn.gqa_project_qkv(lp.self_attn, hn, positions, cfg)
            k_c, v_c = cache["k"][i], cache["v"][i]
            k_c[:, at] = k[:, 0].to(k_c.dtype)
            v_c[:, at] = v[:, 0].to(v_c.dtype)
            x = x + attn.output_projection(attn.decode_attention(q, k_c, v_c, pos),
                                           lp.self_attn.wo)
            hn = layers.rmsnorm(x, lp.ln_c, cfg.rms_eps)
            cq = attn._project(hn, lp.cross_attn.wq)
            ck, cv = cache["cross_k"][i], cache["cross_v"][i]
            co = attn.decode_attention(cq, ck, cv, ck.shape[1] - 1)
            x = x + attn.output_projection(co, lp.cross_attn.wo)
            x = x + layers.mlp(lp.ffn, layers.rmsnorm(x, lp.ln2, cfg.rms_eps))
        x = layers.rmsnorm(x, self.ln_f, cfg.rms_eps)
        return layers.output_logits(self.embed, x, cfg), cache
