"""Decoder-only LM of the dense / GQA / MLA / MoE / VLM families, in PyTorch.

A port of the reference's ``repro.models.transformer`` (``DecoderLM``)
for serving: ``prefill`` (forward over the prompt, emitting the cache)
and ``decode_step`` (one token against the cache).  A layer's attention
is GQA or MLA (``cfg.mla``) and its FFN a SwiGLU MLP or a MoE
(``cfg.moe``); the vision frontend (``cfg.frontend == "vision"``) puts
the batch's ``image_embeds`` in place of the first ``num_patches``
positions.  The training loss is not ported.
``repro_torch.models.ssm_lm.SSMLM`` is a ``DecoderLM`` with other layers,
cache and serving steps.

The reference scans one stacked parameter tree over the layers; here the
layers are an ``nn.ModuleList`` whose parameters keep the reference's
names (``layers.{i}.attn.wq``, ``layers.{i}.ffn.wi_gate``, ...), so
``repro_torch.convert.lm_params_from_numpy`` maps the stacked tree onto
them layer by layer.  The cache keeps the reference's stacked layout in
the compute dtype: ``{"k", "v"}`` of shape (L, B, S, KVH, D), or MLA's
``{"c_kv", "k_rope"}`` of (L, B, S, kv_lora) and (L, B, S, rope).
``decode_step`` writes the new row into the cache it is given, in place
(the reference returns a new cache; its callers only ever use the
returned one), and returns that cache.

``init(seed)`` draws every leaf on the model's device from a
``torch.Generator`` seeded with ``seed``, one layer at a time, straight
into the parameter's storage (``models.common.init_leaf``), so a
full-width model never passes through host memory.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
from torch import nn

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    ModelConfig,
    ParamSpec,
    init_leaf,
    module_from_specs,
    stacked,
)


def check_family(cfg: ModelConfig, family: str) -> None:
    """Raise for a config that the port's model of ``family`` ("dense":
    ``DecoderLM``, "ssm": ``SSMLM``) does not serve: another family, or a
    feature the port does not have yet.  ``DecoderLM`` takes MoE, MLA and
    the vision frontend; ``SSMLM`` none of them."""
    ssm = family == "ssm"
    missing = [what for what, has in (
        ("MoE", ssm and cfg.moe is not None), ("MLA", ssm and cfg.mla is not None),
        (f"the {cfg.frontend} frontend",
         cfg.frontend is not None and (ssm or cfg.frontend != "vision")),
        ("SSM", not ssm and (cfg.family == "ssm" or cfg.ssm is not None)),
        ("hybrid", cfg.family == "hybrid"),
        ("encoder-decoder", cfg.encoder_layers > 0),
    ) if has]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; the port serves the "
            "decoder LM (dense, GQA, MLA, MoE, vision) and the pure SSM (Mamba-2) "
            "families only")
    if ssm and (cfg.family != "ssm" or cfg.ssm is None):
        raise ValueError(f"{cfg.name}: an SSM model needs family 'ssm' and an SSMConfig, "
                         f"got family {cfg.family!r}")


class DecoderLM(nn.Module):
    family = "dense"                  # the config family this model serves

    def __init__(self, cfg: ModelConfig, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        check_family(cfg, self.family)
        self.cfg = cfg
        dev = resolve(device, "DecoderLM")
        self.embed = module_from_specs(layers.embed_specs(cfg), dev)
        self.layers = nn.ModuleList(
            module_from_specs(self.layer_specs(), dev) for _ in range(cfg.num_layers))
        self.ln_f = nn.Parameter(torch.empty(cfg.d_model, dtype=torch.float32, device=dev))

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    # -- parameters ---------------------------------------------------------

    def layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": layers.rmsnorm_spec(cfg.d_model),
            "ln2": layers.rmsnorm_spec(cfg.d_model),
            "attn": attn.mla_specs(cfg) if cfg.mla else attn.gqa_specs(cfg),
            "ffn": (moe_lib.moe_specs(cfg) if cfg.moe
                    else layers.mlp_specs(cfg.d_model, cfg.d_ff, cfg.param_dtype)),
        }

    @torch.no_grad()
    def init(self, seed: int = 0) -> "DecoderLM":
        """Draw every parameter from ``seed`` on the model's device, leaf by
        leaf in the reference's tree order (sorted names), a stacked layer
        leaf one layer at a time with the stacked leaf's initializer."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        n = self.cfg.num_layers
        specs = {
            "embed": layers.embed_specs(self.cfg),
            "layers": self.layer_specs(),
            "ln_f": layers.rmsnorm_spec(self.cfg.d_model),
        }
        for name, spec in sorted(_flatten_specs(specs).items()):
            if name.startswith("layers."):
                rest = name[len("layers."):]
                for layer in self.layers:
                    init_leaf(layer.get_parameter(rest), stacked(spec, n), gen)
            else:
                init_leaf(self.get_parameter(name), spec, gen)
        return self

    # -- cache --------------------------------------------------------------

    def abstract_cache(self, batch: int, seq: int) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        """Shape and dtype of each cache entry."""
        cfg = self.cfg
        lead = (cfg.num_layers, batch, seq)
        dt = cfg.compute_dtype
        if cfg.mla:
            return {"c_kv": (lead + (cfg.mla.kv_lora_rank,), dt),
                    "k_rope": (lead + (cfg.mla.qk_rope_dim,), dt)}
        shape = lead + (cfg.num_kv_heads, cfg.head_dim)
        return {"k": (shape, dt), "v": (shape, dt)}

    def init_cache(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in self.abstract_cache(batch, seq).items()}

    # -- serving ------------------------------------------------------------

    def embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The tokens' embeddings (B, S, d); for the vision frontend the
        first ``num_patches`` positions are ``batch["image_embeds"]`` (B,
        num_patches, d) in the compute dtype, when the batch has them."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        x = layers.embed_tokens(self.embed, tokens, cfg)
        if cfg.frontend == "vision" and "image_embeds" in batch:
            p = cfg.num_patches
            if tokens.shape[1] < p:
                raise ValueError(f"{cfg.name}: a prompt of {tokens.shape[1]} positions holds "
                                 f"no room for {p} image patches")
            img = batch["image_embeds"].to(self.device, cfg.compute_dtype)
            x = torch.cat([img, x[:, p:, :]], dim=1)
        return x

    def _ffn(self, lp, hn: torch.Tensor) -> torch.Tensor:
        if self.cfg.moe:
            return moe_lib.moe_forward(lp.ffn, hn, self.cfg)[0]
        return layers.mlp(lp.ffn, hn)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Forward over the prompt ``batch["tokens"]`` (B, S) (and, for the
        vision frontend, ``batch["image_embeds"]``): returns the last
        position's logits (B, 1, V) and the stacked cache."""
        cfg = self.cfg
        x = self.embed_inputs(batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=self.device).expand(b, s)
        cache = {name: torch.empty(shape, dtype=dtype, device=self.device)
                 for name, (shape, dtype) in self.abstract_cache(b, s).items()}
        for i, lp in enumerate(self.layers):
            hn = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
            if cfg.mla:
                ctx, (c_kv, k_rope) = attn.mla_prefill_attention(lp.attn, hn, positions, cfg,
                                                                 cfg.attn_chunk)
                cache["c_kv"][i] = c_kv
                cache["k_rope"][i] = k_rope
            else:
                q, k, v = attn.gqa_project_qkv(lp.attn, hn, positions, cfg)
                o = attn.blocked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                           k_chunk=cfg.attn_k_chunk)
                cache["k"][i] = k
                cache["v"][i] = v
                ctx = attn.output_projection(o, lp.attn.wo)
            x = x + ctx
            x = x + self._ffn(lp, layers.rmsnorm(x, lp.ln2, cfg.rms_eps))
        x = layers.rmsnorm(x, self.ln_f, cfg.rms_eps)
        return layers.output_logits(self.embed, x[:, -1:, :], cfg), cache

    @torch.no_grad()
    def decode_step(self, batch: Dict[str, Any]):
        """One token ``batch["token"]`` (B, 1) at position ``batch["pos"]``
        (an int or 0-d tensor) against ``batch["cache"]``: returns logits
        (B, 1, V) and the cache with every batch row's entry written at
        pos.  A pos past the cache is clamped for the write, as XLA's
        ``dynamic_update_slice`` clamps it; attention still sees pos."""
        cfg = self.cfg
        token, pos, cache = batch["token"].to(self.device), batch["pos"], batch["cache"]
        pos = int(pos)
        seq = next(iter(cache.values())).shape[2]
        at = min(max(pos, 0), seq - 1)
        x = layers.embed_tokens(self.embed, token, cfg)
        positions = torch.full(token.shape, pos, dtype=torch.int64, device=self.device)
        for i, lp in enumerate(self.layers):
            hn = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
            if cfg.mla:
                new_ckv, new_krope = attn.mla_compress(lp.attn, hn, positions, cfg)
                c_kv, k_rope = cache["c_kv"][i], cache["k_rope"][i]
                c_kv[:, at] = new_ckv[:, 0].to(c_kv.dtype)
                k_rope[:, at] = new_krope[:, 0].to(k_rope.dtype)
                ctx = attn.mla_decode_attention(lp.attn, hn, pos, c_kv, k_rope, cfg)
            else:
                q, k, v = attn.gqa_project_qkv(lp.attn, hn, positions, cfg)
                k_c, v_c = cache["k"][i], cache["v"][i]
                k_c[:, at] = k[:, 0].to(k_c.dtype)
                v_c[:, at] = v[:, 0].to(v_c.dtype)
                o = attn.decode_attention(q, k_c, v_c, pos)
                ctx = attn.output_projection(o, lp.attn.wo)
            x = x + ctx
            x = x + self._ffn(lp, layers.rmsnorm(x, lp.ln2, cfg.rms_eps))
        x = layers.rmsnorm(x, self.ln_f, cfg.rms_eps)
        return layers.output_logits(self.embed, x, cfg), cache


def _flatten_specs(tree: Dict[str, Any], prefix: str = "") -> Dict[str, ParamSpec]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten_specs(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out
