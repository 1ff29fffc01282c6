"""Decoder-only LM of the dense GQA family, in PyTorch.

A port of the dense half of the reference's ``repro.models.transformer``
(``DecoderLM``) for serving: ``prefill`` (forward over the prompt,
emitting the KV cache) and ``decode_step`` (one token against the cache).
MoE, MLA and the vision frontend, and the training loss, are not ported.
``repro_torch.models.ssm_lm.SSMLM`` is a ``DecoderLM`` with other layers,
cache and serving steps.

The reference scans one stacked parameter tree over the layers; here the
layers are an ``nn.ModuleList`` whose parameters keep the reference's
names (``layers.{i}.attn.wq``, ``layers.{i}.ffn.wi_gate``, ...), so
``repro_torch.convert.lm_params_from_numpy`` maps the stacked tree onto
them layer by layer.  The cache keeps the reference's stacked layout:
``{"k", "v"}`` of shape (L, B, S, KVH, D) in the compute dtype.
``decode_step`` writes the new K/V row into the cache it is given, in
place (the reference returns a new cache; its callers only ever use the
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
    feature of the LM families the port does not have yet."""
    missing = [what for what, has in (
        ("MoE", cfg.moe is not None), ("MLA", cfg.mla is not None),
        (f"the {cfg.frontend} frontend", cfg.frontend is not None),
        ("SSM", family != "ssm" and (cfg.family == "ssm" or cfg.ssm is not None)),
        ("hybrid", cfg.family == "hybrid"),
        ("encoder-decoder", cfg.encoder_layers > 0),
    ) if has]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; the port serves the "
            "dense GQA decoder and the pure SSM (Mamba-2) families only")
    if family == "ssm" and (cfg.family != "ssm" or cfg.ssm is None):
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
            "attn": attn.gqa_specs(cfg),
            "ffn": layers.mlp_specs(cfg.d_model, cfg.d_ff, cfg.param_dtype),
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
        shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim)
        return {"k": (shape, cfg.compute_dtype), "v": (shape, cfg.compute_dtype)}

    def init_cache(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in self.abstract_cache(batch, seq).items()}

    # -- serving ------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Forward over the prompt ``batch["tokens"]`` (B, S): returns the
        last position's logits (B, 1, V) and the stacked KV cache."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = layers.embed_tokens(self.embed, tokens, cfg)
        cache = {name: torch.empty(shape, dtype=dtype, device=self.device)
                 for name, (shape, dtype) in self.abstract_cache(b, s).items()}
        for i, lp in enumerate(self.layers):
            hn = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
            q, k, v = attn.gqa_project_qkv(lp.attn, hn, positions, cfg)
            o = attn.blocked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                       k_chunk=cfg.attn_k_chunk)
            cache["k"][i] = k
            cache["v"][i] = v
            x = x + attn.output_projection(o, lp.attn.wo)
            hn = layers.rmsnorm(x, lp.ln2, cfg.rms_eps)
            x = x + layers.mlp(lp.ffn, hn)
        x = layers.rmsnorm(x, self.ln_f, cfg.rms_eps)
        return layers.output_logits(self.embed, x[:, -1:, :], cfg), cache

    @torch.no_grad()
    def decode_step(self, batch: Dict[str, Any]):
        """One token ``batch["token"]`` (B, 1) at position ``batch["pos"]``
        (an int or 0-d tensor) against ``batch["cache"]``: returns logits
        (B, 1, V) and the cache with every batch row's K/V written at pos.
        A pos past the cache is clamped for the write, as XLA's
        ``dynamic_update_slice`` clamps it; attention still sees pos."""
        cfg = self.cfg
        token, pos, cache = batch["token"].to(self.device), batch["pos"], batch["cache"]
        pos = int(pos)
        seq = cache["k"].shape[2]
        at = min(max(pos, 0), seq - 1)
        x = layers.embed_tokens(self.embed, token, cfg)
        positions = torch.full(token.shape, pos, dtype=torch.int64, device=self.device)
        for i, lp in enumerate(self.layers):
            hn = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
            q, k, v = attn.gqa_project_qkv(lp.attn, hn, positions, cfg)
            k_c, v_c = cache["k"][i], cache["v"][i]
            k_c[:, at] = k[:, 0].to(k_c.dtype)
            v_c[:, at] = v[:, 0].to(v_c.dtype)
            o = attn.decode_attention(q, k_c, v_c, pos)
            x = x + attn.output_projection(o, lp.attn.wo)
            hn = layers.rmsnorm(x, lp.ln2, cfg.rms_eps)
            x = x + layers.mlp(lp.ffn, hn)
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
