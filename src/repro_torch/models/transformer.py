"""Decoder-only LM of the dense / GQA / MLA / MoE / VLM families, in PyTorch.

A port of the reference's ``repro.models.transformer`` (``DecoderLM``):
``prefill`` (forward over the prompt, emitting the cache) and
``decode_step`` (one token against the cache).  A layer's attention
is GQA or MLA (``cfg.mla``) and its FFN a SwiGLU MLP or a MoE
(``cfg.moe``); the vision frontend (``cfg.frontend == "vision"``) puts
the batch's ``image_embeds`` in place of the first ``num_patches``
positions.  ``loss`` is the training objective (chunked cross-entropy
plus ``AUX_LOSS_COEF`` times the MoE layers' auxiliary loss, with the
vision frontend's patch positions masked out): ``backbone`` runs
``_layer_train`` over the layers, each inside ``torch.utils.checkpoint``
when ``cfg.remat`` (the reference's ``jax.checkpoint``), so its attention
takes the training route of ``attention.blocked_attention`` (the
``_Flash`` backward, never the forward-only kernels).  ``prefill`` and
``decode_step`` run under ``torch.no_grad()`` and launch the kernels.
``repro_torch.models.ssm_lm.SSMLM``, ``hybrid.HybridLM`` and
``encdec.EncDecLM`` are ``DecoderLM``s with other parameter trees
(``param_specs``, ``stacks``), caches, serving steps and training
backbones: the SSM and hybrid models train through this ``loss`` with
their own ``backbone``, the encoder-decoder through its own ``loss``.
``input_specs`` and ``cache_logical_axes`` are the reference's: the
shape and dtype of each input of a train, prefill or decode step, and
the logical axes of each cache entry.

The reference scans one stacked parameter tree over the layers; here each
stack (``stacks``: ``layers`` here) is an ``nn.ModuleList`` whose
parameters keep the reference's names (``layers.{i}.attn.wq``,
``layers.{i}.ffn.wi_gate``, ...), so
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
full-width model never passes through host memory.  ``abstract()`` is
the reference's stacked tree as ``meta`` tensors, and
``device="meta"`` builds the module without storage.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.distributed.context import current_context, sharding_context
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    ModelConfig,
    ParamSpec,
    abstract_params,
    init_leaf,
    module_from_specs,
    stack_tree,
    stacked,
)

AUX_LOSS_COEF = 0.01


def check_family(cfg: ModelConfig, family: str) -> None:
    """Raise ``ValueError`` for a config of another family than the
    model's ``family``, where the reference's own constructors assert
    (``HybridLM``, ``EncDecLM``): an SSM model needs family "ssm" and an
    ``SSMConfig``; a hybrid one family "hybrid", an ``SSMConfig`` and
    ``block_period > 0`` dividing ``num_layers`` with ``attn_index`` in
    its block; an encoder-decoder one ``encoder_layers > 0``, which no
    other model takes.  A feature a model does not take (the audio
    frontend on a decoder-only config, MoE or MLA on an ``SSMLM``) is
    ignored, as the reference's models ignore it: the parameter tree is
    the reference's, without that feature's leaves."""
    wrong = None
    if (family == "encdec") != (cfg.encoder_layers > 0):
        wrong = "encoder_layers > 0 selects the encoder-decoder model, and only it"
    elif family == "ssm" and (cfg.family != "ssm" or cfg.ssm is None):
        wrong = "an SSM model needs family 'ssm' and an SSMConfig"
    elif family == "hybrid" and not (
            cfg.family == "hybrid" and cfg.ssm is not None and cfg.block_period > 0
            and cfg.num_layers % cfg.block_period == 0
            and 0 <= cfg.attn_index < cfg.block_period):
        wrong = ("a hybrid model needs family 'hybrid', an SSMConfig and block_period > 0 "
                 "dividing num_layers, with attn_index in the block")
    elif family in ("dense", "encdec") and cfg.family in ("ssm", "hybrid"):
        wrong = f"family {cfg.family!r} has its own model"
    if wrong:
        raise ValueError(f"{cfg.name} (family {cfg.family!r}, {cfg.num_layers} layers, "
                         f"block_period {cfg.block_period}, encoder_layers "
                         f"{cfg.encoder_layers}): {wrong}")


class DecoderLM(nn.Module):
    family = "dense"                  # the model's key in ``check_family``

    def __init__(self, cfg: ModelConfig, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        check_family(cfg, self.family)
        self.cfg = cfg
        # "meta": the parameter tree without storage, which the sharded
        # steps (``launch.steps``) bind each rank's tensors into
        meta = torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve(device, type(self).__name__)
        stacks = self.stacks()
        for key, spec in self.param_specs().items():
            if key in stacks:
                self.add_module(key, nn.ModuleList(
                    module_from_specs(spec, dev) for _ in range(stacks[key])))
            elif isinstance(spec, dict):
                self.add_module(key, module_from_specs(spec, dev))
            else:
                self.register_parameter(key, nn.Parameter(
                    torch.empty(spec.shape, dtype=spec.dtype, device=dev)))

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    @classmethod
    def specs_of(cls, cfg: ModelConfig) -> Tuple[Dict[str, Any], Dict[str, int]]:
        """``param_specs()`` and ``stacks()`` of the model ``cfg`` builds,
        without allocating its parameters."""
        check_family(cfg, cls.family)
        view = cls.__new__(cls)
        nn.Module.__init__(view)
        view.cfg = cfg
        return view.param_specs(), view.stacks()

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

    def param_specs(self) -> Dict[str, Any]:
        """The reference's parameter tree, each stack (``stacks``) as the
        specs of one of its layers."""
        return {
            "embed": layers.embed_specs(self.cfg),
            "layers": self.layer_specs(),
            "ln_f": layers.rmsnorm_spec(self.cfg.d_model),
        }

    def stacks(self) -> Dict[str, int]:
        """The keys of ``param_specs`` that the reference stacks on a
        leading axis, and their lengths: here an ``nn.ModuleList`` of that
        many modules."""
        return {"layers": self.cfg.num_layers}

    def stacked_param_specs(self) -> Dict[str, Any]:
        """The reference's ``param_specs``: each stack's leaves stacked on a
        leading "stack" axis of its length."""
        stacks = self.stacks()
        return {k: stack_tree(v, stacks[k]) if k in stacks else v
                for k, v in self.param_specs().items()}

    def abstract(self) -> Dict[str, Any]:
        """The reference's parameter tree as ``meta`` tensors."""
        return abstract_params(self.stacked_param_specs())

    def init_order(self) -> Iterator[Tuple[str, ParamSpec]]:
        """(parameter name, the spec it is drawn by) in the order ``init``
        draws them: the reference's tree order (sorted names), a stacked
        leaf one layer at a time with the stacked leaf's spec."""
        stacks = self.stacks()
        for name, spec in sorted(_flatten_specs(self.param_specs()).items()):
            key, _, rest = name.partition(".")
            if key in stacks:
                for i in range(stacks[key]):
                    yield f"{key}.{i}.{rest}", stacked(spec, stacks[key])
            else:
                yield name, spec

    @torch.no_grad()
    def init(self, seed: int = 0) -> "DecoderLM":
        """Draw every parameter from ``seed`` on the model's device
        (``init_order``), straight into its storage."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, spec in self.init_order():
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

    def cache_logical_axes(self) -> Dict[str, Tuple]:
        if self.cfg.mla:
            return {"c_kv": ("stack", "batch", "kv_seq", None),
                    "k_rope": ("stack", "batch", "kv_seq", None)}
        kv = ("stack", "batch", "kv_seq", "kv_heads", None)
        return {"k": kv, "v": kv}

    def input_specs(self, batch: int, seq: int, mode: str = "train") -> Dict[str, Any]:
        """Shape and dtype of each input of a ``mode`` step ("train",
        "prefill" or "decode"), as ``abstract_cache`` gives them."""
        cfg = self.cfg
        i32 = torch.int32
        if mode in ("train", "prefill"):
            specs = {"tokens": ((batch, seq), i32)}
            if mode == "train":
                specs["labels"] = ((batch, seq), i32)
            if cfg.frontend == "vision":
                specs["image_embeds"] = ((batch, cfg.num_patches, cfg.d_model),
                                         cfg.compute_dtype)
            return specs
        if mode == "decode":
            return {"token": ((batch, 1), i32), "pos": ((), i32),
                    "cache": self.abstract_cache(batch, seq)}
        raise ValueError(mode)

    # -- inputs -------------------------------------------------------------

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

    # -- training -----------------------------------------------------------

    def _layer_train(self, lp, x: torch.Tensor, positions: torch.Tensor):
        """One layer's training forward: (x, the layer's MoE aux loss)."""
        cfg = self.cfg
        h = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
        if cfg.mla:
            ctx, _ = attn.mla_prefill_attention(lp.attn, h, positions, cfg, cfg.attn_chunk)
        else:
            q, k, v = attn.gqa_project_qkv(lp.attn, h, positions, cfg)
            o = attn.blocked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                       k_chunk=cfg.attn_k_chunk)
            ctx = attn.output_projection(o, lp.attn.wo)
        x = x + ctx
        h = layers.rmsnorm(x, lp.ln2, cfg.rms_eps)
        if cfg.moe:
            f, aux = moe_lib.moe_forward(lp.ffn, h, cfg)
        else:
            f, aux = layers.mlp(lp.ffn, h), torch.zeros((), dtype=torch.float32,
                                                        device=x.device)
        return x + f, aux

    def _remat(self, fn, *args):
        """``fn(*args)``, inside ``torch.utils.checkpoint`` when
        ``cfg.remat`` and grad is on (the reference's ``jax.checkpoint``
        of a scanned layer): its activations are recomputed in the
        backward, under the sharding context of the forward.  The
        recomputation runs where autograd runs the backward, on a CUDA
        device's own thread for a CUDA graph, which does not see this
        thread's context: without it an expert-parallel MoE layer would
        recompute as a one-device one."""
        if self.cfg.remat and torch.is_grad_enabled():
            ctx = current_context()
            if ctx is None:
                return checkpoint(fn, *args, use_reentrant=False)

            def in_context(*a):
                with sharding_context(*ctx):
                    return fn(*a)

            return checkpoint(in_context, *args, use_reentrant=False)
        return fn(*args)

    def backbone(self, x: torch.Tensor, positions: torch.Tensor):
        """The layers over x (B, S, d), then the final norm: (x, the sum of
        the layers' aux losses)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in self.layers:
            x, aux_i = self._remat(self._layer_train, lp, x, positions)
            aux = aux + aux_i
        return layers.rmsnorm(x, self.ln_f, self.cfg.rms_eps), aux

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training objective of ``batch["tokens"]`` against
        ``batch["labels"]`` (B, S) (and ``batch["image_embeds"]`` for the
        vision frontend, whose first ``num_patches`` positions the loss
        masks out): a float32 scalar."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = self.embed_inputs(batch)
        x, aux = self.backbone(x, positions)
        mask = None
        if cfg.frontend == "vision":
            mask = (torch.arange(s, device=self.device) >= cfg.num_patches)[None, :]
            mask = mask.to(torch.float32).expand(b, s)
        ce = layers.chunked_softmax_xent(self.embed, x, batch["labels"].to(self.device),
                                         cfg, mask)
        return ce + AUX_LOSS_COEF * aux

    # -- serving ------------------------------------------------------------

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
