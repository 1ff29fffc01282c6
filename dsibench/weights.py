"""The weights of each cell, made from ``--seed`` on the device.

The benchmark makes the weights and hands the same to the program and to
the plain reference, which makes them again from the seed once the
program's state is freed.  Leaves are named as the program names its
parameters.  Draws are a few large calls on one ``torch.Generator``:

* LM: every matrix and the token table from one float32 normal draw,
  each leaf's slice scaled (matrices by 1/sqrt(fan-in), the token table
  by 0.02) and rounded to the parameter's type; norm scales are 1.
* DLRM: the (T, V, E) tables from one draw of std 0.02, then the MLP
  matrices from one draw scaled by 1/sqrt(fan-in); biases are 0.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

# (name, shape, init, fan-in): init "matrix" (std 1/sqrt(fan-in)), "embed"
# (std 0.02), "ones" or "zeros"
Leaf = Tuple[str, Tuple[int, ...], str, int]


def lm_leaves(m: Dict[str, Any]) -> List[Leaf]:
    """The leaves of a dense GQA decoder (SwiGLU MLP, RMSNorm, untied
    output head, optional qk_norm) in sorted-name order."""
    d, h, kvh, hd, ff, v = (m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"],
                            m["d_ff"], m["vocab_size"])
    out = [("embed.out", (d, v), "matrix", d), ("embed.tok", (v, d), "embed", d),
           ("ln_f", (d,), "ones", 0)]
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn.wk", (d, kvh, hd), "matrix", d),
                (p + "attn.wo", (h, hd, d), "matrix", h * hd),
                (p + "attn.wq", (d, h, hd), "matrix", d),
                (p + "attn.wv", (d, kvh, hd), "matrix", d),
                (p + "ffn.wi_gate", (d, ff), "matrix", d),
                (p + "ffn.wi_up", (d, ff), "matrix", d),
                (p + "ffn.wo", (ff, d), "matrix", ff),
                (p + "ln1", (d,), "ones", 0), (p + "ln2", (d,), "ones", 0)]
        if m.get("qk_norm"):
            out += [(p + "attn.k_norm", (hd,), "ones", 0), (p + "attn.q_norm", (hd,), "ones", 0)]
    return sorted(out)


def lm_weights(m: Dict[str, Any], seed: int, device, dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """The LM's initial weights: drawn leaves in ``dtype`` (the
    configuration's parameter type) and float32 norm scales."""
    leaves = lm_leaves(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = sum(math.prod(s) for _, s, init, _ in leaves if init != "ones")
    flat = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, shape, init, fan_in in leaves:
        if init == "ones":
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        k = math.prod(shape)
        std = 0.02 if init == "embed" else 1.0 / math.sqrt(fan_in)
        out[name] = flat[at:at + k].view(shape).mul_(std).to(dtype)
        at += k
    del flat
    return out


def dlrm_mlp_dims(m: Dict[str, Any]) -> Tuple[List[int], List[int]]:
    """The bottom and top MLPs' widths from input to output; the top's
    input is the bottom output beside the (T+1)T/2 pairwise dots."""
    t = m["num_tables"]
    return ([m["num_dense"]] + list(m["bottom_mlp"]),
            [m["bottom_mlp"][-1] + (t + 1) * t // 2] + list(m["top_mlp"]))


def dlrm_mlp_leaves(m: Dict[str, Any]) -> List[Leaf]:
    """The MLP leaves of DLRM in sorted-name order: ``bottom.w{i}`` (din,
    dout), ``bottom.b{i}`` (dout,) and the same of ``top``."""
    out = []
    for tower, dims in zip(("bottom", "top"), dlrm_mlp_dims(m)):
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            out += [(f"{tower}.w{i}", (din, dout), "matrix", din),
                    (f"{tower}.b{i}", (dout,), "zeros", 0)]
    return sorted(out)


def dlrm_weights(m: Dict[str, Any], seed: int, device
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(the float32 (T, V, E) tables, the float32 MLP leaves by name)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = torch.empty((m["num_tables"], m["vocab_per_table"], m["embed_dim"]),
                         dtype=torch.float32, device=device)
    tables.normal_(0.0, 0.02, generator=gen)
    leaves = dlrm_mlp_leaves(m)
    n = sum(math.prod(s) for _, s, init, _ in leaves if init == "matrix")
    flat = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    mlp, at = {}, 0
    for name, shape, init, fan_in in leaves:
        if init == "zeros":
            mlp[name] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        k = math.prod(shape)
        mlp[name] = flat[at:at + k].view(shape).mul(1.0 / math.sqrt(fan_in))
        at += k
    return tables, mlp
