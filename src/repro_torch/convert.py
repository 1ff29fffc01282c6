"""State carried across from the reference package.

The data path has no weights: its state is the warehouse.  A reference
``ColumnBatch`` handed over as numpy arrays becomes the port's
``ColumnBatch`` here, so the reference's generated partitions can be
written into a port ``Table`` and DWRF bytes compared across packages.

The trainer's state is the DLRM's weights and the AdamW state.  The
reference holds them as nested dicts, ``{"bottom": {"w0", "b0", ...},
"top": {...}, ["tables"]}``, each MLP weight ``w{i}`` of shape (din,
dout) applied as ``x @ w + b``.  The port keeps that layout (its MLP
layers are not ``nn.Linear``), so nothing is transposed: a nested key
becomes the port's parameter name ``"bottom.w0"``.

An LM's weights in the reference are one tree whose layer leaves are
stacked on a leading layer axis: ``embed.{tok,out}``, ``layers.{ln1, ln2,
attn.{wq, wk, wv, wo, [bq, bk, bv], [q_norm, k_norm]}, ffn.{wi_gate,
wi_up, wo}}`` and ``ln_f``; MLA's ``attn`` holds ``{w_dq, q_norm, w_uq,
w_dkv, kv_norm, w_uk, w_uv, wo}`` and a MoE's ``ffn`` the float32
``router``, the experts ``{wi_gate, wi_up, wo}`` stacked on an expert
axis and ``shared.{wi_gate, wi_up, wo}``; an SSM's layers hold ``ln1``
and ``mixer.{wz, wx, wB, wC, wdt, conv_x, conv_B, conv_C, out}`` with the
float32 ``mixer.{A_log, D, dt_bias, norm}``.  A hybrid stacks its
blocks instead (``blocks.sub{i}.{ln1, ln2, mixer.*, ffn.*}``), an
encoder-decoder its two stacks (``enc_layers.*``, ``dec_layers.*``,
beside ``enc_ln_f``).  The port's LMs hold one module per layer, so layer
i's leaf ``layers.attn.wq[i]`` is its parameter ``layers.{i}.attn.wq``,
and likewise for every stack of ``LM_STACKS``.  bfloat16 leaves cross
through their bits, so they come across exact.  The caches are stacked
on the layer (or block) axis in both packages (``{"k", "v"}`` of GQA,
``{"c_kv", "k_rope"}`` of MLA, ``{"state", "conv_x", "conv_B",
"conv_C"}`` of the SSM, both of the hybrid, ``cross_k``/``cross_v``
beside the encoder-decoder's K/V), so they cross leaf by leaf.

On a mesh each rank holds its vocab slice of the tables
(``models.dlrm.vocab_rows``): ``dlrm_shard_from_numpy`` cuts a reference
state to a rank's slice, and ``dlrm_tables_for_mesh`` draws a rank's
slice of fresh tables by fixed row blocks, so every mesh holds the same
tables without any rank drawing them whole.  Under expert parallelism
each rank holds its slice of a MoE's experts (``models.moe.expert_rows``):
``moe_shard_from_numpy`` cuts one FFN's reference parameters to it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schema import ColumnBatch, SparseColumn
from repro_torch.models.dlrm import vocab_rows
from repro_torch.models.moe import expert_rows


def column_batch_from_numpy(
    num_rows: int,
    dense: Dict[int, np.ndarray],
    sparse: Dict[int, Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]],
    labels: Optional[np.ndarray] = None,
) -> ColumnBatch:
    """Build a port ``ColumnBatch`` from numpy columns: ``dense`` maps a
    feature id to its (num_rows,) values, ``sparse`` to its (offsets,
    values, scores or None).  Dict order is kept: it is the DWRF stream
    order."""
    for fid, col in dense.items():
        if len(col) != num_rows:
            raise ValueError(f"dense feature {fid}: {len(col)} rows != {num_rows}")
    out_sparse = {}
    for fid, (offsets, values, scores) in sparse.items():
        if len(offsets) != num_rows + 1:
            raise ValueError(
                f"sparse feature {fid}: {len(offsets)} offsets != {num_rows + 1}"
            )
        out_sparse[fid] = SparseColumn(offsets=offsets, values=values, scores=scores)
    if labels is not None and len(labels) != num_rows:
        raise ValueError(f"labels: {len(labels)} rows != {num_rows}")
    return ColumnBatch(num_rows=num_rows, dense=dict(dense), sparse=out_sparse,
                       labels=labels)


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested tree -> its leaves by dotted name, in sorted order; the
    leaves as they are."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Dotted names -> a nested tree, the inverse of ``flatten``; the
    leaves as they are."""
    out: Dict[str, Any] = {}
    for name in sorted(flat):
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[name]
    return out


def _flatten(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in flatten(tree).items()}


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Dotted names -> a nested tree of numpy leaves (tensors converted)."""
    return nest({k: _array(v) if isinstance(v, torch.Tensor) else v
                 for k, v in flat.items()})


def dlrm_params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's DLRM parameter tree (numpy leaves) -> the port's
    parameters by name (``DLRM.params()`` keys), float32 CPU tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in _flatten(tree).items()}


def dlrm_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``dlrm_params_from_numpy``: the reference's nested tree."""
    return _nest(params)


def adamw_state_from_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's AdamW state ``{"mu", "nu", "step"}`` (numpy leaves)
    -> the port's: ``mu``/``nu`` by parameter name, ``step`` an int32
    scalar tensor."""
    return {
        "mu": dlrm_params_from_numpy(state["mu"]),
        "nu": dlrm_params_from_numpy(state["nu"]),
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32),
    }


def adamw_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``adamw_state_from_numpy``."""
    return {
        "mu": _nest(state["mu"]),
        "nu": _nest(state["nu"]),
        "step": np.asarray(int(state["step"]), np.int32),
    }


TABLE_BLOCK_ROWS = 100_000   # the row blocks ``dlrm_tables_for_mesh`` draws by


def _vocab_slice(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows (axis 1) of a (T, V, ...) table-shaped leaf."""
    lo, hi = vocab_rows(t.shape[1], mesh)
    return t[:, lo:hi].contiguous()


def _shard_named(tree: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    return {k: _vocab_slice(v, mesh) if k == "tables" else v for k, v in tree.items()}


def dlrm_shard_from_numpy(state: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's slice of the reference's DLRM state (numpy leaves):
    ``{"params", "opt"}`` with ``opt`` the dense path's AdamW state
    ``{"mu", "nu", "step"}`` or the sparse step's ``{"adam", "acc"}``.
    Parameters and moments come by name (``DLRM.params()`` keys), float32
    CPU tensors; the tables, their moments and the accumulator are cut to
    the rank's rows (``models.dlrm.vocab_rows``), everything else whole.
    Other top-level keys (``"step"``) pass through."""
    def adamw(s):
        s = adamw_state_from_numpy(s)
        return {"mu": _shard_named(s["mu"], mesh), "nu": _shard_named(s["nu"], mesh),
                "step": s["step"]}

    out = dict(state)
    out["params"] = _shard_named(dlrm_params_from_numpy(state["params"]), mesh)
    opt = state["opt"]
    if "adam" in opt:
        out["opt"] = {"adam": adamw(opt["adam"]),
                      "acc": _vocab_slice(torch.from_numpy(np.array(opt["acc"], np.float32)),
                                          mesh)}
    else:
        out["opt"] = adamw(opt)
    return out


def dlrm_tables_for_mesh(cfg, mesh, seed: int = 0) -> torch.Tensor:
    """This rank's (T, hi - lo, E) slice of freshly drawn DLRM tables
    (normal, std 0.02), on the mesh's device.  Each table is drawn in
    blocks of ``TABLE_BLOCK_ROWS`` rows, block k of table t from its own
    generator on the device seeded from (seed, t, k), and the rank keeps
    the rows of each block in its slice: every mesh holds the same
    tables, and no rank draws (or holds on the host) more than the blocks
    its rows lie in."""
    v, e = cfg.vocab_per_table, cfg.embed_dim
    lo, hi = vocab_rows(v, mesh)
    dev = mesh.device
    out = torch.empty((cfg.num_tables, hi - lo, e), dtype=cfg.param_dtype, device=dev)
    gen = torch.Generator(device=dev)
    for t in range(cfg.num_tables):
        for k in range(lo // TABLE_BLOCK_ROWS, (hi - 1) // TABLE_BLOCK_ROWS + 1):
            b0 = k * TABLE_BLOCK_ROWS
            rows = min(TABLE_BLOCK_ROWS, v - b0)
            gen.manual_seed(((seed * 1_000_003 + t) * 1_000_003 + k) % 2 ** 63)
            block = torch.randn((rows, e), generator=gen, dtype=torch.float32, device=dev)
            a, z = max(lo, b0), min(hi, b0 + rows)
            out[t, a - lo:z - lo] = (0.02 * block[a - b0:z - b0]).to(out.dtype)
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of the same dtype; bfloat16 (numpy's
    ``ml_dtypes`` type) through its bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same dtype; bfloat16 as numpy's
    ``"bfloat16"``, which exists once the reference (its ``ml_dtypes``)
    is loaded in the process, the only place such a tree is read."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


# the keys of an LM tree whose leaves the reference stacks on axis 0, one
# entry a layer (``layers``), a hybrid block (``blocks``) or an
# encoder or decoder layer (``enc_layers``, ``dec_layers``)
LM_STACKS = ("layers", "blocks", "enc_layers", "dec_layers")


def stack_layers(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Flat LM leaves ``{stack}.{i}.{rest}`` (``stack`` in ``LM_STACKS``)
    -> ``{stack}.{rest}`` stacked on axis 0 in layer order (``np.stack``
    of numpy leaves, ``torch.stack`` of tensors); other names as they are."""
    out: Dict[str, Any] = {}
    per_layer: Dict[str, Dict[int, Any]] = {}
    for name, leaf in flat.items():
        stack, _, rest = name.partition(".")
        i, _, leaf_name = rest.partition(".")
        if stack in LM_STACKS and i.isdigit():
            per_layer.setdefault(f"{stack}.{leaf_name}", {})[int(i)] = leaf
        else:
            out[name] = leaf
    for name, leaves in per_layer.items():
        layers = [leaves[i] for i in sorted(leaves)]
        out[name] = (torch.stack(layers) if isinstance(layers[0], torch.Tensor)
                     else np.stack(layers))
    return out


def unstack_layers(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``stack_layers``: a stacked leaf's layers as views."""
    out: Dict[str, Any] = {}
    for name, leaf in flat.items():
        stack, _, rest = name.partition(".")
        if stack in LM_STACKS:
            for i in range(leaf.shape[0]):
                out[f"{stack}.{i}.{rest}"] = leaf[i]
        else:
            out[name] = leaf
    return out


def lm_params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's LM parameter tree (numpy leaves, each stack of
    ``LM_STACKS`` stacked on axis 0) -> the port's state dict (CPU tensors
    of the leaves' dtypes, a stack's leaf split into ``{stack}.{i}.*``),
    for ``model.load_state_dict``."""
    return {name: _tensor(leaf) for name, leaf in unstack_layers(_flatten(tree)).items()}


def lm_params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """Inverse of ``lm_params_from_numpy``: the reference's nested tree of
    a port LM, each stack's layers stacked again."""
    return _nest(stack_layers({name: _array(p) for name, p in model.state_dict().items()}))


def lm_cache_from_numpy(cache: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's stacked cache (the KV cache ``{"k", "v"}`` of (L, B,
    S, KVH, D), MLA's ``{"c_kv", "k_rope"}`` of (L, B, S, r), the SSM's
    state and conv tails, the hybrid's both, over its blocks, or the
    encoder-decoder's ``cross_k``/``cross_v`` beside its K/V) -> the
    port's, CPU tensors of the same dtypes."""
    return {name: _tensor(np.asarray(a)) for name, a in cache.items()}



def moe_shard_from_numpy(tree: Dict[str, Any], mesh) -> Dict[str, Any]:
    """One MoE FFN's reference parameters (numpy leaves: ``router``, the
    expert leaves ``wi_gate``/``wi_up``/``wo`` with the expert axis
    first, and ``shared`` if any) -> this rank's: a dict of CPU tensors of
    the leaves' dtypes, the expert leaves cut to the rank's
    ``expert_rows`` and everything else whole."""
    lo, hi = expert_rows(np.shape(tree["wi_gate"])[0], mesh)
    out: Dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = {k: _tensor(np.asarray(v)) for k, v in leaf.items()}
        elif name in ("wi_gate", "wi_up", "wo"):
            out[name] = _tensor(np.asarray(leaf)[lo:hi])
        else:
            out[name] = _tensor(np.asarray(leaf))
    return out
