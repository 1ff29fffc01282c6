"""DLRM — the paper's model family (Naumov et al.), in PyTorch.

A port of the reference's ``repro.models.dlrm``: bottom MLP over the
dense features, mean-pooled embedding bags per table, pairwise dot
interaction among [bottom, tables...], top MLP to one logit.  Sparse
features arrive from the DSI pipeline as padded (B, T, L) id tensors and
a (B, T, L) mask — the tensors DPP workers materialize.

Weights keep the reference's layout: an MLP layer is ``w{i}`` of shape
(din, dout) and ``b{i}`` of shape (dout,), applied as ``x @ w + b``, so
the reference's numpy weights load without a transpose
(``repro_torch.convert.dlrm_params_from_numpy``).  The embedding tables
are a parameter of the module only on the dense path (``tables=True``);
on the sparse path they live in ``train.embedding_cache``'s store and the
module holds the MLPs alone (at ``dlrm-paper`` widths the tables are
(42, 2M, 128) f32, 43 GB).

Init draws on a CPU ``torch.Generator`` from ``seed``, leaf by leaf in
sorted-name order (the reference's tree order), and then moves to the
device, so a CPU run and a CUDA run start from identical weights.  The
initializers are the reference's (``repro.models.common``): "scaled"
weights are normal with std 1/sqrt(fan_in), tables normal with std 0.02,
biases zero.  JAX's PRNG cannot be matched; tests carry weights across.

Model-parallel tables (``_vocab_shards``, ``pooled_embeddings_sharded``,
``sparse_table_update_sharded``): each rank on a mesh's "model" axis
holds rows [r V/n, (r+1) V/n) of every table, (T, V/n, E), and the ids,
masks and d(pooled) are whole on every model rank.  A rank pools only the
occurrences in its own rows, the partial sums are added over "model", and
the update touches only its own rows: the reference's ``shard_map``
semantics, with the rank's slice as the argument in place of the whole
table.  When n does not divide V the unsharded forms run on whole tables,
as in the reference.  On a CUDA tensor the rank's partial is one launch
of the ``embedding_bag`` kernel (sum mode) over its (T V/n, E) rows.

Both table updates, of whole tables and of a rank's slice, hand
``ops.rowwise_adagrad_`` the same operands: each slot's row key in the
flat (T rows, E) table (-1 for another rank's row), its weight and its
bag's d(pooled) row.  On a CPU tensor that is the reference's
scatter-adds; on a CUDA tensor one launch of the ``rowwise_adagrad``
kernel, which never makes the per-slot (N, E) gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple, Union

import torch
from torch import nn

from repro_torch.device import resolve
from repro_torch.distributed.collectives import reduce_from
from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec, abstract_params


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    family: str = "dlrm"
    num_dense: int = 504                 # RM3-like defaults (Table 4)
    num_tables: int = 42
    vocab_per_table: int = 100_000
    embed_dim: int = 128
    max_ids_per_feature: int = 32        # avg sparse length ~20-26 (Table 5)
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    sub_quadratic = True
    attention_free = True

    @property
    def num_layers(self) -> int:  # for generic tooling
        return len(self.bottom_mlp) + len(self.top_mlp)


class MLP(nn.Module):
    """``x @ w{i} + b{i}`` then ReLU, for each layer; the last layer
    stays linear when ``last_linear``."""

    def __init__(self, dims: Tuple[int, ...], last_linear: bool, dtype):
        super().__init__()
        self.n = len(dims) - 1
        self.last_linear = last_linear
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            self.register_parameter(f"w{i}", nn.Parameter(torch.empty(din, dout, dtype=dtype)))
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(dout, dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if not (self.last_linear and i == self.n - 1):
                x = torch.relu(x)
        return x


def vocab_shards(vocab: int, mesh) -> int:
    """The number of vocab slices of a table on ``mesh``: the "model"
    axis's size where it divides ``vocab``, else 1 (whole tables)."""
    n = mesh.shape["model"]
    return n if vocab % n == 0 else 1


def vocab_rows(vocab: int, mesh) -> Tuple[int, int]:
    """[lo, hi): the rows of each ``vocab``-row table this rank holds."""
    n = vocab_shards(vocab, mesh)
    v_loc = vocab // n
    lo = mesh.coord("model") * v_loc if n > 1 else 0
    return lo, lo + v_loc


def _mlp_specs(dims, dtype) -> Dict[str, ParamSpec]:
    specs = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        specs[f"w{i}"] = ParamSpec((din, dout), dtype, "scaled", logical=("embed", "mlp"))
        specs[f"b{i}"] = ParamSpec((dout,), dtype, "zeros", logical=(None,))
    return specs


class _BagSum(torch.autograd.Function):
    """``ops.embedding_bag(table, ids, w, mode="sum")``: the kernel on a
    CUDA tensor, the plain version on a CPU one.  Backward scatters
    ``w * grad`` into a dense gradient of the table."""

    @staticmethod
    def forward(ctx, table, ids, w):
        ctx.save_for_backward(ids, w)
        ctx.rows = table.shape[0]
        return ops.embedding_bag(table, ids, w, mode="sum")

    @staticmethod
    def backward(ctx, g):
        ids, w = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        e = g.shape[-1]
        grad = torch.zeros((ctx.rows, e), dtype=g.dtype, device=g.device)
        grad.index_add_(0, ids.reshape(-1).long(), (g[:, None, :] * w[..., None]).reshape(-1, e))
        return grad, None, None


def bce_with_logits(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy in the reference's exact form:
    ``max(z, 0) - z*y + log1p(exp(-|z|))``."""
    return torch.mean(
        torch.clamp(logit, min=0) - logit * label
        + torch.log1p(torch.exp(-torch.abs(logit)))
    )


class DLRM(nn.Module):
    def __init__(self, cfg: DLRMConfig, *, tables: bool = True, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if cfg.bottom_mlp[-1] != cfg.embed_dim:
            raise ValueError(
                f"bottom_mlp[-1]={cfg.bottom_mlp[-1]} must equal embed_dim="
                f"{cfg.embed_dim}: the interaction stacks them"
            )
        self.cfg = cfg
        dev = resolve(device, "DLRM")
        c = cfg
        n_pairs = (c.num_tables + 1) * c.num_tables // 2
        self.bottom = MLP((c.num_dense,) + c.bottom_mlp, False, c.param_dtype)
        self.top = MLP((c.bottom_mlp[-1] + n_pairs,) + c.top_mlp, True, c.param_dtype)
        if tables:
            self.tables = nn.Parameter(torch.empty(
                c.num_tables, c.vocab_per_table, c.embed_dim, dtype=c.param_dtype))
        else:
            self.tables = None
        t = c.num_tables + 1
        iu, ju = torch.triu_indices(t, t, 1)          # jnp.triu_indices order
        self.register_buffer("_iu", iu, persistent=False)
        self.register_buffer("_ju", ju, persistent=False)
        self.init_weights(seed)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self._iu.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Draw every weight from ``seed`` on a CPU generator, leaf by leaf
        in sorted-name order, and copy it to the module's device."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in sorted(self.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("b"):
                val = torch.zeros(p.shape, dtype=torch.float32)
            elif name == "tables":
                val = 0.02 * torch.randn(p.shape, generator=gen, dtype=torch.float32)
            else:                                      # "scaled": 1/sqrt(fan_in)
                std = 1.0 / math.sqrt(max(p.shape[0], 1))
                val = std * torch.randn(p.shape, generator=gen, dtype=torch.float32)
            p.copy_(val.to(p.dtype))

    def init(self, seed: int = 0) -> "DLRM":
        """``init_weights(seed)``, returning the model."""
        self.init_weights(seed)
        return self

    def abstract(self) -> Dict[str, Any]:
        """The reference's parameter tree as ``meta`` tensors."""
        return abstract_params(self.param_specs())

    def param_specs(self) -> Dict[str, Any]:
        """The reference's spec tree with its logical axes: tables
        ("expert", "vocab", None), MLP weights ("embed", "mlp"), biases
        (None,)."""
        c = self.cfg
        n_pairs = (c.num_tables + 1) * c.num_tables // 2
        return {
            "tables": ParamSpec((c.num_tables, c.vocab_per_table, c.embed_dim),
                                c.param_dtype, "normal", logical=("expert", "vocab", None)),
            "bottom": _mlp_specs((c.num_dense,) + c.bottom_mlp, c.param_dtype),
            "top": _mlp_specs((c.bottom_mlp[-1] + n_pairs,) + c.top_mlp, c.param_dtype),
        }

    def input_specs(self, batch: int, seq: int = 0, mode: str = "train") -> Dict[str, Any]:
        """Shape and dtype of each input of a step (``seq`` is unused; a
        "train" step also takes ``label``)."""
        c = self.cfg
        ids = (batch, c.num_tables, c.max_ids_per_feature)
        specs = {"dense": ((batch, c.num_dense), torch.float32),
                 "sparse_ids": (ids, torch.int32),
                 "sparse_mask": (ids, torch.float32)}
        if mode == "train":
            specs["label"] = ((batch,), torch.float32)
        return specs

    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters by name, in sorted order (the reference's tree
        order, which ``optim.global_norm`` sums in)."""
        return dict(sorted(self.named_parameters()))

    # -- dense path ----------------------------------------------------------

    def pooled_embeddings(self, tables: torch.Tensor,
                          batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(T, V, E) tables, (B, T, L) ids/mask -> (B, T, E) mean-pooled
        bags; ids clip to [0, V-1]."""
        c = self.cfg
        ids, mask = batch["sparse_ids"], batch["sparse_mask"]
        ids = ids.long().clamp(0, c.vocab_per_table - 1)
        t = torch.arange(ids.shape[1], device=ids.device)[None, :, None]
        emb = tables[t, ids]                                     # (B, T, L, E)
        denom = torch.maximum(mask.sum(dim=2), torch.ones((), device=mask.device))
        return (emb * mask[..., None]).sum(dim=2) / denom[..., None]

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.tables is None:
            raise RuntimeError("this DLRM holds no tables (sparse path): "
                               "use forward_from_pooled")
        pooled = self.pooled_embeddings(self.tables, batch)
        return self.forward_from_pooled(pooled, batch)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logit = self.forward(batch).to(torch.float32)
        return bce_with_logits(logit, batch["label"])

    def normalized_entropy(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The paper's model-quality metric (He et al. 2014)."""
        label = batch["label"]
        nll = self.loss(batch)
        p = torch.clamp(torch.mean(label), 1e-6, 1 - 1e-6)
        base = -(p * torch.log(p) + (1 - p) * torch.log(1 - p))
        return nll / base

    # -- sparse training path --------------------------------------------------

    def forward_from_pooled(self, pooled: torch.Tensor,
                            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        dense = batch["dense"].to(self.cfg.compute_dtype)
        bot = self.bottom(dense)
        feats = torch.cat([bot[:, None, :], pooled], dim=1)      # (B, T+1, E)
        inter = torch.bmm(feats, feats.transpose(1, 2))
        top_in = torch.cat([bot, inter[:, self._iu, self._ju]], dim=-1)
        return self.top(top_in)[:, 0]

    def loss_from_pooled(self, pooled: torch.Tensor,
                         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logit = self.forward_from_pooled(pooled, batch).to(torch.float32)
        return bce_with_logits(logit, batch["label"])

    @torch.no_grad()
    def sparse_table_update_(
        self,
        tables: torch.Tensor,       # (T, V, E)
        acc: torch.Tensor,          # (T, V) row-wise AdaGrad accumulator
        dpooled: torch.Tensor,      # (B, T, E)
        batch: Dict[str, torch.Tensor],
        lr: Union[float, torch.Tensor],
        eps: float = 1e-8,
    ) -> None:
        """Row-wise AdaGrad on the touched rows only, in place: each slot's
        gradient is its bag's d(pooled) times its weight, the accumulator
        adds each row's mean squared gradient, and each occurrence moves
        its row by -lr/sqrt(acc+eps) times its gradient
        (``ops.rowwise_adagrad_``: the plain scatter-adds on the CPU, one
        sorted, fused kernel on the card)."""
        c = self.cfg
        keys, w = self._update_operands(batch, 0, c.vocab_per_table)
        ops.rowwise_adagrad_(tables.view(-1, c.embed_dim), acc.view(-1), keys, w,
                             dpooled.reshape(-1, c.embed_dim), lr, eps)

    def _update_operands(self, batch: Dict[str, torch.Tensor], lo: int, rows: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(keys, weights), each (B T, L), of an update of rows [lo, lo +
        rows) of every table held as one flat (T rows, E) table: a slot's
        key is its clipped id's int32 row there (-1 where the id lies
        outside them); its weight is mask / max(sum(mask), 1) over its
        whole bag."""
        c = self.cfg
        ids = batch["sparse_ids"].clamp(0, c.vocab_per_table - 1).to(torch.int32)
        b, t, l = ids.shape
        if t * rows >= 2 ** 31:
            raise ValueError(f"{t} x {rows} rows exceed the update's int32 keys")
        offs = torch.arange(t, device=ids.device, dtype=torch.int32)[None, :, None] * rows
        if rows == c.vocab_per_table:
            keys = ids + offs
        else:
            local = ids - lo
            keys = torch.where((local >= 0) & (local < rows), local + offs, -1)
        mask = batch["sparse_mask"]
        denom = torch.maximum(mask.sum(dim=2), torch.ones((), device=mask.device))
        return keys.reshape(b * t, l), (mask / denom[..., None]).reshape(b * t, l)

    def sparse_table_update(self, tables, acc, dpooled, batch, lr, eps: float = 1e-8
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``sparse_table_update_`` on copies: returns new (tables, acc);
        the inputs are kept."""
        tables, acc = tables.clone(), acc.clone()
        self.sparse_table_update_(tables, acc, dpooled, batch, lr, eps)
        return tables, acc

    # -- model-parallel tables (vocab-sharded over the mesh's "model" axis) --

    def _vocab_shards(self, mesh) -> int:
        return vocab_shards(self.cfg.vocab_per_table, mesh)

    def vocab_rows(self, mesh) -> Tuple[int, int]:
        """[lo, hi): the rows of every table this rank holds on ``mesh``."""
        return vocab_rows(self.cfg.vocab_per_table, mesh)

    def _rank_rows(self, tables: torch.Tensor, mesh) -> Tuple[int, int]:
        """``vocab_rows(mesh)``, checking that ``tables`` is the rank's slice."""
        lo, hi = self.vocab_rows(mesh)
        if tables.shape[1] != hi - lo:
            raise ValueError(f"tables {tuple(tables.shape)} are not this rank's "
                             f"{hi - lo}-row slice on {mesh}")
        return lo, hi

    def _local_ids(self, tables: torch.Tensor, batch, mesh):
        """ids clipped to [0, V-1], then (this rank's row of each id, the
        in-range mask); checks that ``tables`` is the rank's slice."""
        c = self.cfg
        lo, hi = self._rank_rows(tables, mesh)
        ids = batch["sparse_ids"].long().clamp(0, c.vocab_per_table - 1)
        local = ids - lo
        return local, (local >= 0) & (local < hi - lo)

    def pooled_embeddings_sharded(self, tables: torch.Tensor, batch: Dict[str, torch.Tensor],
                                  mesh) -> torch.Tensor:
        """(B, T, E) mean-pooled bags from this rank's (T, V/n, E) slice:
        its in-range occurrences weighted by the mask, summed over the
        "model" axis, divided by max(sum(mask), 1) over the whole mask.
        Differentiable in ``tables``."""
        if self._vocab_shards(mesh) == 1:
            return self.pooled_embeddings(tables, batch)
        c = self.cfg
        local, sel = self._local_ids(tables, batch, mesh)
        mask = batch["sparse_mask"]
        b, t, l = local.shape
        v_loc = tables.shape[1]
        if t * v_loc >= 2 ** 31:
            raise ValueError(f"{t} x {v_loc} rows exceed the kernel's int32 ids")
        offs = torch.arange(t, device=local.device)[None, :, None] * v_loc
        flat = (torch.where(sel, local, 0) + offs).to(torch.int32).reshape(b * t, l)
        w = (mask * sel).to(tables.dtype).reshape(b * t, l)
        part = _BagSum.apply(tables.reshape(-1, c.embed_dim), flat, w).reshape(b, t, c.embed_dim)
        part = reduce_from(part, mesh, "model")
        denom = torch.maximum(mask.sum(dim=2), torch.ones((), device=mask.device))
        return part / denom[..., None].to(part.dtype)

    @torch.no_grad()
    def sparse_table_update_sharded_(self, tables, acc, dpooled, batch, lr, mesh,
                                     eps: float = 1e-8) -> None:
        """``sparse_table_update_`` on this rank's (T, V/n, E) slice and
        (T, V/n) accumulator, in place: only the occurrences in its rows."""
        if self._vocab_shards(mesh) == 1:
            self.sparse_table_update_(tables, acc, dpooled, batch, lr, eps)
            return
        c = self.cfg
        lo, hi = self._rank_rows(tables, mesh)
        keys, w = self._update_operands(batch, lo, hi - lo)
        ops.rowwise_adagrad_(tables.view(-1, c.embed_dim), acc.view(-1), keys, w,
                             dpooled.reshape(-1, c.embed_dim), lr, eps)

    def sparse_table_update_sharded(self, tables, acc, dpooled, batch, lr, mesh,
                                    eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
        """``sparse_table_update_sharded_`` on copies: returns the rank's
        new (tables, acc) slices; the inputs are kept."""
        tables, acc = tables.clone(), acc.clone()
        self.sparse_table_update_sharded_(tables, acc, dpooled, batch, lr, mesh, eps)
        return tables, acc
