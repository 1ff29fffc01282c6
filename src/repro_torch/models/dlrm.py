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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple, Union

import torch
from torch import nn

from repro_torch.device import resolve


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
    def sparse_table_update(
        self,
        tables: torch.Tensor,       # (T, V, E)
        acc: torch.Tensor,          # (T, V) row-wise AdaGrad accumulator
        dpooled: torch.Tensor,      # (B, T, E)
        batch: Dict[str, torch.Tensor],
        lr: Union[float, torch.Tensor],
        eps: float = 1e-8,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Row-wise AdaGrad on the touched rows only: d(pooled) expands to
        per-row gradients, the accumulator adds each row's mean squared
        gradient, and each occurrence moves its row by -lr/sqrt(acc+eps)
        times its gradient.  Returns new (tables, acc); inputs are kept."""
        c = self.cfg
        ids = batch["sparse_ids"].long().clamp(0, c.vocab_per_table - 1)
        mask = batch["sparse_mask"]
        denom = torch.maximum(mask.sum(dim=2), torch.ones((), device=mask.device))
        w = mask / denom[..., None]                              # (B, T, L)
        rg = (dpooled[:, :, None, :] * w[..., None]).reshape(-1, c.embed_dim)
        t = ids.shape[1]
        offs = torch.arange(t, device=ids.device)[None, :, None] * c.vocab_per_table
        flat = (ids + offs).reshape(-1)
        acc_flat = acc.reshape(-1).clone()
        acc_flat.index_add_(0, flat, torch.mean(torch.square(rg), dim=-1))
        scale = lr / torch.sqrt(acc_flat[flat] + eps)
        tables_flat = tables.reshape(-1, c.embed_dim).clone()
        tables_flat.index_add_(0, flat, (-scale[:, None] * rg).to(tables.dtype))
        return tables_flat.reshape(tables.shape), acc_flat.reshape(acc.shape)
