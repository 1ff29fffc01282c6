"""Plain reference of DLRM's sparse training steps (Naumov et al.): each
table's bag mean-pooled over its live ids (ids outside the vocab clipped
to its ends), a ReLU bottom MLP over the dense features, the pairwise
dots of [bottom output, each table's bag] in upper-triangle order beside
the bottom output, a top MLP whose last layer is linear, and the mean
binary cross-entropy with logits.  The MLPs take ``adamw.AdamW`` (the
clip over the MLP gradients alone); each table row the batch reads takes
row-wise AdaGrad at ``sparse_lr_scale`` x the schedule's learning rate:
every occurrence's gradient (its bag's gradient times the occurrence's
share of the bag) adds its mean square to the row's accumulator, and
then moves the row by -lr / sqrt(acc + eps) times itself.

Float32 with TF32 off.  ``precision="tf32"`` is the control: every
matrix product of the MLPs and the interaction takes operands rounded to
TF32 (10 bits of mantissa, to nearest).  Only the rows the steps read
are kept: the tables are drawn whole from the seed, those rows gathered,
and the rest freed.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from dsibench import weights as W
from dsibench.reference.adamw import AdamW, schedule


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (float32 with 13 low mantissa bits cleared,
    to nearest, ties away from zero); gradients pass straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    q = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (q - x).detach()


def bce_with_logits(z, y):
    return torch.mean(torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


class Model:
    def __init__(self, m: Dict[str, Any], precision: str):
        self.m = m
        self.q = tf32 if precision == "tf32" else (lambda t: t)
        t = m["num_tables"] + 1
        self.iu, self.ju = torch.triu_indices(t, t, 1)

    def mlp(self, p, tower, x, n, last_linear):
        for i in range(n):
            x = self.q(x) @ self.q(p[f"{tower}.w{i}"]) + p[f"{tower}.b{i}"]
            if not (last_linear and i == n - 1):
                x = torch.relu(x)
        return x

    def loss(self, p, pooled, dense, label):
        m = self.m
        bot = self.mlp(p, "bottom", dense, len(m["bottom_mlp"]), False)
        feats = torch.cat([bot[:, None, :], pooled], dim=1)
        inter = self.q(feats) @ self.q(feats).transpose(1, 2)
        top_in = torch.cat([bot, inter[:, self.iu.to(feats.device), self.ju.to(feats.device)]],
                           dim=-1)
        z = self.mlp(p, "top", top_in, len(m["top_mlp"]), True)[:, 0]
        return bce_with_logits(z, label)


def run(model: Dict[str, Any], opt: Dict[str, Any], seed: int,
        batches: List[Dict[str, np.ndarray]], device, precision: str = "float32"
        ) -> Dict[str, Any]:
    """The reference's steps over ``batches`` from the weights of
    ``seed``: each step's loss; the first step's gradient norm of each
    MLP leaf (clipped, as AdamW takes it) and of each table's row
    gradients; after the last step, each MLP leaf's change, each table's
    change over the rows read and each table's accumulator."""
    m = dict(model)
    t, v, e = m["num_tables"], m["vocab_per_table"], m["embed_dim"]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        flat_ids, live = [], []
        for b in batches:
            ids = np.clip(b["sparse_ids"].astype(np.int64), 0, v - 1)
            flat_ids.append(ids + np.arange(t, dtype=np.int64)[None, :, None] * v)
            live.append(b["sparse_mask"] > 0)
        rows = np.unique(np.concatenate([f[k] for f, k in zip(flat_ids, live)]))
        tables, mlp = W.dlrm_weights(m, seed, device)
        rows_t = torch.as_tensor(rows, device=device)
        start = tables.view(-1, e)[rows_t].clone()
        del tables
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()        # the whole tables' block, free for the next draw
        emb = start.clone()
        acc = torch.zeros(len(rows), dtype=torch.float32, device=device)
        table_of = rows_t // v
        params = {k: x.clone().requires_grad_(True) for k, x in mlp.items()}
        net = Model(m, precision)
        adam = AdamW(opt, params, [k for k, x in params.items() if x.dim() >= 2])
        losses, first = [], None
        for step, (b, f, k) in enumerate(zip(batches, flat_ids, live), 1):
            # each live slot's row among the kept rows; a dead slot reads row
            # 0 with weight 0
            idx = np.where(k, np.searchsorted(rows, f), 0)
            idx_t = torch.as_tensor(idx, device=device)
            mask = torch.as_tensor(b["sparse_mask"], device=device)
            denom = torch.clamp(mask.sum(dim=2), min=1.0)
            w = mask / denom[..., None]
            with torch.no_grad():
                pooled = (emb[idx_t] * w[..., None]).sum(dim=2)
            pooled.requires_grad_(True)
            dense = torch.as_tensor(b["dense"], device=device)
            label = torch.as_tensor(b["label"], device=device)
            loss = net.loss(params, pooled, dense, label)
            *g, gp = torch.autograd.grad(loss, [*params.values(), pooled])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                clipped = adam.step({kk: p.data for kk, p in params.items()},
                                    dict(zip(params, g)))
                lr = schedule(opt, step) * opt["sparse_lr_scale"]
                rg = (gp[:, :, None, :] * w[..., None]).reshape(-1, e)
                flat = idx_t.reshape(-1)
                acc.index_add_(0, flat, torch.mean(rg * rg, dim=-1))
                scale = lr / torch.sqrt(acc[flat] + opt["adagrad_eps"])
                emb.index_add_(0, flat, -scale[:, None] * rg)
                if first is None:
                    first = {kk: float(torch.linalg.vector_norm(x)) for kk, x in clipped.items()}
                    sq = (rg * rg).sum(dim=-1).reshape(mask.shape).sum(dim=(0, 2))
                    for tt in range(t):
                        first[f"tables.{tt}"] = float(torch.sqrt(sq[tt]))
        change = {k: float(torch.linalg.vector_norm(p.detach() - mlp[k]))
                  for k, p in params.items()}
        d = torch.linalg.vector_norm(emb - start, dim=1) ** 2
        for tt in range(t):
            sel = table_of == tt
            change[f"tables.{tt}"] = float(torch.sqrt(d[sel].sum()))
            change[f"acc.{tt}"] = float(torch.linalg.vector_norm(acc[sel]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {"losses": losses, "grad": first, "change": change, "rows": len(rows)}

