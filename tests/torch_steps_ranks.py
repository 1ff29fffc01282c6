"""The port's side of ``tests/test_torch_steps_sharded.py``: ``run_rank``
runs on every rank of a gloo group of four that
``repro_torch.distributed.spawn`` starts, on the CPU, and returns numpy
results.  It imports no JAX: the ranks start fast."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy, moe_shard_from_numpy
from repro_torch.launch.mesh import make_mesh, record_collectives
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.models.common import ModelConfig, MoEConfig
from repro_torch.models.moe import expert_rows, moe_forward_ep
from repro_torch.optim import OptimizerConfig, adamw_init
from repro_torch.train import Trainer, TrainerConfig

AXES = ("data", "model")


def smoke(arch):
    """The reference script's config, in the port."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    return dataclasses.replace(cfg, remat=True) if cfg.moe is not None else cfg


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy() if isinstance(tree, torch.Tensor) else tree


def _train(arch, mesh, ins, c):
    cfg = smoke(arch)
    opt_cfg = OptimizerConfig(**c["opt"])
    bundle = make_train_step(cfg, mesh, c["B"], c["S"], opt_cfg=opt_cfg, device="cpu")
    params = bundle.shard_params(lm_params_from_numpy(ins[arch]["params0"]))
    opt = adamw_init(params, opt_cfg)
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    out = {"specs": {k: tuple(s) for k, s in bundle.in_specs[0].items()},
           "expert": sorted(bundle.expert), "loss": [], "grad_norm": [], "params": []}
    for i, b in enumerate(ins[arch]["batches"]):
        local = bundle.shard_batch(b)
        with record_collectives() as log:
            params, opt, m = bundle.fn(params, opt, local)
        if i == 0:          # step 1's collectives, (kind, result bytes, axis, group)
            out["collectives"] = [(c.kind, c.nbytes, c.axis, c.group) for c in log]
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["params"].append(_np(params))
    out["in_place"] = all(p.data_ptr() == ptrs[k] for k, p in params.items())
    out["mu_specs_same"] = set(opt["mu"]) == set(params) and all(
        opt["mu"][k].shape == params[k].shape for k in params)
    return out


def _ep_backward(mesh, ins, c):
    """d(sum(y * cot) + coef * aux / n_data)/d(params, x) of this rank's
    rows through ``moe_forward_ep``."""
    cfg = ModelConfig(**c["ep_cfg"], moe=MoEConfig(**c["ep_moe"]),
                      param_dtype=torch.float32, compute_dtype=torch.float32)
    p = moe_shard_from_numpy(ins["ep_params"], mesh)
    leaves = {"router": p["router"], "wi_gate": p["wi_gate"], "wi_up": p["wi_up"],
              "wo": p["wo"], **{f"shared.{k}": v for k, v in p["shared"].items()}}
    leaves = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    tree = {k: v for k, v in leaves.items() if "." not in k}
    tree["shared"] = {k.split(".")[1]: v for k, v in leaves.items() if "." in k}
    n_data = mesh.shape["data"]
    rows = ins["ep_x"].shape[0] // n_data
    lo = mesh.coord("data") * rows
    x = torch.from_numpy(ins["ep_x"][lo:lo + rows]).requires_grad_(True)
    cot = torch.from_numpy(ins["ep_cot"][lo:lo + rows])
    y, aux = moe_forward_ep(tree, x, cfg, mesh, cfg.moe)
    loss = torch.sum(y * cot) + c["aux_coef"] * aux / n_data
    grads = torch.autograd.grad(loss, [*leaves.values(), x])
    out = {k: g.numpy() for k, g in zip(leaves, grads)}
    out["x"] = grads[-1].numpy()
    out["rows"], out["experts"] = (lo, lo + rows), expert_rows(cfg.moe.num_experts, mesh)
    return out


def _serve(mesh, ins, c):
    cfg = smoke(c["archs"][0])
    full = lm_params_from_numpy(ins[c["archs"][0]]["params0"])
    pre = make_prefill_step(cfg, mesh, c["B"], c["S"], device="cpu")
    logits, cache = pre.fn(pre.shard_params(full),
                           pre.shard_batch({"tokens": ins["serve"]["tokens"]}))
    out = {"prefill_logits": logits.numpy(), "prefill_cache": _np(cache),
           "expert": sorted(pre.expert)}
    dec = make_decode_step(cfg, mesh, c["B"], c["S"] + c["decode_extra"], device="cpu")
    local = dec.shard_batch({"token": ins["serve"]["token"], "pos": np.int32(c["S"]),
                             "cache": ins["serve"]["long_cache"]})
    ptrs = {k: t.data_ptr() for k, t in local["cache"].items()}
    logits, cache = dec.fn(dec.shard_params(full), local)
    out["decode_logits"] = logits.numpy()
    out["decode_cache"] = _np(cache)
    out["decode_in_place"] = all(t.data_ptr() == ptrs[k] for k, t in cache.items())
    out["decode_specs"] = {k: tuple(s) for k, s in dec.in_specs[1]["cache"].items()}
    return out


def _trainer(mesh, next_mesh, ins, c):
    """``Trainer(mesh=...)`` on qwen3-smoke: the steps, then ``remesh``."""
    arch = c["archs"][1]
    cfg, opt_cfg = smoke(arch), OptimizerConfig(**c["opt"])
    batches = ins[arch]["batches"]
    trainer = Trainer(cfg, opt_cfg, TrainerConfig(max_steps=len(batches),
                                                  checkpoint_dir=c["ckpt_dir"]),
                      mesh=mesh, device="cpu")
    params = make_train_step(cfg, mesh, c["B"], c["S"], trainer.rules,
                             device="cpu").shard_params(lm_params_from_numpy(ins[arch]["params0"]))
    state = trainer.fit(batches, {"params": params, "opt": adamw_init(params, opt_cfg),
                                  "step": 0})
    out = {"specs": {k: tuple(s) for k, s in trainer._specs().items()},
           "loss": [h.loss for h in trainer.history],
           "grad_norm": [h.grad_norm for h in trainer.history],
           "params": _np(state["params"]), "step": state["step"]}
    state = trainer.remesh(next_mesh, state)
    out["remeshed"] = _np(state["params"])
    out["remeshed_mu"] = _np(state["opt"]["mu"])
    out["next_specs"] = {k: tuple(s) for k, s in trainer._specs().items()}
    fresh = trainer.init_state(0)
    out["init_shapes"] = {k: tuple(v.shape) for k, v in fresh["params"].items()}
    # the checkpoint written whole on this mesh, resumed on the next one
    resumed = Trainer(cfg, opt_cfg, TrainerConfig(max_steps=len(batches),
                                                  checkpoint_dir=c["ckpt_dir"]),
                      mesh=next_mesh, device="cpu")
    state = resumed.fit([], resumed.init_state(1))
    out["resumed_step"] = state["step"]
    out["resumed"] = _np(state["params"])
    out["resumed_mu"] = _np(state["opt"]["mu"])
    return out


def run_rank(rank, ins, c):
    torch.set_num_threads(1)
    out = {}
    meshes = [tuple(s) for s in c["meshes"]]
    for shape in meshes:
        mesh = make_mesh(shape, AXES, device="cpu")
        r = {"coord": (mesh.coord("data"), mesh.coord("model"))}
        for arch in c["archs"]:
            r[arch] = _train(arch, mesh, ins, c)
        r["ep"] = _ep_backward(mesh, ins, c)
        if shape == meshes[0]:
            r["serve"] = _serve(mesh, ins, c)
            nxt = make_mesh(meshes[1], AXES, device="cpu")
            r["trainer"] = _trainer(mesh, nxt, ins, c)
            r["trainer"]["next_coord"] = (nxt.coord("data"), nxt.coord("model"))
        out[shape] = r
    return out
