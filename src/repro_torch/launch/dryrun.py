"""Dry run of every (arch x shape x mesh) cell: one rank's step traced on
the ``meta`` device over a virtual mesh.

A port of the reference's ``repro.launch.dryrun``.  The reference lowers
and compiles each cell for 256 or 512 virtual host devices
(``--xla_force_host_platform_device_count=512``) and reads the compiled
program; here one rank of the production mesh, (16, 16) over ("data",
"model") or (2, 16, 16) over ("pod", "data", "model"), is a
``launch.mesh.VirtualMesh`` at coordinate 0, and its step
(``launch.steps.make_step(..., device="meta")``) runs once on empty
``meta`` tensors of its slices (``StepBundle.slice_shapes``) and its
batch rows, under the op-trace analyzer (``launch.hlo_analysis``).
Nothing is computed: the kernels and every other op propagate shapes.

For each cell this proves the sharding config is coherent end to end
(every slice, gather and collective has the shape the step needs) and
gives the roofline terms on the H100 (``launch.roofline``).  The records
keep the reference's keys: ``lower_s`` is the time to build the step and
its arguments, ``compile_s`` the trace's; ``memory_analysis`` comes from
the trace (``hlo_analysis.memory_analysis``); ``xla_cost_analysis``
becomes ``flop_counter``, ``torch.utils.flop_counter.FlopCounterMode``'s
total over the same run, a cross-check of the dot count; and
``hlo_size_chars`` is the number of ops in the trace.  A decode step's
``pos`` is a host int (the last cache slot), as the models read it with
``int(pos)``.

One cell runs on the CPU instead: ``dlrm-paper`` ``train_4k``, whose
sparse update sizes its occurrences with ``nonzero``
(``kernels/ref.py``'s ``rowwise_adagrad_``, the CPU form), which ``meta``
cannot size.  It runs on CPU tensors
at full size (one rank's 125,000-row slice of each of the 42 tables),
with every id in the rank's rows and every mask slot set: the most work
a rank's step can do.  Its record says so (``device``, ``note``).

Results append to an incremental JSONL so a crashed sweep resumes where
it left off.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # full sweep, both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --resume   # skip cells already done
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.launch import roofline as rl
from repro_torch.launch.hlo_analysis import analyze, memory_analysis, trace
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.launch.steps import make_step, slice_shape
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.optim import adamw_init

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                       "dryrun_torch.jsonl")
DLRM_NOTE = ("traced on CPU tensors at full size (meta cannot size the sparse update's "
             "nonzero): every id in the rank's rows and every mask slot set")


def production_shape(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def lm_args(bundle, shape) -> Tuple[Any, ...]:
    """One rank's arguments of an LM step, empty on the mesh's device
    (``meta``): its parameter slices, a zero AdamW state for a train step,
    and its batch rows.  A decode step's ``pos`` is the last cache slot, a
    host int."""
    model, mesh = bundle.model, bundle.mesh

    def empty(shape_dtype, spec):
        s, dtype = shape_dtype
        return torch.empty(slice_shape(tuple(s), spec, mesh), dtype=dtype, device=mesh.device)

    params = {k: torch.empty(s, dtype=model.get_parameter(k).dtype, device=mesh.device)
              for k, s in bundle.slice_shapes().items()}
    specs = model.input_specs(shape.global_batch, shape.seq_len, shape.mode)
    bspecs = bundle.in_specs[-1]
    batch: Dict[str, Any] = {}
    for k, v in specs.items():
        if k == "pos":
            batch[k] = shape.seq_len - 1
        elif k == "cache":
            batch[k] = {ck: empty(cv, bspecs[k][ck]) for ck, cv in v.items()}
        else:
            batch[k] = empty(v, bspecs[k])
    if shape.mode == "train":
        return params, adamw_init(params, bundle.opt_cfg), batch
    return params, batch


def dlrm_args(bundle, global_batch: int, seed: int = 0) -> Tuple[Any, ...]:
    """One rank's arguments of the DLRM sparse step on the mesh's device
    (the CPU): its MLPs and its (T, V/n, E) slice of the tables (empty),
    a zero accumulator and AdamW state, and its batch rows with every id
    in the rank's rows and every mask slot set."""
    model: DLRM = bundle.model
    mesh = bundle.mesh
    c = model.cfg
    dev = mesh.device
    params = {k: torch.zeros_like(p) for k, p in model.params().items()}
    lo, hi = model.vocab_rows(mesh)
    params["tables"] = torch.empty((c.num_tables, hi - lo, c.embed_dim), dtype=torch.float32,
                                   device=dev)
    opt = {"adam": adamw_init({k: v for k, v in params.items() if k != "tables"},
                              bundle.opt_cfg),
           "acc": torch.zeros((c.num_tables, hi - lo), dtype=torch.float32, device=dev)}
    rng = np.random.default_rng(seed)
    b = slice_shape((global_batch,), bundle.in_specs[2]["label"], mesh)[0]
    ids = (b, c.num_tables, c.max_ids_per_feature)
    batch = {"dense": torch.from_numpy(rng.standard_normal((b, c.num_dense), np.float32)),
             "sparse_ids": torch.from_numpy(rng.integers(lo, hi, ids).astype(np.int32)),
             "sparse_mask": torch.ones(ids, dtype=torch.float32),
             "label": torch.from_numpy((rng.random(b) < 0.5).astype(np.float32))}
    return params, opt, {k: v.to(dev) for k, v in batch.items()}


def trace_cell(arch: str, shape_name: str, multi_pod: bool = False, smoke: bool = False,
               mesh_shape: Optional[Tuple[int, ...]] = None):
    """(trace, bundle, flop counter total, build seconds, trace seconds) of
    one rank's step of a cell.  ``mesh_shape`` replaces the production
    mesh's shape, over its last ``len(mesh_shape)`` axes."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = cfglib.get_smoke_config(arch) if smoke else cfglib.get_config(arch)
    shape = (cfglib.SMOKE_SHAPES if smoke else cfglib.SHAPES)[shape_name]
    prod, axes = production_shape(multi_pod)
    dims = tuple(mesh_shape) if mesh_shape is not None else prod
    if len(dims) != len(axes):
        axes = axes[-len(dims):]
    t0 = time.time()
    dlrm = isinstance(cfg, DLRMConfig)
    mesh = VirtualMesh(dims, axes, device="cpu" if dlrm else "meta")
    bundle = make_step(arch, shape_name, mesh, smoke=smoke, device=mesh.device)
    if dlrm:
        args = dlrm_args(bundle, shape.global_batch)
    else:
        args = lm_args(bundle, shape)
    t_build = time.time() - t0
    with FlopCounterMode(display=False) as fc:
        tr = trace(bundle.fn, *args)
    t_trace = time.time() - t0 - t_build
    tr.result = None
    return tr, bundle, fc.get_total_flops(), t_build, t_trace


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             smoke: bool = False, mesh_shape: Optional[Tuple[int, ...]] = None) -> dict:
    shape = (cfglib.SMOKE_SHAPES if smoke else cfglib.SHAPES)[shape_name]
    cfg = cfglib.get_smoke_config(arch) if smoke else cfglib.get_config(arch)
    prod, _ = production_shape(multi_pod)
    dims = tuple(mesh_shape) if mesh_shape is not None else prod
    chips = int(np.prod(dims))
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in dims),
        "multi_pod": multi_pod,
        "chips": chips,
        "status": "running",
    }
    if smoke:
        rec["smoke"] = True
    t0 = time.time()
    try:
        tr, bundle, fc_flops, t_build, t_trace = trace_cell(arch, shape_name, multi_pod,
                                                            smoke, mesh_shape)
        cost = analyze(tr)
        model_flops = rl.model_flops_estimate(cfg, shape)
        attn_flops = rl.attention_flops_estimate(cfg, shape)
        terms = rl.RooflineTerms(
            flops=cost.flops * chips,       # the trace is one rank's step
            hbm_bytes=cost.bytes_accessed * chips,
            wire_bytes_per_device=cost.wire_bytes,
            chips=chips,
            model_flops=model_flops,
            inter_node_wire_bytes=cost.inter_node_wire_bytes,
        )
        stats = rl.parse_collectives(tr.collectives)
        rec.update(
            {
                "status": "ok",
                "device": str(bundle.mesh.device),
                "lower_s": round(t_build, 2),
                "compile_s": round(t_trace, 2),
                "memory_analysis": memory_analysis(tr),
                "flop_counter": {"flops_per_device": float(fc_flops)},
                "hlo_flops_per_device": cost.flops,
                "hlo_bytes_per_device": cost.bytes_accessed,
                "collectives": cost.collective_counts,
                "collective_result_bytes": stats.result_bytes,
                "wire_bytes_per_device": cost.wire_bytes,
                "inter_node_wire_bytes": cost.inter_node_wire_bytes,
                "unknown_trip_loops": cost.unknown_trip_loops,
                "model_flops": model_flops,
                "attention_flops": attn_flops,
                "roofline": terms.to_dict(),
                "hlo_size_chars": len(tr.ops),
                "kernel_calls": tr.kernel_calls(),
                "dot_flops_top": dict(
                    sorted(cost.dot_flops_by_meta.items(), key=lambda kv: -kv[1])[:8]
                ),
            }
        )
        if isinstance(cfg, DLRMConfig):
            rec["note"] = DLRM_NOTE
        del tr, bundle
    except Exception as e:
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    rec["wall_s"] = round(time.time() - t0, 2)
    gc.collect()
    if verbose:
        brief = {k: rec.get(k) for k in ("arch", "shape", "mesh", "status", "wall_s")}
        if rec["status"] == "ok":
            brief["bottleneck"] = rec["roofline"]["bottleneck"]
            brief["step_s"] = round(rec["roofline"]["step_time_s"], 4)
        else:
            brief["error"] = rec.get("error")
        print(json.dumps(brief), flush=True)
    return rec


def all_cells():
    for arch in cfglib.ARCH_IDS:
        for shape_name in cfglib.SHAPES:
            ok, why = cfglib.cell_supported(arch, shape_name)
            for multi_pod in (False, True):
                yield arch, shape_name, multi_pod, ok, why


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--smoke", action="store_true", help="SMOKE configs and shapes")
    ap.add_argument("--mesh", default=None,
                    help="a mesh shape over the production axes, e.g. 2x2 (default: "
                         "the production mesh)")
    args = ap.parse_args(argv)
    dims = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r["arch"], r["shape"], r["multi_pod"]))
                except json.JSONDecodeError:
                    pass

    def emit(rec):
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")

    if args.all:
        n_err = 0
        for arch, shape_name, multi_pod, ok, why in all_cells():
            key = (arch, shape_name, multi_pod)
            if key in done:
                continue
            if not ok:
                emit({"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                      "status": "skipped", "reason": why})
                continue
            rec = run_cell(arch, shape_name, multi_pod, smoke=args.smoke, mesh_shape=dims)
            emit(rec)
            n_err += rec["status"] == "error"
        return 1 if n_err else 0

    rec = run_cell(args.arch, args.shape, args.multi_pod, smoke=args.smoke, mesh_shape=dims)
    emit(rec)
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
