"""Readings for the limits of ``correct``: the program's numbers over many
seeds, and the control's.

    python3 -m dsibench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 2]

For each of ``--seeds`` it runs the cell once in this process with a
short window and prints the numbers compared; for each of
``--control-seeds`` it runs the control, the plain reference in the
nearest precision below the configuration's (float32 -> TF32, bf16 ->
fp8 e4m3), in the program's place at the cell's size, and prints its
numbers against the float32 reference's; for each of ``--fault-seeds``
and ``--unchanged-seeds`` the same of the faults "half of the batch left
out" and "a step that returns its state unchanged".  The benchmark's own runs never
run the control.  Each reading is a JSON line on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parents[1]
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def control_numbers(cell: str, seed: int, device: str,
                    overrides: Dict[str, Any] = None, fault: str = "control"
                    ) -> Dict[str, float]:
    """The control's numbers in ``cell``: the reference in the precision
    below the configuration's against the float32 reference, on the same
    batches from the same weights.  ``fault="half"`` reads instead the
    fault of half the batch left out (the reference in the program's
    place, its steps' mean loss taken over the first half of each batch's
    rows); ``fault="unchanged"`` the fault of a step that returns its state
    unchanged (the reference's updates skipped: its parameters and
    moments stay as they were)."""
    from dsibench import compare, generate, harness
    from dsibench.reference import dpp_transform
    from dsibench.reference import tokens as ref_tokens
    from dsibench.reference.adamw import AdamW

    overrides = overrides or {}
    man = harness.manifest(ROOT)
    w = harness.workload(man, cell)
    config = harness.merged(harness.load_json("configs", w["config"]), overrides.get("config"))
    traffic = harness.merged(harness.load_json("traffic", w["traffic"]),
                             overrides.get("traffic"))
    model, opt = config["model"], config["optimizer"]
    reference = harness.load_module("reference", config["reference"])
    n = traffic["check_steps"]
    if config["runner"] == "lm_train":
        docs = generate.token_docs(traffic, model["vocab_size"], seed)
        batches = ref_tokens.batches(docs, traffic["seq"], traffic["rows"])[:n]
        leaf_of = lambda k: k  # noqa: E731
    else:
        _, plan, raws, dense_keys, sparse_keys = generate.dlrm_raws(model, traffic, seed)
        batches = sorted((dpp_transform.transform(r, plan, dense_keys, sparse_keys,
                                                  model["max_ids_per_feature"]) for r in raws),
                         key=lambda b: b["label"].tobytes())[:n]
        leaf_of = lambda k: k.replace("acc.", "tables.", 1)  # noqa: E731
    if fault == "half":
        low = reference.run(model, opt, seed, [_half(b) for b in batches], device)
    elif fault == "unchanged":
        step = AdamW.step
        AdamW.step = lambda self, params, grads, store=None: {k: g * 0 for k, g in grads.items()}
        try:
            low = reference.run(model, opt, seed, batches, device)
        finally:
            AdamW.step = step
    else:
        low = reference.run(model, opt, seed, batches, device,
                            precision=CONTROL[model["param_dtype"]])
    ref = reference.run(model, opt, seed, batches, device)
    keep = compare.moved(ref["change"], ref["grad"], leaf_of)
    gaps = compare.loss_gaps(low["losses"], ref["losses"])
    out = {"loss": max(gaps),
           "grad": compare.worst_leaf(low["grad"], ref["grad"])[0],
           "change": compare.worst_leaf(low["change"], ref["change"], keep)[0],
           "grad_median_leaf": compare.median_leaf(low["grad"], ref["grad"], ref["grad"]),
           "change_median_leaf": compare.median_leaf(low["change"], ref["change"], keep),
           "batches": 0}
    if config["runner"] != "lm_train":
        out["dense"] = 0.0
    return out


def _half(batch):
    """The first half of a batch's rows."""
    if isinstance(batch, dict):
        return {k: v[:len(v) // 2] for k, v in batch.items()}
    return tuple(v[:len(v) // 2] for v in batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--unchanged-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from dsibench import harness

    if not torch.cuda.is_available():
        print("dsibench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    quiet = lambda s: None  # noqa: E731
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        result, checks = harness.run_cell(args.workload, seed, args.seconds, False,
                                          t_start=t, log=quiet)
        print(json.dumps({"kind": "program", "seed": seed, "correct": result["correct"],
                          "numbers": {k: v for k, v, _ in checks},
                          "s": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    for kind, seeds in (("control", args.control_seeds), ("half", args.fault_seeds),
                        ("unchanged", args.unchanged_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t = time.perf_counter()
            numbers = control_numbers(args.workload, seed, "cuda", fault=kind)
            print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                              "s": time.perf_counter() - t}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
