"""LM training through the port's ``Trainer`` (its dense LM path), fed by
``core.tokens.lm_batches_from_table`` reading the DWRF token corpus
through the decode engine on the run's device.

Set-up builds one ``Trainer`` with the benchmark's weights and a zero
AdamW state, and drives it through ``Trainer.fit`` on the same feed
that the window reads: first the steps the reference follows (after the
first, each leaf's first gradient norm is read from AdamW's first moment,
mu / (1 - beta1); after the last, each leaf's change from the weights of
the seed), then the warm-up steps.  The window continues ``Trainer.fit``
on that feed until it closes: the feed records each step's end when fit
asks for the next batch, after it has read the step's loss (a wait for
the device), and a ``stall`` span around reading, decoding and packing
the next batch.  Once the window has closed, the fed batches are held to
the plain packing of the raw corpus, and the reference follows the first
steps from the same weights.
"""
from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from dsibench import compare, counts, generate
from dsibench import weights as W
from dsibench.harness import BenchmarkError
from dsibench.reference import tokens as ref_tokens
from dsibench.runners import optimizer_config, program_config


class Feed:
    """The batches ``Trainer.fit`` takes, each kept for the check."""

    def __init__(self, batches):
        self.it = iter(batches)
        self.fed: List[Dict[str, np.ndarray]] = []

    def _next(self):
        try:
            b = next(self.it)
        except StopIteration:
            raise BenchmarkError("the token corpus ran out") from None
        self.fed.append(b)
        return b

    def take(self, n: int):
        for _ in range(n):
            yield self._next()

    def window(self, win, units: int, history):
        """Batches until the window closes; a step runs from the ask for
        its batch to the ask for the next one."""
        while True:
            start = win.clock()
            with win.span("stall"):
                b = self._next()
            with win.span("step"):
                yield b
            win.step(start, win.clock(), units, history[-1].loss)
            if not win.due():
                return


class Session:
    units = "tokens"

    def __init__(self, config, traffic, seed, device, log):
        from repro_torch.core import tokens as T
        from repro_torch.core.decode import TorchDecodeEngine
        from repro_torch.optim import adamw_init
        from repro_torch.train import Trainer, TrainerConfig

        self.model, self.opt = config["model"], config["optimizer"]
        self.seed, self.device, self.log = seed, device, log
        self.rows, self.seq = traffic["rows"], traffic["seq"]
        self.n_check = traffic["check_steps"]
        self.table, self.docs = generate.token_table(traffic, self.model["vocab_size"], seed)
        opt_cfg = optimizer_config(config)
        self.trainer = Trainer(program_config(config), opt_cfg, TrainerConfig(max_steps=1 << 62),
                               device=device)
        dtype = getattr(torch, self.model["param_dtype"])
        w = W.lm_weights(self.model, seed, device, dtype)
        self.state = self.trainer.load_state({"params": w, "opt": adamw_init(w, opt_cfg),
                                              "step": 0})
        del w
        self.feed = Feed(T.lm_batches_from_table(self.table, self.seq, self.rows,
                                                 decode_engine=TorchDecodeEngine(device)))
        self._fit(self.feed.take(1))
        b1 = self.opt["beta1"]
        self.grad = {k: float(torch.linalg.vector_norm(mu)) / (1 - b1)
                     for k, mu in self.state["opt"]["mu"].items()}
        self._fit(self.feed.take(self.n_check - 1))
        self.losses = [m.loss for m in self.trainer.history[:self.n_check]]
        start = W.lm_weights(self.model, seed, device, dtype)
        self.change = {k: float(torch.linalg.vector_norm(p.float() - start[k].float()))
                       for k, p in self.state["params"].items()}
        del start
        self._fit(self.feed.take(traffic["warmup_steps"]))
        self.step_flops = counts.lm_step_flops(self.model, self.rows, self.seq)
        self.step_counts: Dict[str, List[float]] = {"flops": []}
        log(f"[lm_train] {sum(p.numel() for p in self.trainer.model.parameters())} parameters; "
            f"{self.n_check} checked and {traffic['warmup_steps']} warm-up steps of "
            f"{self.rows} x {self.seq} tokens; losses {self.losses}")

    def _fit(self, batches) -> None:
        """``Trainer.fit`` over ``batches`` from the state the session
        holds, handed over whole: the dict passed in is emptied once fit has
        taken its own copy (at its first batch), so no second generation of
        the AdamW moments outlives the step that replaces it."""
        state, self.state = self.state, None

        def handed():
            state.clear()
            yield from batches

        self.state = self.trainer.fit(handed(), state)

    def run_window(self, win) -> None:
        self._fit(self.feed.window(win, self.rows * self.seq, self.trainer.history))
        self.step_counts["flops"] = [self.step_flops] * len(win.steps)

    def close_program(self) -> None:
        del self.trainer, self.state
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, reference) -> Dict[str, float]:
        want = ref_tokens.batches(self.docs, self.seq, self.rows)
        bad = 0
        for i, b in enumerate(self.feed.fed):
            if i >= len(want) or b["tokens"].shape != want[i][0].shape:
                bad += self.rows
                continue
            bad += int(np.sum(np.any(b["tokens"] != want[i][0], axis=1)
                              | np.any(b["labels"] != want[i][1], axis=1)))
        ref = reference.run(self.model, self.opt, self.seed, want[:self.n_check], self.device)
        grad, grad_leaf = compare.worst_leaf(self.grad, ref["grad"])
        keep = compare.moved(ref["change"], ref["grad"])
        change, change_leaf = compare.worst_leaf(self.change, ref["change"], keep)
        gaps = compare.loss_gaps(self.losses, ref["losses"])
        mid = compare.median_leaf(self.change, ref["change"], keep)
        self.log(f"[lm_train] losses {self.losses} against the reference's {ref['losses']}; "
                 f"worst grad leaf {grad_leaf}, worst change leaf {change_leaf} (of "
                 f"{len(keep)} of {len(ref['change'])} leaves moved; the median leaf's change "
                 f"gap {mid:.3e}); step loss gaps {gaps}; {len(self.feed.fed)} "
                 f"batches fed, {bad} rows unlike the plain packing")
        return {"batches": bad, "loss": max(gaps), "grad": grad, "change": change}


def setup(config, traffic, seed, device, log) -> Session:
    return Session(config, traffic, seed, device, log)
