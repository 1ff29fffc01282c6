"""Continuous-batching LM server: slot-managed prefill + decode.

A port of the reference's ``repro.serving.server``.  A fixed pool of B
cache slots; an arriving request is prefilled into a free slot by
replaying its prompt token by token through ``decode_step``, and every
engine tick decodes one token for all active slots.  Positions are kept
per slot on the host.

The slot logic is the reference's, its fault included: ``decode_step``
writes the K/V of every batch row at ``pos``, so replaying one slot's
prompt (the other rows carry token 0) overwrites the cached rows of the
other slots at those positions, and admitting a second request changes
the first one's output.  For an SSM (``SSMLM``) it is worse: every
decode step advances the recurrent state of every row, so replaying one
slot's prompt feeds token 0 into every other slot's state.  The port gives
the reference's tokens, so it keeps that behaviour.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    # filled by the server:
    output: List[int] = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None


@dataclasses.dataclass
class ServerConfig:
    slots: int = 4
    cache_len: int = 256
    eos_id: int = -1                    # -1: never stop early


class BatchingServer:
    def __init__(self, model_cfg: Any, cfg: ServerConfig, seed: int = 0, *,
                 device: Union[str, torch.device] = "cuda",
                 params: Optional[Dict[str, torch.Tensor]] = None):
        """``params``: a state dict to load (for example the reference's
        weights through ``repro_torch.convert.lm_params_from_numpy``);
        without it the weights are drawn from ``seed``."""
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = resolve(device, "BatchingServer")
        self.model = build_model(model_cfg, device=self.device)
        if params is None:
            self.model.init(seed)
        else:
            self.model.load_state_dict(params)
        self.cache = self.model.init_cache(cfg.slots, cfg.cache_len)
        self._active: Dict[int, Request] = {}      # slot -> request
        self._pos = np.zeros(cfg.slots, np.int32)  # next write position per slot
        self._queue: List[Request] = []
        self._next_token = np.zeros((cfg.slots, 1), np.int32)

    # -- API -------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.submitted_s = time.perf_counter()
        self._queue.append(req)

    def run(self, max_ticks: int = 1000) -> List[Request]:
        """Drive the engine until queue + slots drain; returns finished."""
        finished: List[Request] = []
        for _ in range(max_ticks):
            self._admit(finished)
            if not self._active:
                if not self._queue:
                    break
                continue
            self._tick(finished)
        return finished

    # -- internals -------------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.cfg.slots) if s not in self._active]

    def _admit(self, finished: List[Request]) -> None:
        """Prefill queued requests into free slots by token-by-token replay
        through the decode step; the last replay step's argmax is the first
        generated token and is emitted here."""
        for slot in self._free_slots():
            if not self._queue:
                return
            req = self._queue.pop(0)
            self._active[slot] = req
            self._pos[slot] = 0
            for tok in req.prompt:
                self._write_token(slot, int(tok))
            self._emit(slot, int(self._next_token[slot, 0]), finished)

    def _decode(self, tokens: np.ndarray, pos: int) -> torch.Tensor:
        batch = {"token": torch.from_numpy(tokens).to(self.device), "pos": pos,
                 "cache": self.cache}
        logits, self.cache = self.model.decode_step(batch)
        return logits

    def _write_token(self, slot: int, token: int) -> None:
        """Advance one position of one slot through the decode step (the
        other rows carry token 0 and are written at the same position)."""
        tok_vec = np.zeros((self.cfg.slots, 1), np.int32)
        tok_vec[slot, 0] = token
        logits = self._decode(tok_vec, int(self._pos[slot]))
        self._pos[slot] += 1
        self._next_token[slot, 0] = int(torch.argmax(logits[slot, 0]))

    def _tick(self, finished: List[Request]) -> None:
        """One decode step for every active slot: one batched call when
        their positions agree, else one call per slot."""
        positions = {self._pos[s] for s in self._active}
        if len(positions) == 1:
            logits = self._decode(self._next_token, int(positions.pop()))
            toks = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()
            for s in list(self._active):
                self._pos[s] += 1
                self._emit(s, int(toks[s]), finished)
            self._next_token = toks[:, None]
        else:
            for s in list(self._active):
                self._write_token(s, int(self._next_token[s, 0]))
                self._emit(s, int(self._next_token[s, 0]), finished)

    def _emit(self, slot: int, token: int, finished: List[Request]) -> None:
        req = self._active[slot]
        if req.first_token_s is None:
            req.first_token_s = time.perf_counter()
        req.output.append(token)
        done = (
            len(req.output) >= req.max_new_tokens
            or token == self.cfg.eos_id
            or self._pos[slot] >= self.cfg.cache_len - 1
        )
        if done:
            req.done_s = time.perf_counter()
            finished.append(req)
            del self._active[slot]

    # -- metrics ---------------------------------------------------------------

    @staticmethod
    def latency_report(reqs: List[Request]) -> Dict[str, float]:
        ttft = [r.first_token_s - r.submitted_s for r in reqs if r.first_token_s]
        e2e = [r.done_s - r.submitted_s for r in reqs if r.done_s]
        toks = sum(len(r.output) for r in reqs)
        wall = max((r.done_s or 0) for r in reqs) - min(r.submitted_s for r in reqs)
        return {
            "requests": len(reqs),
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "e2e_p50_s": float(np.percentile(e2e, 50)) if e2e else 0.0,
            "decode_tok_per_s": toks / wall if wall > 0 else 0.0,
        }
