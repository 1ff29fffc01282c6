"""Ambient sharding context: lets model code see the (mesh, rules) pair
without threading it through every call.

A port of the reference's ``repro.distributed.context``.
``sharding_context`` and ``current_context`` are the reference's.
``constrain`` is the identity: in the reference it asks XLA to keep an
activation in a sharding, while in the port placement is explicit -- each
rank holds its own slices and the step calls its collectives itself -- so
there is nothing to constrain.  It is kept so that model code written
against the reference's API runs unchanged; no port model calls it yet.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional, Sequence, Tuple

from repro_torch.distributed.sharding import AxisRules

_CTX: contextvars.ContextVar[Optional[Tuple[Any, AxisRules]]] = contextvars.ContextVar(
    "sharding_ctx", default=None
)


@contextlib.contextmanager
def sharding_context(mesh: Any, rules: AxisRules):
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_context() -> Optional[Tuple[Any, AxisRules]]:
    return _CTX.get()


def constrain(x: Any, logical_axes: Sequence[Optional[str]]) -> Any:
    """The identity: the port places every tensor explicitly."""
    return x
