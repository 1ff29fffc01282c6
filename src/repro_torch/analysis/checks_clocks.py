"""Clock-injection rule (REPRO-C001).

The TTL, lease, and heartbeat logic in ``core/cache`` and ``core/dpp`` is
deterministic under test ONLY because absolute time is read through an
injected ``clock=`` callable (``StripeCache(ttl_s=..., clock=fake)``,
``DPPMaster(clock=fake)``).  A direct ``time.time()`` /
``time.monotonic()`` call in those packages silently re-couples the logic
to the wall clock and turns every TTL/lease test flaky.

Banned: *calls* to ``time.time`` / ``time.monotonic`` anywhere under
``src/repro_torch/core/cache/`` and ``src/repro_torch/core/dpp/``.

Allowed:

  * referencing ``time.time``/``time.monotonic`` without calling it —
    that is exactly how the injected default is declared
    (``clock: Callable[[], float] = time.monotonic``);
  * ``time.sleep`` (waiting is not reading the clock);
  * ``time.perf_counter`` (duration measurement for metrics, never used
    in control-flow deadlines that tests need to fake).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.core import (
    CheckContext,
    Finding,
    attr_chain,
    checker,
    enclosing_symbol,
    rule,
)

C001 = rule("REPRO-C001",
            "direct time.time()/time.monotonic() call in a clock-injected "
            "package (core/cache, core/dpp)")

_SCOPES = ("src/repro_torch/core/cache/", "src/repro_torch/core/dpp/")
_BANNED = {("time", "time"), ("time", "monotonic")}


class _Scan(ast.NodeVisitor):
    def __init__(self):
        self.stack: List[ast.AST] = []
        self.hits: List[tuple] = []   # (line, dotted-name, symbol)

    def _push(self, node):
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = _push

    def visit_Call(self, node: ast.Call) -> None:
        chain = attr_chain(node.func)
        if chain and tuple(chain) in _BANNED:
            self.hits.append(
                (node.lineno, ".".join(chain), enclosing_symbol(self.stack))
            )
        self.generic_visit(node)


@checker("clock-injection")
def check_clocks(ctx: CheckContext):
    findings: List[Finding] = []
    for mod in ctx.src_modules():
        if not mod.rel.startswith(_SCOPES):
            continue
        scan = _Scan()
        scan.visit(mod.tree)
        for line, name, sym in scan.hits:
            findings.append(Finding(
                C001, mod.rel, line,
                f"calls {name}() directly; inject a `clock=` callable "
                "(reference the time function only as the default value)",
                sym,
            ))
    return findings
