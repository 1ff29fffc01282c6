"""Span-hygiene rule (REPRO-S001).

A tracer span that is opened but never closed poisons the whole trace
artifact: ``otherData.open_spans`` goes non-zero, the report's ``--check``
gate fails, and the span's duration silently vanishes from the Table-7
attribution.  Manually-paired ``__enter__``/``__exit__`` (or a handle
stashed in a variable and closed "later") leaks exactly this way on any
exception path.

  * **S001** — in ``src/repro_torch/core/**``, ``<tracer>.span(...)`` may only
    appear as a ``with``-statement context expression, where the span is
    closed on every exit path by construction.  The atomic APIs
    (``record`` / ``instant``) are exempt — they never hold a span open.

A call is recognized as a span-open when the receiver chain contains a
``tracer``-named part (``self.tracer.span(...)``, ``tracer.span(...)``),
so unrelated ``.span`` methods on other objects are not captured.
"""
from __future__ import annotations

import ast
from typing import List, Set, Tuple

from repro_torch.analysis.core import (
    CheckContext,
    Finding,
    attr_chain,
    checker,
    enclosing_symbol,
    rule,
)

S001 = rule("REPRO-S001",
            "tracer span in core/ opened outside a `with` block")

_SCOPE = "src/repro_torch/core/"


def _is_span_open(node: ast.AST) -> bool:
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "span"):
        return False
    chain = attr_chain(node.func.value) or []
    return any("tracer" in part.lower() for part in chain)


class _Scan(ast.NodeVisitor):
    """Collect span-open calls that are not ``with``-item contexts."""

    def __init__(self) -> None:
        self.stack: List[ast.AST] = []
        self._with_ctx: Set[int] = set()
        self.bad: List[Tuple[int, str]] = []     # (line, symbol)

    def _push(self, node: ast.AST) -> None:
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = _push

    def _visit_with(self, node) -> None:
        # mark the context expressions BEFORE descending into them, so
        # the Call visit below sees them as sanctioned
        for item in node.items:
            if _is_span_open(item.context_expr):
                self._with_ctx.add(id(item.context_expr))
        self.generic_visit(node)

    visit_With = visit_AsyncWith = _visit_with

    def visit_Call(self, node: ast.Call) -> None:
        if _is_span_open(node) and id(node) not in self._with_ctx:
            self.bad.append((node.lineno, enclosing_symbol(self.stack)))
        self.generic_visit(node)


@checker("span-hygiene")
def check_spans(ctx: CheckContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.src_modules():
        if not mod.rel.startswith(_SCOPE):
            continue
        scan = _Scan()
        scan.visit(mod.tree)
        for line, sym in scan.bad:
            findings.append(Finding(
                S001, mod.rel, line,
                "tracer span opened outside a `with` block — core spans "
                "must close via context manager on every exit path (use "
                "record()/instant() for atomic events)",
                sym,
            ))
    return findings
