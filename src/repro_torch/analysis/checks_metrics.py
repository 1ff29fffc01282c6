"""Metrics-contract rules (REPRO-M001/M002).

The port's benchmarks (``benchmarks/torch/*.py``) read
``WorkerMetrics``/``TierStats``/``CacheStats``/... fields by attribute.
A renamed or deleted field turns a Table-9-style benchmark into an
``AttributeError`` at best and a silently-wrong derived metric at worst.

  * **M001** — every metric attribute a benchmark reads must exist on one
    of the metric dataclasses (fields, ``@property``s, and methods all
    count).  Receivers are recognized two ways: chained access through a
    ``.metrics`` / ``.stats`` attribute (``sess.prefetcher.metrics.fills``),
    and locals assigned from a metrics getter
    (``m = sess.worker_metrics()``; ``stats = engine.stats``) — tracking
    is dropped on reassignment, so ``m = table.partitions[p]`` is never
    misread as a metrics object.
  * **M002** — metric counters are monotonic: ``x.hits -= 1`` (or
    ``x.hits = x.hits - k``) anywhere in ``src/repro_torch`` is a finding.
    Capacity gauges legitimately shrink and are exempt: ``bytes_stored``
    (eviction) and ``buffered_batches`` (drain).

The metric vocabulary is *discovered*, not hand-listed: any class in the
src tree declaring at least one ``counter()`` / ``gauge()`` field
(:mod:`repro_torch.obs.meta`) is a metric class; its declared counters feed
M002 and its full surface (fields + properties + methods) feeds M001.
Which fields may shrink comes from the same declarations — a field is
exempt from M002 iff some metric class declares it ``gauge()``.  If
discovery finds nothing repo-wide the checker reports that as drift
instead of silently checking nothing.
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

M001 = rule("REPRO-M001",
            "benchmark reads a metric attribute that no metric class "
            "defines")
M002 = rule("REPRO-M002",
            "metric counter decremented (counters are monotonic; only "
            "gauges may shrink)")

_GETTER_CALLS = {"worker_metrics", "fleet_metrics"}
_METRIC_ATTRS = {"metrics", "stats"}
_DECL_FNS = ("counter", "gauge")


def _decl_kind(stmt: ast.stmt) -> Tuple[str, str]:
    """("counter"|"gauge", field) for ``f: T = counter(...)``-style
    declarations (bare or module-qualified), else ("", "")."""
    if not (isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)
            and isinstance(stmt.value, ast.Call)):
        return "", ""
    fn = stmt.value.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else ""
    )
    return (name, stmt.target.id) if name in _DECL_FNS else ("", "")


def _class_vocab(cls: ast.ClassDef) -> Set[str]:
    names: Set[str] = set()
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
    return names


def discover_metric_classes(ctx: CheckContext):
    """Every class in the src tree declaring at least one ``counter()``
    or ``gauge()`` field, as ``(rel, ClassDef, counters, gauges)``."""
    out = []
    for mod in ctx.src_modules():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            counters: Set[str] = set()
            gauges: Set[str] = set()
            for stmt in node.body:
                kind, field = _decl_kind(stmt)
                if kind == "counter":
                    counters.add(field)
                elif kind == "gauge":
                    gauges.add(field)
            if counters or gauges:
                out.append((mod.rel, node, counters, gauges))
    return out


def _load_vocab(ctx: CheckContext) -> Tuple[Set[str], Set[str], List[Finding]]:
    """(full vocabulary, counter fields, drift findings)."""
    vocab: Set[str] = set(_METRIC_ATTRS)   # x.metrics.stats... chains
    counters: Set[str] = set()
    gauges: Set[str] = set()
    drift: List[Finding] = []
    discovered = discover_metric_classes(ctx)
    if not discovered:
        drift.append(Finding(
            M001, "src/repro_torch/obs/meta.py", 1,
            "no metric class discovered repo-wide — counter()/gauge() "
            "field declarations have vanished, so M001/M002 would check "
            "nothing",
        ))
    for _rel, cls, cs, gs in discovered:
        vocab |= _class_vocab(cls)
        counters |= cs
        gauges |= gs
    # name-level exemption: a field gauge() *anywhere* may shrink (the
    # M002 scan sees attribute names, not receiver types)
    return vocab, counters - gauges, drift


class _BenchScan(ast.NodeVisitor):
    """Per-function tracking of metrics-typed locals + attribute reads."""

    def __init__(self, vocab: Set[str]):
        self.vocab = vocab
        self.tracked: Set[str] = set()
        self.stack: List[ast.AST] = []
        self.bad: List[Tuple[int, str, str]] = []   # (line, attr, symbol)

    def _push(self, node):
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = _push

    def _is_metrics_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            return node.func.attr in _GETTER_CALLS
        if isinstance(node, ast.Attribute):
            return node.attr in _METRIC_ATTRS
        if isinstance(node, ast.Name):
            return node.id in self.tracked
        return False

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        metric = self._is_metrics_expr(node.value)
        for t in node.targets:
            if isinstance(t, ast.Name):
                if metric:
                    self.tracked.add(t.id)
                else:
                    self.tracked.discard(t.id)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        recv = node.value
        is_metric_recv = (
            (isinstance(recv, ast.Name) and recv.id in self.tracked)
            or (isinstance(recv, ast.Attribute) and recv.attr in _METRIC_ATTRS)
        )
        if is_metric_recv and node.attr not in self.vocab:
            self.bad.append(
                (node.lineno, node.attr, enclosing_symbol(self.stack))
            )
        self.generic_visit(node)


@checker("metrics-contract")
def check_metrics(ctx: CheckContext):
    vocab, counters, findings = _load_vocab(ctx)
    for mod in ctx.glob_modules("benchmarks/torch/*.py"):
        scan = _BenchScan(vocab)
        scan.visit(mod.tree)
        for line, attr, sym in scan.bad:
            findings.append(Finding(
                M001, mod.rel, line,
                f"reads .{attr} on a metrics object but no metric class "
                "defines it — renamed field or stale benchmark",
                sym,
            ))
    for mod in ctx.src_modules():
        for node in ast.walk(mod.tree):
            target = None
            if isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Sub):
                target = node.target
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.value, ast.BinOp) \
                    and isinstance(node.value.op, ast.Sub):
                t, lhs = node.targets[0], node.value.left
                if isinstance(t, ast.Attribute) and isinstance(lhs, ast.Attribute) \
                        and t.attr == lhs.attr \
                        and attr_chain(t) == attr_chain(lhs):
                    target = t
            if isinstance(target, ast.Attribute) and target.attr in counters:
                findings.append(Finding(
                    M002, mod.rel, node.lineno,
                    f"decrements counter .{target.attr} — metric counters "
                    "are monotonic (use a gauge field if occupancy is "
                    "intended)",
                ))
    return findings
