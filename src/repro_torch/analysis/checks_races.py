"""Shared-state publication rules backing the runtime race sanitizer.

``repro_torch.analysis.racedep`` (the Eraser-style lockset detector) exempts
attributes a class declares in a class-level ``_unshared`` tuple —
deliberately lock-free fields (GIL-atomic monotone flags, single-writer
telemetry).  That escape hatch only stays honest if it cannot drift:

  * **REPRO-R001** — on a race-instrumented class (the
    ``racedep.INSTRUMENTED_CLASSES`` set), a field assigned outside
    ``__init__`` without the lock held must be declared in
    ``_unshared``.  Every lock-free write is therefore either visible
    to the runtime detector or explicitly allowlisted where a reader sees it —
    never silently both unlocked and untracked.
  * **REPRO-R002** — no double-checked locking: an attribute
    *published* under a class's lock (assigned inside ``with
    self._lock``) may not be *tested* without it (``if self.cache is
    None:`` at lock depth 0).  The check-then-act window between the
    unguarded test and the action is exactly the atomicity bug the
    interleaving explorer (``repro_torch.analysis.sched``) exists to catch —
    snapshot the attribute into a local inside the lock instead.

Both rules are deliberately narrower than REPRO-L001: they look only at
*direct* ``self.<attr>`` rebinds/tests (what ``racedep`` observes at
attribute granularity), but they apply to private methods and to
lock-less classes too — ``PrefetchPlanner``/``ElasticController`` hold
no lock by design, so every cross-thread field they write must be in
``_unshared`` where the detector and a reader can see it.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.checks_locks import _declared_locks, _is_lock_expr
from repro_torch.analysis.core import CheckContext, Finding, checker, rule
from repro_torch.analysis.racedep import INSTRUMENTED_CLASSES

R001 = rule("REPRO-R001",
            "field on a race-instrumented class assigned outside __init__ "
            "without the lock and not declared in `_unshared`")
R002 = rule("REPRO-R002",
            "double-checked locking: attribute published under the lock "
            "is tested without it")

_LOCK_ATTR_RE = re.compile(r"^_\w*lock$")


def _unshared_decl(cls: ast.ClassDef) -> Set[str]:
    """Names in the class-level ``_unshared = ("a", "b")`` declaration."""
    names: Set[str] = set()
    for node in cls.body:
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == "_unshared"
                   for t in targets):
            continue
        if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
            for el in value.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    names.add(el.value)
    return names


class _AccessScan(ast.NodeVisitor):
    """Direct ``self.<attr>`` rebinds and condition tests, by lock depth."""

    def __init__(self, locks: Set[str], assume_locked: bool):
        self.locks = locks
        self.depth = 1 if assume_locked else 0   # _locked helper contract
        self.unlocked_writes: List[Tuple[int, str]] = []
        self.locked_writes: Set[str] = set()
        self.unlocked_tests: List[Tuple[int, str]] = []

    def visit_With(self, node: ast.With) -> None:
        is_lock = any(_is_lock_expr(i.context_expr, self.locks)
                      for i in node.items)
        if is_lock:
            self.depth += 1
        self.generic_visit(node)
        if is_lock:
            self.depth -= 1

    def _write(self, target: ast.AST, line: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._write(el, line)
            return
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            if self.depth == 0:
                self.unlocked_writes.append((line, target.attr))
            else:
                self.locked_writes.add(target.attr)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._write(t, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._write(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._write(node.target, node.lineno)
        self.generic_visit(node)

    def _test(self, expr: ast.AST, line: int) -> None:
        if self.depth > 0:
            return
        for node in ast.walk(expr):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"):
                self.unlocked_tests.append((line, node.attr))
            # `self.cache.dedup` chains: the *root* attr is the tested one
            elif (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Attribute)
                    and isinstance(node.value.value, ast.Name)
                    and node.value.value.id == "self"):
                self.unlocked_tests.append((line, node.value.attr))

    def visit_If(self, node: ast.If) -> None:
        self._test(node.test, node.lineno)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._test(node.test, node.lineno)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._test(node.test, node.lineno)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._test(node.test, node.lineno)
        self.generic_visit(node)


def _scan_class(cls: ast.ClassDef, locks: Set[str]
                ) -> Dict[str, _AccessScan]:
    scans: Dict[str, _AccessScan] = {}
    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name.startswith("__"):
            continue   # __init__ & friends: pre-publication
        scan = _AccessScan(locks, assume_locked=fn.name.endswith("_locked"))
        for stmt in fn.body:
            scan.visit(stmt)
        scans[fn.name] = scan
    return scans


@checker("race-publication")
def check_races(ctx: CheckContext):
    findings: List[Finding] = []
    instrumented = INSTRUMENTED_CLASSES
    for mod in ctx.src_modules():
        race_classes = instrumented.get(mod.rel, ())
        for cls in [n for n in ast.walk(mod.tree)
                    if isinstance(n, ast.ClassDef)]:
            locks = _declared_locks(cls)
            is_instrumented = cls.name in race_classes
            if not locks and not is_instrumented:
                continue
            scans = _scan_class(cls, locks)

            if is_instrumented:
                unshared = _unshared_decl(cls)
                lockdesc = ("/".join(f"self.{l}" for l in sorted(locks))
                            or "a lock")
                for fname, scan in scans.items():
                    for line, attr in scan.unlocked_writes:
                        if attr in unshared or _LOCK_ATTR_RE.match(attr):
                            continue
                        findings.append(Finding(
                            R001, mod.rel, line,
                            f"assigns self.{attr} outside __init__ without "
                            f"{lockdesc}; guard it or declare it in "
                            f"{cls.name}._unshared (racedep then skips it)",
                            f"{cls.name}.{fname}",
                        ))

            if locks:
                published: Set[str] = set()
                for scan in scans.values():
                    published |= scan.locked_writes
                published -= {a for a in published if _LOCK_ATTR_RE.match(a)}
                seen: Set[Tuple[str, int, str]] = set()
                for fname, scan in scans.items():
                    for line, attr in scan.unlocked_tests:
                        if attr in published and (fname, line, attr) not in seen:
                            seen.add((fname, line, attr))
                            findings.append(Finding(
                                R002, mod.rel, line,
                                f"tests self.{attr} without the lock that "
                                "publishes it (double-checked locking); "
                                "snapshot it into a local inside the lock",
                                f"{cls.name}.{fname}",
                            ))
    return findings
