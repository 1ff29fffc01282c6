"""Lock-discipline rules (the StripeCache/TectonicFS/DPPMaster convention).

Classes that guard shared state declare a lock attribute in ``__init__``
(``self._lock = threading.Lock()`` — any ``_*lock`` name, ``Lock`` or
``RLock``).  The repo convention, enforced here:

  * public methods mutate ``self.*`` state only inside a
    ``with self._lock:`` block (REPRO-L001);
  * helpers that *assume* the lock is held carry a ``_locked`` suffix,
    never acquire the lock themselves, and are only called from inside a
    lock region or from other ``_locked`` helpers (REPRO-L002);
  * a private helper that mutates shared state without acquiring the lock
    must carry the ``_locked`` suffix so call sites know the contract
    (REPRO-L003; helpers only ever called from ``__init__`` are exempt —
    pre-publication state is not yet shared).

Mutation means: assignment / augmented assignment / deletion whose target
is rooted at ``self.<attr>`` (subscripts included, so
``self._dram[k] = e`` counts), or a call to a known mutating method
(``append``/``pop``/``update``/``record``/...) on a ``self``-rooted
receiver.  Locals and parameters are never flagged — cross-object aliasing
is out of scope for a repo-native linter.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import CheckContext, Finding, attr_chain, checker, rule

L001 = rule("REPRO-L001",
            "public method of a lock-declaring class mutates shared state "
            "outside `with self._lock`")
L002 = rule("REPRO-L002",
            "`_locked` helper called outside a lock region, or itself "
            "acquires the lock")
L003 = rule("REPRO-L003",
            "private helper mutates shared state without the lock and "
            "lacks the `_locked` suffix")

_LOCK_ATTR_RE = re.compile(r"^_\w*lock$")

_MUTATORS = {
    "append", "add", "pop", "remove", "clear", "update", "insert",
    "extend", "discard", "setdefault", "popitem", "move_to_end",
    "record", "record_job", "merge",
}


def _self_root(node: ast.AST) -> Optional[str]:
    """First attribute above a ``self`` root, descending through attribute
    and subscript chains: ``self._dram[k].expires`` -> ``_dram``."""
    attrs: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            attrs.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            break
    if isinstance(node, ast.Name) and node.id == "self" and attrs:
        return attrs[-1]
    return None


def _declared_locks(cls: ast.ClassDef) -> Set[str]:
    """Lock attributes assigned from ``threading.Lock()``/``RLock()``."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Call)):
            continue
        chain = attr_chain(node.value.func)
        if not chain or chain[-1] not in ("Lock", "RLock"):
            continue
        for t in node.targets:
            root = _self_root(t)
            if root and _LOCK_ATTR_RE.match(root):
                locks.add(root)
    return locks


def _is_lock_expr(expr: ast.AST, locks: Set[str]) -> bool:
    """``with <anything>.<lockname>:`` opens a lock region — the receiver
    may be ``self``, a local alias, or another instance (``m._lock`` in a
    classmethod)."""
    chain = attr_chain(expr)
    return bool(chain) and len(chain) >= 2 and chain[-1] in locks


class _MethodScan(ast.NodeVisitor):
    """One pass over a method body tracking lock depth."""

    def __init__(self, locks: Set[str]):
        self.locks = locks
        self.depth = 0
        # (line, root_attr) of self-rooted mutations at depth 0
        self.unlocked_mutations: List[Tuple[int, str]] = []
        # (line, helper_name, depth>0) for calls to *_locked helpers
        self.locked_calls: List[Tuple[int, str, bool]] = []
        # lines where `with self._lock` appears (for the L002 self-acquire check)
        self.acquires: List[int] = []

    def visit_With(self, node: ast.With) -> None:
        is_lock = any(_is_lock_expr(i.context_expr, self.locks)
                      for i in node.items)
        if is_lock:
            self.acquires.append(node.lineno)
            self.depth += 1
        self.generic_visit(node)
        if is_lock:
            self.depth -= 1

    def _mutation(self, target: ast.AST, line: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._mutation(el, line)
            return
        root = _self_root(target)
        if root and root not in self.locks and self.depth == 0:
            self.unlocked_mutations.append((line, root))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._mutation(t, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._mutation(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._mutation(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._mutation(t, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute):
            name = node.func.attr
            if name in _MUTATORS:
                root = _self_root(node.func.value)
                if root and self.depth == 0:
                    self.unlocked_mutations.append((node.lineno, root))
            if name.endswith("_locked"):
                self.locked_calls.append((node.lineno, name, self.depth > 0))
        self.generic_visit(node)


def _call_sites(cls: ast.ClassDef, method: str) -> List[str]:
    """Names of methods within ``cls`` that call ``<recv>.<method>(...)``."""
    sites: List[str] = []
    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == method):
                sites.append(fn.name)
    return sites


@checker("lock-discipline")
def check_locks(ctx: CheckContext):
    findings: List[Finding] = []
    for mod in ctx.src_modules():
        for cls in [n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)]:
            locks = _declared_locks(cls)
            if not locks:
                continue
            lockdesc = "/".join(f"self.{l}" for l in sorted(locks))
            for fn in cls.body:
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if fn.name.startswith("__"):
                    continue   # __init__ et al: pre-publication state
                scan = _MethodScan(locks)
                for stmt in fn.body:
                    scan.visit(stmt)
                sym = f"{cls.name}.{fn.name}"
                public = not fn.name.startswith("_")
                is_locked_helper = fn.name.endswith("_locked")
                if public:
                    for line, root in scan.unlocked_mutations:
                        findings.append(Finding(
                            L001, mod.rel, line,
                            f"mutates self.{root} outside `with {lockdesc}`",
                            sym,
                        ))
                elif not is_locked_helper and scan.unlocked_mutations:
                    sites = _call_sites(cls, fn.name)
                    if not sites or any(s != "__init__" for s in sites):
                        line, root = scan.unlocked_mutations[0]
                        findings.append(Finding(
                            L003, mod.rel, line,
                            f"mutates self.{root} without {lockdesc}; "
                            "rename with a `_locked` suffix (callers must "
                            "hold the lock) or acquire the lock",
                            sym,
                        ))
                if is_locked_helper and scan.acquires:
                    findings.append(Finding(
                        L002, mod.rel, scan.acquires[0],
                        f"`_locked` helper acquires {lockdesc} itself "
                        "(callers already hold it — deadlock hazard)",
                        sym,
                    ))
                for line, callee, under_lock in scan.locked_calls:
                    if not under_lock and not is_locked_helper:
                        findings.append(Finding(
                            L002, mod.rel, line,
                            f"calls {callee}() outside a `with {lockdesc}` "
                            "block",
                            sym,
                        ))
    return findings
