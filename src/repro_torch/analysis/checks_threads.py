"""Thread-hygiene rules (REPRO-T001/T002).

The DPP fleet leans hard on background threads (workers, producers,
monitors, prefetch fills).  Two failure shapes keep reappearing in
concurrency post-mortems, so they are banned statically:

  * **T001** — a ``threading.Thread`` that is neither ``daemon=True`` nor
    ever ``join()``-ed: it outlives the test/session that spawned it and
    wedges interpreter shutdown.  A thread passes when its constructor
    has a literal ``daemon=True``, its target variable/attribute is
    ``.join()``-ed (or ``.daemon = True``-ed) somewhere in the module, or
    it is collected into a container that is iterated and joined.
  * **T002** — bare ``except:`` — it swallows ``KeyboardInterrupt`` and
    ``SystemExit``, turning a Ctrl-C during a stuck drain into a hung
    worker.  Catch ``Exception`` (or ``BaseException`` where a re-raise
    follows) instead.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import CheckContext, Finding, attr_chain, checker, \
    enclosing_symbol, rule

T001 = rule("REPRO-T001",
            "threading.Thread neither daemonized nor joined — leaks past "
            "shutdown")
T002 = rule("REPRO-T002",
            "bare `except:` swallows KeyboardInterrupt/SystemExit")


def _is_thread_ctor(node: ast.Call) -> bool:
    chain = attr_chain(node.func)
    return bool(chain) and chain[-1] == "Thread" and (
        len(chain) == 1 or chain[-2] == "threading"
    )


def _daemon_true(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return kw.value.value is True
    return False


def _assigned_names(parents: List[ast.AST]) -> List[str]:
    """Names/attrs the Thread(...) value is bound to via the direct parent
    statement: ``t = Thread()`` / ``self._t = Thread()``."""
    out: List[str] = []
    stmt = parents[-1] if parents else None
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            chain = attr_chain(t)
            if chain:
                out.append(".".join(chain))
    elif isinstance(stmt, ast.AnnAssign):
        chain = attr_chain(stmt.target)
        if chain:
            out.append(".".join(chain))
    return out


class _ThreadScan(ast.NodeVisitor):
    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.joined: set = set()       # dotted names x where x.join(...) occurs
        self.daemoned: set = set()     # dotted names x where x.daemon = True
        self.any_loop_join = False     # for t in <...>: t.join() patterns
        self._collect()

    def _collect(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join":
                chain = attr_chain(node.func.value)
                if chain:
                    self.joined.add(".".join(chain))
                    self.any_loop_join = True
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr == "daemon":
                        chain = attr_chain(t.value)
                        if chain and isinstance(node.value, ast.Constant) \
                                and node.value.value is True:
                            self.daemoned.add(".".join(chain))


@checker("thread-hygiene")
def check_threads(ctx: CheckContext):
    findings: List[Finding] = []
    for mod in ctx.src_modules():
        scan = _ThreadScan(mod.tree)
        # walk with parent statements so we can see what a ctor binds to
        stack: List[ast.AST] = []

        def walk(node: ast.AST) -> None:
            if isinstance(node, ast.Call) and _is_thread_ctor(node):
                if not _daemon_true(node):
                    names = _assigned_names(
                        [p for p in stack if isinstance(p, ast.stmt)][-1:]
                    )
                    covered = any(
                        n in scan.joined or n in scan.daemoned for n in names
                    )
                    # threads built inline into a joined/iterated container
                    # (e.g. `threads = [Thread(...) for ...]` + loop join):
                    in_comp = any(
                        isinstance(p, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp))
                        for p in stack
                    )
                    in_container = (not names or in_comp) \
                        and scan.any_loop_join
                    if not covered and not in_container:
                        findings.append(Finding(
                            T001, mod.rel, node.lineno,
                            "thread is neither daemon=True nor joined in "
                            "this module",
                            enclosing_symbol([
                                p for p in stack
                                if isinstance(p, (ast.ClassDef, ast.FunctionDef,
                                                  ast.AsyncFunctionDef))
                            ]),
                        ))
            stack.append(node)
            for child in ast.iter_child_nodes(node):
                walk(child)
            stack.pop()

        walk(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                findings.append(Finding(
                    T002, mod.rel, node.lineno,
                    "bare `except:` — catch Exception (or BaseException + "
                    "re-raise)",
                ))
    return findings
