"""Checker framework: findings, rule registry, noqa/baseline, runner.

A *checker* is a function ``check(ctx) -> Iterable[Finding]`` registered
with :func:`checker`; the rules it may emit are declared up front with
:func:`rule` so the registry (and the doc-drift gate) always knows the
full rule catalog, including rules whose checker found nothing.

Suppression model (additive gate):

  * inline — a finding is dropped when its source line (or the line
    above) carries ``# repro: noqa(RULE-ID)`` / ``# repro: noqa``;
  * baseline — a checked-in file of finding keys
    (``rule|path|symbol|message``); baselined findings are reported as
    "known" and do not fail the run.  Keys avoid line numbers so pure
    line drift never invalidates the baseline.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# -- findings ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # "REPRO-L001"
    path: str          # repo-relative posix path
    line: int          # 1-based
    message: str       # line-number free (keys must survive line drift)
    symbol: str = ""   # enclosing Class.method anchor, "" at module level

    @property
    def key(self) -> str:
        return f"{self.rule}|{self.path}|{self.symbol}|{self.message}"

    def render(self) -> str:
        where = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{where}"


# -- rule + checker registry -------------------------------------------------

_RULES: Dict[str, str] = {}
_CHECKERS: List[Tuple[str, Callable]] = []

_RULE_ID_RE = re.compile(r"^REPRO-[A-Z]\d{3}$")


def rule(rule_id: str, summary: str) -> str:
    """Declare a rule id with a one-line summary; returns the id."""
    if not _RULE_ID_RE.match(rule_id):
        raise ValueError(f"bad rule id {rule_id!r} (want REPRO-<letter><3 digits>)")
    if rule_id in _RULES and _RULES[rule_id] != summary:
        raise ValueError(f"rule {rule_id} declared twice with different summaries")
    _RULES[rule_id] = summary
    return rule_id


def checker(name: str) -> Callable[[Callable], Callable]:
    def deco(fn: Callable) -> Callable:
        _CHECKERS.append((name, fn))
        return fn
    return deco


def all_rules() -> Dict[str, str]:
    """rule-id -> summary, for ``--list-rules`` and the doc-drift gate."""
    _load_checkers()
    return dict(sorted(_RULES.items()))


def _load_checkers() -> None:
    # import for registration side effects; idempotent
    from repro_torch.analysis import checks_clocks  # noqa: F401
    from repro_torch.analysis import checks_kernels  # noqa: F401
    from repro_torch.analysis import checks_locks  # noqa: F401
    from repro_torch.analysis import checks_metrics  # noqa: F401
    from repro_torch.analysis import checks_races  # noqa: F401
    from repro_torch.analysis import checks_spans  # noqa: F401
    from repro_torch.analysis import checks_threads  # noqa: F401


# -- parsed-source model -----------------------------------------------------


@dataclasses.dataclass
class SourceModule:
    path: Path
    rel: str                      # repo-relative posix path
    text: str
    lines: List[str]
    tree: ast.Module


class CheckContext:
    """Everything a checker may look at: the parsed ``src/repro_torch`` tree plus
    lazy access to other repo files (tests, benchmarks)."""

    def __init__(self, repo: Path):
        self.repo = Path(repo)
        self.src = self.repo / "src" / "repro_torch"
        self._cache: Dict[str, Optional[SourceModule]] = {}

    def load(self, rel: str) -> Optional[SourceModule]:
        """Parse one repo-relative file; None if absent or unparsable
        (checkers treat a missing anchor file as its own finding)."""
        if rel not in self._cache:
            p = self.repo / rel
            mod = None
            if p.is_file():
                text = p.read_text()
                try:
                    mod = SourceModule(p, rel, text, text.splitlines(),
                                       ast.parse(text, filename=rel))
                except SyntaxError:
                    mod = None
            self._cache[rel] = mod
        return self._cache[rel]

    def src_modules(self) -> List[SourceModule]:
        out = []
        for p in sorted(self.src.rglob("*.py")):
            m = self.load(p.relative_to(self.repo).as_posix())
            if m is not None:
                out.append(m)
        return out

    def glob_modules(self, pattern: str) -> List[SourceModule]:
        out = []
        for p in sorted(self.repo.glob(pattern)):
            m = self.load(p.relative_to(self.repo).as_posix())
            if m is not None:
                out.append(m)
        return out


# -- suppression -------------------------------------------------------------

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\(([^)]*)\))?")


def _suppressed(mod_lines: Sequence[str], finding: Finding) -> bool:
    # the finding's own line, or the line just above (for long statements)
    for ln in (finding.line, finding.line - 1):
        if 1 <= ln <= len(mod_lines):
            m = _NOQA_RE.search(mod_lines[ln - 1])
            if m:
                rules = m.group(1)
                if rules is None or finding.rule in {
                    r.strip() for r in rules.split(",")
                }:
                    return True
    return False


# -- baseline ----------------------------------------------------------------


def load_baseline(path: Path) -> List[str]:
    if not Path(path).is_file():
        return []
    return [
        ln for ln in Path(path).read_text().splitlines()
        if ln.strip() and not ln.lstrip().startswith("#")
    ]


def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    keys = sorted(f.key for f in findings)
    header = (
        "# repro_torch.analysis baseline — known findings the gate tolerates.\n"
        "# Regenerate with: python -m repro_torch.analysis --write-baseline\n"
        "# Keep this empty or near-empty: fix findings, don't bank them.\n"
    )
    Path(path).write_text(header + "".join(k + "\n" for k in keys))


# -- runner ------------------------------------------------------------------


def run_checks(
    repo: Path,
    rules: Optional[Sequence[str]] = None,
    baseline: Optional[Sequence[str]] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Run every registered checker over ``repo``.

    Returns ``(new, known)``: findings not in / in the baseline, after
    inline-noqa suppression and optional rule filtering.  CI fails iff
    ``new`` is non-empty.
    """
    _load_checkers()
    ctx = CheckContext(Path(repo))
    findings: List[Finding] = []
    for _name, fn in _CHECKERS:
        findings.extend(fn(ctx))
    if rules is not None:
        want = set(rules)
        unknown = want - set(_RULES)
        if unknown:
            raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
        findings = [f for f in findings if f.rule in want]
    findings = [
        f for f in findings
        if not _mod_suppressed(ctx, f)
    ]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    remaining = list(baseline or [])
    new, known = [], []
    for f in findings:
        if f.key in remaining:
            remaining.remove(f.key)   # baseline is a multiset
            known.append(f)
        else:
            new.append(f)
    return new, known


def _mod_suppressed(ctx: CheckContext, f: Finding) -> bool:
    mod = ctx.load(f.path)
    return mod is not None and _suppressed(mod.lines, f)


# -- shared AST helpers ------------------------------------------------------


def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None for non-name-rooted chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def enclosing_symbol(stack: Sequence[ast.AST]) -> str:
    names = [
        n.name for n in stack
        if isinstance(n, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    return ".".join(names)
