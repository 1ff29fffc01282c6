"""Kernel-parity rules (REPRO-K001/K002), over the port's layout.

The port's fused transform is a CUDA kernel whose plain PyTorch version,
``kernels/ref.py``, is the truth the CPU tests and ``chip_smoke.py`` hold
it to.  That net only keeps its power if every op stays inside it:

  * **K001** — every ``constexpr int OP_* = N;`` code of
    ``src/repro_torch/csrc/fused_transform.cu`` has a counterpart of the
    same name and value in ``src/repro_torch/kernels/ref.py``, and vice
    versa.  The ``.cu`` is read as text with one regex (``CheckContext``
    parses only Python); the plain version's table is its module-level
    ``OP_NAME = <int>`` assignments.
  * **K002** — every ``OP_*`` code is exercised by
    ``tests/test_torch_engines.py``: the test source references the
    ``OP_<NAME>`` constant itself, or uses the op's transform name in a
    spec (``OP_SIGRID_HASH`` -> ``SigridHash``; float-lane variants such
    as ``OP_CLAMP_F`` map to their base transform, ``Clamp``).

    K002 also covers the dispatch layer: every public function of
    ``src/repro_torch/kernels/ops.py`` must be named by one of the port's
    CPU differential suites (``KSUITES``); and the decode layer: every
    public function of ``src/repro_torch/kernels/decode.py`` (the kernels,
    their routes and the ``*_route`` pickers) must be named by
    ``tests/test_torch_kernels.py`` or ``tests/test_torch_kernel_routes.py``.

A new op can therefore never land without a plain version and a
differential test naming it.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.core import CheckContext, Finding, checker, rule

K001 = rule("REPRO-K001",
            "OP_* code missing its counterpart in kernels/ref.py (or ref "
            "defines an op the kernel does not)")
K002 = rule("REPRO-K002",
            "OP_* code not exercised by the differential suite in "
            "tests/test_torch_engines.py")

FUSED = "src/repro_torch/csrc/fused_transform.cu"
REF = "src/repro_torch/kernels/ref.py"
SUITE = "tests/test_torch_engines.py"
OPS = "src/repro_torch/kernels/ops.py"
KSUITES = ("tests/test_torch_kernels.py", "tests/test_torch_standalone.py",
           "tests/test_torch_lm.py", "tests/test_torch_ssm.py")
DECODE = "src/repro_torch/kernels/decode.py"
DSUITES = ("tests/test_torch_kernels.py", "tests/test_torch_kernel_routes.py")

_CU_OP_RE = re.compile(
    r"^[ \t]*constexpr[ \t]+int[ \t]+(OP_\w+)[ \t]*=[ \t]*(\d+)[ \t]*;", re.M)


def _cu_op_defs(text: str) -> Dict[str, Tuple[int, int]]:
    """``constexpr int OP_NAME = N;`` lines of a CUDA source ->
    {name: (value, line)}."""
    return {
        m.group(1): (int(m.group(2)), text.count("\n", 0, m.start()) + 1)
        for m in _CU_OP_RE.finditer(text)
    }


def _op_defs(mod) -> Dict[str, Optional[int]]:
    """Module-level ``OP_NAME = <int>`` assignments -> {name: value}."""
    ops: Dict[str, Optional[int]] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id.startswith("OP_"):
                val = node.value
                ops[t.id] = (
                    val.value if isinstance(val, ast.Constant)
                    and isinstance(val.value, int) else None
                )
    return ops


def transform_name(op_const: str) -> str:
    """``OP_SIGRID_HASH`` -> ``SigridHash``; float-lane variants map to
    their base transform (``OP_CLAMP_F`` -> ``Clamp``)."""
    base = op_const[len("OP_"):]
    base = re.sub(r"_F$", "", base)
    return "".join(w.capitalize() for w in base.split("_"))


@checker("kernel-parity")
def check_kernel_parity(ctx: CheckContext):
    findings: List[Finding] = []
    cu = ctx.repo / FUSED
    if not cu.is_file():
        return [Finding(K001, FUSED, 1, "kernel source missing")]
    fused_ops = _cu_op_defs(cu.read_text())
    ref = ctx.load(REF)
    suite = ctx.load(SUITE)
    ref_ops = _op_defs(ref) if ref is not None else {}
    if ref is None:
        findings.append(Finding(K001, REF, 1, "ref module missing/unparsable"))
    for name, (value, line) in sorted(fused_ops.items()):
        if name not in ref_ops:
            findings.append(Finding(
                K001, FUSED, line,
                f"{name} has no counterpart in kernels/ref.py — the fused "
                "op has no parity oracle",
            ))
        elif ref_ops[name] is not None and ref_ops[name] != value:
            findings.append(Finding(
                K001, FUSED, line,
                f"{name} = {value} but kernels/ref.py says {ref_ops[name]} "
                "— op-code tables diverge",
            ))
    for name in sorted(set(ref_ops) - set(fused_ops)):
        findings.append(Finding(
            K001, REF, 1,
            f"{name} defined in ref.py only — dead oracle or missing "
            "CUDA implementation",
        ))
    if suite is None:
        findings.append(Finding(
            K002, SUITE, 1,
            "differential suite missing — no op is parity-tested",
        ))
        return findings
    for name, (_value, line) in sorted(fused_ops.items()):
        if name in suite.text or transform_name(name) in suite.text:
            continue
        findings.append(Finding(
            K002, FUSED, line,
            f"{name} is never exercised by {SUITE} (neither the constant "
            f"nor a {transform_name(name)!r} spec appears)",
        ))
    findings.extend(_check_coverage(
        ctx, OPS, KSUITES, "public kernel",
        "a dispatchable op without a differential test",
        "kernel differential suites missing — no dispatchable kernel is "
        "parity-tested",
    ))
    findings.extend(_check_coverage(
        ctx, DECODE, DSUITES, "decode kernel",
        "an extract-path op without a differential test",
        "decode differential suites missing — no decode kernel is "
        "parity-tested",
    ))
    return findings


def _public_kernel_defs(mod) -> Dict[str, int]:
    """Top-level public ``def``s of a module -> {name: line}."""
    return {
        node.name: node.lineno
        for node in mod.tree.body
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_")
    }


def _check_coverage(ctx: CheckContext, module: str, suites: Sequence[str],
                    what: str, why: str, missing: str) -> List[Finding]:
    """K002, one kernel layer: every public def of ``module`` must be named
    by one of ``suites`` (the union of the files that exist)."""
    mod = ctx.load(module)
    if mod is None:
        return []
    kernels = _public_kernel_defs(mod)
    if not kernels:
        return []
    texts = [m.text for m in map(ctx.load, suites) if m is not None]
    if not texts:
        return [Finding(K002, suites[0], 1, missing)]
    named_by = " or ".join(suites)
    return [
        Finding(
            K002, module, line,
            f"{what} {name!r} is never exercised by {named_by} — {why}",
        )
        for name, line in sorted(kernels.items())
        if not any(name in t for t in texts)
    ]
