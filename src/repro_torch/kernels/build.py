"""Build the CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) into an object by
its own ``nvcc`` (all started together), and the objects are linked into
one shared library with a plain C interface.  The library goes to
``build/repro_torch/`` at the repository root, named by a hash of the
sources (the ``*.cuh`` headers they include too), so a changed source
builds anew and an unchanged one loads at once.  Nothing is built when
the module is imported: the first launch builds, under a lock, because
several DPP worker threads reach their first launch together.

Each C entry point takes device pointers, sizes and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch (the tensor-core flash
attention returns minus a ``CUresult`` where the driver refuses one of
its TMA tensor maps); ``check`` raises on a nonzero code.  No ``--use_fast_math`` and no ``--ftz=true``: the float
ops must keep subnormals exactly as the plain versions do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_F32 = ctypes.c_float
# C signatures: every pointer (and the stream) is a c_void_p, so ctypes
# never cuts a 64-bit address to a 32-bit int
SIGNATURES = {
    "xor_decrypt_launch": (_P, _P, _I64, _P),
    "dense_unpack_launch": (_P, _P, _P, _I32, _I32, _I32, _P),
    "dense_unpack_warp_launch": (_P, _P, _P, _I32, _I32, _I32, _P),
    "ragged_gather_launch": (_P, _P, _P, _P, _I64, _I64, _P),
    "ragged_gather_vec_launch": (_P, _P, _P, _P, _I64, _I64, _P),
    "fused_transform_launch": (
        _P, _P, _P, _P, _P, _P, _I32, _I64, _I64, _I64, _I32, _P,
    ),
    "fused_transform_vec_launch": (_P, _P, _P, _P, _P, _P, _I32, _I64, _I32, _P),
    "embedding_bag_launch": (_P, _P, _P, _P, _I64, _I32, _I64, _I32, _I32, _P),
    "embedding_bag_warp_launch": (_P, _P, _P, _P, _I64, _I32, _I64, _I32, _I32, _P),
    "flash_attention_launch": (
        _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _I32, _F32, _I32, _P,
    ),
    "flash_attention_sm90_launch": (
        _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _I32, _F32, _P,
    ),
    "flash_attention_sm90_tile_launch": (_P, _P, _P, _P, _P, _I32, _I64, _I64, _I64, _P),
    "ssd_chunk_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _I64, _I64, _I64, _I64, _I32, _P,
    ),
    "ssd_chunk_sm90_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _I64, _I64, _I64, _I64, _P,
    ),
    "sigrid_hash_launch": (_P, _P, _I64, _U32, _U64, _U32, _P),
    "bucketize_launch": (_P, _P, _P, _I64, _I32, _P),
    "rowwise_adagrad_keys_launch": (_P, _P, _P, _P, _I64, _I32, _I32, _I64, _P),
    "rowwise_adagrad_rows_launch": (
        _P, _P, _P, _P, _P, _P, _P, _F32, _P, _P, _P, _P, _I64, _I32, _I32, _P,
    ),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the repro_torch "
            "kernels need the CUDA toolkit to build"
        )
    return str(path)


def build(verbose: bool = False) -> Path:
    """Compile the kernels (one nvcc per source, in parallel) and link
    them; returns the library path.  A finished build is reused."""
    lib_path = BUILD_DIR / f"librepro_torch_{source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        objs = []
        failed = []
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            if verbose and out:
                print(out, flush=True)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
            objs.append(str(obj))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)    # atomic: other processes see all or nothing
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(name: str, err: int) -> None:
    """Raise on a C entry point's nonzero code: a ``cudaError_t``, or minus
    a ``CUresult`` where the driver refused a TMA tensor map."""
    if err < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


class LaunchCounts:
    """Kernel launches by name: each wrapper adds one where it launches
    its kernel and nowhere else, so a run can show that it went through
    the kernels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n: Dict[str, int] = {}

    def add(self, name: str) -> None:
        with self._lock:
            self._n[name] = self._n.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._n.clear()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)


LAUNCHES = LaunchCounts()
