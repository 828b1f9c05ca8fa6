"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source,
all started together) and link into one shared library with a plain C
interface, loaded with ``ctypes``. The library lands in
``build/halo2_rsa_tpu_torch/<hash of the sources>/`` under the checkout, so
an edit to any source builds anew and an unchanged tree reuses the last
build. Nothing is built at import time: the first kernel launch builds.

:func:`sass_opcodes` reads the built library's machine code (``cuobjdump
-sass``) so that a run can count each kernel's instructions.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "halo2_rsa_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_U32 = ctypes.c_uint32
_P32 = ctypes.POINTER(ctypes.c_uint32)
# C entry points of csrc/*.cu: argument types (every one returns the
# launch's cudaError_t as an int)
SIGNATURES = {
    "h2r_mont_mul": [_VP, _VP, _VP, _LL, _P32, _U32, _VP],
    "h2r_g1_add": [_VP] * 9 + [_LL, _P32, _U32, _VP],
    "h2r_g1_add_mixed": [_VP] * 8 + [_LL, _P32, _U32, _VP],
    "h2r_g1_double": [_VP] * 6 + [_LL, _P32, _U32, _VP],
    "h2r_int_ops": [ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _LL, _VP],
    "h2r_mont_mul_lm": [_VP, _VP, _VP, _LL, _P32, _U32, _VP],
    "h2r_mont_mul_staged": [_VP, _VP, _VP, _LL, _P32, _U32, ctypes.c_int, _VP],
}

_lock = threading.Lock()
_lib = None


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """nvcc on PATH, else under the toolkit PyTorch finds (CUDA_HOME,
    CUDA_PATH or the toolkit's usual prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the hashed build directory (if not there
    yet), one nvcc process per source in parallel, then link; returns the
    library's path."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, "libh2r_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir)
    try:
        nvcc = nvcc_path()
        extra = ["-Xptxas=-v"] if verbose else []
        jobs = []
        for src in (s for s in _sources() if s.endswith(".cu")):
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *extra, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors, logs = [], []
        for obj, proc in jobs:
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                errors.append(f"{os.path.basename(obj)} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp = os.path.join(work, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *[o for o, _ in jobs]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        if verbose:
            print("".join(logs), flush=True)
        os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


# SASS opcodes that run on the SM's integer pipes (the uniform-datapath U*
# opcodes, moves, loads/stores and branches are not counted)
INT_OPCODES = frozenset({
    "IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "SEL",
    "LEA", "IMNMX", "IABS", "IMUL", "PRMT", "POPC", "FLO", "BMSK", "BREV", "VIADD",
    "VIMNMX", "ISCADD", "IDP", "IDP4A",
})
# the integer opcodes Hopper issues to its FMA pipe (IMAD and its MOV/IADD/
# SHL/WIDE/X forms); the others run on the integer ALU pipe. Each pipe has
# 64 lanes per SM; the four schedulers issue 128 thread-instructions per SM
# per clock in all.
FMA_PIPE_OPCODES = frozenset({"IMAD", "IMUL"})
_SASS_FUNC = re.compile(r"^\s*Function : (\S+)")
_SASS_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_opcodes(lib_path: str | None = None) -> dict[str, collections.Counter]:
    """{kernel symbol: Counter of full SASS opcodes (e.g. ``IMAD.WIDE.U32``)}
    of the built library, from ``cuobjdump -sass`` (needs the toolkit)."""
    lib_path = lib_path or build()
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}):\n{proc.stderr}")
    out: dict[str, collections.Counter] = {}
    cur = None
    for text in proc.stdout.splitlines():
        m = _SASS_FUNC.match(text)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = _SASS_INSN.match(text)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return out


def int_instructions(ops: collections.Counter) -> int:
    """How many of a kernel's SASS instructions run on the integer pipes."""
    return sum(n for op, n in ops.items() if op.split(".")[0] in INT_OPCODES)


def pipe_counts(ops: collections.Counter) -> dict[str, int]:
    """A kernel's SASS instructions by where they issue: ``fma`` (integer
    opcodes of the FMA pipe), ``alu`` (the other integer opcodes) and
    ``issued`` (every instruction but the NOP padding)."""
    fma = sum(n for op, n in ops.items() if op.split(".")[0] in FMA_PIPE_OPCODES)
    return dict(fma=fma, alu=int_instructions(ops) - fma,
                issued=sum(n for op, n in ops.items() if op != "NOP"))


def kernel_opcodes(sass: dict, name: str, *template_args: int) -> collections.Counter:
    """The one kernel in ``sass`` whose mangled symbol holds ``name`` (and,
    for a template, the integer arguments in order)."""
    pat = re.escape(name) + ("I" + "".join(f"Li{a}E" for a in template_args) + "E"
                             if template_args else r"(?!I)")
    hits = [k for k in sass if re.search(pat, k)]
    if len(hits) != 1:
        raise KeyError(f"{name}{list(template_args)}: {len(hits)} kernels match in the SASS")
    return sass[hits[0]]
