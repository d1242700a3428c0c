"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use the sources are compiled for Hopper (``sm_90a``) with
``nvcc``, one process per source and all started together, then linked
into one shared library with a plain C interface, which is loaded with
``ctypes``.  The library's name carries a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
The build directory is ``kernels/build/`` beside this file (git-ignored).

Nothing here runs at import: the CPU tests import the package without a
compiler or a card.  A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points; each returns a cudaError_t as int
SIGNATURES = {
    "rt_rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _P),
    "rt_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                           _I, _P),
    "rt_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _F, _I, _P),
    "rt_ssd_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _I, _I, _P),
}

_lib: ctypes.CDLL | None = None
build_log = ""            # nvcc's output (ptxas registers / spills per kernel)
build_seconds: float | None = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set NVCC or put the CUDA toolkit's "
                       "bin/ on PATH to build the repro_torch kernels")


def _sources(csrc: Path) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def _digest(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def build(csrc: Path = CSRC) -> Path:
    """Compile the sources in ``csrc`` (default: this package's csrc/) into
    a shared library, if not built yet; its path."""
    global build_log, build_seconds
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{_digest(csrc)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        sources = _sources(csrc)
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        results = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                            for src, obj in zip(sources, objs)])
        build_log = "".join(out for _, out in results)
        if any(rc for rc, _ in results):
            raise RuntimeError("nvcc failed to compile the kernels:\n" + build_log)
        tmp_lib = Path(tmp) / lib_path.name
        rc, out = _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                             "-o", str(tmp_lib)]])[0]
        build_log += out
        if rc:
            raise RuntimeError("nvcc failed to link the kernels:\n" + out)
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load(path: Path) -> ctypes.CDLL:
    """A built library, with the C signatures of the entry points it has."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib
