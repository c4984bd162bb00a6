"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` for ``sm_90a``, all of them at
once, and the objects are linked into one shared library with a plain C
interface, at first use, into ``build/kernels/`` beside the package
(git-ignored), and loaded with ``ctypes``.  The library name carries
a hash of the sources, so an edited kernel is rebuilt and a stale library is
never loaded.  Nothing here runs at import time: CPU-only installs import
every module of the port without a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of csrc/*.cu: every function returns cudaGetLastError()
SIGNATURES = {
    # slot, S, starts, counts, num_tiles, tiles_x, out, stop, stream
    "artdeco_composite_fwd": (_P, _L, _P, _P, _I, _I, _P, _P, _P),
    # slot, S, starts, counts, stop, num_tiles, tiles_x, g_out, ckpt, grad,
    # stream
    "artdeco_composite_bwd": (_P, _L, _P, _P, _P, _I, _I, _P, _P, _P, _P),
    # D11, D21, p_in, valid, n, h, w, radius, d_max, d_min, init_score,
    # p_out, score_out, stream
    "artdeco_refine": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                       _P, _P, _P),
    # info (7 ints; launch_info.cuh)
    "artdeco_composite_fwd_info": (_P,),
    # radius, info
    "artdeco_refine_info": (_I, _P),
}
# what launch_info.cuh writes, in order
INFO_KEYS = ("threads", "cluster", "registers", "spill_bytes", "shared_bytes",
             "blocks_per_sm", "max_clusters")


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha1()
    for p in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libartdeco_kernels_{h.hexdigest()[:12]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is missing; returns (path, nvcc output)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # objects and the library go to private names, then the library is
    # renamed: a concurrent build never loads a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for obj, p in procs:
            log.append(p.communicate()[0])
            if p.returncode != 0:
                failed.append(obj)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-shared", "-o", lib, *(o for o, _ in procs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(lib, out)
    return out, "\n".join(log) + res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and cached per process."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def launch_info(name: str, *args) -> dict:
    """The launch shape of a kernel as the runtime reports it (``INFO_KEYS``;
    -1 where the runtime refuses a query), from the library's ``name``
    function: ``artdeco_composite_fwd_info()`` (K1) or
    ``artdeco_refine_info(radius)`` (K3)."""
    info = (ctypes.c_int * len(INFO_KEYS))()
    check(getattr(load(), name)(*args, ctypes.cast(info, ctypes.c_void_p)), name)
    return dict(zip(INFO_KEYS, info))
