"""ctypes bindings for the native C++ data loader (``native/artdeco_io.cpp``).

Port of ``artdeco_tpu/runtime/native_loader.py``.  The source is the one
the JAX package binds, read where it lies; the port builds it at first use
with ``g++ -O3 -shared -fPIC -std=c++17 ... -ljpeg -lpng -lpthread`` into
``build/native/`` of the repository (git-ignored), never into
``native/``.

``missing_toolchain`` says whether this machine can build it at all: it
returns the compiler's message when ``g++`` or the libjpeg/libpng headers
are missing, else None.  That is a property of the machine, decided
before any build.  Once the toolchain is there, a failed build or
``dlopen`` raises with the compiler's output, and a failed decode raises:
nothing here returns None for a failure.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(_REPO, "native", "artdeco_io.cpp")
LIB = os.path.join(_REPO, "build", "native", "libartdeco_io.so")
_PROBE = "#include <cstdio>\n#include <cstddef>\n#include <jpeglib.h>\n#include <png.h>\n"

_lock = threading.Lock()
_lib = None
_missing = ...


def missing_toolchain() -> Optional[str]:
    """None when ``g++`` and the libjpeg/libpng headers are there; else the
    reason, in the compiler's words.  Checked once per process."""
    global _missing
    if _missing is ...:
        try:
            res = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"], input=_PROBE,
                                 capture_output=True, text=True)
            _missing = None if res.returncode == 0 else (
                res.stderr.strip().splitlines() or ["g++ failed"])[0]
        except FileNotFoundError:
            _missing = "g++: not found"
    return _missing


def build_native(force: bool = False, src: str = SRC, out: str = LIB) -> str:
    """Compile ``src`` into the shared library ``out`` (when it is missing,
    older than the source, or ``force``); returns its path.  Raises
    RuntimeError with the compiler's output when the build fails."""
    if not force and os.path.isfile(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp,
           "-ljpeg", "-lpng", "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building the native loader failed: {' '.join(cmd)}\n"
                           f"{res.stderr}{res.stdout}")
    os.replace(tmp, out)     # atomic: concurrent builders each leave a whole file
    return out


def get_lib():
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        why = missing_toolchain()
        if why is not None:
            raise RuntimeError(f"the native loader cannot be built here: {why}")
        lib = ctypes.CDLL(build_native())
        lib.prefetcher_create.restype = ctypes.c_void_p
        lib.prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.prefetcher_get.restype = ctypes.c_int
        lib.prefetcher_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
        lib.decode_image.restype = ctypes.c_int
        lib.decode_image.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether this machine can build the native loader."""
    return missing_toolchain() is None


def decode_image(path: str, max_wh=(8192, 8192)) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG or PNG file, decoded by libjpeg/libpng."""
    lib = get_lib()
    buf = np.empty(max_wh[0] * max_wh[1] * 3, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    ok = lib.decode_image(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.size, ctypes.byref(w), ctypes.byref(h),
    )
    if not ok:
        raise IOError(f"native decode failed: {path}")
    return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


class NativePrefetcher:
    """Ordered frame stream: decode once, produce SLAM + map tensors.

    Mirrors the transform geometry of ``dataio.camera.PinholeCamera`` (long
    edge -> resize -> centre crop for SLAM; area downsample for map) with
    the library's own filters: an area average when shrinking, bilinear
    when growing, maps left in float.  Only valid when no undistortion
    remap is active.
    """

    def __init__(self, paths, camera, ring_size: int = 8, n_threads: int = 4):
        if camera.mapx is not None:
            raise ValueError("the native loader does not undistort")
        self.lib = get_lib()
        self.n = len(paths)
        # the pre-crop resize dims the camera used
        H0, W0 = camera.H_original, camera.W_original
        s = max(H0, W0)
        rs_w = int(round(W0 * camera.target_size / s))
        rs_h = int(round(H0 * camera.target_size / s))
        self.slam_shape = (3, camera.H_slam, camera.W_slam)
        self.map_shape = (3, camera.H_map, camera.W_map)
        arr = (ctypes.c_char_p * self.n)(*[p.encode() for p in paths])
        self.handle = self.lib.prefetcher_create(
            arr, self.n, camera.W_slam, camera.H_slam, rs_w, rs_h,
            camera.W_map, camera.H_map, ring_size, n_threads,
        )
        self._idx = 0

    def get(self):
        """The next frame's (slam (3, H_slam, W_slam) in [-1, 1], map
        (3, H_map, W_map) in [0, 1]), float32."""
        slam = np.empty(self.slam_shape, np.float32)
        mp = np.empty(self.map_shape, np.float32)
        ok = self.lib.prefetcher_get(
            self.handle, self._idx,
            slam.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        self._idx += 1
        if not ok:
            raise IOError(f"native decode failed at frame {self._idx - 1}")
        return slam, mp

    def close(self):
        if self.handle:
            self.lib.prefetcher_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
