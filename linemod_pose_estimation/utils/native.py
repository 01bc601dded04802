"""ctypes bindings for the native C++ runtime (native/ directory).

The reference's bank I/O is native C++ (cv::FileStorage); ours is too for
the cold-start path: `native/bank_loader.cpp` parses the OpenCV-YAML bank
files ~50x faster than the PyYAML route.  The library is built on first use
by `make -C native` into native/build/ (listed in .gitignore); a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "liblpe_native.so")

_lib = None


def _build() -> None:
    """`make -C native` for the bank loader, under a file lock so that
    concurrent first users (test workers, two servers) build it once."""
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    with open(_SO_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_SO_PATH):
            return
        res = subprocess.run(
            ["make", "-C", _NATIVE_DIR, "build/liblpe_native.so"],
            capture_output=True, text=True, timeout=300,
        )
        if res.returncode != 0:
            raise RuntimeError(
                "building the native bank loader failed (make -C native):\n"
                + res.stdout[-2000:] + res.stderr[-4000:])


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH):
        _build()
    lib = ctypes.CDLL(_SO_PATH)
    for name in ("lpe_load_params_blob", "lpe_load_templates_blob"):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_uint8)
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.lpe_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.lpe_free.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """True once the native loader is built and loaded (builds it on
    first call; a failed build raises)."""
    return _get_lib() is not None


def _grab_blob(fn, path: str) -> bytes | None:
    size = ctypes.c_int64(0)
    ptr = fn(path.encode(), ctypes.byref(size))
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, size.value)
    finally:
        _get_lib().lpe_free(ptr)


def load_params_native(path: str):
    """Parse a renderer_params.yml via the native loader.

    Returns (R (N,3,3) f64, T (N,3) f64, K (N,3,3) f32, D (N,), Ori_dist
    (N,), Rect (N,4) i32, globals (11,) f64) or None if the file does not
    parse.
    """
    lib = _get_lib()
    blob = _grab_blob(lib.lpe_load_params_blob, path)
    if blob is None:
        return None
    off = 0
    (n,) = np.frombuffer(blob, np.int64, 1, off)
    off += 8
    n = int(n)

    def take(dtype, count, shape):
        nonlocal off
        a = np.frombuffer(blob, dtype, count, off).reshape(shape).copy()
        off += a.nbytes
        return a

    R = take(np.float64, n * 9, (n, 3, 3))
    T = take(np.float64, n * 3, (n, 3))
    K = take(np.float32, n * 9, (n, 3, 3))
    D = take(np.float64, n, (n,))
    Od = take(np.float64, n, (n,))
    Rect = take(np.int32, n * 4, (n, 4))
    glob = take(np.float64, 11, (11,))
    return R, T, K, D, Od, Rect, glob


def load_templates_native(path: str):
    """Parse a templates.yml via the native loader.

    Returns (entries (M,6) i32 rows [pyramid_id, w, h, level, modality, nf],
    features (F,3) i32 rows [y, x, ori], header (4,) i32
    [pyramid_levels, n_modalities, T0, T1], modality_params (2,4) f64)
    or None if the file does not parse.
    """
    lib = _get_lib()
    blob = _grab_blob(lib.lpe_load_templates_blob, path)
    if blob is None:
        return None
    off = 0
    n_entries, n_feat = np.frombuffer(blob, np.int64, 2, off)
    off += 16

    def take(dtype, count, shape):
        nonlocal off
        a = np.frombuffer(blob, dtype, count, off).reshape(shape).copy()
        off += a.nbytes
        return a

    entries = take(np.int32, int(n_entries) * 6, (int(n_entries), 6))
    features = take(np.int32, int(n_feat) * 3, (int(n_feat), 3))
    header = take(np.int32, 4, (4,))
    mparams = take(np.float64, 8, (2, 4))
    return entries, features, header, mparams
