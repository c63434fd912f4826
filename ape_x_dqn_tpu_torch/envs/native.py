"""ctypes bindings for the native Atari observation kernel
(``ape_x_dqn_tpu_torch/cpp/preproc.cpp``, the port's own copy of the
JAX package's host kernel).

This is CPU code for the actors' env steps, not a GPU kernel. It
compiles lazily with g++ into the package's ``_build/`` directory
(utils/native_build.py); without a toolchain `preproc` returns None and
envs/atari.py takes the numpy path, which is bit-identical
(tests/test_torch_actors.py holds the two, and the JAX package's
kernel, equal) but slower, since it materialises per-frame float
intermediates.

Flags: -march=native (the library's name carries a per-CPU-model tag,
so a shared checkout never loads a wrong-ISA binary) and
-ffp-contract=off, which keeps bit parity with numpy: a fused
multiply-add would round differently from numpy's separate float
operations.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ape_x_dqn_tpu_torch.utils.native_build import build_and_load, machine_tag

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "cpp" / "preproc.cpp"
BUILD_DIR = _PKG / "_build"

_lib: ctypes.CDLL | None = None
_tried = False


def _load() -> ctypes.CDLL | None:
    # module-level cache: preproc() runs once per env step in every
    # actor thread, so it must not re-enter build_and_load's lock or
    # rebind argtypes per frame (two threads racing the first call do
    # the same idempotent work)
    global _lib, _tried
    if _tried:
        return _lib
    so = BUILD_DIR / f"libapex_preproc.{machine_tag()}.so"
    lib = build_and_load(str(SOURCE), str(so),
                         flags=("-march=native", "-ffp-contract=off"))
    if lib is not None:
        try:
            lib.apex_preproc.restype = None
            lib.apex_preproc.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        except AttributeError:
            lib = None  # a stale library without the symbol: numpy path
    _lib, _tried = lib, True
    return _lib


def available() -> bool:
    return _load() is not None


def preproc(f0: np.ndarray, f1: np.ndarray | None,
            out_h: int, out_w: int) -> np.ndarray | None:
    """max(f0, f1) -> grayscale -> bilinear (out_h, out_w) -> uint8.

    f0/f1: uint8 [H, W, 3] RGB (f1 None = a single frame). Returns None
    when the native library is unavailable (the caller takes the numpy
    path)."""
    lib = _load()
    if lib is None:
        return None
    f0 = np.ascontiguousarray(f0, np.uint8)
    p1 = None
    if f1 is not None:
        f1 = np.ascontiguousarray(f1, np.uint8)
        p1 = f1.ctypes.data_as(ctypes.c_void_p)
    h, w = f0.shape[:2]
    out = np.empty((out_h, out_w), np.uint8)
    lib.apex_preproc(f0.ctypes.data_as(ctypes.c_void_p), p1, h, w,
                     out.ctypes.data_as(ctypes.c_void_p), out_h, out_w)
    return out
