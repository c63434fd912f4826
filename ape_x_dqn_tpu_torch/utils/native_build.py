"""Lazy build-and-load for the port's native C++ host code.

Counterpart of the part of ``ape_x_dqn_tpu/utils/native_build.py`` that
the port needs (`build_and_load`, `machine_tag`). A source compiles with
g++ on first use into the package's ``_build/`` directory (listed in
.gitignore) and is loaded with ctypes; without a toolchain the callers
fall back to their numpy paths, which are bit compatible. A build writes
a per-pid temporary and renames it into place, so concurrent first uses
never load a half-written library. Builds run with -Wall -Wextra
-Werror: the native pieces are small enough to hold warning-free.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL | None] = {}  # guarded-by: _lock

WARNING_FLAGS = ("-Wall", "-Wextra", "-Werror")


def build_and_load(src: str, so: str,
                   flags: tuple[str, ...] = ()) -> ctypes.CDLL | None:
    """Compile src -> so with g++ (if missing or older than src) and
    dlopen it. Returns None when no compiler is available or the build
    fails; the result (None included) is cached per so-path for the
    process lifetime."""
    with _lock:
        if so in _cache:
            return _cache[so]
        lib = None
        tmp = f"{so}.{os.getpid()}"
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                os.makedirs(os.path.dirname(so), exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", *WARNING_FLAGS, *flags, "-shared",
                     "-fPIC", src, "-o", tmp],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError):
            lib = None
        finally:
            try:
                os.unlink(tmp)  # leftover from a failed or killed compile
            except OSError:
                pass
        _cache[so] = lib
        return lib


def machine_tag() -> str:
    """Stable per-CPU-model tag for -march=native builds: a library
    cached on a shared checkout must not be loaded on a host with
    another instruction set (it would load, then fault)."""
    try:
        with open("/proc/cpuinfo") as fh:
            # x86 keys plus their ARM equivalents; frequency lines vary
            # run to run and must stay out of the hash
            lines = {ln for ln in fh
                     if ln.startswith(("model name", "flags", "Features",
                                       "CPU implementer", "CPU part"))}
        if not lines:
            raise OSError("no ISA-identifying cpuinfo lines")
        return hashlib.md5("".join(sorted(lines)).encode()).hexdigest()[:8]
    except OSError:
        return platform.machine() or "generic"
