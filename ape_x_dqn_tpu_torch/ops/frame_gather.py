"""Frame-row gather: a hand-written CUDA kernel for Hopper, and its plain
PyTorch version.

`gather_rows(src, idx)` computes ``out[i] = src[idx[i]]`` over the
leading axis of a contiguous ``src [N, ...]`` of any dtype, treating
each row as ``row_bytes`` contiguous bytes. It is the same function as
the TPU kernel ``ape_x_dqn_tpu/ops/frame_gather.py:46
gather_rows_pallas``, and the frame-ring replay rebuilds its 4-frame
stacks through it (replay/frame_ring.py ``_gather``).

- On CUDA tensors it launches the kernel in ``csrc/frame_gather.cu`` or
  raises: there is no fallback. The kernel is built with nvcc for
  sm_90a at first use, from the sources in this package, into
  ``_build/`` (listed in .gitignore), and loaded with ctypes. The same
  nvcc call builds the learner's stage markers (``csrc/stage_marks.cu``,
  launched by obs/stages.py) into the same library.
- On CPU tensors, and only there, it runs `gather_rows_reference`.

`gather_rows.launches` counts kernel launches (and nothing else), so a
run can show that its main path went through the kernel. A call made
while its stream is capturing a CUDA graph launches nothing: it counts
in `gather_rows.captured` instead, and whoever replays the graph adds
the launches it carries to `gather_rows.launches` at each replay
(runtime/step_graph.py). `gather_rows.bytes_moved` sums what the
eager launches read and write, for obs/profiling.py's analytic cost.

Bound: pure memory traffic, ``M * row_bytes`` read plus as much written;
see the note in the CUDA source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "frame_gather.cu"
# every source of the library: the gather and the stage markers
SOURCES = (SOURCE, _PKG / "csrc" / "stage_marks.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib: ctypes.CDLL | None = None


def gather_rows_reference(src: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version: src [N, ...], idx [M] int -> [M, ...]."""
    return src[idx.long()]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the frame-gather CUDA kernel cannot be built")
    return str(path)


def build() -> float:
    """Compile the kernel if its library is missing; load it. Returns
    the seconds spent (0.0 when it was already loaded)."""
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    # named by the sources' hash: an edited source builds anew
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in SOURCES)).hexdigest()[:10]
    so = BUILD_DIR / f"libframe_gather.{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building "
                f"{', '.join(map(str, SOURCES))}:\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.gather_rows_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mark = lib.stage_mark_launch
    mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    mark.restype = ctypes.c_int
    _lib = lib
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The built library (built and loaded at first use)."""
    build()
    return _lib


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]]: src [N, ...] contiguous, idx [M] int32 or
    int64 -> [M, ...] in src's dtype. Indices are expected in [0, N);
    the kernel clamps anything else into range (the CPU version raises
    on them, as torch indexing does)."""
    if src.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_reference(src, idx)
    if src.device.type != "cuda" or idx.device != src.device:
        raise ValueError(
            f"gather_rows needs src and idx on one CUDA device (or both "
            f"on the CPU), got {src.device} and {idx.device}")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise ValueError(
            f"idx must be a 1-D int32/int64 tensor, got {idx.dtype} "
            f"{tuple(idx.shape)}")
    if src.dim() < 1 or src.shape[0] < 1:
        raise ValueError(f"src must have >= 1 row, got {tuple(src.shape)}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows needs contiguous src and idx")
    m = idx.shape[0]
    if m >= 2 ** 31:
        raise ValueError(f"too many indices for one launch: {m}")
    out = torch.empty((m, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    if m == 0:
        return out
    row_bytes = src[0].numel() * src.element_size()
    build()
    dev = src.device.index
    with torch.cuda.device(dev):
        rc = _lib.gather_rows_launch(
            dev, src.data_ptr(), idx.data_ptr(),
            int(idx.dtype == torch.int64), out.data_ptr(), src.shape[0], m,
            row_bytes, torch.cuda.current_stream(dev).cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{rc}")
    if capturing:
        gather_rows.captured += 1
    else:
        count_launches(src.device, 1)
        gather_rows.bytes_moved += 2 * m * row_bytes + m * idx.element_size()
    return out


def count_launches(device: torch.device, n: int) -> None:
    """Count n launches of the kernel on `device`: eager ones here, the
    ones a replayed graph carries there (runtime/step_graph.py)."""
    gather_rows.launches += n
    key = str(device)
    gather_rows.by_device[key] = gather_rows.by_device.get(key, 0) + n


gather_rows.launches = 0   # kernel launches, graph replays included
gather_rows.by_device = {}  # the same, by device ("cuda:1": n)
gather_rows.captured = 0   # launches recorded into CUDA graphs
# bytes the eager launches read and wrote (rows twice, the indices once):
# what obs/profiling.py's analytic cost adds for them
gather_rows.bytes_moved = 0
