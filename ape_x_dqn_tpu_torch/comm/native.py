"""ctypes bindings for the native framing codec
(``ape_x_dqn_tpu_torch/cpp/framing.cpp``, the port's own byte-for-byte
copy of the JAX package's host code; tests/test_torch_isolation.py pins
it against the original).

Counterpart of ``ape_x_dqn_tpu/comm/native.py``. This is CPU code for
the transports, not a GPU kernel. It compiles lazily with g++ into the
package's ``_build/`` directory (utils/native_build.py); without a
toolchain the pure-Python fallbacks (zlib.crc32, bytes joins, numpy
XOR-delta and int8 quantization) are wire-compatible, so a
native-enabled learner can talk to a Python-only actor host.
`available()` says which path runs.

Every entry point accepts bytes, bytearray, or (1-D, contiguous)
memoryview without copying: the ingest hot path hands `socket.recv_into`
buffers and numpy array views straight through, so the only per-message
copy left is the wire->staging landing itself (see
socket_transport.decode_batch_into).
"""

from __future__ import annotations

import ctypes
import os
import zlib

from ape_x_dqn_tpu_torch.utils.native_build import build_and_load

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "cpp", "framing.cpp")
_SO = os.path.join(_PKG, "_build", "libapex_framing.so")


_lib: ctypes.CDLL | None = None
_tried = False
_has_delta = False
_has_q8 = False

Buffer = bytes | bytearray | memoryview


def _load() -> ctypes.CDLL | None:
    # module-level cache: the codec runs per ingest message; don't
    # re-enter build_and_load's lock or rebind argtypes per call
    global _lib, _tried, _has_delta, _has_q8
    if _tried:
        return _lib
    lib = build_and_load(_SRC, _SO)
    if lib is not None:
        try:
            # c_void_p (not c_char_p) for the data pointers so writable
            # buffers (bytearray, numpy views) pass without a bytes copy
            lib.apex_crc32.restype = ctypes.c_uint32
            lib.apex_crc32.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_uint32]
            lib.apex_pack.restype = ctypes.c_uint64
            lib.apex_pack.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
            lib.apex_unpack_offsets.restype = ctypes.c_uint64
            lib.apex_unpack_offsets.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
        except AttributeError:
            lib = None  # stale .so missing a symbol: Python fallback
    if lib is not None:
        try:
            # delta symbols bound separately: a stale .so predating the
            # wire codec still serves crc/pack, and only the delta
            # transform falls back to numpy (wire-compatible either way)
            lib.apex_delta_encode.restype = None
            lib.apex_delta_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_uint64, ctypes.c_uint64]
            lib.apex_delta_undo.restype = None
            lib.apex_delta_undo.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
            _has_delta = True
        except AttributeError:
            _has_delta = False
    if lib is not None:
        try:
            # q8 symbols likewise bound separately (param-plane codec,
            # comm/param_codec.py): a stale .so predating it degrades
            # only the quantizer to the bit-identical numpy fallback
            lib.apex_q8_encode.restype = None
            lib.apex_q8_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_float, ctypes.c_float]
            lib.apex_q8_dequant_add.restype = None
            lib.apex_q8_dequant_add.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_float, ctypes.c_float]
            _has_q8 = True
        except AttributeError:
            _has_q8 = False
    _lib, _tried = lib, True
    return _lib


def have_native() -> bool:
    return _load() is not None


def available() -> bool:
    """Whether the compiled codec (every symbol: crc, framing, XOR-delta
    and int8 quantization) serves the calls, rather than the fallbacks."""
    return _load() is not None and _has_delta and _has_q8


def have_delta_native() -> bool:
    _load()
    return _has_delta


def have_q8_native() -> bool:
    _load()
    return _has_q8


def _addr(data: Buffer) -> tuple[ctypes.c_void_p, int, object]:
    """(pointer, length, keepalive) for a bytes-like object, copy-free
    where the buffer protocol allows it. The keepalive object must stay
    referenced for the duration of the native call."""
    if isinstance(data, bytes):
        return (ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p),
                len(data), data)
    mv = data if isinstance(data, memoryview) else memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    if not mv.contiguous:
        b = mv.tobytes()  # non-contiguous: copy is unavoidable
        return (ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p),
                len(b), b)
    n = mv.nbytes
    if n == 0:
        return ctypes.c_void_p(0), 0, mv
    if mv.readonly:
        # ctypes' from_buffer needs a writable buffer; a readonly view
        # over bytes already has a stable address via the bytes object
        obj = mv.obj
        if isinstance(obj, bytes) and len(obj) == n:
            return (ctypes.cast(ctypes.c_char_p(obj), ctypes.c_void_p),
                    n, obj)
        b = mv.tobytes()
        return (ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p),
                len(b), b)
    arr = (ctypes.c_ubyte * n).from_buffer(mv)
    # addressof, NOT ctypes.cast(arr, ...): cast's keepalive bookkeeping
    # puts the array into a reference cycle, so the buffer export it
    # holds survives until a gc pass — which pins shared-memory
    # segments (BufferError on SharedMemory.close) long after the call
    # returned. addressof is a plain int; the _keep tuple alone bounds
    # the export's lifetime to this call, released by refcount.
    return ctypes.c_void_p(ctypes.addressof(arr)), n, (arr, mv)


def crc32(data: Buffer, seed: int = 0) -> int:
    lib = _load()
    if lib is None:
        return zlib.crc32(data, seed) & 0xFFFFFFFF
    ptr, n, _keep = _addr(data)
    return int(lib.apex_crc32(ptr, n, seed))


def pack_records(chunks: list[Buffer]) -> bytes:
    """Gather chunks into one [u64 len][bytes]* frame (native memcpy)."""
    lib = _load()
    if lib is None:
        out = bytearray()
        for c in chunks:
            mv = c if isinstance(c, (bytes, bytearray)) \
                else memoryview(c).cast("B")
            out += len(mv).to_bytes(8, "little") + mv
        return bytes(out)
    n = len(chunks)
    srcs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_uint64 * n)()
    # keep refs so the buffers stay alive across the call
    keep = []
    total = 0
    for i, c in enumerate(chunks):
        ptr, ln, ka = _addr(c)
        keep.append(ka)
        srcs[i] = ptr
        lens[i] = ln
        total += ln + 8
    dst = ctypes.create_string_buffer(total)
    wrote = lib.apex_pack(ctypes.cast(dst, ctypes.c_void_p), srcs, lens, n)
    assert wrote == total, (wrote, total)
    return dst.raw


def _unpack_offsets(frame: Buffer,
                    max_records: int) -> list[tuple[int, int]]:
    """[(offset, length)] per record — the shared walk behind both the
    copying and memoryview unpack forms."""
    lib = _load()
    if lib is None:
        out, off = [], 0
        mv = frame if isinstance(frame, (bytes, bytearray)) \
            else memoryview(frame).cast("B")
        ln = len(mv)
        while off < ln:
            if off + 8 > ln:
                raise ValueError("malformed frame")
            rec = int.from_bytes(mv[off:off + 8], "little")
            off += 8
            if off + rec > ln:
                raise ValueError("malformed frame")
            out.append((off, rec))
            off += rec
        return out
    offs = (ctypes.c_uint64 * max_records)()
    lens = (ctypes.c_uint64 * max_records)()
    ptr, ln, _keep = _addr(frame)
    n = lib.apex_unpack_offsets(ptr, ln, offs, lens, max_records)
    if n == ctypes.c_uint64(-1).value:
        raise ValueError("malformed frame")
    return [(offs[i], lens[i]) for i in range(n)]


def unpack_records(frame: Buffer, max_records: int = 4096) -> list[bytes]:
    """Inverse of pack_records; raises ValueError on malformed frames."""
    return [bytes(frame[o:o + ln])
            for o, ln in _unpack_offsets(frame, max_records)]


def unpack_records_mv(frame: Buffer,
                      max_records: int = 4096) -> list[memoryview]:
    """Zero-copy unpack: memoryview slices into `frame` itself. The
    views alias the frame — the caller must keep the frame alive and
    unmodified while they are in use (the ingest staging path copies
    them into the staging block immediately; that landing is the ONE
    copy per wire byte)."""
    mv = memoryview(frame)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    return [mv[o:o + ln] for o, ln in _unpack_offsets(frame, max_records)]


# -- XOR-delta transform (wire codec "delta-deflate") -----------------------


def delta_encode(rows2d) -> "bytes":
    """XOR-delta a C-contiguous (rows, row_bytes) uint8 array along its
    leading axis: out[0] = rows2d[0], out[i] = rows2d[i] ^ rows2d[i-1].
    Returns the delta bytes (the deflate input on the encode side)."""
    import numpy as np

    a = np.ascontiguousarray(rows2d, dtype=np.uint8)
    lib = _load()
    if lib is None or not _has_delta or a.shape[0] == 0:
        out = np.empty_like(a)
        if a.shape[0]:
            out[0] = a[0]
            np.bitwise_xor(a[1:], a[:-1], out=out[1:])
        return out.tobytes()
    out = np.empty_like(a)
    dptr, _, dkeep = _addr(memoryview(out).cast("B"))
    sptr, _, skeep = _addr(memoryview(a).cast("B"))
    lib.apex_delta_encode(dptr, sptr, a.shape[0], a.shape[1])
    del dkeep, skeep
    return out.tobytes()


def delta_undo_inplace(rows2d) -> None:
    """Prefix-XOR undo IN PLACE on a writable C-contiguous
    (rows, row_bytes) uint8 array: rows2d[i] ^= rows2d[i-1] for
    i = 1..rows-1. Row 0 must already be absolute — on the ingest path
    the caller lands delta rows straight in the staging block, fixes
    row 0 up against the previous landed row, then calls this."""
    import numpy as np

    a = rows2d
    if a.shape[0] <= 1:
        return
    lib = _load()
    if lib is None or not _has_delta:
        # ufunc accumulate is the vectorized-per-row C path in numpy:
        # absolute[i] = delta[0] ^ delta[1] ^ ... ^ delta[i]
        np.bitwise_xor.accumulate(a, axis=0, out=a)
        return
    ptr, _, keep = _addr(memoryview(a).cast("B"))
    lib.apex_delta_undo(ptr, a.shape[0], a.shape[1])
    del keep


# -- int8 affine quantization (param codec "delta-q8") ----------------------
#
# The numpy fallbacks mirror the C kernels operation-for-operation in
# strict float32 (np.rint and nearbyintf both round half to even), so a
# native-enabled learner and a Python-only actor host reconstruct the
# SAME chain base — cross-impl parity is a wire contract here, pinned
# by test_param_codec.py.


def q8_encode(delta, lo: float, scale: float) -> bytes:
    """Quantize a C-contiguous float32 array to int8 bins:
    q = clip(rint((x - lo) / scale) - 127, -128, 127)."""
    import numpy as np

    a = np.ascontiguousarray(delta, dtype=np.float32).reshape(-1)
    lib = _load()
    if lib is None or not _has_q8 or a.size == 0:
        lo32, scale32 = np.float32(lo), np.float32(scale)
        q = np.rint((a - lo32) / scale32)
        return np.clip(q - np.float32(127.0), -128.0,
                       127.0).astype(np.int8).tobytes()
    out = np.empty(a.size, dtype=np.int8)
    dptr, _, dkeep = _addr(memoryview(out).cast("B"))
    sptr, _, skeep = _addr(memoryview(a).cast("B"))
    lib.apex_q8_encode(dptr, sptr, a.size,
                       ctypes.c_float(lo), ctypes.c_float(scale))
    del dkeep, skeep
    return out.tobytes()


def q8_dequant_add(base, q, lo: float, scale: float) -> None:
    """Dequantize-and-accumulate IN PLACE into a writable C-contiguous
    float32 array: base += (q + 127) * scale + lo — the decode side of
    q8_encode and the encoder's own chain advance."""
    import numpy as np

    b = base.reshape(-1)
    qa = np.frombuffer(q, dtype=np.int8) if not isinstance(q, np.ndarray) \
        else q.reshape(-1)
    if b.size != qa.size:
        raise ValueError(f"q8 length mismatch: base {b.size} vs q {qa.size}")
    lib = _load()
    if lib is None or not _has_q8 or b.size == 0:
        lo32, scale32 = np.float32(lo), np.float32(scale)
        d = (qa.astype(np.float32) + np.float32(127.0)) * scale32
        d += lo32
        b += d
        return
    bptr, _, bkeep = _addr(memoryview(b).cast("B"))
    qptr, _, qkeep = _addr(memoryview(qa).cast("B"))
    lib.apex_q8_dequant_add(bptr, qptr, b.size,
                            ctypes.c_float(lo), ctypes.c_float(scale))
    del bkeep, qkeep
