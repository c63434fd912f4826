"""Parameter-plane codec: delta + int8-quantized param broadcast.

Counterpart of ``ape_x_dqn_tpu/comm/param_codec.py`` without JAX or
``ml_dtypes``: trees flatten through `tree_flatten`, the port's own
flattener, which keeps JAX's leaf order for the containers that occur
(a dict by sorted keys, lists and tuples in order, None as an empty
subtree), so a coded payload one package encodes the other decodes; the
bf16 wire rounding is torch's round-to-nearest-even with NaNs written
as ``ml_dtypes`` writes them (`bf16_bits`). The learner publishes a
plain dict of numpy arrays (`tree_to_numpy`), never a torch tensor, so
a receiver needs neither the learner's torch build nor a card. The
legacy pickled blob (the raw plane) carries this module's `_Bf16Wire`
marker, so that plane is read by peers of the same package; the coded
(APXC) payloads and the experience wire are shared by both packages.

Params — `model_bytes x peers x publish_rate` of learner egress —
would otherwise be raw pickled blobs (bf16-downcast at best). This
module is the param-plane analogue of the experience codec: a
versioned-blob PROVIDER that is
the single source of truth for param bytes at a given (epoch, version)
— the legacy pickled blob, the shm seqlock area, local get_params, the
poll replies and every push subscriber all read it, so pull and push
can never disagree about the bytes for a version — plus a chain codec
("delta-q8") that ships each publish as a per-leaf delta against the
previous published version:

  - float32 leaves: delta vs the reconstruction chain, int8 AFFINE
    quantization (256 bins across the delta's [min, max] span; scale
    and offset ride the JSON meta), then deflate. The encoder advances
    its own chain through the DEQUANTIZED delta — exactly what every
    decoder holds — so quantization error never compounds across
    versions (each step's error is that step's residual alone,
    <= scale/2 per element).
  - constant deltas (unchanged leaves, global shifts) ship as a bias
    scalar in the meta — zero payload bytes ("z").
  - non-float leaves ship raw-if-changed ("a"), nothing if bytewise
    identical ("s").
  - per-leaf never-inflate guard: a quantized delta that would not
    undercut the absolute downcast leaf ships absolute instead; a
    whole payload that would not undercut the legacy APXV reply
    degrades to it (the codec can never inflate the param path, which
    is the `param_compression_ratio >= 1.0` floor obs --check gates).

Catch-up and resync: the provider caches the last `window` encoded
segments as a chain; a client that missed versions replays the chain
segments from its base in one payload. A base outside the window, an
unknown base, or an epoch bump (new learner incarnation) gets a FULL
resync payload (absolute leaves + the pytree structure), counted in
`param_resyncs`. Optimizer state never touches this path — only the
actor-side policy copy rides it, and the documented tolerance is
pinned by the quantized-policy parity smoke (PARITY.md).

Precision contract: coded reconstruction tracks the wire-dtype tree
(bf16-roundtripped f32 under the default param_wire_dtype) within one
quantization step of the latest delta; a client that seeded its chain
from a raw/APXV full starts within wire rounding of the provider's
chain and the offset stays CONSTANT (deltas are additive), collapsing
to zero at every full resync. Cross-implementation bit-parity of the
quantizer (native kernel vs numpy fallback, cpp/framing.cpp) is a wire
contract pinned by test_param_codec.py.

Wire shape (rides MSG_PARAMS / MSG_PARAMS_PUSH): a coded payload leads
with PARAMS_CODEC_MAGIC — distinct from the versioned-header magic
('APXV') and from a legacy pickle (0x80 first byte), so every receiver
build sniffs the right parser — followed by packed segments, each a
pack_records frame of [JSON head, buffers...]. Coded payloads are only
ever sent to peers that ASKED for the codec (hello "param_codecs"
offer for pushes, a "codec" field in the MSG_PARAMS_REQ JSON for
pulls); old<->new interop degrades silently to the raw paths both
ways, and the same-host shm seqlock area always carries the raw blob
(local bandwidth is free; cross-plane consistency is tested).
"""

from __future__ import annotations

import json
import pickle
import struct
import zlib
from collections import deque
from typing import Any

import numpy as np
import torch

from ape_x_dqn_tpu_torch.comm import native
from ape_x_dqn_tpu_torch.obs.health import make_lock

PARAM_CODECS = ("raw", "delta-q8")

# coded payload prefix: magic, membership epoch, version this payload
# reconstructs, base version the chain starts from (-1 = full resync).
# The magic's first wire byte (0x43 'C') collides with neither a legacy
# pickle (0x80) nor an APXV versioned header (0x56 'V').
_CODEC_HDR = struct.Struct("<Iqqq")
PARAMS_CODEC_MAGIC = 0x41505843  # 'APXC'

# versioned (non-coded) reply prefix — shared with socket_transport;
# defined here so the provider can emit both reply shapes
_PARAMS_HDR = struct.Struct("<Iqq")
PARAMS_HDR_MAGIC = 0x41505856  # 'APXV'

_Q8_SPAN = 254.0  # quantization bins spanning the delta's [min, max]
# params are a low-rate path (one encode per publish, not per batch):
# spend more deflate effort than the experience codec's Z_BEST_SPEED
_DEFLATE_LEVEL = 6


def check_param_codec(codec: str) -> str:
    if codec not in PARAM_CODECS:
        raise ValueError(
            f"param_codec must be one of {PARAM_CODECS}, got {codec!r}")
    return codec


# -- trees -------------------------------------------------------------------


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, skeleton) in JAX's leaf order: a dict's children by
    sorted key, a list's or tuple's in order, None an empty subtree,
    anything else a leaf. The skeleton is the tree with every leaf
    replaced by its index (what JAX's ``tree_unflatten(treedef,
    range(n))`` builds), so it pickles as plain containers and two
    skeletons compare with ``==``."""
    leaves: list = []

    def walk(x: Any) -> Any:
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            kids = [walk(v) for v in x]
            if isinstance(x, list):
                return kids
            return type(x)(*kids) if hasattr(x, "_fields") else tuple(kids)
        leaves.append(x)
        return len(leaves) - 1

    return leaves, walk(tree)


def tree_unflatten(skeleton: Any, leaves: list) -> Any:
    """Inverse of `tree_flatten`: the skeleton with each index replaced
    by its leaf."""

    def walk(s: Any) -> Any:
        if s is None:
            return None
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            kids = [walk(v) for v in s]
            if isinstance(s, list):
                return kids
            return type(s)(*kids) if hasattr(s, "_fields") else tuple(kids)
        return leaves[s]

    return walk(skeleton)


def tree_map(fn, tree: Any) -> Any:
    leaves, skeleton = tree_flatten(tree)
    return tree_unflatten(skeleton, [fn(x) for x in leaves])


def num_leaves(skeleton: Any) -> int:
    return len(tree_flatten(skeleton)[0])


def _leaf_to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tree_to_numpy(params: Any) -> Any:
    """Every leaf as a numpy array (a torch tensor is copied to the
    host; the driver publishes host copies already)."""
    return tree_map(_leaf_to_numpy, params) if params is not None else None


# -- bf16 wire rounding ------------------------------------------------------


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bit patterns of its bfloat16 rounding, to
    nearest even, as ``ml_dtypes`` rounds: torch does the rounding, and
    a NaN becomes ml_dtypes' quiet NaN with its sign kept (0x7FC0 /
    0xFFC0), where torch's vectorised cast writes 0xFFFF."""
    a = np.ascontiguousarray(x, dtype=np.float32)
    if not a.flags["WRITEABLE"]:
        a = a.copy()
    out = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16) \
        .numpy().view(np.uint16).copy()
    nan = np.isnan(a)
    if nan.any():
        out[nan] = np.where(np.signbit(a[nan]), 0xFFC0, 0x7FC0)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> float32 through bfloat16 (the wire's rounding)."""
    return bf16_bits_to_f32(bf16_bits(x)).reshape(np.shape(x))


# -- wire dtype helpers (shared with socket_transport) ----------------------


class _Bf16Wire:
    """Marker wrapping a leaf the SENDER downcast f32->bf16 for the
    wire (`a`: the uint16 bit patterns, in the leaf's shape). The
    receiver upcasts exactly these leaves back to float32 and leaves
    everything else untouched, so the wire never silently changes a
    tree's native dtypes."""

    __slots__ = ("a",)

    def __init__(self, a):
        self.a = a


def _downcast_f32(tree: Any) -> Any:
    """float32 leaves -> bf16 wrapped in _Bf16Wire for the wire (half
    the bytes; other dtypes — uint8 frames, ints, f64 — pass through
    untouched and untagged)."""

    def one(x):
        x = np.asarray(x)
        return _Bf16Wire(bf16_bits(x).reshape(x.shape)) \
            if x.dtype == np.float32 else x

    return tree_map(one, tree) if tree is not None else None


def _upcast_bf16(tree: Any) -> Any:
    """Restore sender-downcast leaves (_Bf16Wire markers) to float32;
    every other leaf keeps its wire dtype exactly (values carry the
    bf16 rounding; exactness is not a wire contract — see
    SocketIngestServer.param_wire_dtype)."""

    def one(x):
        return bf16_bits_to_f32(x.a) if isinstance(x, _Bf16Wire) else x

    return tree_map(one, tree) if tree is not None else None


# -- leaf encode/decode ------------------------------------------------------


def _decode_abs(m: dict, buf) -> np.ndarray:
    """Materialize one absolute ("a") leaf as a fresh writable array
    (it becomes chain state the q8 path mutates in place)."""
    raw = zlib.decompress(buf) if m.get("zl") else buf
    sh = m["sh"]
    if m.get("w") == "bf16":
        arr = np.frombuffer(raw, dtype=np.uint16)
        if arr.size != int(np.prod(sh, dtype=np.int64)):
            raise ValueError(f"abs leaf inflates to {arr.size} elements, "
                             f"expected shape {sh}")
        return bf16_bits_to_f32(arr).reshape(sh)
    arr = np.frombuffer(raw, dtype=np.dtype(m["dt"]))
    if arr.size != int(np.prod(sh, dtype=np.int64)):
        raise ValueError(f"abs leaf inflates to {arr.size} elements, "
                         f"expected shape {sh}")
    return arr.reshape(sh).copy()


def _deflate_maybe(m: dict, buf: bytes) -> bytes:
    """Per-leaf never-inflate deflate: tag "zl" only when it shrinks."""
    comp = zlib.compress(buf, _DEFLATE_LEVEL)
    if len(comp) < len(buf):
        m["zl"] = 1
        return comp
    return buf


def _abs_leaf(w: np.ndarray, wire_dtype: str) -> tuple[dict, bytes]:
    """Absolute leaf: f32 downcast to the wire dtype, everything else
    raw bytes; deflated when that shrinks it."""
    if w.dtype == np.float32 and wire_dtype == "bfloat16":
        m: dict = {"e": "a", "sh": list(w.shape), "dt": w.dtype.str,
                   "w": "bf16"}
        return m, _deflate_maybe(m, bf16_bits(w).tobytes())
    m = {"e": "a", "sh": list(w.shape), "dt": w.dtype.str}
    return m, _deflate_maybe(m, w.tobytes())


# -- server side: the one versioned-blob provider ---------------------------


class ParamBlobProvider:
    """Single source of truth for param bytes per (epoch, version).

    Owns the published tree, the legacy pickled blob (lazy, cached per
    version — also what the shm seqlock area and legacy/raw clients
    get), the local get_params tree cache (blob-roundtripped, so local
    and remote pulls see bit-identical values), and — when the codec is
    on — the delta chain: the float32 reconstruction every negotiated
    decoder holds, plus the last `window` encoded segments for
    catch-up. One lock guards all of it, so a pull reply, a push frame
    and the shm write can never pair a blob with the wrong version."""

    def __init__(self, wire_dtype: str = "bfloat16",
                 codec: str = "raw", window: int = 8):
        if wire_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"param_wire_dtype must be 'bfloat16' or 'float32', "
                f"got {wire_dtype!r}")
        self._wire_dtype = wire_dtype
        self.codec = check_param_codec(codec)
        self._window = max(1, int(window))
        self._lock = make_lock("param_provider._lock")
        self._params: tuple[Any, int] = (None, -1)  # guarded-by: _lock
        self._blob: bytes | None = pickle.dumps((None, -1))  # guarded-by: _lock
        self._tree_cache: tuple[Any, int] | None = None  # guarded-by: _lock
        # delta-chain state (all guarded-by: _lock): the reconstruction
        # leaves R (what every decoder holds after applying the chain),
        # the version/epoch R corresponds to, the pytree structure, the
        # recent segments, and the cached full-resync payload
        self._chain_epoch = -1  # guarded-by: _lock
        self._chain: deque[tuple[int, int, bytes]] = deque()  # guarded-by: _lock
        self._recon: list[np.ndarray] | None = None  # guarded-by: _lock
        self._recon_version = -1  # guarded-by: _lock
        self._treedef: Any = None  # guarded-by: _lock
        self._full: tuple[tuple[int, int], bytes] | None = None  # guarded-by: _lock

    @property
    def version(self) -> int:
        with self._lock:
            return self._params[1]

    @property
    def chain_len(self) -> int:
        """Encoded segments currently cached (test/obs seam)."""
        with self._lock:
            return len(self._chain)

    def publish(self, params: Any, version: int) -> None:
        """Store the tree; serialization/encoding stay lazy until the
        first reply needs them (publishing must not stall the learner
        thread on a multi-MB pickle when nobody is connected)."""
        with self._lock:
            self._params = (params, version)
            self._blob = None
            self._tree_cache = None

    # raw (legacy/APXV) plane

    def _build_blob_locked(self) -> bytes:
        """(Re)build the pickled param blob; caller holds self._lock.
        Reply paths read (blob, version) ATOMICALLY under the lock —
        pairing a blob with the version of a concurrent publish would
        let an up-to-date client skip a real update."""
        if self._blob is None:
            params, version = self._params
            host = tree_to_numpy(params)
            if self._wire_dtype == "bfloat16":
                host = _downcast_f32(host)
            self._blob = pickle.dumps(  # apexlint: unguarded(caller holds _lock)
                (host, version), protocol=pickle.HIGHEST_PROTOCOL)
        return self._blob

    def raw_blob(self) -> bytes:
        """Legacy pickled (tree, version) blob — what empty-payload
        (pre-versioning) clients receive verbatim."""
        with self._lock:
            return self._build_blob_locked()

    def raw_blob_versioned(self) -> tuple[bytes, int, Any]:
        """(blob, version, tree_cache_key) read atomically — the shm
        param-area writer's pairing."""
        with self._lock:
            blob = self._build_blob_locked()
            return blob, self._params[1], blob

    def get_tree(self) -> tuple[Any, int]:
        """Local loopback callers get the deserialized tree directly,
        cached per published version — no pickle round-trip per pull;
        the pickled blob stays wire-only. The cache still holds the
        BLOB-roundtripped values (bf16 wire rounding and all), so local
        and remote pulls see bit-identical params."""
        with self._lock:
            if self._tree_cache is not None:
                return self._tree_cache
        blob = self.raw_blob()
        params, version = pickle.loads(blob)
        out = (_upcast_bf16(params), version)
        with self._lock:
            # cache only if no newer publish invalidated the blob while
            # we deserialized outside the lock
            if self._blob is blob:
                self._tree_cache = out
        return out

    def versioned_reply(self, have_epoch: int, have_version: int,
                        epoch: int) -> tuple[bytes, str, int, int]:
        """APXV reply: [magic, epoch, version] header, plus the pickled
        blob only when the client is behind. Returns (payload, kind,
        version, raw_cost) — raw_cost is what the reply costs with no
        codec, the compression-ratio denominator's counterpart."""
        with self._lock:
            blob = self._build_blob_locked()
            version = self._params[1]
        hdr = _PARAMS_HDR.pack(PARAMS_HDR_MAGIC, epoch, version)
        if have_epoch == epoch and have_version == version:
            return hdr, "unchanged", version, len(hdr)
        return hdr + blob, "raw_full", version, len(hdr) + len(blob)

    # coded plane

    def coded_reply(self, have_epoch: int, have_version: int,
                    epoch: int) -> tuple[bytes, str, int, int]:
        """Best coded reply for a client holding (have_epoch,
        have_version): header-only "unchanged", a "delta" chain from
        the client's base, a coded "full" resync, or — whenever the
        coded form would not undercut it (payload-level never-inflate)
        — the APXV "raw_full". Returns (payload, kind, version,
        raw_cost)."""
        with self._lock:
            version = self._params[1]
            if version < 0:
                blob = self._build_blob_locked()
                hdr = _PARAMS_HDR.pack(PARAMS_HDR_MAGIC, epoch, version)
                return hdr + blob, "raw_full", version, \
                    _PARAMS_HDR.size + len(blob)
            if have_epoch == epoch and have_version == version:
                hdr = _PARAMS_HDR.pack(PARAMS_HDR_MAGIC, epoch, version)
                return hdr, "unchanged", version, len(hdr)
            self._extend_chain_locked(epoch)
            raw_cost = _PARAMS_HDR.size + len(self._build_blob_locked())
            if have_epoch == epoch and have_version >= 0:
                segs = self._segments_from_locked(have_version)
                if segs:
                    payload = _CODEC_HDR.pack(
                        PARAMS_CODEC_MAGIC, epoch, version,
                        have_version) + native.pack_records(segs)
                    if len(payload) < raw_cost:
                        return payload, "delta", version, raw_cost
            full = self._full_payload_locked(epoch)
            if len(full) < raw_cost:
                return full, "full", version, raw_cost
            hdr = _PARAMS_HDR.pack(PARAMS_HDR_MAGIC, epoch, version)
            return hdr + self._build_blob_locked(), "raw_full", \
                version, raw_cost

    def _wire_leaves_locked(self) -> tuple[list[np.ndarray], Any]:
        """Flatten the published tree to the WIRE-dtype leaves W the
        codec targets: f32 leaves bf16-roundtripped under the default
        wire dtype (identical values to what the raw path delivers),
        everything else as-is. Fulls and deltas both aim at W, so
        every entry point converges on the same values."""
        params, _ = self._params
        leaves, treedef = tree_flatten(tree_to_numpy(params))
        out = []
        for x in leaves:
            a = np.ascontiguousarray(x)
            if a.dtype == np.float32 and self._wire_dtype == "bfloat16":
                a = bf16_round(a)
            out.append(a)
        return out, treedef

    def _reset_chain_locked(self, epoch: int,
                            leaves: list[np.ndarray] | None = None,
                            treedef: Any = None,
                            version: int = -1) -> None:
        self._chain.clear()
        self._full = None  # apexlint: unguarded(caller holds _lock)
        self._chain_epoch = epoch  # apexlint: unguarded(caller holds _lock)
        # owned copies: chain leaves are mutated in place by the q8
        # advance, and under a float32 wire dtype the flatten may alias
        # the learner's own arrays
        recon = None if leaves is None else [np.array(x) for x in leaves]
        self._recon = recon  # apexlint: unguarded(caller holds _lock)
        self._treedef = treedef  # apexlint: unguarded(caller holds _lock)
        self._recon_version = version  # apexlint: unguarded(caller holds _lock)

    def _extend_chain_locked(self, epoch: int) -> None:
        """Advance the reconstruction chain to the published version,
        encoding one segment from wherever the chain last stood (the
        chain skips versions nobody ever requested — its nodes are the
        versions clients actually hold). Caller holds self._lock."""
        params, version = self._params
        if epoch != self._chain_epoch:
            # epoch bump: the old chain's bases belong to a dead
            # incarnation — every client crossing it resyncs full
            self._reset_chain_locked(epoch)
        if version < 0 or (self._recon is not None
                           and version == self._recon_version):
            return
        leaves, treedef = self._wire_leaves_locked()
        compatible = (
            self._recon is not None and treedef == self._treedef
            and len(leaves) == len(self._recon)
            and all(a.shape == b.shape and a.dtype == b.dtype
                    for a, b in zip(leaves, self._recon)))
        if not compatible:
            # first publish, or model surgery changed the structure:
            # the chain restarts here and outstanding bases resync
            self._reset_chain_locked(epoch, leaves, treedef, version)
            return
        seg, new_recon = self._encode_segment_locked(leaves, version)
        self._chain.append((self._recon_version, version, seg))
        while len(self._chain) > self._window:
            self._chain.popleft()
        self._recon = new_recon  # apexlint: unguarded(caller holds _lock)
        self._recon_version = version  # apexlint: unguarded(caller holds _lock)
        self._full = None  # apexlint: unguarded(caller holds _lock)

    def _encode_segment_locked(
            self, wire_leaves: list[np.ndarray],
            to_version: int) -> tuple[bytes, list[np.ndarray]]:
        metas: list[dict] = []
        bufs: list[bytes] = []
        new_recon: list[np.ndarray] = []
        assert self._recon is not None
        for r, w in zip(self._recon, wire_leaves):
            if w.dtype != np.float32:
                if np.array_equal(r, w):
                    metas.append({"e": "s"})
                    new_recon.append(r)
                else:
                    m, buf = _abs_leaf(w, self._wire_dtype)
                    metas.append(m)
                    bufs.append(buf)
                    new_recon.append(np.array(w))
                continue
            d = w - r
            lo = float(d.min()) if d.size else 0.0
            hi = float(d.max()) if d.size else 0.0
            if not (np.isfinite(lo) and np.isfinite(hi)):
                # non-finite deltas (inf/nan params) cannot quantize;
                # ship the leaf absolute and move on
                m, buf = _abs_leaf(w, self._wire_dtype)
                metas.append(m)
                bufs.append(buf)
                new_recon.append(np.array(w))
                continue
            if lo == hi:
                # constant delta (unchanged leaf / global shift): the
                # bias rides the meta, zero payload bytes
                metas.append({"e": "z", "b": lo})
                new_recon.append(r + np.float32(lo) if lo != 0.0 else r)
                continue
            scale = float(np.float32((hi - lo) / _Q8_SPAN))
            q = native.q8_encode(d, lo, scale)
            m = {"e": "q8", "lo": lo, "sc": scale}
            buf = _deflate_maybe(m, q)
            # per-leaf never-inflate guard: a quantized delta that does
            # not undercut the absolute downcast leaf ships absolute
            abs_bytes = w.size * (2 if self._wire_dtype == "bfloat16"
                                  else 4)
            if len(buf) >= abs_bytes:
                m, buf = _abs_leaf(w, self._wire_dtype)
                metas.append(m)
                bufs.append(buf)
                new_recon.append(np.array(w))
                continue
            metas.append(m)
            bufs.append(buf)
            # advance through the DEQUANTIZED delta — exactly what
            # every decoder computes — so error never compounds
            r2 = np.array(r)
            native.q8_dequant_add(r2, np.frombuffer(q, np.int8),
                                  lo, scale)
            new_recon.append(r2)
        head = {"full": 0, "v": to_version, "leaves": metas}
        seg = native.pack_records([json.dumps(head).encode()] + bufs)
        return seg, new_recon

    def _segments_from_locked(self, base_version: int) -> list[bytes] | None:
        """Chain segments replaying base_version -> current, or None
        when the base is not a cached chain node (out of window, never
        encoded, pre-reset) — the caller then resyncs full."""
        out: list[bytes] = []
        found = False
        for from_v, _to_v, seg in self._chain:
            if not found:
                if from_v != base_version:
                    continue
                found = True
            out.append(seg)
        return out if found else None

    def _full_payload_locked(self, epoch: int) -> bytes:
        """Coded full-resync payload: absolute wire-dtype leaves plus
        the pytree structure (a pickled leaf-index skeleton — the same
        container types the raw blob pickles anyway). Cached per
        (epoch, version)."""
        version = self._params[1]
        key = (epoch, version)
        if self._full is not None and self._full[0] == key:
            return self._full[1]
        leaves, treedef = self._wire_leaves_locked()
        metas, bufs = [], []
        for w in leaves:
            m, buf = _abs_leaf(w, self._wire_dtype)
            metas.append(m)
            bufs.append(buf)
        head = {"full": 1, "v": version, "leaves": metas}
        skeleton = treedef  # tree_flatten's treedef is the skeleton
        seg = native.pack_records(
            [json.dumps(head).encode(),
             pickle.dumps(skeleton, protocol=pickle.HIGHEST_PROTOCOL)]
            + bufs)
        payload = _CODEC_HDR.pack(PARAMS_CODEC_MAGIC, epoch, version,
                                  -1) + native.pack_records([seg])
        self._full = (key, payload)  # apexlint: unguarded(caller holds _lock)
        return payload


# -- client side: chain decoder ---------------------------------------------


# apexlint: unhandled(PARAMS_HDR_MAGIC) — the decoder only ever sees
# APXC bodies: the transport sniffs the tag first and routes raw APXV
# fulls through its legacy parser, seeding this chain via note_full()
class ParamChainDecoder:
    """Reconstruction state for coded param payloads: the float32
    leaves the chain stands at, the structure to unflatten them with,
    and the (epoch, version) they correspond to. NOT thread-safe — the
    owning transport serializes access (its pull and push-reader
    threads both land here)."""

    def __init__(self):
        self._leaves: list[np.ndarray] | None = None
        self._treedef: Any = None
        self._epoch = -1
        self._version = -1

    @property
    def version(self) -> int:
        return self._version

    def reset(self) -> None:
        self._leaves = None
        self._treedef = None
        self._epoch = -1
        self._version = -1

    def note_full(self, tree: Any, version: int, epoch: int) -> None:
        """Seed/refresh the chain base from a raw-path full (legacy or
        APXV blob): a client bootstrapped over the raw plane can still
        ride deltas afterwards. The seeded base sits within wire
        rounding of the provider's chain; the offset is constant and
        collapses at the next full."""
        leaves, treedef = tree_flatten(tree)
        self._leaves = [np.array(np.asarray(x)) for x in leaves]
        self._treedef = treedef
        self._version = int(version)
        self._epoch = int(epoch)

    def _tree(self) -> Any:
        assert self._leaves is not None
        return tree_unflatten(self._treedef, [x.copy() for x in self._leaves])

    def apply(self, payload) -> tuple[str, Any, int, int]:
        """Apply one coded payload: ("full", tree, version, epoch) on
        success (delta chains and full resyncs both land here — the
        tree is a fresh copy, safe to hand to the actor), or
        ("resync", None, version, epoch) when the payload's base is not
        what this chain holds (missed version / epoch bump / no state)
        — the caller must then re-pull with no base. Malformed payloads
        raise ValueError."""
        mv = memoryview(payload)
        if len(mv) < _CODEC_HDR.size:
            raise ValueError("coded param payload too short")
        magic, ep, ver, base = _CODEC_HDR.unpack_from(mv)
        if magic != PARAMS_CODEC_MAGIC:
            raise ValueError("not a coded param payload")
        segs = native.unpack_records_mv(mv[_CODEC_HDR.size:])
        if base == -1:
            if len(segs) != 1:
                raise ValueError(
                    f"full resync carries {len(segs)} segments")
            self._apply_full(segs[0], ver, ep)
            return "full", self._tree(), ver, ep
        if (self._leaves is None or self._epoch != ep
                or self._version != base):
            return "resync", None, ver, ep
        v = base
        for seg in segs:
            v = self._apply_delta(seg)
        if v != ver:
            raise ValueError(
                f"chain reached version {v}, payload advertised {ver}")
        self._version = ver
        self._epoch = ep
        return "full", self._tree(), ver, ep

    def _apply_full(self, seg, ver: int, ep: int) -> None:
        recs = native.unpack_records_mv(seg)
        head = json.loads(bytes(recs[0]))
        if not head.get("full"):
            raise ValueError("resync payload without a full segment")
        # the skeleton's leaves are numbered in leaf order, which both
        # packages share
        treedef = pickle.loads(recs[1])
        metas = head["leaves"]
        if num_leaves(treedef) != len(metas):
            raise ValueError(
                f"structure has {num_leaves(treedef)} leaves, "
                f"payload {len(metas)}")
        if len(recs) != 2 + len(metas):
            raise ValueError("full segment record count mismatch")
        leaves = []
        for i, m in enumerate(metas):
            if m.get("e") != "a":
                raise ValueError(
                    f"unexpected leaf encoding {m.get('e')!r} in full")
            leaves.append(_decode_abs(m, recs[2 + i]))
        self._leaves = leaves
        self._treedef = treedef
        self._version = ver
        self._epoch = ep

    def _apply_delta(self, seg) -> int:
        recs = native.unpack_records_mv(seg)
        head = json.loads(bytes(recs[0]))
        if head.get("full"):
            raise ValueError("unexpected full segment mid-chain")
        metas = head["leaves"]
        assert self._leaves is not None
        if len(metas) != len(self._leaves):
            raise ValueError(
                f"chain holds {len(self._leaves)} leaves, "
                f"segment carries {len(metas)}")
        bi = 1
        for i, m in enumerate(metas):
            e = m.get("e")
            if e == "s":
                continue
            if e == "z":
                b = float(m["b"])
                if b != 0.0:
                    self._leaves[i] += np.float32(b)
            elif e == "q8":
                buf = recs[bi]
                bi += 1
                q = zlib.decompress(buf) if m.get("zl") else buf
                leaf = self._leaves[i]
                if leaf.dtype != np.float32:
                    raise ValueError(
                        f"q8 delta against non-f32 leaf {leaf.dtype}")
                native.q8_dequant_add(leaf, np.frombuffer(q, np.int8),
                                      float(m["lo"]), float(m["sc"]))
            elif e == "a":
                buf = recs[bi]
                bi += 1
                self._leaves[i] = _decode_abs(m, buf)
            else:
                raise ValueError(f"unknown param leaf encoding {e!r}")
        if bi != len(recs):
            raise ValueError("delta segment record count mismatch")
        return int(head["v"])
