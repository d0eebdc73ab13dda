"""Live checkpoint transport: a recovering replica fetches weights from a
healthy peer over HTTP instead of from disk.

The port of ``torchft_tpu/checkpointing.py``'s ``CheckpointTransport``
and ``CheckpointServer``. The gate discipline is the same: the server
starts disallowed; ``send_checkpoint`` publishes a state dict for exactly
one step and allows reads; ``disallow_checkpoint`` (called from
``Manager.should_commit``) re-locks it so the dict is never read while
the optimizer mutates it. A request for any other step gets a 400.

Three paths, tried in this order by the receiver:

- **stream** (the default): the streamed zero-copy heal. The donor lays
  the published dict out once per (publish, wire) — a skeleton tree whose
  array leaves are :class:`_ArraySlot` placeholders, and per-leaf byte
  offsets into one packed stream — and copies every leaf into one host
  staging buffer laid out as that stream (pinned, one copy per leaf, on
  a side stream that waits for the writer of the state). Range requests
  (``/checkpoint/{step}/stream/{i}/{n}/{wire}/{seq}``) are then
  ``memoryview`` slices of that buffer, each with its CRC32C in the
  ``X-TFT-Crc32c`` header; only the skeleton (``/streammeta/{wire}``) is
  pickled. The staging is taken under the gate, so its ranges need
  neither the gate nor a drain: a healer that read the meta of a
  publish finishes from it even after ``disallow_checkpoint``, and the
  next publish replaces it (its nonce turns older ranges into 400s).
  The receiver ``readinto``\\ s N ranges over N connections into
  one preallocated (pinned) buffer, verifies each range's CRC as it
  reads, rebuilds each leaf as a ``torch.frombuffer`` view the moment its
  bytes are covered and uploads it ``non_blocking`` to its device while
  later ranges are still arriving. ``wire="bf16"`` narrows the f32 leaves
  under an ``opt_state`` key (K3, one segmented launch per device on the
  card) and the receiver widens them back on the device (exact);
  everything else ships raw, so healed weights are bit-identical to the
  donor's. The layout, offsets and range bytes are the JAX package's
  byte for byte for the same tree.
- **striped**: the pickled dict as N byte ranges over N connections
  (``/checkpoint/{step}/part/{i}/{n}``), from a per-publish pickle cache.
- **single**: the pickled dict streamed over one connection with chunked
  transfer encoding.

A 404 or 500 (a peer without the endpoint, or a gate timeout) or a
:class:`WireCorruption` falls through to the next path after the
surviving range readers are cancelled; a ``TimeoutError`` raises, since
the stream already spent the caller's budget. The pickle paths return
numpy leaves through a safelisted unpickler (numpy array reconstructors,
numpy and ``collections`` classes, a narrow set of data builtins, this
module's ``_ArraySlot``; never ``torch.load``); the stream path returns
tensors on the receiver's device. Knobs: ``TORCHFT_HEAL_WIRE`` (``bf16``
or none), ``TORCHFT_HEAL_STREAMS`` (default: the stripes),
``TORCHFT_CKPT_STRIPES`` (default 4).

The endpoint is unauthenticated HTTP: the checkpoint port must only be
reachable inside the training cluster's trusted network.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
import socket
import threading
import time
import urllib.error
import urllib.request
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Generic, List, Optional, Tuple, TypeVar, Union

import numpy as np
import torch

from ._device import resolve_device
from ._native import (
    WireCorruption,
    crc32c as _crc32c,
    crc32c_update as _crc32c_update,
)
from ._tree import flatten, flatten_with_path, is_opt_state_path, tree_map, unflatten
from .ops.quantize_kernels import cast_bf16_group

logger: logging.Logger = logging.getLogger(__name__)

T = TypeVar("T")


class CheckpointTransport(Generic[T], ABC):
    """Pluggable live-recovery transport."""

    @abstractmethod
    def metadata(self) -> str:
        """Transport metadata (e.g. the URL prefix) recovering replicas
        need; shipped to peers through the quorum RPC."""

    @abstractmethod
    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: T, timeout: timedelta,
        stream: Optional[torch.cuda.Stream] = None,
    ) -> None:
        """Makes ``state_dict`` for ``step`` available to ``dst_ranks``.
        ``stream``: the CUDA stream the state was last written on (default:
        the calling thread's current stream); reads of card leaves wait
        for it."""

    def disallow_checkpoint(self) -> None:
        """Called once the training loop may mutate the state dict again."""

    @abstractmethod
    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: timedelta
    ) -> T:
        """Fetches the state dict for ``step`` from the peer described by
        ``metadata``."""

    def shutdown(self, wait: bool = True) -> None:
        ...


def _to_host(tree: Any) -> Any:
    """Every tensor leaf becomes a numpy array (a host copy for card
    tensors), for the pickle paths. bf16 has no numpy dtype without extra
    packages; such state is refused here rather than silently widened
    (the stream path carries it)."""

    def leaf(l: Any) -> Any:
        if isinstance(l, torch.Tensor):
            if l.dtype == torch.bfloat16:
                raise TypeError(
                    "bf16 tensors have no numpy form on the pickled heal "
                    "paths; the stream path carries them"
                )
            return l.detach().cpu().numpy()
        return l

    return tree_map(leaf, tree)


def serialize_state_dict(state_dict: Any) -> bytes:
    """Pickles a tree with all tensor leaves on the host as numpy."""
    buf = io.BytesIO()
    dump_state_dict_stream(state_dict, buf)
    return buf.getvalue()


def dump_state_dict_stream(state_dict: Any, fileobj: Any) -> None:
    """Streams the pickled tree (tensor leaves as host numpy) into
    ``fileobj``, e.g. a socket's writer: pickle emits as it goes, so the
    payload is never one bytes object. :func:`load_state_dict_stream`
    reads it back."""
    pickle.dump(_to_host(state_dict), fileobj, protocol=pickle.HIGHEST_PROTOCOL)


class _ChunkedWriter:
    """HTTP/1.1 chunked transfer encoder over a handler's ``wfile``."""

    def __init__(self, wfile: Any) -> None:
        self._wfile = wfile

    def write(self, data: Any) -> int:
        # protocol-5 pickle passes PickleBuffer objects; a flat memoryview
        # streams any buffer-protocol payload without a copy
        mv = memoryview(data).cast("B")
        if mv.nbytes:
            self._wfile.write(f"{mv.nbytes:x}\r\n".encode("ascii"))
            self._wfile.write(mv)
            self._wfile.write(b"\r\n")
        return mv.nbytes

    def close(self) -> None:
        self._wfile.write(b"0\r\n\r\n")


# CLASSES from these module roots may be constructed by a checkpoint
# (extend with register_safe_modules). Not this package: a payload
# resolving its helpers could widen the list mid-load.
_SAFE_MODULE_ROOTS = {"numpy", "collections"}
# The numpy array pickle format's reconstructors, and the stream
# skeleton's frozen data-only placeholder: the only non-class-root
# globals a checkpoint may reference (a REDUCE on an arbitrary function
# is the pickle code-execution primitive).
_SAFE_EXACT = frozenset({
    ("torchft_tpu_torch.checkpointing", "_ArraySlot"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
})
# Builtins narrowed to data constructors.
_SAFE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "range", "set", "slice", "str", "tuple",
})


def register_safe_modules(*roots: str) -> None:
    """Allows CLASSES from more top-level modules (e.g. a package holding
    custom state classes) in incoming checkpoints. Call at startup on
    every replica: the set is snapshotted when a load begins, so a
    payload cannot extend it mid-load."""
    _SAFE_MODULE_ROOTS.update(roots)


class _SafeUnpickler(pickle.Unpickler):
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._roots = frozenset(_SAFE_MODULE_ROOTS)

    def find_class(self, module: str, name: str) -> Any:
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if (module, name) in _SAFE_EXACT:
            return super().find_class(module, name)
        if module.partition(".")[0] in self._roots:
            obj = super().find_class(module, name)
            if isinstance(obj, type):  # classes only, never functions
                return obj
        raise pickle.UnpicklingError(
            f"checkpoint references disallowed global {module}.{name}; if "
            "this is your own state CLASS, call "
            "torchft_tpu_torch.checkpointing.register_safe_modules"
            f"({module.partition('.')[0]!r}) on every replica"
        )


def load_state_dict_stream(fileobj: Any) -> Any:
    """Safelisted unpickle reading incrementally from ``fileobj``."""
    return _SafeUnpickler(fileobj).load()


def deserialize_state_dict(raw: bytes) -> Any:
    """Inverse of :func:`serialize_state_dict` through the safelist."""
    return _SafeUnpickler(io.BytesIO(raw)).load()


# -- streamed zero-copy heal --------------------------------------------------

# readinto granularity on the receiver, and the grain at which a leaf
# whose bytes are covered becomes eligible for its upload
_STREAM_CHUNK = 1 << 20

# torch dtype <-> the numpy-style name a slot carries (the JAX package's
# names: ``np.dtype.name``, ml_dtypes' ``bfloat16``)
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
    torch.complex64: "complex64", torch.complex128: "complex128",
}
_DTYPES_BY_NAME = {name: dt for dt, name in _DTYPE_NAMES.items()}


def _dtype_name(dtype: torch.dtype) -> str:
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no heal stream encoding for {dtype}") from None


def _dtype_by_name(name: str) -> torch.dtype:
    try:
        return _DTYPES_BY_NAME[name]
    except KeyError:
        raise TypeError(f"no heal stream decoding for {name!r}") from None


@dataclass(frozen=True)
class _ArraySlot:
    """Placeholder for one array leaf in the stream skeleton: where its
    bytes live in the packed stream and how to decode them. Pure data —
    safe to rebuild from an untrusted payload (safelisted exactly)."""

    shape: Tuple[int, ...]
    dtype: str       # the leaf's dtype name (what the receiver restores)
    wire_dtype: str  # as shipped ("bfloat16" when narrowed on the wire)
    offset: int      # byte offset into the packed stream
    nbytes: int


def _array_leaf(leaf: Any) -> Optional[torch.Tensor]:
    """A tensor view of an array leaf (tensors, numpy arrays), or None for
    a leaf that rides the skeleton pickle (scalars, strings, ...)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.asarray(leaf, order="C"))
    return None


def _heal_wire_from_env() -> Optional[str]:
    wire = os.environ.get("TORCHFT_HEAL_WIRE", "").strip().lower()
    if wire in ("", "none", "f32", "raw"):
        return None
    if wire != "bf16":
        raise ValueError(f"unsupported TORCHFT_HEAL_WIRE: {wire!r}")
    return wire


def _first_cuda_device(state_dict: Any) -> Optional[torch.device]:
    for leaf in flatten(state_dict)[0]:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A tensor's elements as flat contiguous bytes."""
    return t.contiguous().reshape(-1).view(torch.uint8)


class _StreamStaging:
    """A packed-stream staging of a state tree: the layout (``meta``: the
    skeleton and the packed total) and a host buffer holding the bytes.
    The streamed heal builds one per (publish, wire); the durable tier
    and the serving plane build one per snapshot or version.

    Card leaves reach the buffer on a side stream that first waits on
    ``ready`` (a device and an event recorded there on the stream that
    wrote the state; else the current stream), and the build blocks until
    the copies land, so the gate lock it is built under orders it before
    the next optimizer update. Under ``wire="bf16"`` the ``opt_state``
    f32 leaves are narrowed on their device first (on the card one
    segmented K3 call over all of them, a launch per 64 leaves; on the
    CPU its plain version), which halves their copy.

    ``shard_of=(rank, world)`` limits the capture to one member's shard:
    the layout and ``total`` follow from shapes alone, then only the
    bytes in ``[total*rank//world, total*(rank+1)//world)`` are copied
    (the floor split of ``durable.shard_bounds``). A leaf that straddles
    an edge gives only its in-range elements, the span widened outward to
    whole wire elements; ``captured_bytes`` counts what was copied, and a
    read outside the shard raises. The buffer always owns its bytes (a
    copy, unlike the JAX package's views of immutable arrays), so a
    staging may outlive the step it captured: every staging is a
    snapshot, and the JAX package's ``snapshot`` switch has no
    counterpart.

    ``zero_copy`` (card leaves only): the capture is one device-side copy
    of the shard's bytes on the current stream, behind which the
    trainer's next update queues, plus an event; the d2h into the host
    buffer runs at the first read (the durable writer thread) behind
    that event. The trainer's stall is then the device copy alone, not
    the d2h. Leaves off the card take the copying path."""

    def __init__(
        self, state_dict: Any, wire: Optional[str], seq: int = 0,
        ready: Optional[Tuple[torch.device, torch.cuda.Event]] = None,
        shard_of: Optional[Tuple[int, int]] = None,
        zero_copy: bool = False,
    ) -> None:
        t0 = time.perf_counter()
        self.seq = seq
        leaves_with_path, treedef = flatten_with_path(state_dict)
        # Layout first: offsets and wire dtypes follow from shapes alone.
        plan: List[Tuple[torch.Tensor, bool, int, int]] = []
        skeleton_leaves: List[Any] = []
        offset = 0
        for path, leaf in leaves_with_path:
            t = _array_leaf(leaf)
            if t is None:
                skeleton_leaves.append(leaf)
                continue
            narrow = (wire == "bf16" and t.dtype == torch.float32
                      and is_opt_state_path(path))
            wdtype = torch.bfloat16 if narrow else t.dtype
            shape = tuple(int(d) for d in t.shape)
            nbytes = int(np.prod(shape, dtype=np.int64)) * wdtype.itemsize
            skeleton_leaves.append(_ArraySlot(
                shape=shape, dtype=_dtype_name(t.dtype),
                wire_dtype=_dtype_name(wdtype), offset=offset, nbytes=nbytes,
            ))
            plan.append((t, narrow, offset, nbytes))
            offset += nbytes
        self.total = offset
        if shard_of is not None:
            rank, world = shard_of
            if world < 1 or not 0 <= rank < world:
                raise ValueError(f"bad shard {rank} of {world}")
            begin, end = offset * rank // world, offset * (rank + 1) // world
        else:
            begin, end = 0, offset
        self._range = (begin, end)
        # The in-range element slice of every leaf that meets the range:
        # (flat slice, narrow, stream offset, bytes).
        ents: List[Tuple[torch.Tensor, bool, int, int]] = []
        for t, narrow, off, nbytes in plan:
            if off >= end or off + nbytes <= begin:
                continue
            ws = 2 if narrow else t.element_size()
            lo = (max(begin, off) - off) // ws * ws
            hi = min(nbytes, -(-(min(end, off + nbytes) - off) // ws) * ws)
            ents.append((t.reshape(-1)[lo // ws:hi // ws], narrow, off + lo,
                         hi - lo))
        # contiguous in the stream: [first slice's start, last slice's end)
        self._base = ents[0][2] if ents else begin
        self.captured_bytes = (ents[-1][2] + ents[-1][3] - self._base
                               if ents else 0)
        self._lock = threading.Lock()
        # zero_copy: (card buffer, event after its copy, [(lo, hi)] runs)
        self._pending: Optional[Tuple[torch.Tensor, Any, list]] = None
        on_card = any(t.is_cuda for t, _, _, _ in ents)
        t1 = time.perf_counter()
        if zero_copy and ents and all(t.is_cuda for t, _, _, _ in ents) \
                and len({t.device for t, _, _, _ in ents}) == 1:
            self.buffer: Optional[torch.Tensor] = None
            self._view: Optional[memoryview] = None
            t2 = t1
            self._capture_on_card(ents, ready)
        else:
            self._set_buffer(torch.empty(self.captured_bytes,
                                         dtype=torch.uint8,
                                         pin_memory=on_card))
            t2 = time.perf_counter()
            self._capture(ents, ready)
        t3 = time.perf_counter()
        buf = io.BytesIO()
        pickle.dump(
            {"v": 1, "wire": wire, "total": offset, "seq": seq,
             "skeleton": unflatten(treedef, skeleton_leaves)},
            buf, protocol=pickle.HIGHEST_PROTOCOL,
        )
        self.meta = buf.getvalue()
        # what the build cost its caller (the stall of a durable
        # capture), and its parts: the layout, the host buffer's
        # allocation, the copies (waiting for the state's writer
        # included), the meta pickle
        self.build_s = time.perf_counter() - t0
        self.split = {"layout_s": t1 - t0, "alloc_s": t2 - t1,
                      "copy_s": t3 - t2, "meta_s": self.build_s - (t3 - t0)}

    def _set_buffer(self, buffer: torch.Tensor) -> None:
        self.buffer = buffer
        self._view = memoryview(buffer.numpy()).cast("B")

    def _capture(self, ents, ready) -> None:
        by_device: Dict[torch.device, list] = {}
        for ent in ents:
            by_device.setdefault(ent[0].device, []).append(ent)
        for device, dents in by_device.items():
            if device.type != "cuda":
                self._copy_in(dents, self.buffer)
                continue
            side = torch.cuda.Stream(device)
            if ready is not None and ready[0] == device:
                side.wait_event(ready[1])
            else:
                side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self._copy_in(dents, self.buffer)
                done = side.record_event()
            done.synchronize()

    def _capture_on_card(self, ents, ready) -> None:
        """The zero-copy capture: the shard's bytes into one card buffer
        on the current stream (the trainer's next update queues behind
        the copy), an event after it; :meth:`_host_view` moves them."""
        device = ents[0][0].device
        cur = torch.cuda.current_stream(device)
        if ready is not None and ready[0] == device:
            cur.wait_event(ready[1])
        dev = torch.empty(self.captured_bytes, dtype=torch.uint8,
                          device=device)
        self._copy_in(ents, dev)
        self._pending = (dev, cur.record_event(), [(0, self.captured_bytes)])

    def _copy_in(self, ents, dst: torch.Tensor) -> None:
        """Copies leaf slices of one device into ``dst`` at their stream
        offsets less the staging's base (on the current stream),
        narrowing the marked ones with one K3 launch over all of them."""
        narrow = [t for t, n, _, _ in ents if n]
        words = None
        if narrow:
            words = torch.empty(sum(t.numel() for t in narrow),
                                dtype=torch.bfloat16, device=narrow[0].device)
            cast_bf16_group(narrow, words)
        at = 0
        for t, n, off, nbytes in ents:
            if n:
                src = words[at:at + t.numel()]
                at += t.numel()
            else:
                src = t
            if nbytes:
                rel = off - self._base
                dst[rel:rel + nbytes].copy_(
                    _bytes_of(src), non_blocking=t.is_cuda and not dst.is_cuda)

    def _host_view(self) -> memoryview:
        """The host bytes, moving a zero-copy capture's card buffer down
        first (once, on a side stream behind the capture's event)."""
        with self._lock:
            if self._pending is not None:
                dev, event, runs = self._pending
                self._set_buffer(torch.empty(self.captured_bytes,
                                             dtype=torch.uint8,
                                             pin_memory=True))
                side = torch.cuda.Stream(dev.device)
                side.wait_event(event)
                with torch.cuda.stream(side):
                    for lo, hi in runs:
                        self.buffer[lo:hi].copy_(dev[lo:hi], non_blocking=True)
                side.synchronize()
                self._pending = None  # the card buffer goes
            return self._view

    def _slice(self, begin: int, end: int) -> memoryview:
        cb, ce = self._range
        if begin < cb or end > ce:
            raise ValueError(
                f"range [{begin}, {end}) outside captured span [{cb}, {ce}) "
                "of a shard-limited staging")
        return self._host_view()[begin - self._base:end - self._base]

    def write_range(self, wfile: Any, begin: int, end: int) -> None:
        """Streams bytes [begin, end) of the packed layout into ``wfile``
        as one slice of the staging buffer."""
        if begin < end:
            wfile.write(self._slice(begin, end))

    def range_crc32c(self, begin: int, end: int) -> int:
        """CRC32C over bytes [begin, end): the ``X-TFT-Crc32c`` header of a
        range response, over exactly what :meth:`write_range` ships."""
        return _crc32c(self._slice(begin, end) if begin < end else b"")


def load_packed_meta(raw: bytes) -> Dict[str, Any]:
    """Safelisted unpickle of a packed-stream meta blob (a
    :class:`_StreamStaging`'s ``meta``): the layout skeleton and the wire
    parameters, never code."""
    meta = _SafeUnpickler(io.BytesIO(raw)).load()
    if not isinstance(meta, dict) or "skeleton" not in meta:
        raise ValueError("packed meta blob missing skeleton")
    return meta


def rebuild_from_packed(
    meta: Dict[str, Any], buf: Any, *,
    device: Optional[Union[str, torch.device]] = None,
) -> Any:
    """The state tree of a packed byte buffer laid out by
    :class:`_StreamStaging` (all ``meta['total']`` bytes: a durable
    snapshot reassembled from its shards, or a verified serving version),
    its leaves on ``device`` (``None``: the card). On the CPU a leaf is a
    view of ``buf`` (a copy of it when ``buf`` is read-only); on the card
    the whole buffer goes up in one copy and the leaves are views of it.
    ``buf`` may also be a 1-D uint8 tensor, on the host or already on
    ``device`` (the durable restore uploads it first, to time the upload
    apart). Wire-narrowed leaves (the bf16 opt-state) widen back to their
    dtype (exact)."""
    device = resolve_device(device)
    total = int(meta["total"])
    if isinstance(buf, torch.Tensor):
        if buf.dtype != torch.uint8 or buf.dim() != 1 or buf.numel() < total:
            raise ValueError(
                f"packed buffer {buf.dtype} {tuple(buf.shape)}, layout "
                f"needs {total} uint8 bytes")
        base = buf[:total].to(device)
    else:
        view = memoryview(buf).cast("B")
        if view.nbytes < total:
            raise ValueError(
                f"packed buffer holds {view.nbytes} bytes, layout needs "
                f"{total}")
        if view.readonly:
            view = memoryview(bytearray(view[:total]))
        host = (torch.frombuffer(view, dtype=torch.uint8, count=total)
                if total else torch.empty(0, dtype=torch.uint8))
        base = host if device.type == "cpu" else host.to(device)
    slots, treedef = flatten(meta["skeleton"])
    out: List[Any] = []
    for slot in slots:
        if not isinstance(slot, _ArraySlot):
            out.append(slot)
            continue
        wdtype = _dtype_by_name(slot.wire_dtype)
        odtype = _dtype_by_name(slot.dtype)
        raw = base[slot.offset:slot.offset + slot.nbytes]
        if slot.offset % wdtype.itemsize:
            raw = raw.clone()  # a dtype view needs an aligned offset
        leaf = raw.view(wdtype).reshape(slot.shape)
        out.append(leaf if wdtype == odtype else leaf.to(odtype))
    return unflatten(treedef, out)


class _TimedAcquire:
    """Lock acquire with timeout that raises instead of returning False."""

    def __init__(self, lock: threading.Lock, timeout: timedelta) -> None:
        self._lock = lock
        self._timeout = timeout

    def __enter__(self) -> None:
        if not self._lock.acquire(timeout=self._timeout.total_seconds()):
            raise TimeoutError(
                f"timed out acquiring checkpoint lock after {self._timeout}"
            )

    def __exit__(self, *exc: object) -> None:
        self._lock.release()


class CheckpointServer(CheckpointTransport[T]):
    """Threaded HTTP server for the heal's three paths (module docstring).

    Starts disallowed: requests block on the gate lock until
    ``send_checkpoint`` publishes a dict, and re-block after
    ``disallow_checkpoint``. ``device`` is where :meth:`recv_checkpoint`
    uploads a streamed heal (``None``: the card)."""

    def __init__(
        self, timeout: timedelta = timedelta(seconds=30),
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self._checkpoint_lock = threading.Lock()
        self._disallowed = False
        self._step = -1
        self._timeout = timeout
        self._device = resolve_device(device)
        self._state_dict: Any = None
        # (device, event) the published state's writer had reached when
        # it was published (card leaves)
        self._ready: Optional[Tuple[torch.device, torch.cuda.Event]] = None
        # one pickle per publish, backing the striped /part/ endpoint
        self._serialized: Optional[bytes] = None
        self._serialized_step = -1
        # Stream stagings of the current publish, one per wire: host
        # copies, so their ranges are served without the gate, and they
        # outlive disallow_checkpoint until the next publish replaces them.
        # Guarded by _stream_lock (the gate only orders their build).
        self._stagings: Dict[Optional[str], _StreamStaging] = {}
        self._stagings_step = -1
        # Publish nonce, bumped by every allow_checkpoint: a range request
        # carries the nonce of its meta, so a republish in between (same
        # step included) 400s instead of serving a torn mix of two dicts.
        self._publish_seq = 0
        # /stream/ responses in flight
        self._stream_inflight = 0
        self._stream_lock = threading.Lock()
        # What the last recv_checkpoint measured: path, wire, streams,
        # bytes, fetch_s, h2d_s (the stream path), for heal attribution.
        self.last_fetch_stats: Optional[Dict[str, Any]] = None
        # the native library (the ranges' CRC32C) loads, or builds, now:
        # not inside the first range request, under a healer's timeout
        _crc32c(b"")

        # Gate starts held: nothing readable until the first send.
        self.disallow_checkpoint()

        ckpt_server = self

        class RequestHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self) -> None:
                try:
                    prefix = "/checkpoint/"
                    if not self.path.startswith(prefix):
                        self.send_error(404, "unknown path")
                        return
                    rest = self.path[len(prefix):].split("/")
                    if len(rest) == 4 and rest[1] == "part":
                        # /checkpoint/{step}/part/{i}/{n}
                        self._serve_part(int(rest[0]), int(rest[2]),
                                         int(rest[3]))
                        return
                    if len(rest) == 3 and rest[1] == "streammeta":
                        # /checkpoint/{step}/streammeta/{wire}
                        self._serve_stream_meta(int(rest[0]), rest[2])
                        return
                    if len(rest) == 6 and rest[1] == "stream":
                        # /checkpoint/{step}/stream/{i}/{n}/{wire}/{seq}
                        self._serve_stream_part(
                            int(rest[0]), int(rest[2]), int(rest[3]),
                            rest[4], int(rest[5]),
                        )
                        return
                    if len(rest) != 1:
                        self.send_error(404, "unknown path")
                        return
                    with _TimedAcquire(ckpt_server._checkpoint_lock,
                                   ckpt_server._timeout):
                        if not self._step_ok(int(rest[0])):
                            return
                        # Device -> host before the 200 is committed, so a
                        # failed copy still gets a clean 500.
                        host_tree = _to_host(ckpt_server._state_dict)
                        self.send_response(200)
                        self.send_header(
                            "Content-Type", "application/octet-stream"
                        )
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                        out = _ChunkedWriter(self.wfile)
                        pickle.dump(
                            host_tree, out, protocol=pickle.HIGHEST_PROTOCOL
                        )
                        out.close()
                except Exception as e:  # noqa: BLE001 - report to the peer
                    logger.exception("checkpoint server error")
                    try:
                        self.send_error(500, str(e))
                    except Exception:
                        pass

            def _step_ok(self, requested: int) -> bool:
                """Under the gate lock: 400 unless ``requested`` is the
                published step."""
                step = ckpt_server._step
                if requested != step:
                    self.send_error(
                        400,
                        f"invalid checkpoint requested: serving {step} but "
                        f"got {requested}",
                    )
                    return False
                return True

            def _serve_part(self, requested: int, i: int, n: int) -> None:
                """One byte range of the pickled dict. The gate lock is
                held only to check the step and build the cache, not while
                the body streams (the N parts would serialize); the cache
                is immutable bytes, so a disallow cannot tear it."""
                if n < 1 or not (0 <= i < n):
                    self.send_error(404, f"bad part {i}/{n}")
                    return
                with _TimedAcquire(ckpt_server._checkpoint_lock,
                                   ckpt_server._timeout):
                    if not self._step_ok(requested):
                        return
                    payload = ckpt_server._serialized
                    if payload is None or \
                            ckpt_server._serialized_step != requested:
                        payload = serialize_state_dict(ckpt_server._state_dict)
                        ckpt_server._serialized = payload
                        ckpt_server._serialized_step = requested
                start = len(payload) * i // n
                end = len(payload) * (i + 1) // n
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(end - start))
                self.end_headers()
                self.wfile.write(memoryview(payload)[start:end])

            def _staging_for(
                self, requested: int, wire_tok: str, seq: Optional[int] = None,
            ) -> Optional[_StreamStaging]:
                """The staging for ``wire_tok`` of the published step. A
                range request (``seq`` given) whose staging exists is
                served from it without the gate, and counts as in flight.
                Otherwise the step (and a range's nonce) are checked and
                the staging is built from the live state under the gate
                lock. Returns None after having sent an error."""
                wire = None if wire_tok in ("none", "f32", "raw") else wire_tok
                if wire not in (None, "bf16"):
                    self.send_error(404, f"unknown heal wire {wire_tok!r}")
                    return None
                if seq is not None:
                    with ckpt_server._stream_lock:
                        staging = ckpt_server._stagings.get(wire)
                        if (staging is not None and staging.seq == seq
                                and ckpt_server._stagings_step == requested):
                            ckpt_server._stream_inflight += 1
                            return staging
                with _TimedAcquire(ckpt_server._checkpoint_lock,
                                   ckpt_server._timeout):
                    if not self._step_ok(requested):
                        return None
                    if seq is not None and seq != ckpt_server._publish_seq:
                        self.send_error(
                            400,
                            f"stale publish: serving seq "
                            f"{ckpt_server._publish_seq}, range asked for "
                            f"{seq}",
                        )
                        return None
                    with ckpt_server._stream_lock:
                        staging = ckpt_server._stagings.get(wire)
                    if staging is None:
                        staging = _StreamStaging(
                            ckpt_server._state_dict, wire,
                            seq=ckpt_server._publish_seq,
                            ready=ckpt_server._ready,
                        )
                    with ckpt_server._stream_lock:
                        ckpt_server._stagings[wire] = staging
                        ckpt_server._stagings_step = requested
                        if seq is not None:
                            ckpt_server._stream_inflight += 1
                    return staging

            def _serve_stream_meta(self, requested: int, wire_tok: str) -> None:
                staging = self._staging_for(requested, wire_tok)
                if staging is None:
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(staging.meta)))
                self.end_headers()
                self.wfile.write(staging.meta)

            def _serve_stream_part(
                self, requested: int, i: int, n: int, wire_tok: str, seq: int,
            ) -> None:
                if n < 1 or not (0 <= i < n):
                    self.send_error(404, f"bad stream part {i}/{n}")
                    return
                staging = self._staging_for(requested, wire_tok, seq=seq)
                if staging is None:
                    return
                try:
                    begin = staging.total * i // n
                    end = staging.total * (i + 1) // n
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(end - begin))
                    self.send_header(
                        "X-TFT-Crc32c",
                        f"{staging.range_crc32c(begin, end):08x}",
                    )
                    self.end_headers()
                    staging.write_range(self.wfile, begin, end)
                finally:
                    with ckpt_server._stream_lock:
                        ckpt_server._stream_inflight -= 1

            def log_message(self, format: str, *args: object) -> None:
                logger.debug(f"checkpoint server: {format % args}")

        class _Server(ThreadingHTTPServer):
            address_family = socket.AF_INET6
            request_queue_size = 1024
            daemon_threads = True

        self._server = _Server(("::", 0), RequestHandler)
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            daemon=True,
            name="checkpoint_server",
        )
        self._thread.start()

    @classmethod
    def load_from_address(
        cls,
        address: str,
        timeout: timedelta,
        stripes: Optional[int] = None,
        wire: Optional[str] = "env",
        streams: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> Any:
        """Fetches a checkpoint from a step-qualified URL: the stream path
        onto ``device`` (``None``: the card), else the pickle paths
        (numpy leaves). ``wire`` (default: env ``TORCHFT_HEAL_WIRE``),
        ``streams`` (default: env ``TORCHFT_HEAL_STREAMS``, else
        ``stripes``) and ``stripes`` (default: env
        ``TORCHFT_CKPT_STRIPES``, else 4; 1 skips the striped path)."""
        out, _stats = cls._fetch(address, timeout, stripes, wire, streams,
                                 resolve_device(device))
        return out

    @classmethod
    def _fetch(
        cls,
        address: str,
        timeout: timedelta,
        stripes: Optional[int] = None,
        wire: Optional[str] = "env",
        streams: Optional[int] = None,
        device: Optional[torch.device] = None,
    ) -> Tuple[Any, Dict[str, Any]]:
        """:meth:`load_from_address` returning ``(tree, stats)``: the path
        taken and its seconds, for heal-latency attribution."""
        device = resolve_device(device)
        if stripes is None:
            stripes = int(os.environ.get("TORCHFT_CKPT_STRIPES", "4"))
        stripes = max(1, min(int(stripes), 64))
        if wire == "env":
            wire = _heal_wire_from_env()
        if streams is None:
            streams = int(os.environ.get("TORCHFT_HEAL_STREAMS", str(stripes)))
        streams = max(1, min(int(streams), 64))
        logger.info(
            f"fetching checkpoint from {address} "
            f"(streams={streams}, wire={wire}, pickle stripes={stripes})"
        )
        t0 = time.perf_counter()
        try:
            return cls._load_stream(address, timeout, wire, streams, device)
        except urllib.error.HTTPError as e:
            if e.code not in (404, 500):
                raise
            # a peer without the stream endpoint (or a gate timeout): heal
            # over the pickled paths rather than fail
            logger.warning(
                "peer checkpoint server lacks the zero-copy stream "
                f"endpoint (HTTP {e.code}); falling back to pickled fetch"
            )
        except TimeoutError:
            # the stream spent the caller's whole budget; a fallback would
            # start a fresh full-timeout attempt against the same donor
            raise
        except WireCorruption as e:
            # detected corruption: never install the bytes; the pickled
            # fallback re-reads everything
            logger.error(
                f"heal stream failed integrity check ({e}); refetching "
                "via the pickled fallback"
            )
        except OSError as e:
            if isinstance(getattr(e, "reason", None), TimeoutError):
                # urllib wraps connect/read timeouts as
                # URLError(reason=TimeoutError): the same budget case
                raise
            logger.warning(
                f"streamed checkpoint fetch failed ({e!r}); "
                "falling back to pickled fetch"
            )
        if stripes > 1:
            try:
                out = cls._load_striped(address, timeout, stripes)
                return out, {
                    "path": "striped",
                    "stripes": stripes,
                    "fetch_s": time.perf_counter() - t0,
                }
            except urllib.error.HTTPError as e:
                if e.code not in (404, 500):
                    raise
                logger.warning(
                    "peer checkpoint server lacks the striped endpoint "
                    f"(HTTP {e.code}); falling back to single-stream fetch"
                )
            except OSError as e:
                # a reset mid-stripe: the single stream needs no up-front
                # serialize, so the heal can still succeed there
                logger.warning(
                    f"striped checkpoint fetch failed ({e!r}); "
                    "falling back to single-stream fetch"
                )
        with urllib.request.urlopen(address, timeout=timeout.total_seconds()) as f:
            out = load_state_dict_stream(f)
        return out, {"path": "single", "fetch_s": time.perf_counter() - t0}

    @classmethod
    def _load_stream(
        cls,
        address: str,
        timeout: timedelta,
        wire: Optional[str],
        streams: int,
        device: torch.device,
    ) -> Tuple[Any, Dict[str, Any]]:
        """The zero-copy receiver: the layout, ``streams`` range readers
        ``readinto``-ing one preallocated buffer (pinned for a card
        ``device``) with the CRC folded into the read loop, and a walker
        that rebuilds each leaf as a view the moment its bytes are
        covered and uploads it while later ranges are still arriving.
        Raises ``urllib.error.HTTPError(404)`` against a peer without the
        endpoint (the caller falls back)."""
        deadline = time.monotonic() + timeout.total_seconds()
        wire_tok = wire if wire is not None else "none"
        t0 = time.perf_counter()
        with urllib.request.urlopen(
            f"{address}/streammeta/{wire_tok}", timeout=timeout.total_seconds()
        ) as f:
            meta = _SafeUnpickler(f).load()
        total = int(meta["total"])
        seq = int(meta.get("seq", 0))
        slots, treedef = flatten(meta["skeleton"])
        on_card = device.type == "cuda"
        host = torch.empty(total, dtype=torch.uint8, pin_memory=on_card)
        view = memoryview(host.numpy()).cast("B")
        bounds = [total * i // streams for i in range(streams + 1)]
        progress = list(bounds[:-1])
        cond = threading.Condition()
        errors: List[BaseException] = []
        # set when the walker gives up: surviving readers stop, or they
        # would compete with the fallback for the link
        cancel = threading.Event()

        def pull(i: int) -> None:
            try:
                begin, end = bounds[i], bounds[i + 1]
                if begin >= end:
                    return
                with urllib.request.urlopen(
                    f"{address}/stream/{i}/{streams}/{wire_tok}/{seq}",
                    timeout=timeout.total_seconds(),
                ) as resp:
                    want_crc = resp.headers.get("X-TFT-Crc32c")
                    pos = begin
                    crc_state = 0xFFFFFFFF
                    while pos < end and not cancel.is_set():
                        n = resp.readinto(view[pos:min(pos + _STREAM_CHUNK, end)])
                        if not n:
                            raise OSError(
                                f"heal stream {i} ended early at {pos}/{end}"
                            )
                        if want_crc is not None:
                            crc_state = _crc32c_update(crc_state,
                                                       view[pos:pos + n])
                        pos += n
                        if pos >= end and want_crc is not None:
                            # verify before publishing the final progress:
                            # the walker only consumes checked ranges
                            got_crc = crc_state ^ 0xFFFFFFFF
                            if got_crc != int(want_crc, 16):
                                raise WireCorruption(
                                    "wire corruption: heal stream range "
                                    f"{i} CRC32C mismatch (got {got_crc:08x}, "
                                    f"donor sent {want_crc}, bytes "
                                    f"[{begin}, {end}))"
                                )
                        with cond:
                            progress[i] = pos
                            cond.notify_all()
            except BaseException as e:  # noqa: BLE001 - wake the walker
                with cond:
                    errors.append(e)
                    cond.notify_all()

        threads = [
            threading.Thread(target=pull, args=(i,), daemon=True,
                             name=f"heal_stream_{i}")
            for i in range(streams)
        ]
        for t in threads:
            t.start()

        def wait_covered(begin: int, end: int) -> None:
            with cond:
                while True:
                    if errors:
                        raise errors[0]
                    if all(progress[j] >= min(end, bounds[j + 1])
                           for j in range(streams)
                           if bounds[j] < end and bounds[j + 1] > begin):
                        return
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            "streamed heal fetch timed out (covered through "
                            f"~{min(progress)}/{total} bytes)"
                        )
                    cond.wait(min(remaining, 1.0))

        out_leaves: List[Any] = []
        outs: List[torch.Tensor] = []
        side = done = None
        try:
            array_slots = [s for s in slots if isinstance(s, _ArraySlot)]
            if on_card and array_slots:
                # Every output allocated on the current stream up front, and
                # the side stream waits once for what that stream ran
                # before (a block's earlier users), so the uploads can run
                # beside whatever the trainer enqueues meanwhile.
                outs = [torch.empty(s.shape, dtype=_dtype_by_name(s.dtype),
                                    device=device) for s in array_slots]
                narrowed = [o for o, s in zip(outs, array_slots)
                            if s.wire_dtype != s.dtype]
                wide = torch.empty(sum(o.numel() for o in narrowed),
                                   dtype=torch.bfloat16, device=device)
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
            outs_it = iter(outs)
            at = 0
            for slot in slots:
                if not isinstance(slot, _ArraySlot):
                    out_leaves.append(slot)
                    continue
                wait_covered(slot.offset, slot.offset + slot.nbytes)
                wdtype = _dtype_by_name(slot.wire_dtype)
                odtype = _dtype_by_name(slot.dtype)
                count = slot.nbytes // wdtype.itemsize
                src = (torch.frombuffer(view, dtype=wdtype, count=count,
                                        offset=slot.offset)
                       if count else torch.empty(0, dtype=wdtype))
                src = src.reshape(slot.shape)
                if side is None:
                    # a view of the receive buffer (widened: a new tensor)
                    leaf = src if wdtype == odtype else src.to(odtype)
                else:
                    leaf = next(outs_it)
                    with torch.cuda.stream(side):
                        if wdtype == odtype:
                            leaf.copy_(src, non_blocking=True)
                        else:
                            w = wide[at:at + count].view(slot.shape)
                            at += count
                            w.copy_(src, non_blocking=True)
                            leaf.copy_(w)  # bf16 -> f32 on the card: exact
                out_leaves.append(leaf)
            if side is not None:
                done = side.record_event()
            for t in threads:
                t.join(max(0.0, deadline - time.monotonic()))
            with cond:
                if errors:
                    raise errors[0]
                if any(t.is_alive() for t in threads):
                    raise TimeoutError("streamed heal fetch timed out draining")
        except BaseException:
            cancel.set()
            if side is not None:
                # uploads may still read the receive buffer
                side.synchronize()
            raise
        fetch_s = time.perf_counter() - t0
        h2d_s = 0.0
        if done is not None:
            # the upload left over once the last byte arrived: the part of
            # the h2d the overlap could not hide
            t1 = time.perf_counter()
            done.synchronize()
            h2d_s = time.perf_counter() - t1
        return (
            unflatten(treedef, out_leaves),
            {"path": "stream", "wire": wire, "streams": streams,
             "bytes": total, "fetch_s": fetch_s, "h2d_s": h2d_s},
        )

    @classmethod
    def _load_striped(cls, address: str, timeout: timedelta, stripes: int) -> Any:
        """Parallel byte-range fetch of the pickle, then one safelisted
        unpickle (the whole payload held once on the receiver)."""

        def fetch(i: int) -> bytes:
            # One retry on 500: the donor builds its pickle cache under the
            # gate lock at the first part request, which can hold the lock
            # past the server's timeout and 500 the siblings.
            for attempt in (0, 1):
                try:
                    with urllib.request.urlopen(
                        f"{address}/part/{i}/{stripes}",
                        timeout=timeout.total_seconds(),
                    ) as f:
                        return f.read()
                except urllib.error.HTTPError as e:
                    if attempt or e.code != 500:
                        raise
            raise AssertionError("unreachable")

        with ThreadPoolExecutor(max_workers=stripes,
                                thread_name_prefix="ckpt_stripe") as ex:
            parts = list(ex.map(fetch, range(stripes)))
        return deserialize_state_dict(b"".join(parts))

    def address(self) -> str:
        """URL prefix of this server; append the step to fetch."""
        port = self._server.socket.getsockname()[1]
        return f"http://{socket.gethostname()}:{port}/checkpoint/"

    def allow_checkpoint(self, step: int) -> None:
        """Publishes ``step`` under a new nonce; unblocks readers."""
        self._step = step
        with self._stream_lock:
            # the previous publish's stagings go (a range of theirs in
            # flight keeps its own reference to the bytes it reads)
            self._publish_seq += 1
            self._stagings = {}
            self._stagings_step = -1
        if self._disallowed:
            self._disallowed = False
            self._checkpoint_lock.release()

    def disallow_checkpoint(self) -> None:
        """Re-locks the gate so the dict can be mutated: no new meta,
        pickle or staging build reads it until the next publish. The
        stream stagings stay: they are host copies taken under the gate
        (the JAX package's stage views of the live buffers, and so drains
        their readers here), and a healer that read this publish's meta
        finishes its ranges from them."""
        if not self._disallowed:
            self._disallowed = True
            self._checkpoint_lock.acquire()
            self._serialized = None
            self._serialized_step = -1

    # -- CheckpointTransport --

    def metadata(self) -> str:
        return self.address()

    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: T, timeout: timedelta,
        stream: Optional[torch.cuda.Stream] = None,
    ) -> None:
        self._state_dict = state_dict
        self._ready = None
        dev = _first_cuda_device(state_dict)
        if dev is not None:
            if stream is None:
                stream = torch.cuda.current_stream(dev)
            self._ready = (dev, stream.record_event())
        self._serialized = None  # a new dict, even at an unchanged step
        self._serialized_step = -1
        self.allow_checkpoint(step)

    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: timedelta
    ) -> T:
        out, stats = self._fetch(f"{metadata}{step}", timeout,
                                 device=self._device)
        self.last_fetch_stats = stats
        return out

    def shutdown(self, wait: bool = True) -> None:
        """Stops serving. Requests in flight hold the gate lock until done."""
        self._server.shutdown()
        if wait:
            self._thread.join()
        self._server.server_close()
