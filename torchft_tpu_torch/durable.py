"""Durable checkpoints: asynchronous, sharded, wire-compressed
snapshots behind a CRC-framed manifest, and restore with no live donor.

The port of ``torchft_tpu/durable.py``. Four parts:

**Capture at the commit boundary.** A ``Manager`` commit hook (or an
explicit :meth:`DurableCheckpointer.maybe_save`) captures the state into
a :class:`~.checkpointing._StreamStaging` limited to this member's
shard. The staging owns its bytes (the optimizer goes on updating the
live tensors in place), and under ``wire="bf16"`` the ``opt_state`` f32
leaves are narrowed on the card by K3 first (params always raw). The
trainer pays only this capture; CRC, write and fsync run on a writer
thread. With ``zero_copy`` the capture is one device-side copy of the
shard, and the d2h moves to the writer thread too.

**1/W sharded writes.** The packed stream splits into W contiguous byte
ranges, the floor split the streamed heal's range readers use, and the
member of participating rank r writes only bytes ``[total*r//W,
total*(r+1)//W)`` plus a small marker with the range's CRC32C.

**A fenced manifest.** A snapshot becomes restorable only when a
``commit`` record lands in the manifest log, an append-only log of
``[u32 len][u32 crc32c]`` frames whose torn tail is dropped on replay.
Rank 0 appends the record only after all W shard markers are present and
agree, so a partly written set never wins a restore; a quorum move
mid-snapshot aborts the set in flight.

**Restore with no donor.** :meth:`DurableCheckpointer.restore_latest`
replays the manifest, takes the newest committed set whose objects
verify, reads the W_old shards into one buffer (each shard's CRC checked
against the manifest) and rebuilds the full tree with
:func:`~.checkpointing.rebuild_from_packed` on the checkpointer's device,
so a fleet of another width restores it too. In a running fleet the live
heal comes first; the manager consults this tier only on a cold fleet.

Storage is pluggable behind :class:`CheckpointStore`
(:class:`LocalDirStore` by default). The files a port member writes are
the JAX package's byte for byte for the same tree, except the meta
pickle, which names this package's slot class.

Knobs: ``TORCHFT_DURABLE_EVERY``, ``TORCHFT_DURABLE_WIRE``,
``TORCHFT_DURABLE_MODE``, ``TORCHFT_DURABLE_STORE``,
``TORCHFT_DURABLE_STAGING_MB``, ``TORCHFT_DURABLE_COMMIT_TIMEOUT_S``,
``TORCHFT_DURABLE_ZEROCOPY``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import pickle
import queue
import struct
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from ._device import resolve_device
from ._native import crc32c as _crc32c
from .checkpointing import (
    _StreamStaging,
    deserialize_state_dict,
    load_packed_meta,
    rebuild_from_packed,
    serialize_state_dict,
)

logger = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.log"
_SNAP_PREFIX = "snap/"
# [u32 payload_len][u32 crc32c(payload)] — the DurableLog frame shape.
_FRAME = struct.Struct("<II")
# What marks a committed set unusable at restore, so that the next older
# one is tried: a missing or short object, a CRC or size mismatch, a meta
# or loader blob that does not unpickle through the safelist.
_SET_UNUSABLE = (ValueError, OSError, KeyError, EOFError,
                 pickle.UnpicklingError)


def shard_bounds(total: int, world: int) -> List[int]:
    """The W+1 byte boundaries splitting a packed stream into W
    contiguous shards — the same floor split (``total*i//W``) the
    streamed-heal range readers tile a donor stream with, so shard r of
    a snapshot is byte-identical to range r/W of a live heal."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    return [total * i // world for i in range(world + 1)]


# ---------------------------------------------------------------------------
# storage backends


class CheckpointStore(ABC):
    """Durable object storage for snapshots and the manifest log.

    Implementations must make :meth:`put` atomic-and-durable (a name is
    either absent or holds the complete fsynced bytes — presence implies
    durability) and :meth:`append` durable before returning. Names are
    ``/``-separated keys. The default local-directory backend is
    :class:`LocalDirStore`; an object store (S3/GCS) drops in by
    implementing this ABC — ``append`` may be emulated with versioned
    record objects as long as replay order is preserved."""

    @abstractmethod
    def put(self, name: str, data: bytes) -> None:
        """Atomically publishes ``data`` under ``name`` (fsynced)."""

    def put_from(self, name: str, write_fn: Callable[[Any], None]) -> int:
        """Streams a writer callback into ``name`` (atomic, fsynced).
        Returns the byte count. Default buffers through memory; backends
        with real streaming override."""
        buf = io.BytesIO()
        write_fn(buf)
        data = buf.getvalue()
        self.put(name, data)
        return len(data)

    @abstractmethod
    def get(self, name: str) -> bytes:
        """Reads the full object (KeyError/OSError when absent)."""

    @abstractmethod
    def read_range(self, name: str, offset: int, nbytes: int) -> bytes:
        """Reads ``nbytes`` starting at ``offset`` of the object."""

    @abstractmethod
    def append(self, name: str, data: bytes) -> None:
        """Durably appends ``data`` to the (possibly absent) object."""

    @abstractmethod
    def list(self, prefix: str) -> List[str]:
        """All object names under ``prefix`` (sorted)."""

    @abstractmethod
    def delete(self, name: str) -> None:
        """Removes an object (no-op when absent)."""

    @abstractmethod
    def exists(self, name: str) -> bool:
        """True when ``name`` holds a published object."""

    def delete_prefix(self, prefix: str) -> None:
        for name in self.list(prefix):
            self.delete(name)


class LocalDirStore(CheckpointStore):
    """Filesystem-backed store rooted at a directory (point it at the
    shared durable mount so every member and any future cold fleet see
    one namespace). ``put`` is tmp + fsync + atomic rename + directory
    fsync; ``append`` is O_APPEND + fsync — the exact publish discipline
    the control-plane WAL uses."""

    def __init__(self, root: str) -> None:
        self._root = os.path.abspath(root)
        os.makedirs(self._root, exist_ok=True)

    @property
    def root(self) -> str:
        return self._root

    def _path(self, name: str) -> str:
        parts = [p for p in name.split("/") if p]
        if not parts or any(p in ("..", ".") for p in parts):
            raise ValueError(f"bad store name: {name!r}")
        return os.path.join(self._root, *parts)

    @staticmethod
    def _fsync_dir(path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:  # pragma: no cover - platform without dir fds
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def put(self, name: str, data: bytes) -> None:
        self.put_from(name, lambda f: f.write(data))

    def put_from(self, name: str, write_fn: Callable[[Any], None]) -> int:
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                write_fn(f)
                f.flush()
                os.fsync(f.fileno())
                size = f.tell()
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        # Rename durability: the new directory entry must itself survive
        # a crash, or a committed manifest could reference a shard whose
        # name vanished with the dirent.
        self._fsync_dir(os.path.dirname(path))
        return size

    def get(self, name: str) -> bytes:
        with open(self._path(name), "rb") as f:
            return f.read()

    def read_range(self, name: str, offset: int, nbytes: int) -> bytes:
        with open(self._path(name), "rb") as f:
            f.seek(offset)
            return f.read(nbytes)

    def append(self, name: str, data: bytes) -> None:
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "ab") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def list(self, prefix: str) -> List[str]:
        out: List[str] = []
        for dirpath, _, files in os.walk(self._root):
            rel = os.path.relpath(dirpath, self._root)
            for fname in files:
                if fname.endswith(".tmp") or ".tmp." in fname:
                    continue
                name = fname if rel == "." else f"{rel}/{fname}".replace(
                    os.sep, "/"
                )
                if name.startswith(prefix):
                    out.append(name)
        return sorted(out)

    def delete(self, name: str) -> None:
        path = self._path(name)
        try:
            os.unlink(path)
        except FileNotFoundError:
            return
        # prune now-empty parents up to (not including) the root
        d = os.path.dirname(path)
        while d != self._root:
            try:
                os.rmdir(d)
            except OSError:
                break
            d = os.path.dirname(d)

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))


def store_from_env(default_dir: str) -> CheckpointStore:
    """Resolves the durable store backend: ``TORCHFT_DURABLE_STORE``
    (``file:/path`` or a bare path) when set, else a
    :class:`LocalDirStore` at ``default_dir``."""
    spec = os.environ.get("TORCHFT_DURABLE_STORE", "").strip()
    if not spec:
        return LocalDirStore(default_dir)
    if spec.startswith("file:"):
        return LocalDirStore(spec[len("file:"):])
    if "://" in spec or ":" in spec.split("/", 1)[0]:
        raise ValueError(f"unsupported TORCHFT_DURABLE_STORE: {spec!r}")
    return LocalDirStore(spec)


# ---------------------------------------------------------------------------
# manifest log


class ManifestLog:
    """Append-only CRC32C-framed record log over a store object. Each
    record is ``[u32 len][u32 crc32c(json)]json``; replay walks frames
    and drops the tail at the first short or corrupt frame (a crash
    mid-append can tear at any byte, and a torn record never yields a
    committed snapshot). Compaction rewrites the log atomically through
    :meth:`CheckpointStore.put` with only live records, so a crash
    mid-compaction leaves either the old or the new log, both valid."""

    def __init__(self, store: CheckpointStore, name: str = MANIFEST_NAME):
        self._store = store
        self._name = name
        self._lock = threading.Lock()

    @staticmethod
    def frame(record: Dict[str, Any]) -> bytes:
        payload = json.dumps(
            record, separators=(",", ":"), sort_keys=True
        ).encode()
        return _FRAME.pack(len(payload), _crc32c(payload)) + payload

    def append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._store.append(self._name, self.frame(record))

    def replay(self) -> Tuple[List[Dict[str, Any]], int]:
        """All intact records in append order, plus the dropped torn-tail
        byte count (0 on a clean log)."""
        try:
            raw = (
                self._store.get(self._name)
                if self._store.exists(self._name)
                else b""
            )
        except OSError:
            raw = b""
        records: List[Dict[str, Any]] = []
        pos = 0
        while pos + _FRAME.size <= len(raw):
            ln, want = _FRAME.unpack_from(raw, pos)
            begin = pos + _FRAME.size
            if begin + ln > len(raw):
                break  # torn: frame promised more bytes than exist
            payload = raw[begin:begin + ln]
            if _crc32c(payload) != want:
                break  # torn or corrupt: nothing after it is trusted
            try:
                rec = json.loads(payload)
            except ValueError:
                break
            records.append(rec)
            pos = begin + ln
        return records, len(raw) - pos

    def compact(self, live: List[Dict[str, Any]]) -> None:
        with self._lock:
            self._store.put(
                self._name, b"".join(self.frame(r) for r in live)
            )


# ---------------------------------------------------------------------------
# snapshots


@dataclass
class _Snapshot:
    """One in-flight capture: the staged bytes plus everything the
    writer and committer need. ``abort`` flips when the quorum moved
    mid-flight (the set can no longer complete: W changed under it)."""

    step: int
    quorum_id: int
    rank: int
    world: int
    staging: _StreamStaging
    local_state: Optional[bytes]  # per-member blob (loader position)
    replica_id: str
    stats: Dict[str, Any]
    abort: threading.Event = field(default_factory=threading.Event)
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def directory(self) -> str:
        return snapshot_dir(self.step, self.quorum_id, self.world)


def snapshot_dir(step: int, quorum_id: int, world: int) -> str:
    return (
        f"{_SNAP_PREFIX}step{step:08d}_q{max(quorum_id, 0):08d}"
        f"_w{world:04d}"
    )


def _member_id(replica_id: str) -> str:
    """Stable per-member identity for local-state blobs. The native
    Manager suffixes the configured replica id with a per-session UUID
    (``repA:3f2c...``) — that suffix changes on every restart, so the
    durable name must key on the stable prefix or a restarted member
    could never find its own loader position."""
    stable = str(replica_id).split(":", 1)[0]
    return "".join(
        c if c.isalnum() or c in "._-" else "_" for c in stable
    ) or "member"


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


def inconsistent_marker(
    markers: Dict[int, Dict[str, Any]],
    *,
    step: int,
    quorum_id: int,
    world: int,
    total: int,
    wire: str,
) -> Optional[Tuple[int, Optional[Dict[str, Any]]]]:
    """The commit fence's consistency predicate: all W shard markers must
    be present and agree with the snapshot's identity before a commit
    record may be appended. Returns the first offending ``(rank,
    marker_or_None)``, or ``None`` when the set may commit."""
    for r in range(world):
        m = markers.get(r)
        if m is None:
            return (r, None)
        ok = (
            m.get("step") == step
            and m.get("quorum_id") == quorum_id
            and m.get("world") == world
            and m.get("total") == total
            and m.get("wire") == wire
            and m.get("rank") == r
        )
        if not ok:
            return (r, m)
    return None


def live_commits(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Committed, non-retired manifest records in commit order: the
    restorable candidates, the same set for the committer's retention
    pass and the restore."""
    retired = {r["dir"] for r in records if r.get("t") == "retire"}
    return [
        r
        for r in records
        if r.get("t") == "commit" and r["dir"] not in retired
    ]


class DurableCheckpointer:
    """Asynchronous sharded durable checkpoints of (user state, manager
    state, loader position) behind a fenced manifest.

    Usage::

        ckpt = DurableCheckpointer(dir_, manager, state, loader=loader,
                                   every=100, keep=3)
        ckpt.restore_latest()          # before the first quorum
        while ...:
            ...; optimizer.step(avg)
            ckpt.maybe_save()          # capture-only stall on the
                                       # every-th COMMITTED step
        ckpt.close()

    or hook-driven (``register_hook=True``): the capture fires inside
    ``Manager.should_commit`` with no per-step call in the loop.

    ``mode="async"`` (default): ``maybe_save`` pays only the snapshot
    capture; a background writer CRCs, writes and fsyncs the member's
    1/W shard, and rank 0 commits the manifest once all W shards are
    durable. ``mode="sync"`` runs the same pipeline on the trainer thread
    (the stall baseline, and for tooling that must not return before
    durability)."""

    def __init__(
        self,
        directory: str,
        manager: Any,
        state: Any,
        *,
        loader: Any = None,
        every: Optional[int] = None,
        keep: int = 3,
        store: Optional[CheckpointStore] = None,
        wire: Optional[str] = "__env__",
        mode: Optional[str] = None,
        commit_timeout_s: Optional[float] = None,
        max_staging_mb: Optional[float] = None,
        zero_copy: Optional[bool] = None,
        register_hook: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        """
        Args:
            directory: durable root (shared mount) — used when ``store``
                is not given (``TORCHFT_DURABLE_STORE`` overrides).
            manager: the Manager; supplies ``{step, batches_committed}``,
                the participating rank/world at the commit boundary, and
                the quorum id that fences in-flight sets.
            state: object with ``state_dict()``/``load_state_dict()``
                for USER state.
            loader: optional stateful loader; its position is saved as
                PER-MEMBER local state keyed by replica id (a restored
                fleet with different replica ids starts loaders fresh).
            every: snapshot every ``every``-th committed step
                (``TORCHFT_DURABLE_EVERY``, default 100).
            keep: committed snapshots retained (older sets are retired
                from the manifest and their objects deleted).
            store: explicit backend; default from env/``directory``.
            wire: ``"bf16"`` (default via ``TORCHFT_DURABLE_WIRE``,
                bf16 opt-state / raw params) or ``None`` for raw f32.
            mode: ``"async"`` | ``"sync"`` (``TORCHFT_DURABLE_MODE``).
            commit_timeout_s: how long rank 0 waits for all W shard
                markers before abandoning the set
                (``TORCHFT_DURABLE_COMMIT_TIMEOUT_S``, default 120).
            max_staging_mb: cap on in-flight staged snapshot bytes; a
                capture that would exceed it is SKIPPED (backpressure
                never stalls the trainer; ``TORCHFT_DURABLE_STAGING_MB``,
                0 = unlimited).
            zero_copy: capture card leaves with one device-side copy of
                the shard on the current stream and leave the d2h to the
                writer thread (``TORCHFT_DURABLE_ZEROCOPY``, default
                off). Not the JAX package's pinning of immutable arrays:
                the port's optimizers update in place, so a reference to
                a live tensor would snapshot a later step. Costs the
                shard's bytes on the card while the set is in flight.
            register_hook: wire ``manager.add_commit_hook`` so captures
                fire at every committed ``every``-boundary step without
                a ``maybe_save`` call in the loop.
            device: where :meth:`restore_latest` places the restored
                tensors before loading them (``None``: the card).
        """
        self._manager = manager
        self._state = state
        self._device = resolve_device(device)
        self._loader = loader
        self._every = max(
            int(every if every is not None
                else _env_int("TORCHFT_DURABLE_EVERY", 100)),
            1,
        )
        self._keep = max(int(keep), 1)
        self._store = store if store is not None else store_from_env(directory)
        if wire == "__env__":
            wire = os.environ.get("TORCHFT_DURABLE_WIRE", "bf16").strip()
            wire = None if wire.lower() in ("", "none", "f32", "raw") else wire
        if wire not in (None, "bf16"):
            raise ValueError(f"unsupported durable wire: {wire!r}")
        self._wire = wire
        mode = (
            mode
            or os.environ.get("TORCHFT_DURABLE_MODE", "async").strip()
            or "async"
        )
        if mode not in ("async", "sync"):
            raise ValueError(f"unsupported durable mode: {mode!r}")
        self._mode = mode
        self._commit_timeout_s = (
            commit_timeout_s
            if commit_timeout_s is not None
            else _env_float("TORCHFT_DURABLE_COMMIT_TIMEOUT_S", 120.0)
        )
        self._max_staging = int(
            (
                max_staging_mb
                if max_staging_mb is not None
                else _env_float("TORCHFT_DURABLE_STAGING_MB", 0.0)
            )
            * 1024
            * 1024
        )
        self._zero_copy = bool(
            zero_copy
            if zero_copy is not None
            else os.environ.get("TORCHFT_DURABLE_ZEROCOPY", "").strip()
            .lower() in ("1", "true", "yes", "on")
        )
        self._manifest = ManifestLog(self._store)
        self._last_saved: Optional[int] = None
        self._inflight: List[_Snapshot] = []
        self._inflight_lock = threading.Lock()
        self._queue: "queue.Queue[Optional[_Snapshot]]" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._closed = False
        # bench/test observability: one row per capture attempt, plus
        # the last restore's bucket breakdown
        self.snapshots: List[Dict[str, Any]] = []
        self.last_restore_stats: Optional[Dict[str, Any]] = None
        if register_hook:
            manager.add_commit_hook(self._on_commit)
        # Hand the manager the cold-start fallback, so a cold fleet's
        # first quorum restores the latest committed set when no live
        # donor exists (a trainer may still call restore_latest() before
        # its loop: the consult is one-shot and a nonzero step disarms
        # it). Managers without the hook are fine.
        register_restore = getattr(manager, "set_durable_restore", None)
        if callable(register_restore):
            register_restore(self.restore_latest)

    # -- capture (trainer thread) --

    def _on_commit(self, step: int, quorum_id: int, committed: bool) -> None:
        """Manager commit hook: fences in-flight sets against quorum
        moves, then captures on committed ``every``-boundary steps."""
        self._fence_inflight(quorum_id)
        if not committed:
            return
        if step == 0 or step % self._every or step == self._last_saved:
            return
        self._capture(step, quorum_id)

    def maybe_save(self) -> Optional[str]:
        """Captures iff the manager just committed an ``every``-boundary
        step; call right after ``should_commit``/``optimizer.step``.
        Returns the snapshot directory name when a capture was taken
        (async: durability follows once the manifest commit lands)."""
        step = self._manager.current_step()
        # step only advances on COMMIT: after an aborted step the loop
        # lands here again at the same step — re-capturing would publish
        # a loader position that already consumed the aborted batch
        if step == 0 or step % self._every or step == self._last_saved:
            return None
        return self.save()

    def save(self) -> Optional[str]:
        """Unconditional capture of the current committed state."""
        step = self._manager.current_step()
        quorum_id = self._manager.quorum_id()
        self._fence_inflight(quorum_id)
        return self._capture(step, quorum_id)

    def _fence_inflight(self, quorum_id: int) -> None:
        """A quorum move invalidates every in-flight set captured under
        the old membership: its W no longer tiles the fleet, so peers
        will never produce the missing shards. Abort them; the writer
        deletes whatever partial objects already landed."""
        with self._inflight_lock:
            self._inflight = [s for s in self._inflight if not s.done.is_set()]
            for snap in self._inflight:
                if snap.quorum_id != quorum_id:
                    snap.abort.set()

    def _capture(self, step: int, quorum_id: int) -> Optional[str]:
        rank = self._manager.participating_rank()
        if rank is None:
            return None  # spare/healing member: no shard duty this set
        world = max(int(self._manager.num_participants()), 1)
        t0 = time.perf_counter()
        payload = {
            "user": self._state.state_dict(),
            "torchft": self._manager.state_dict(),
        }
        row: Dict[str, Any] = {
            "step": step, "quorum_id": quorum_id, "rank": rank,
            "world": world, "mode": self._mode, "wire": self._wire or "none",
            "committed": False, "aborted": False, "skipped": False,
        }
        if self._max_staging > 0:
            with self._inflight_lock:
                pending = sum(
                    s.staging.captured_bytes
                    for s in self._inflight
                    if not s.done.is_set()
                )
            if pending > self._max_staging:
                # Backpressure without a stall: dropping a snapshot only
                # widens the restore gap; blocking the trainer on disk
                # is exactly what v2 exists to remove.
                row["skipped"] = True
                row["stall_s"] = time.perf_counter() - t0
                self.snapshots.append(row)
                logger.warning(
                    "durable snapshot at step %d skipped: %d staged bytes "
                    "in flight exceed TORCHFT_DURABLE_STAGING_MB", step,
                    pending,
                )
                return None
        # Range-limited capture: this member writes only its ~1/W shard,
        # so it copies only the bytes that shard touches; the skeleton
        # (layout, no bytes) stays complete for rank 0's meta.
        staging = _StreamStaging(
            payload, self._wire, seq=step, shard_of=(rank, world),
            zero_copy=self._zero_copy,
        )
        local = (
            serialize_state_dict(self._loader.state_dict())
            if self._loader is not None
            else None
        )
        snap = _Snapshot(
            step=step, quorum_id=quorum_id, rank=rank, world=world,
            staging=staging, local_state=local,
            replica_id=_member_id(self._manager.replica_id()), stats=row,
        )
        row["total_bytes"] = staging.total
        row["captured_bytes"] = staging.captured_bytes
        row["capture_split"] = staging.split
        bounds = shard_bounds(staging.total, world)
        row["shard_bytes"] = bounds[rank + 1] - bounds[rank]
        # The trainer's whole stall: the capture above (the copies and
        # the skeleton pickle). Everything after this line is off the
        # training path in async mode.
        row["stall_s"] = time.perf_counter() - t0
        self._last_saved = step
        self.snapshots.append(row)
        with self._inflight_lock:
            self._inflight.append(snap)
        if self._mode == "sync":
            t1 = time.perf_counter()
            self._write_snapshot(snap)
            if rank == 0 and not snap.abort.is_set():
                self._commit_snapshot(snap)
            snap.done.set()
            # sync mode stalls for the full pipeline — the baseline the
            # async stall is benched against
            row["stall_s"] += time.perf_counter() - t1
        else:
            self._ensure_writer()
            self._queue.put(snap)
        return snap.directory

    # -- writer (background thread) --

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, name="durable_writer", daemon=True
            )
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            snap = self._queue.get()
            if snap is None:
                return
            try:
                self._write_snapshot(snap)
                if snap.rank == 0 and not snap.abort.is_set():
                    self._commit_snapshot(snap)
            except Exception:
                logger.exception(
                    "durable snapshot at step %d failed", snap.step
                )
            finally:
                snap.done.set()

    def _write_snapshot(self, snap: _Snapshot) -> None:
        d = snap.directory
        bounds = shard_bounds(snap.staging.total, snap.world)
        begin, end = bounds[snap.rank], bounds[snap.rank + 1]
        row = snap.stats
        t0 = time.perf_counter()
        if snap.abort.is_set():
            row["aborted"] = True
            return
        crc = snap.staging.range_crc32c(begin, end)
        shard_name = f"{d}/shard_{snap.rank:04d}.bin"
        self._store.put_from(
            shard_name,
            lambda f: snap.staging.write_range(f, begin, end),
        )
        marker: Dict[str, Any] = {
            "v": 1, "step": snap.step, "quorum_id": snap.quorum_id,
            "rank": snap.rank, "world": snap.world,
            "begin": begin, "end": end, "nbytes": end - begin,
            "crc": f"{crc:08x}", "wire": self._wire or "none",
            "total": snap.staging.total, "name": shard_name,
        }
        if snap.rank == 0:
            meta = snap.staging.meta
            self._store.put(f"{d}/meta.pkl", meta)
            marker["meta_nbytes"] = len(meta)
            marker["meta_crc"] = f"{_crc32c(meta):08x}"
        if snap.local_state is not None:
            self._store.put(
                f"{d}/member_{snap.replica_id}.local", snap.local_state
            )
        if snap.abort.is_set():
            row["aborted"] = True
            self._cleanup_member(snap)
            return
        # Marker publication is the member's durability vote: it lands
        # (atomic, fsynced) strictly AFTER the shard payload is durable,
        # so the committer polling markers can never commit over a shard
        # still in flight.
        self._store.put(
            f"{d}/shard_{snap.rank:04d}.json",
            json.dumps(marker, sort_keys=True).encode(),
        )
        row["write_s"] = time.perf_counter() - t0
        row["durable_bytes"] = (end - begin) + (
            marker.get("meta_nbytes", 0)
            + (len(snap.local_state) if snap.local_state else 0)
        )

    def _cleanup_member(self, snap: _Snapshot) -> None:
        d = snap.directory
        for name in (
            f"{d}/shard_{snap.rank:04d}.bin",
            f"{d}/shard_{snap.rank:04d}.json",
            f"{d}/member_{snap.replica_id}.local",
            *((f"{d}/meta.pkl",) if snap.rank == 0 else ()),
        ):
            try:
                self._store.delete(name)
            except OSError:  # pragma: no cover - best-effort cleanup
                pass

    # -- committer (rank 0, background thread) --

    def _commit_snapshot(self, snap: _Snapshot) -> bool:
        """Polls the store until all W shard markers are durably present
        and mutually consistent, then appends the manifest commit record
        — the ONLY thing that makes the set restorable."""
        d = snap.directory
        deadline = time.monotonic() + self._commit_timeout_s
        t0 = time.perf_counter()
        markers: Dict[int, Dict[str, Any]] = {}
        while len(markers) < snap.world:
            for r in range(snap.world):
                if r in markers:
                    continue
                name = f"{d}/shard_{r:04d}.json"
                if not self._store.exists(name):
                    continue
                try:
                    markers[r] = json.loads(self._store.get(name))
                except (OSError, ValueError):
                    continue
            if len(markers) >= snap.world:
                break
            if snap.abort.is_set() or time.monotonic() > deadline:
                snap.stats["aborted"] = True
                logger.warning(
                    "durable snapshot %s abandoned: %d/%d shard markers "
                    "after %.1fs", d, len(markers), snap.world,
                    time.monotonic() - (deadline - self._commit_timeout_s),
                )
                return False
            time.sleep(0.02)
        bad = inconsistent_marker(
            markers,
            step=snap.step,
            quorum_id=snap.quorum_id,
            world=snap.world,
            total=snap.staging.total,
            wire=self._wire or "none",
        )
        if bad is not None:
            logger.warning(
                "durable snapshot %s abandoned: shard %d marker "
                "inconsistent (%s)", d, bad[0], bad[1],
            )
            snap.stats["aborted"] = True
            return False
        if snap.abort.is_set():
            snap.stats["aborted"] = True
            return False
        record = {
            "t": "commit", "step": snap.step, "quorum_id": snap.quorum_id,
            "world": snap.world, "wire": self._wire or "none",
            "total": snap.staging.total, "dir": d,
            "meta": {
                "name": f"{d}/meta.pkl",
                "nbytes": markers[0]["meta_nbytes"],
                "crc": markers[0]["meta_crc"],
            },
            "shards": [
                {
                    "rank": r, "name": markers[r]["name"],
                    "begin": markers[r]["begin"], "end": markers[r]["end"],
                    "nbytes": markers[r]["nbytes"], "crc": markers[r]["crc"],
                }
                for r in range(snap.world)
            ],
            "unix_ms": int(time.time() * 1000),
        }
        self._manifest.append(record)
        snap.stats["committed"] = True
        snap.stats["commit_s"] = time.perf_counter() - t0
        self._retire_old()
        return True

    def _retire_old(self) -> None:
        """Retention: keep the newest ``keep`` committed sets; retire the
        rest (a ``retire`` record fences them from restore BEFORE their
        objects disappear) and compact the log when it accumulates."""
        records, _ = self._manifest.replay()
        retired = {r["dir"] for r in records if r.get("t") == "retire"}
        commits = live_commits(records)
        for rec in commits[: -self._keep] if len(commits) > self._keep else []:
            self._manifest.append({"t": "retire", "dir": rec["dir"]})
            retired.add(rec["dir"])
            try:
                self._store.delete_prefix(rec["dir"] + "/")
            except OSError:  # pragma: no cover - best-effort retention
                pass
        if len(records) > max(8 * self._keep, 64):
            live = [
                r
                for r in records
                if r.get("t") == "commit" and r["dir"] not in retired
            ]
            self._manifest.compact(live)

    # -- restore (no-donor path) --

    def restore_latest(
        self, device: Optional[Union[str, torch.device]] = None,
    ) -> Optional[int]:
        """Reassembles the newest committed snapshot from the durable
        tier and loads it (tensors on ``device``, default the
        checkpointer's); returns its step, or None when the manifest
        holds no restorable set. The manager calls it at a cold fleet's
        first quorum; a trainer may also call it before the first quorum.

        In a running fleet the live streamed heal comes first; this runs
        when no donor is left. It works at another fleet width: every
        member rebuilds the full tree from all W_old shards, and
        width-dependent state re-shards at the next quorum. A set that
        fails validation (missing or short object, CRC or size mismatch,
        a meta blob the safelist refuses) falls back to the next older
        committed set; an error of the rebuild or of the upload to the
        device raises."""
        device = self._device if device is None else resolve_device(device)
        t_replay = time.perf_counter()
        records, dropped = self._manifest.replay()
        commits = live_commits(records)
        replay_s = time.perf_counter() - t_replay
        for rec in reversed(commits):
            try:
                meta, buf, local, stats = self._read_committed(rec)
            except _SET_UNUSABLE as e:  # an older set may be whole
                logger.warning(
                    "durable restore: committed set %s unusable (%s); "
                    "trying older", rec.get("dir"), e,
                )
                continue
            # The rebuild (the upload to the card, the moments widened
            # there) stays outside the fallback: a device error is not a
            # bad set, and an older set would meet it too.
            t2 = time.perf_counter()
            payload = rebuild_from_packed(meta, buf, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stats["rebuild_s"] = time.perf_counter() - t2
            stats["device"] = str(device)
            stats["manifest_read_s"] += replay_s
            stats["dropped_tail_bytes"] = dropped
            self._state.load_state_dict(payload["user"])
            self._manager.load_state_dict(payload["torchft"])
            if self._loader is not None and local is not None:
                self._loader.load_state_dict(local)
                stats["loader_restored"] = True
            step = int(payload["torchft"]["step"])
            # Arm the same-step guard: an aborted first post-restore step
            # must not re-capture over this set with a drifted loader.
            self._last_saved = step
            self.last_restore_stats = stats
            logger.info(
                "restored durable snapshot %s (step %d, %d shards, "
                "%d bytes)", rec["dir"], step, rec["world"], rec["total"],
            )
            return step
        return None

    def _read_committed(
        self, rec: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], bytearray, Optional[Any], Dict[str, Any]]:
        """A committed set's meta, its packed stream reassembled from
        every shard (each CRC-checked) and this member's loader state;
        raises one of ``_SET_UNUSABLE`` when the set does not validate."""
        stats: Dict[str, Any] = {
            "dir": rec["dir"], "step": rec["step"], "world": rec["world"],
            "bytes": rec["total"], "wire": rec["wire"],
        }
        t0 = time.perf_counter()
        meta_raw = self._store.get(rec["meta"]["name"])
        if len(meta_raw) != rec["meta"]["nbytes"] or (
            f"{_crc32c(meta_raw):08x}" != rec["meta"]["crc"]
        ):
            raise ValueError("meta blob CRC/size mismatch")
        meta = load_packed_meta(meta_raw)
        if int(meta["total"]) != int(rec["total"]):
            raise ValueError("meta/manifest total mismatch")
        stats["manifest_read_s"] = time.perf_counter() - t0

        # Parallel range reads: each shard is one contiguous range of
        # the packed stream, so W readers fill one buffer with no
        # reassembly pass.
        t1 = time.perf_counter()
        total = int(rec["total"])
        buf = bytearray(total)
        view = memoryview(buf)
        errors: List[BaseException] = []

        def fetch(shard: Dict[str, Any]) -> None:
            try:
                begin, end = int(shard["begin"]), int(shard["end"])
                data = self._store.read_range(
                    shard["name"], 0, end - begin
                )
                if len(data) != end - begin:
                    raise ValueError(
                        f"shard {shard['rank']} short read "
                        f"({len(data)}/{end - begin})"
                    )
                if f"{_crc32c(data):08x}" != shard["crc"]:
                    raise ValueError(
                        f"shard {shard['rank']} CRC32C mismatch"
                    )
                view[begin:end] = data
            except BaseException as e:  # noqa: BLE001 - surface to caller
                errors.append(e)

        threads = [
            threading.Thread(target=fetch, args=(s,), daemon=True)
            for s in rec["shards"]
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        covered = sorted(
            (int(s["begin"]), int(s["end"])) for s in rec["shards"]
        )
        pos = 0
        for begin, end in covered:
            if begin != pos:
                raise ValueError("shard ranges do not tile the stream")
            pos = end
        if pos != total:
            raise ValueError("shard ranges do not cover the stream")
        stats["shard_fetch_s"] = time.perf_counter() - t1

        local = None
        local_name = (
            f"{rec['dir']}/member_"
            f"{_member_id(self._manager.replica_id())}.local"
        )
        if self._loader is not None and self._store.exists(local_name):
            local = deserialize_state_dict(self._store.get(local_name))
        return meta, buf, local, stats

    # -- lifecycle / introspection --

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Blocks until every in-flight snapshot finished (written +
        committed/aborted). Returns False on timeout."""
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        with self._inflight_lock:
            pending = list(self._inflight)
        for snap in pending:
            remain = (
                None if deadline is None else deadline - time.monotonic()
            )
            if remain is not None and remain <= 0:
                return False
            if not snap.done.wait(remain):
                return False
        return True

    def committed_steps(self) -> List[int]:
        """Steps of currently restorable (committed, unretired) sets."""
        records, _ = self._manifest.replay()
        retired = {r["dir"] for r in records if r.get("t") == "retire"}
        return [
            int(r["step"])
            for r in records
            if r.get("t") == "commit" and r["dir"] not in retired
        ]

    def latest_path(self) -> Optional[str]:
        """Directory name of the newest committed set (None when empty)."""
        records, _ = self._manifest.replay()
        retired = {r["dir"] for r in records if r.get("t") == "retire"}
        commits = [
            r
            for r in records
            if r.get("t") == "commit" and r["dir"] not in retired
        ]
        return commits[-1]["dir"] if commits else None

    @property
    def store(self) -> CheckpointStore:
        return self._store

    @property
    def manifest(self) -> ManifestLog:
        return self._manifest

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drains the writer thread (in-flight snapshots finish)."""
        if self._closed:
            return
        self._closed = True
        if self._writer is not None and self._writer.is_alive():
            self._queue.put(None)
            self._writer.join(timeout)

    def __enter__(self) -> "DurableCheckpointer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
