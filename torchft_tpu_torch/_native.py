"""ctypes binding of the native control plane.

The library is the same C++ the JAX package binds (``native/``), built by
this package into its own ``_build/`` directory at first use
(:mod:`torchft_tpu_torch._build`), so the two packages speak one wire
protocol and can share a quorum and a ring. Exposes the lighthouse (flat,
durable root, standby, region tier), the lease client, the
per-replica-group manager server and its client, the rendezvous store,
the ring, two-tier and CommPlan entry points :mod:`.collectives` drives
with their per-op and per-bucket stats, the CRC32C the heal stream's
ranges carry, the quorum and lease protocol's pure entry points, the
write-ahead quorum log and the seeded fault engine.

Timeouts surface as ``TimeoutError``, a failed frame checksum as
:class:`WireCorruption`, other native failures as
``RuntimeError``. ctypes releases the GIL for every native call, so
blocking RPCs never stall other Python threads.
"""

from __future__ import annotations

import atexit
import ctypes
import json
import weakref
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, List, Optional, Union

_vp = ctypes.c_void_p
_cp = ctypes.c_char_p
_i64 = ctypes.c_int64
_int = ctypes.c_int

# name -> (restype, argtypes)
_SIGNATURES = {
    "tft_last_error": (_cp, []),
    "tft_string_free": (None, [_vp]),
    "tft_lighthouse_create": (_vp, [
        _cp, ctypes.c_uint64, _i64, _i64, _i64,
        _cp,   # wal dir ("" = no durability)
        _i64,  # snapshot every N records (0 = default)
        _cp,   # peer root endpoints ("" = none)
        _int,  # standby
        _i64,  # takeover ms (0 = default)
    ]),
    "tft_lighthouse_address": (_vp, [_vp]),
    "tft_lighthouse_shutdown": (None, [_vp]),
    "tft_lighthouse_destroy": (None, [_vp]),
    "tft_lighthouse_active": (_int, [_vp]),
    "tft_lighthouse_root_epoch": (_i64, [_vp]),
    "tft_lighthouse_status_json": (_int, [_vp, ctypes.POINTER(_vp)]),
    # one-shot heartbeat: addr, replica id, timeout ms
    "tft_lighthouse_heartbeat": (_int, [_cp, _cp, _i64]),
    # The region lighthouse (the hierarchical tier's middle layer).
    "tft_region_create": (_vp, [
        _cp,   # bind
        _cp,   # root addr
        _cp,   # region id
        _i64,  # digest interval ms
        _i64,  # heartbeat timeout ms (the root's)
        _i64,  # connect timeout ms
    ]),
    "tft_region_address": (_vp, [_vp]),
    "tft_region_shutdown": (None, [_vp]),
    "tft_region_destroy": (None, [_vp]),
    "tft_region_status_json": (_int, [_vp, ctypes.POINTER(_vp)]),
    "tft_region_quorum_json": (_int, [_vp, ctypes.POINTER(_vp)]),
    # A persistent lighthouse-protocol client: batched lease renewal,
    # heartbeat and depart over one connection.
    "tft_lease_client_create": (_vp, [_cp, _i64]),
    "tft_lease_client_destroy": (None, [_vp]),
    "tft_lease_client_renew": (_int, [
        _vp, _cp, _i64, ctypes.POINTER(_i64),  # entries JSON, quorum_id out
    ]),
    "tft_lease_client_heartbeat": (_int, [_vp, _cp, _i64]),
    "tft_lease_client_depart": (_int, [_vp, _cp, _i64]),
    "tft_manager_create": (_vp, [
        _cp, _cp, _cp, _cp, _cp,  # replica id, lighthouse, host, bind, store
        ctypes.c_uint64,          # world size
        _i64, _i64,               # heartbeat interval ms, connect timeout ms
        _cp,                      # root fallback addr list ("" = none)
        _i64,                     # lease ttl ms (<= 0 = lighthouse default)
        _cp, _cp,                 # region label, host label ("" = unlabeled)
        _i64,                     # region re-probe bound
    ]),
    "tft_manager_address": (_vp, [_vp]),
    "tft_manager_using_root": (_int, [_vp]),
    "tft_manager_probe_given_up": (_int, [_vp]),
    # member-health digest (JSON) riding every later lease renewal
    "tft_manager_set_status": (_int, [_vp, _cp]),
    "tft_manager_shutdown": (None, [_vp]),
    "tft_manager_destroy": (None, [_vp]),
    "tft_client_create": (_vp, [_cp, _i64]),
    "tft_client_destroy": (None, [_vp]),
    "tft_client_quorum": (_int, [
        _vp, _i64, _i64, _cp, _int, _int, _i64, ctypes.POINTER(_vp),
    ]),
    "tft_client_checkpoint_metadata": (_int, [
        _vp, _i64, _i64, ctypes.POINTER(_vp),
    ]),
    "tft_client_should_commit": (_int, [
        _vp, _i64, _i64, _int, _i64, ctypes.POINTER(_int),
    ]),
    "tft_client_kill": (_int, [_vp, _cp]),
    "tft_store_create": (_vp, [_cp]),
    "tft_store_address": (_vp, [_vp]),
    "tft_store_port": (_int, [_vp]),
    "tft_store_shutdown": (None, [_vp]),
    "tft_store_destroy": (None, [_vp]),
    "tft_store_client_create": (_vp, [_cp, _i64]),
    "tft_store_client_destroy": (None, [_vp]),
    "tft_store_client_set": (_int, [_vp, _cp, _cp, ctypes.c_size_t, _i64]),
    "tft_store_client_get": (_int, [
        _vp, _cp, _i64, ctypes.POINTER(_vp), ctypes.POINTER(ctypes.c_size_t),
    ]),
    "tft_store_client_add": (_int, [
        _vp, _cp, _i64, _i64, ctypes.POINTER(_i64),  # key, delta, timeout, out
    ]),
    # The control plane's pure entry points (the quorum tick, the lease
    # and digest protocol) as JSON in, JSON out.
    "tft_quorum_compute": (_int, [_i64, _cp, _cp, ctypes.POINTER(_vp)]),
    "tft_compute_quorum_results": (_int, [
        _cp, _i64, _cp, ctypes.POINTER(_vp),
    ]),
    "tft_quorum_step": (_int, [_i64, _i64, _cp, _cp, ctypes.POINTER(_vp)]),
    "tft_lease_apply": (_int, [_cp, _cp, _i64, ctypes.POINTER(_vp)]),
    "tft_depart_apply": (_int, [_cp, _cp, ctypes.POINTER(_vp)]),
    "tft_digest_make": (_int, [_cp, _i64, _cp, ctypes.POINTER(_vp)]),
    "tft_digest_apply": (_int, [_cp, _cp, _i64, ctypes.POINTER(_vp)]),
    # The root's write-ahead quorum log.
    "tft_wal_open": (_vp, [_cp, _i64]),
    "tft_wal_close": (None, [_vp]),
    "tft_wal_log_lease": (_int, [_vp, _cp, _i64]),  # slices JSON, unix ms
    "tft_wal_log_depart": (_int, [_vp, _cp]),
    "tft_wal_log_quorum": (_int, [_vp, _cp, _i64, _i64]),  # gen, epoch
    "tft_wal_log_epoch": (_int, [_vp, _i64]),
    "tft_wal_snapshot": (_int, [
        _vp, _cp,
        _i64, _i64,  # quorum gen, root epoch
        _i64, _i64,  # mono now, unix now
    ]),
    "tft_wal_recover": (_int, [_cp, _i64, _i64, ctypes.POINTER(_vp)]),
    "tft_backoff_ms": (_i64, [_int, _i64, _i64, ctypes.c_uint64]),
    "tft_jittered_interval_ms": (_i64, [_i64, ctypes.c_uint64, ctypes.c_uint64]),
    # Host ring collectives.
    "tft_hc_create": (_vp, []),
    "tft_hc_destroy": (None, [_vp]),
    "tft_hc_configure_hier": (_int, [
        _vp, _cp, _i64, _i64, _i64,
        _i64,  # stripes
        _i64,  # stripes_inter (<= 0 = stripes)
        _cp,   # regions JSON ("" = flat)
        _cp,   # hosts JSON ("" = none)
    ]),
    "tft_hc_hier_capable": (_i64, [_vp]),
    # host-tier transport of the last configure: 0 none, 1 loopback TCP
    # (TORCHFT_HC_SHM=0), 2 shared-memory rings
    "tft_hc_host_tier_transport": (_i64, [_vp]),
    # the ring's CRC32C frame trailer: 1 on, 0 off (before configure)
    "tft_hc_set_wire_crc": (None, [_vp, _int]),
    "tft_hc_wire_crc": (_int, [_vp]),
    "tft_hc_release": (_int, [_vp]),
    "tft_hc_abort": (None, [_vp]),
    "tft_hc_allreduce": (_int, [_vp, _vp, ctypes.c_size_t, _int, _int, _i64]),
    # the quantized ring: int8 chunks + per-chunk f32 scales (f32 in/out)
    "tft_hc_allreduce_q8": (_int, [_vp, _vp, ctypes.c_size_t, _i64]),
    "tft_hc_allgather": (_int, [_vp, _vp, _vp, ctypes.c_size_t, _i64]),
    # (start, len) element ranges a rank owns at a pinned stripe partition
    "tft_hc_shard_ranges": (_i64, [
        _vp, ctypes.c_size_t, ctypes.c_size_t,
        _i64,  # rank
        _i64,  # layout stripes
        ctypes.POINTER(_i64), _i64,
    ]),
    # the ring's two phases as ops of their own (the sharded outer sync)
    "tft_hc_reduce_scatter": (_int, [
        _vp, _vp, ctypes.c_size_t, _int, _int,
        _vp,   # this rank's shard (out)
        _i64,  # layout stripes
        _i64,
    ]),
    "tft_hc_reduce_scatter_q8": (_int, [
        _vp, _vp, ctypes.c_size_t,
        _vp,   # this rank's shard (out)
        _int,  # grid_shard: the fused q8 op's owner quantize+decode
        _i64,  # layout stripes
        _i64,
    ]),
    "tft_hc_allgather_into": (_int, [
        _vp, _vp, _vp,  # this rank's shard, the full output
        ctypes.c_size_t, _int,
        _i64,  # layout stripes
        _i64,
    ]),
    "tft_hc_broadcast": (_int, [_vp, _vp, ctypes.c_size_t, _i64, _i64]),
    "tft_hc_barrier": (_int, [_vp, _i64]),
    "tft_hc_allreduce_hier": (_int, [
        _vp, _vp, ctypes.c_size_t, _int, _int,
        _int,  # inter-hop wire: 0 native, 1 bf16, 2 q8
        _i64,
    ]),
    # per-tier phase/byte breakdown of the last two-tier op (JSON)
    "tft_hc_last_hier_json": (_int, [_vp, ctypes.POINTER(_vp)]),
    # per-stripe wall times (ns) of the last bulk ring op
    "tft_hc_last_stripe_ns": (_i64, [_vp, ctypes.POINTER(_i64), _i64]),
    # live shared-memory segment handles in this library (the leak oracle)
    "tft_shm_live_count": (_i64, []),
    "tft_shm_unlink": (_int, [_cp]),
    # The chaos plane: this library's process-global seeded fault engine.
    "tft_fault_arm": (_int, [_cp]),  # plan JSON
    "tft_fault_disarm": (None, []),
    "tft_fault_armed": (_int, []),
    "tft_fault_stats_json": (_int, [ctypes.POINTER(_vp)]),
    # Persistent comm plans.
    "tft_plan_build": (_i64, [
        _vp, ctypes.POINTER(_i64), ctypes.POINTER(ctypes.c_int32), _i64, _int,
    ]),
    "tft_plan_build_pre": (_i64, [
        _vp, ctypes.POINTER(_i64), ctypes.POINTER(ctypes.c_int32), _i64, _int,
    ]),
    # the two-tier schedule behind the one-call execute (the wire
    # applies at the leader's inter-region hop only)
    "tft_plan_build_hier": (_i64, [
        _vp, ctypes.POINTER(_i64), ctypes.POINTER(ctypes.c_int32), _i64, _int,
    ]),
    "tft_plan_execute": (_int, [
        _vp, _i64, ctypes.POINTER(_vp), ctypes.POINTER(_vp),
        ctypes.c_double, _int, _i64,
    ]),
    "tft_plan_execute_pre": (_int, [
        _vp, _i64,
        ctypes.POINTER(_vp),  # per-group wire payloads
        ctypes.POINTER(_vp),  # per-group scale sidecars (q8)
        ctypes.POINTER(_vp),  # leaf outputs
        ctypes.c_double, _int, _i64,
    ]),
    # Sharded plans (per-step ZeRO): the fused schedule split at the
    # reduce-scatter boundary, a grad leg and a param leg.
    "tft_plan_build_sharded": (_i64, [
        _vp, ctypes.POINTER(_i64), ctypes.POINTER(ctypes.c_int32), _i64,
        _int,  # grad-leg wire: 0 native, 1 bf16, 2 q8
        _int,  # param-leg wire: 0 native, 1 bf16
    ]),
    "tft_plan_execute_rs": (_int, [
        _vp, _i64, ctypes.POINTER(_vp),
        ctypes.POINTER(ctypes.c_float),  # this rank's f32 shard (out)
        ctypes.c_double, _int, _i64,
    ]),
    "tft_plan_execute_ag": (_int, [
        _vp, _i64,
        ctypes.POINTER(ctypes.c_float),  # the updated f32 shard (in)
        ctypes.POINTER(_vp),             # leaf outputs
        _i64,
    ]),
    # out[3]: shard element count, effective stripes, total elements
    "tft_plan_sharded_meta": (_int, [_vp, _i64, ctypes.POINTER(_i64)]),
    "tft_plan_reset_feedback": (_int, [_vp, _i64]),
    # per-bucket pack/ring/unpack seconds of the plan's last execute (JSON)
    "tft_plan_stats_json": (_int, [_vp, _i64, ctypes.POINTER(_vp)]),
    # CRC32C (Castagnoli): the ring frame and heal range checksum
    "tft_crc32c": (ctypes.c_uint32, [_cp, ctypes.c_uint64]),
    "tft_crc32c_update": (ctypes.c_uint32, [
        ctypes.c_uint32, _cp, ctypes.c_uint64,
    ]),
}


class _Lib:
    """The native library, built and loaded on first attribute access
    (importing the package builds nothing and starts no process)."""

    def __init__(self) -> None:
        self._cdll: Optional[ctypes.CDLL] = None

    def _load(self) -> ctypes.CDLL:
        if self._cdll is None:
            from ._build import build_native

            lib = ctypes.CDLL(build_native())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            self._cdll = lib
        return self._cdll

    def __getattr__(self, name: str) -> Any:
        return getattr(self._load(), name)


_lib = _Lib()

_OK = 0
_TIMEOUT = 1


class WireCorruption(RuntimeError):
    """A CRC-guarded wire frame failed its integrity check (a ring frame
    or a heal stream range): a flipped bit that decoded cleanly would
    otherwise install wrong bytes with no vote to catch it. A
    RuntimeError like every native failure, with a type of its own so
    callers can tell it apart."""


# The native WireCorruptionError's message prefix: the cross-language
# contract the typed re-raise keys on.
_WIRE_CORRUPTION_PREFIX = "wire corruption:"


def _check(rc: int) -> None:
    if rc == _OK:
        return
    msg = _lib.tft_last_error().decode("utf-8", "replace")
    if rc == _TIMEOUT:
        raise TimeoutError(msg)
    if msg.startswith(_WIRE_CORRUPTION_PREFIX):
        raise WireCorruption(msg)
    raise RuntimeError(msg)


def _take_string(ptr: ctypes.c_void_p) -> str:
    try:
        return ctypes.cast(ptr, ctypes.c_char_p).value.decode("utf-8")
    finally:
        _lib.tft_string_free(ptr)


def _ms(t: Union[timedelta, float, int]) -> int:
    """A timedelta (or seconds) in integer milliseconds."""
    if isinstance(t, timedelta):
        return int(t.total_seconds() * 1000)
    return int(t * 1000)


# Native servers own background threads; libc teardown at interpreter
# exit races them, so every live server is shut down at exit.
_live_servers: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _shutdown_live_servers() -> None:
    for server in list(_live_servers):
        try:
            server.shutdown()
        except Exception:
            pass


@dataclass
class QuorumResult:
    """Per-rank quorum outcome."""

    quorum_id: int = 0
    replica_rank: int = 0
    replica_world_size: int = 0
    recover_src_manager_address: str = ""
    recover_src_rank: Optional[int] = None
    recover_dst_ranks: List[int] = field(default_factory=list)
    store_address: str = ""
    max_step: int = 0
    max_rank: Optional[int] = None
    max_world_size: int = 0
    heal: bool = False
    # Region and host label of every participant, indexed by replica
    # rank (empty strings for unlabeled members): what Manager hands the
    # data plane for the two-tier schedule and the shared-memory host tier.
    replica_regions: List[str] = field(default_factory=list)
    replica_hosts: List[str] = field(default_factory=list)

    @classmethod
    def _from_json(cls, raw: str) -> "QuorumResult":
        d = json.loads(raw)
        return cls(
            quorum_id=d["quorum_id"],
            replica_rank=d["replica_rank"],
            replica_world_size=d["replica_world_size"],
            recover_src_manager_address=d["recover_src_manager_address"],
            recover_src_rank=d.get("recover_src_rank"),
            recover_dst_ranks=list(d.get("recover_dst_ranks", [])),
            store_address=d["store_address"],
            max_step=d["max_step"],
            max_rank=d.get("max_rank"),
            max_world_size=d["max_world_size"],
            heal=d["heal"],
            replica_regions=list(d.get("replica_regions", [])),
            replica_hosts=list(d.get("replica_hosts", [])),
        )


class Lighthouse:
    """In-process global quorum server.

    The durable knobs are optional: ``wal_dir`` turns on the
    write-ahead quorum log and its snapshot, so a restarted root replays
    to its pre-crash ``quorum_id``; ``peers`` lists the other roots of
    this root's failover set (comma-separated); ``standby=True`` starts
    passive, tailing the active peer, and takes over after
    ``takeover_ms`` without a sync."""

    def __init__(
        self,
        bind: str = "[::]:0",
        min_replicas: int = 1,
        join_timeout_ms: int = 100,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
        wal_dir: str = "",
        snapshot_every: int = 0,
        peers: str = "",
        standby: bool = False,
        takeover_ms: int = 0,
    ) -> None:
        self._handle = _lib.tft_lighthouse_create(
            bind.encode(), min_replicas, join_timeout_ms, quorum_tick_ms,
            heartbeat_timeout_ms, wal_dir.encode(), snapshot_every,
            peers.encode(), 1 if standby else 0, takeover_ms,
        )
        if not self._handle:
            _check(2)
        _live_servers.add(self)

    def address(self) -> str:
        return _take_string(_lib.tft_lighthouse_address(self._handle))

    def active(self) -> bool:
        """True while this root serves; a passive standby rejects the
        protocol so clients rotate to the next endpoint."""
        return bool(_lib.tft_lighthouse_active(self._handle))

    def root_epoch(self) -> int:
        """The root epoch: bumped at every active claim (startup or
        takeover) and fenced through the WAL when there is one. 0 =
        never active."""
        return int(_lib.tft_lighthouse_root_epoch(self._handle))

    def status_json(self) -> dict:
        """Members and lease deadlines, the last quorum, the tier role
        (``flat``/``root``/``standby``), tick counters, region digests
        and the durability stamps (``root_epoch``, ``wal_replayed``,
        ``wal``); served over HTTP as ``GET /status.json``."""
        out = ctypes.c_void_p()
        _check(_lib.tft_lighthouse_status_json(self._handle, ctypes.byref(out)))
        return json.loads(_take_string(out))

    def shutdown(self) -> None:
        if self._handle:
            _lib.tft_lighthouse_shutdown(self._handle)

    def __del__(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(_lib, "_cdll", None) is not None:
            _lib.tft_lighthouse_destroy(handle)

    def __enter__(self) -> "Lighthouse":
        return self

    def __exit__(self, *exc: object) -> None:
        self.shutdown()


class RegionLighthouse:
    """In-process region lighthouse, the middle tier of the quorum
    service: it serves the manager-facing lighthouse protocol locally,
    pushes membership digests to the root and long-polls the global
    quorum back out."""

    def __init__(
        self,
        root_addr: str,
        region_id: str,
        bind: str = "[::]:0",
        digest_interval_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
        connect_timeout_ms: int = 10000,
    ) -> None:
        self._handle = _lib.tft_region_create(
            bind.encode(), root_addr.encode(), region_id.encode(),
            digest_interval_ms, heartbeat_timeout_ms, connect_timeout_ms,
        )
        if not self._handle:
            _check(2)
        _live_servers.add(self)

    def address(self) -> str:
        return _take_string(_lib.tft_region_address(self._handle))

    def status_json(self) -> dict:
        out = ctypes.c_void_p()
        _check(_lib.tft_region_status_json(self._handle, ctypes.byref(out)))
        return json.loads(_take_string(out))

    def quorum_json(self) -> dict:
        """The region's cache of the last global quorum with its
        refresh ``age_ms`` (also ``GET /quorum.json``); it keeps serving,
        with a growing age, while the root is down."""
        out = ctypes.c_void_p()
        _check(_lib.tft_region_quorum_json(self._handle, ctypes.byref(out)))
        return json.loads(_take_string(out))

    def shutdown(self) -> None:
        if self._handle:
            _lib.tft_region_shutdown(self._handle)

    def __del__(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(_lib, "_cdll", None) is not None:
            _lib.tft_region_destroy(handle)

    def __enter__(self) -> "RegionLighthouse":
        return self

    def __exit__(self, *exc: object) -> None:
        self.shutdown()


class LeaseClient:
    """Persistent lighthouse-protocol client: batched lease renewals,
    heartbeats and departs over one connection (simulated groups and
    host-level renewal batchers; real managers renew through their
    native server)."""

    def __init__(
        self, addr: str, connect_timeout: timedelta = timedelta(seconds=10)
    ) -> None:
        self._handle = _lib.tft_lease_client_create(
            addr.encode(), _ms(connect_timeout))

    def renew(
        self, entries: List[dict], timeout: timedelta = timedelta(seconds=10)
    ) -> int:
        """Renews a batch of leases, each ``{replica_id, ttl_ms,
        participating, member}``; returns the service's quorum_id."""
        out = ctypes.c_int64()
        _check(_lib.tft_lease_client_renew(
            self._handle, json.dumps(entries).encode(), _ms(timeout),
            ctypes.byref(out)))
        return out.value

    def heartbeat(
        self, replica_id: str, timeout: timedelta = timedelta(seconds=10)
    ) -> None:
        _check(_lib.tft_lease_client_heartbeat(
            self._handle, replica_id.encode(), _ms(timeout)))

    def depart(
        self, replica_id: str, timeout: timedelta = timedelta(seconds=10)
    ) -> None:
        _check(_lib.tft_lease_client_depart(
            self._handle, replica_id.encode(), _ms(timeout)))

    def __del__(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(_lib, "_cdll", None) is not None:
            _lib.tft_lease_client_destroy(handle)


def lighthouse_heartbeat(
    addr: str, replica_id: str, timeout: timedelta = timedelta(seconds=5)
) -> None:
    """One heartbeat for ``replica_id``: a live non-participant."""
    _check(_lib.tft_lighthouse_heartbeat(
        addr.encode(), replica_id.encode(), _ms(timeout)))


class Manager:
    """Native per-replica-group manager server, hosted by group rank 0."""

    def __init__(
        self,
        replica_id: str,
        lighthouse_addr: str,
        hostname: str,
        bind: str,
        store_addr: str,
        world_size: int,
        heartbeat_interval: timedelta = timedelta(milliseconds=100),
        connect_timeout: timedelta = timedelta(seconds=60),
        root_addr: str = "",
        lease_ttl: Optional[timedelta] = None,
        region: str = "",
        host: str = "",
        region_probe_max: int = 0,
    ) -> None:
        """``lighthouse_addr`` is the group's lighthouse: the flat or
        root service, or a region lighthouse under a hierarchical tier.
        ``root_addr`` ("" = none) is the root fallback a dead region
        demotes the group to. Either may be a comma-separated failover
        set (active root and warm standbys); a failed renewal rotates to
        the next endpoint on a jittered backoff. ``lease_ttl`` (None =
        the lighthouse's default) is how long the group stays live
        without a renewal. ``region_probe_max`` bounds a demoted
        manager's region re-probes (0 = forever). ``region`` and
        ``host`` ("" = unlabeled) ride the quorum request into every
        member's quorum result, whose region and host maps the data
        plane compiles into the two-tier schedule and the shared-memory
        intra-host tier."""
        self._handle = _lib.tft_manager_create(
            replica_id.encode(), lighthouse_addr.encode(), hostname.encode(),
            bind.encode(), store_addr.encode(), world_size,
            _ms(heartbeat_interval), _ms(connect_timeout),
            root_addr.encode(),
            _ms(lease_ttl) if lease_ttl is not None else 0,
            region.encode(), host.encode(), region_probe_max,
        )
        if not self._handle:
            _check(2)
        _live_servers.add(self)

    def using_root_fallback(self) -> bool:
        """True while region failover has this group registered directly
        at the root (always False without a ``root_addr``)."""
        return bool(_lib.tft_manager_using_root(self._handle))

    def region_probe_given_up(self) -> bool:
        """True once ``region_probe_max`` consecutive region re-probes
        failed: the manager stays on the root and probes no more."""
        return bool(_lib.tft_manager_probe_given_up(self._handle))

    def address(self) -> str:
        return _take_string(_lib.tft_manager_address(self._handle))

    def set_status(self, status: dict) -> None:
        """Publishes a member-health digest that rides every later lease
        renewal to the lighthouse, where it shows under this member in
        ``/status.json`` (``members[i].status``). Display-only: the
        quorum never reads it."""
        _check(_lib.tft_manager_set_status(
            self._handle, json.dumps(status).encode()))

    def shutdown(self) -> None:
        if self._handle:
            _lib.tft_manager_shutdown(self._handle)

    def __del__(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(_lib, "_cdll", None) is not None:
            _lib.tft_manager_destroy(handle)


class ManagerClient:
    """Blocking client for a manager server."""

    def __init__(
        self, addr: str, connect_timeout: timedelta = timedelta(seconds=60)
    ) -> None:
        self._handle = _lib.tft_client_create(addr.encode(), _ms(connect_timeout))

    def quorum(
        self,
        rank: int,
        step: int,
        checkpoint_metadata: str,
        shrink_only: bool = False,
        force_reconfigure: bool = False,
        timeout: timedelta = timedelta(seconds=60),
    ) -> QuorumResult:
        out = ctypes.c_void_p()
        _check(
            _lib.tft_client_quorum(
                self._handle, rank, step, checkpoint_metadata.encode(),
                1 if shrink_only else 0, 1 if force_reconfigure else 0,
                _ms(timeout), ctypes.byref(out),
            )
        )
        return QuorumResult._from_json(_take_string(out))

    def checkpoint_metadata(
        self, rank: int, timeout: timedelta = timedelta(seconds=60)
    ) -> str:
        out = ctypes.c_void_p()
        _check(
            _lib.tft_client_checkpoint_metadata(
                self._handle, rank, _ms(timeout), ctypes.byref(out)
            )
        )
        return _take_string(out)

    def should_commit(
        self,
        rank: int,
        step: int,
        should_commit: bool,
        timeout: timedelta = timedelta(seconds=60),
    ) -> bool:
        out = ctypes.c_int()
        _check(
            _lib.tft_client_should_commit(
                self._handle, rank, step, 1 if should_commit else 0,
                _ms(timeout), ctypes.byref(out),
            )
        )
        return bool(out.value)

    def kill(self, msg: str = "") -> None:
        """Asks the manager server to exit its process (``_exit(1)`` in
        whatever process hosts it)."""
        _check(_lib.tft_client_kill(self._handle, msg.encode()))

    def __del__(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(_lib, "_cdll", None) is not None:
            _lib.tft_client_destroy(handle)


class Store:
    """Rendezvous KV store server (the c10d TCPStore role)."""

    def __init__(self, bind: str = "[::]:0") -> None:
        self._handle = _lib.tft_store_create(bind.encode())
        if not self._handle:
            _check(2)
        _live_servers.add(self)

    def address(self) -> str:
        return _take_string(_lib.tft_store_address(self._handle))

    @property
    def port(self) -> int:
        return _lib.tft_store_port(self._handle)

    def shutdown(self) -> None:
        if self._handle:
            _lib.tft_store_shutdown(self._handle)

    def __del__(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(_lib, "_cdll", None) is not None:
            _lib.tft_store_destroy(handle)


class StoreClient:
    """Client for a :class:`Store`."""

    def __init__(
        self, addr: str, connect_timeout: timedelta = timedelta(seconds=60)
    ) -> None:
        self._handle = _lib.tft_store_client_create(
            addr.encode(), _ms(connect_timeout)
        )
        if not self._handle:
            _check(2)

    def set(
        self, key: str, value: bytes, timeout: timedelta = timedelta(seconds=60)
    ) -> None:
        _check(
            _lib.tft_store_client_set(
                self._handle, key.encode(), value, len(value), _ms(timeout)
            )
        )

    def get(self, key: str, timeout: timedelta = timedelta(seconds=60)) -> bytes:
        out = ctypes.c_void_p()
        out_len = ctypes.c_size_t()
        _check(
            _lib.tft_store_client_get(
                self._handle, key.encode(), _ms(timeout), ctypes.byref(out),
                ctypes.byref(out_len),
            )
        )
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            _lib.tft_string_free(out)

    def add(
        self, key: str, delta: int, timeout: timedelta = timedelta(seconds=60)
    ) -> int:
        """Adds ``delta`` to the integer at ``key`` and returns the sum."""
        out = ctypes.c_int64()
        _check(_lib.tft_store_client_add(
            self._handle, key.encode(), delta, _ms(timeout), ctypes.byref(out)))
        return out.value

    def __del__(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(_lib, "_cdll", None) is not None:
            _lib.tft_store_client_destroy(handle)


def _crc_arg(data: Union[bytes, bytearray, memoryview]) -> "tuple[Any, int]":
    """Bytes pass through; writable buffers (the heal receiver's buffer)
    hash in place through a c_char view; read-only views pay one copy."""
    if isinstance(data, bytes):
        return data, len(data)
    mv = memoryview(data).cast("B")
    n = mv.nbytes
    if n == 0:
        return b"", 0
    if mv.readonly:
        return mv.tobytes(), n
    return (ctypes.c_char * n).from_buffer(mv), n


def crc32c(data: Union[bytes, bytearray, memoryview]) -> int:
    """CRC32C (Castagnoli), as the native ring frames and the heal
    stream ranges carry it."""
    buf, n = _crc_arg(data)
    return int(_lib.tft_crc32c(buf, n))


def crc32c_update(state: int, data: Union[bytes, bytearray, memoryview]) -> int:
    """Incremental CRC32C: seed with ``0xFFFFFFFF``, chain updates,
    finish with ``state ^ 0xFFFFFFFF``."""
    buf, n = _crc_arg(data)
    if n == 0:
        return state
    return int(_lib.tft_crc32c_update(state, buf, n))


def crc32c_combine(parts: List[Union[bytes, bytearray, memoryview]]) -> int:
    """CRC32C over the concatenation of ``parts``, never built."""
    state = 0xFFFFFFFF
    for part in parts:
        state = crc32c_update(state, part)
    return state ^ 0xFFFFFFFF


def _json_call(fn: Any, *args: Any) -> Any:
    out = ctypes.c_void_p()
    _check(fn(*args, ctypes.byref(out)))
    return json.loads(_take_string(out))


def _dumps(obj: Any) -> bytes:
    return json.dumps(obj).encode()


def quorum_compute(now_ms: int, state: dict, opt: dict) -> dict:
    """The native quorum_compute as a pure function: ``{"quorum":
    [members] | None, "reason": str}``."""
    return _json_call(_lib.tft_quorum_compute, now_ms, _dumps(state), _dumps(opt))


def compute_quorum_results(replica_id: str, rank: int, quorum: dict) -> QuorumResult:
    """The native compute_quorum_results as a pure function."""
    out = ctypes.c_void_p()
    _check(_lib.tft_compute_quorum_results(
        replica_id.encode(), rank, _dumps(quorum), ctypes.byref(out)))
    return QuorumResult._from_json(_take_string(out))


def quorum_step(now_ms: int, unix_now_ms: int, state: dict, opt: dict) -> dict:
    """One quorum tick as a pure state transition, the function both
    the flat lighthouse and the hierarchical root run: ``{"state",
    "quorum", "changed", "reason"}``."""
    return _json_call(_lib.tft_quorum_step, now_ms, unix_now_ms,
                      _dumps(state), _dumps(opt))


def lease_apply(state: dict, entries: list, now_ms: int) -> dict:
    """Applies a batched lease renewal to a lighthouse state."""
    return _json_call(_lib.tft_lease_apply, _dumps(state), _dumps(entries), now_ms)


def depart_apply(state: dict, replica_id: str) -> dict:
    """Applies an explicit depart to a lighthouse state."""
    return _json_call(_lib.tft_depart_apply, _dumps(state), replica_id.encode())


def digest_make(state: dict, now_ms: int, opt: dict) -> list:
    """The region side of the digest protocol: age-relative entries."""
    return _json_call(_lib.tft_digest_make, _dumps(state), now_ms, _dumps(opt))


def digest_apply(state: dict, digest: list, now_ms: int) -> dict:
    """The root side of the digest protocol: merges entries into a state."""
    return _json_call(_lib.tft_digest_apply, _dumps(state), _dumps(digest), now_ms)


class WalLog:
    """A handle on a root's write-ahead quorum log, the same native
    class the live lighthouse writes through. Scripted clocks pass one
    ``t`` as both mono and unix time, so the replay's rebase is the
    identity."""

    def __init__(self, dir: str, snapshot_every: int = 0) -> None:
        self._handle = _lib.tft_wal_open(dir.encode(), snapshot_every)
        if not self._handle:
            _check(2)

    def log_lease(self, entries: List[dict], unix_ms: int) -> None:
        """Appends post-apply member slices, each ``{replica_id, age_ms,
        ttl_ms, participating, joined_age_ms, member}``, ages relative
        to ``unix_ms``."""
        _check(_lib.tft_wal_log_lease(self._handle, _dumps(entries), unix_ms))

    def log_depart(self, replica_id: str) -> None:
        _check(_lib.tft_wal_log_depart(self._handle, replica_id.encode()))

    def log_quorum(self, quorum: dict, quorum_gen: int, root_epoch: int) -> None:
        _check(_lib.tft_wal_log_quorum(
            self._handle, _dumps(quorum), quorum_gen, root_epoch))

    def log_epoch(self, epoch: int) -> None:
        _check(_lib.tft_wal_log_epoch(self._handle, epoch))

    def snapshot(self, state: dict, quorum_gen: int, root_epoch: int,
                 mono_now: int, unix_now: int) -> None:
        """Writes ``snapshot.json`` atomically and truncates the log."""
        _check(_lib.tft_wal_snapshot(
            self._handle, _dumps(state), quorum_gen, root_epoch, mono_now,
            unix_now))

    def close(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(_lib, "_cdll", None) is not None:
            _lib.tft_wal_close(handle)

    def __del__(self) -> None:
        self.close()


def wal_recover(dir: str, mono_now: int, unix_now: int) -> dict:
    """Replays a WAL directory (snapshot and log) into ``{"state",
    "quorum_gen", "root_epoch", "replayed", "records_replayed",
    "dropped_tail_bytes"}``, times rebased onto ``mono_now``. A torn
    tail record fails its length or CRC and is dropped whole."""
    return _json_call(_lib.tft_wal_recover, dir.encode(), mono_now, unix_now)


def backoff_ms(failures: int, base_ms: int, max_ms: int, seed: int) -> int:
    """The renewal loop's deterministic jittered exponential backoff."""
    return _lib.tft_backoff_ms(failures, base_ms, max_ms, seed)


def jittered_interval_ms(interval_ms: int, seed: int, tick: int) -> int:
    """The deterministic jittered renewal interval."""
    return _lib.tft_jittered_interval_ms(interval_ms, seed, tick)


def shm_unlink(name: str) -> None:
    """Removes a shared-memory segment name (idempotent; mappings stay
    valid): the cleanup a respawn runs before it creates again."""
    _check(_lib.tft_shm_unlink(name.encode()))


def fault_arm(plan: dict) -> None:
    """Arms (replaces) this library's process-global seeded fault plan
    (:mod:`torchft_tpu_torch.chaos` builds them). Stats persist across
    re-arms; :func:`fault_disarm` resets everything. A process that
    loads two builds of the native library has two engines: arm the one
    whose ring sends the frame."""
    _check(_lib.tft_fault_arm(_dumps(plan)))


def fault_disarm() -> None:
    """Disarms injection and clears the plan and stats; disarmed, every
    injection point costs one relaxed atomic load."""
    _lib.tft_fault_disarm()


def fault_armed() -> bool:
    return bool(_lib.tft_fault_armed())


def fault_stats() -> dict:
    """Cumulative injections: ``{"armed", "fired_total", "fired":
    {"seam:kind": n}}``."""
    out = ctypes.c_void_p()
    _check(_lib.tft_fault_stats_json(ctypes.byref(out)))
    return json.loads(_take_string(out))
