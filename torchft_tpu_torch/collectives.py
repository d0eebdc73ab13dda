"""Reconfigurable collectives for the cross-replica-group gradient sync.

The port of ``torchft_tpu/collectives.py``, cut to the training path: a
``Collectives`` object is ``configure()``d onto a new membership at every
quorum change, on a per-quorum store prefix so stale members never
cross-talk. The transport is the native TCP ring (the Gloo role): a dead
replica group surfaces as an abortable socket error, never a wedged
device collective.

The gradient sync runs through persistent comm plans
(:meth:`HostCollectives.plan_allreduce`): the leaf layout, wire encoding
and staging are compiled once per tree signature and each step is one
GIL-released native call. Two ways to feed a flat plan:

- host pack: leaves (copied to the host when they live on the card) go
  to the native plan, which casts/quantizes them itself;
- device pack (:class:`_DeviceWirePacker`): the port's CUDA kernels emit
  the wire encoding on the card (int8 codes + per-leaf scales for
  ``q8ef``, bf16 words for ``bf16``), only wire-sized bytes cross into
  pinned host staging, and the native plan decodes them straight into
  its ring buffer.

Both produce bit-identical ring staging, and so do the JAX package's
host and device packs: members of either package may share one ring.
Leaves flatten in ``jax.tree_util`` order (:mod:`._tree`), so plan group
layouts agree leaf for leaf across the packages.

Topology: ``configure`` takes the quorum's region and host maps. Members
sharing a (region, host) pair reduce over shared-memory rings (the host
tier), host leaders of a region over a TCP ring (the intra tier), and
one leader per region over the inter-region ring, whose hop alone
carries the wire encoding (:meth:`HostCollectives.allreduce_hier`,
``plan_allreduce(hier=True)``).

Every op records its phase timings, drained by
:meth:`OpStatsMixin.pop_op_stats` with the JAX package's keys (plan ops
add the native per-bucket ``pack_s``/``ring_s``/``unpack_s`` split,
two-tier ops the per-tier seconds and measured bytes).

Ops are asynchronous: each returns a :class:`Work`; one executor thread
issues them in submission order.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import time
from abc import ABC, abstractmethod
from concurrent.futures import Future, ThreadPoolExecutor
from datetime import timedelta
from enum import IntEnum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import _native
from ._native import _check, _lib, _ms
from ._tree import flatten as _flatten
from ._tree import unflatten as _unflatten
from .ops import quantize_kernels as qk


class ReduceOp(IntEnum):
    """Matches tft::ReduceOp in native/src/collectives.h. AVG is SUM
    followed by a host-side divide."""

    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVG = 100


# Native dtype codes (tft::Dtype).
_NATIVE_DTYPES = {
    torch.float32: 0,
    torch.float64: 1,
    torch.int32: 2,
    torch.int64: 3,
    torch.bfloat16: 4,
}


class Work:
    """Handle for an async collective; the result is the output tree."""

    def __init__(self, future: "Future[Any]") -> None:
        self._future = future

    def wait(self, timeout: Optional[timedelta] = None) -> Any:
        return self._future.result(
            timeout=timeout.total_seconds() if timeout is not None else None
        )

    def add_done_callback(self, fn: Callable[["Future[Any]"], None]) -> None:
        self._future.add_done_callback(fn)


def _completed(value: Any) -> Work:
    f: "Future[Any]" = Future()
    f.set_result(value)
    return Work(f)


class Collectives(ABC):
    """Reconfigurable collectives over replica groups."""

    @abstractmethod
    def configure(
        self,
        store_addr: str,
        rank: int,
        world_size: int,
        regions: Optional[Sequence[str]] = None,
        hosts: Optional[Sequence[str]] = None,
    ) -> None:
        """(Re)builds the communicator for a new membership.
        ``store_addr`` is ``host:port/prefix`` with a prefix unique to the
        quorum. ``regions`` / ``hosts``: one region and one host label
        per rank (the quorum's maps); a backend that understands topology
        compiles them into the two-tier schedule, others ignore them."""

    def hier_capable(self) -> bool:
        """Whether the last configure built a two-tier schedule (a region
        map with >= 2 distinct labels and/or a host map grouping >= 2
        co-hosted ranks)."""
        return False

    def allreduce_hier(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
    ) -> Work:
        """Like :meth:`allreduce` over the two-tier schedule; ``wire``
        (``None`` | ``"bf16"`` | ``"q8"``) encodes the inter-region hop
        only. Bit-identical across members; the summation order differs
        from the flat ring's. Raises without a hier-capable configure."""
        raise NotImplementedError(
            f"{type(self).__name__} has no two-tier schedule"
        )

    @abstractmethod
    def allreduce(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
    ) -> Work:
        """Reduces a tree of tensors across the group; the result has the
        same structure, dtypes and devices, bit-identical on every rank.
        ``divisor`` (SUM only) divides the reduced result."""

    def plan_allreduce(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
        device_pack: bool = True,
        hier: bool = False,
    ) -> Work:
        """Like :meth:`allreduce` (SUM/AVG only) through a persistent
        precompiled comm plan. ``wire``: ``None`` ships native dtypes,
        ``"bf16"`` rounds f32 leaves to bfloat16, ``"q8"`` ships int8
        ring chunks, ``"q8ef"`` adds per-leaf int8 quantization with
        error feedback. ``device_pack=False`` packs CPU leaves on the
        host instead; ``hier`` runs the two-tier schedule (see
        :meth:`HostCollectives.plan_allreduce`)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no persistent comm plans"
        )

    def plan_reset_feedback(self) -> None:
        """Zeroes the error-feedback carry of every cached ``q8ef`` plan;
        call on heal/abort."""

    @abstractmethod
    def size(self) -> int:
        ...

    @abstractmethod
    def rank(self) -> int:
        ...

    def shutdown(self) -> None:
        ...


# Python wire names -> native PlanWire codes (collectives.h).
_PLAN_WIRES = {None: 0, "bf16": 1, "q8": 2, "q8ef": 3}

# Inter-hop wire codes of the two-tier bulk op (native HierWire).
_HIER_WIRES = {None: 0, "bf16": 1, "q8": 2}

# Cap on the per-stripe timing readback (native kMaxStripes).
_MAX_STRIPES = 64

# Native kMinStripeBytes: effective_stripes' payload-derived partition.
_MIN_STRIPE_BYTES = 64 << 10

# Bytes of the native per-op header exchange (magic, kind, count, dtype, op).
_OP_HEADER_BYTES = 24


def _effective_stripes(payload: int, configured: int) -> int:
    return max(1, min(configured, max(1, payload // _MIN_STRIPE_BYTES)))


def _q8_wire_overhead(eff: int, world: int, phases: int = 2) -> int:
    """Bytes the q8 wire ships beyond its int8 codes: one f32 scale per
    (stripe, ring chunk) per quantized phase, plus the op header."""
    return 4 * eff * max(world, 1) * phases + _OP_HEADER_BYTES


# numpy dtype names, which order the JAX package's bulk groups
_NP_NAMES = {
    torch.float32: "float32",
    torch.float64: "float64",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.bfloat16: "bfloat16",
}

# Wires the device pack serves. Plain "q8" ships RAW f32 to the quantized
# ring by contract; quantizing at the device boundary would change its
# numerics ("q8ef" is what PipelinedDDP's q8 mode uses).
_DEVICE_PACK_WIRES = (None, "bf16", "q8ef")


def _fingerprint(stripes: int, regions: Sequence[str],
                 hosts: Sequence[str]) -> str:
    """The ring-schedule fingerprint every member checks through the
    store at configure. The first two fields are the JAX package's
    pipelined-legacy knobs at their defaults (the port does not
    pipeline), the stripe count stands for both the flat and the
    inter-region rings, then the region map, and, only when every rank
    carries a host label, the host map and the shm knobs (transport and
    ring capacity: the two ends of a shm ring must agree). Identical to
    a default JAX member's, so members of both packages share a ring."""
    fp = f"4:4194304:{stripes}:{stripes}:{','.join(regions)}"
    if hosts and all(hosts):
        shm_on = os.environ.get("TORCHFT_HC_SHM", "").lower() not in (
            "0", "off", "false")
        shm_ring = max(int(os.environ.get("TORCHFT_HC_SHM_RING_BYTES",
                                          str(1 << 20))), 4096)
        fp += f":hosts={','.join(hosts)}:shm{1 if shm_on else 0}:{shm_ring}"
    return fp


Sig = Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]


def _signature(leaves: Sequence[torch.Tensor]) -> Sig:
    return tuple((tuple(l.shape), l.dtype) for l in leaves)


def _plan_groups(
    sig: Sequence[Tuple[Any, torch.dtype]], wire: Optional[str]
) -> List[Tuple[torch.dtype, List[int]]]:
    """leaf -> group assignment of a comm plan, replicating native
    plan_build EXACTLY (first-appearance order of the group dtype over
    leaves in signature order): the prepacked execute indexes groups
    positionally. Raises KeyError on a signature no plan can take."""
    groups: List[Tuple[torch.dtype, List[int]]] = []
    for i, (_, dt) in enumerate(sig):
        if wire in ("q8", "q8ef"):
            if dt not in (torch.float32, torch.bfloat16):
                raise KeyError(dt)
            gdt = torch.float32
        else:
            if dt not in _NATIVE_DTYPES:
                raise KeyError(dt)
            gdt = (
                torch.bfloat16
                if (wire == "bf16" and dt == torch.float32) else dt
            )
        for g in groups:
            if g[0] == gdt:
                g[1].append(i)
                break
        else:
            groups.append((gdt, [i]))
    return groups


def _canonical_nan(t: torch.Tensor) -> torch.Tensor:
    """f32 host tensor with every NaN rewritten to sign | 0x7FC00000.

    The native bf16 pack rounds with a carry that overflows on
    high-mantissa NaNs (0x7FFFFFFF, the card's canonical NaN, comes out
    as -0.0); the canonical quiet NaN survives it as 0x7FC0."""
    nan = torch.isnan(t)
    if not bool(nan.any()):
        return t
    bits = t.view(torch.int32)
    canon = torch.where(
        bits < 0,
        torch.tensor(-0x00400000, dtype=torch.int32),  # 0xFFC00000
        torch.tensor(0x7FC00000, dtype=torch.int32),
    )
    return torch.where(nan, canon, bits).view(torch.float32)


class _DeviceWirePacker:
    """Pack of a fixed tree signature into the WIRE encoding on the
    leaves' device, with the port's kernels (:mod:`.ops.quantize_kernels`),
    emitting the per-group buffers a prepacked CommPlan decodes:

    - ``wire="q8ef"``: per-leaf int8 EF quantization, one K1a and one
      K1b launch for the plan's single f32 group
      (:func:`.ops.quantize_kernels.quantize_q8_ef_group`). The codes
      land in the group's concatenated layout in a device buffer
      allocated once, the per-leaf scales form the sidecar, and the
      error-feedback carry lives here as one flat f32 buffer on the
      device, advanced in place, never crossing to the host.
    - ``wire="bf16"``: a bf16 group with f32 leaves is cast by one K3
      launch (:func:`.ops.quantize_kernels.cast_bf16_group`) that reads
      the leaves in place and writes the group's bf16 wire buffer,
      allocated once here; an all-bf16 group and other dtypes pack
      natively (concatenated).
    - ``wire=None``: the plain concat pack (one transfer per group).

    For leaves on the card the pack runs on the packer's own stream,
    which first waits on an event the caller recorded after producing the
    leaves; the packed buffers are copied into pinned host staging
    allocated once here, and only an event recorded after those copies is
    waited on before the native plan reads them. Work the caller queued
    on its own stream after the event (the next step's forward/backward)
    runs alongside and is never waited on. For CPU leaves the kernels'
    plain versions run and no staging copy is made. Nothing here falls
    back: a kernel that fails to build or launch raises."""

    def __init__(self, leaves: Sequence[torch.Tensor], wire: Optional[str]) -> None:
        if wire not in _DEVICE_PACK_WIRES:
            raise ValueError(f"no device pack for wire {wire!r}")
        self.wire = wire
        self.sig = _signature(leaves)
        try:
            self.groups = _plan_groups(self.sig, wire)
        except KeyError as e:
            raise ValueError(
                f"wire {wire!r} cannot pack leaves of dtype {e.args[0]}"
            ) from None
        self.device = leaves[0].device
        if any(l.device != self.device for l in leaves):
            raise ValueError("device pack needs every leaf on one device")
        self.staged = self.device.type == "cuda"
        # Everything the pack allocates or touches on the card lives on
        # this stream: the EF carry never meets the caller's stream.
        self.stream = torch.cuda.Stream(self.device) if self.staged else None
        # q8ef: the EF carry (one flat f32 buffer; ``residuals`` are its
        # per-leaf views, for any reader) and the group's wire buffers
        self.residuals: Optional[List[torch.Tensor]] = None
        if wire == "q8ef":
            ((_, idxs),) = self.groups  # q8 plans are a single f32 group
            counts = [math.prod(self.sig[i][0]) for i in idxs]
            with self._on_stream():
                self._carry = torch.zeros(sum(counts), dtype=torch.float32,
                                          device=self.device)
                self._codes = torch.empty(sum(counts), dtype=torch.int8,
                                          device=self.device)
                self._scales = torch.empty(len(idxs), dtype=torch.float32,
                                           device=self.device)
            self.residuals = [
                v.view(self.sig[i][0]) for i, v in
                zip(idxs, torch.split(self._carry, counts))
            ]
        # bf16: each group's bf16 wire buffer where K3 casts (None: the
        # group concatenates natively)
        self._casts: List[Optional[torch.Tensor]] = [None] * len(self.groups)
        if wire == "bf16":
            with self._on_stream():
                for g, (gdt, idxs) in enumerate(self.groups):
                    if gdt == torch.bfloat16 and any(
                        self.sig[i][1] != torch.bfloat16 for i in idxs
                    ):
                        self._casts[g] = torch.empty(
                            sum(math.prod(self.sig[i][0]) for i in idxs),
                            dtype=torch.bfloat16, device=self.device)
        self._host_payloads: List[torch.Tensor] = []
        self._host_scales: List[torch.Tensor] = []
        self.last_split = (0.0, 0.0)
        if self.staged:
            for gdt, idxs in self.groups:
                count = sum(math.prod(self.sig[i][0]) for i in idxs)
                wdt = torch.int8 if wire == "q8ef" else gdt
                self._host_payloads.append(
                    torch.empty(count, dtype=wdt, pin_memory=True)
                )
                if wire == "q8ef":
                    self._host_scales.append(
                        torch.empty(len(idxs), dtype=torch.float32,
                                    pin_memory=True)
                    )

    def _on_stream(self) -> Any:
        return (torch.cuda.stream(self.stream) if self.staged
                else contextlib.nullcontext())

    def _pack_on_device(
        self, leaves: Sequence[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        if self.residuals is not None:
            ((_, idxs),) = self.groups
            qk.quantize_q8_ef_group([leaves[i] for i in idxs], self._carry,
                                    self._codes, self._scales)
            return [self._codes], [self._scales]
        payloads = []
        for (gdt, idxs), buf in zip(self.groups, self._casts):
            if buf is not None:
                # f32 (or mixed) sources: one cast launch per group into
                # its wire buffer (bf16 -> f32 -> bf16 round-trips exactly).
                # Reusing the buffer is safe: its d2h copy runs on this
                # stream and pack_step waits for it before returning.
                qk.cast_bf16_group([leaves[i] for i in idxs], buf)
                payloads.append(buf)
            else:
                payloads.append(
                    torch.cat([leaves[i].to(gdt).reshape(-1) for i in idxs])
                )
        return payloads, []

    def pack_step(
        self, leaves: Sequence[torch.Tensor], ready: Any = None
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(payloads, scales) as host tensors, one entry per plan group
        (scales empty off the q8ef wire). Advances the EF carry. For card
        leaves ``ready`` is the CUDA event recorded on the caller's stream
        once the leaves were written; the leaves must stay alive until
        this returns. Sets ``last_split``: the host seconds until the
        pack's launches and copies were queued, and then until the copies
        had landed."""
        if _signature(leaves) != self.sig:
            raise ValueError("leaves do not match the packer's signature")
        t0 = time.perf_counter()
        if not self.staged:
            payloads, scales = self._pack_on_device(leaves)
            out = ([p.contiguous() for p in payloads],
                   [s.contiguous() for s in scales])
            self.last_split = (time.perf_counter() - t0, 0.0)
            return out
        with torch.cuda.device(self.device), self._on_stream():
            self.stream.wait_event(ready)
            payloads, scales = self._pack_on_device(leaves)
            for host, dev in zip(self._host_payloads, payloads):
                host.copy_(dev, non_blocking=True)
            for host, dev in zip(self._host_scales, scales):
                host.copy_(dev, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        t1 = time.perf_counter()
        copied.synchronize()
        self.last_split = (t1 - t0, time.perf_counter() - t1)
        return self._host_payloads, self._host_scales

    def reset_feedback(self) -> None:
        """Zeroes the EF carry (the heal/abort discipline, same contract
        as the native plan carry)."""
        if self.residuals is not None:
            with self._on_stream():
                self._carry.zero_()


class _CommPlan:
    """Python handle for one native CommPlan.

    Everything a step needs is allocated once: the input pointer arrays
    and two alternating sets of host output tensors (a caller may still
    hold step k's result while step k+1 executes, so outputs
    double-buffer; a result older than two executes is overwritten).
    Outputs are pinned when the leaves live on the card; their upload is
    then asynchronous, and a set is not rewritten before the event
    recorded after its last upload has passed.

    A two-tier plan (``hier``) over card leaves also owns one pinned host
    tensor per leaf, the native host pack's input, and the stream that
    copies the leaves into them; the input pointers are set here once."""

    def __init__(self, handle: Any, sig: Sig, wire: Optional[str],
                 prepacked: bool, pin: bool, hier: bool = False,
                 stripes: int = 1, world: int = 1,
                 device: Optional[torch.device] = None) -> None:
        assert not (prepacked and hier)
        self.sig = sig
        self.wire = wire
        n = len(sig)
        counts = [math.prod(s) for s, _ in sig]
        codes = [_NATIVE_DTYPES[dt] for _, dt in sig]  # KeyError: no plan
        build = (_lib.tft_plan_build_hier if hier
                 else _lib.tft_plan_build_pre if prepacked
                 else _lib.tft_plan_build)
        plan_id = build(
            handle,
            (ctypes.c_int64 * n)(*counts),
            (ctypes.c_int32 * n)(*codes),
            n,
            _PLAN_WIRES[wire],
        )
        if plan_id < 0:
            _check(2)
        self.plan_id = plan_id
        self.in_ptrs = (ctypes.c_void_p * n)()
        if prepacked:
            ng = len(_plan_groups(sig, wire))
            self.group_in = (ctypes.c_void_p * ng)()
            self.group_aux = (ctypes.c_void_p * ng)()
        self.staging: List[torch.Tensor] = []
        self.stream = None
        if hier and pin:
            self.staging = [torch.empty(s, dtype=dt, pin_memory=True)
                            for s, dt in sig]
            for i, t in enumerate(self.staging):
                self.in_ptrs[i] = t.data_ptr()
            self.stream = torch.cuda.Stream(device)
        self.out_sets: List[List[torch.Tensor]] = []
        self.out_ptrs: List[Any] = []
        for _ in range(2):
            outs = [torch.empty(s, dtype=dt, pin_memory=pin) for s, dt in sig]
            self.out_sets.append(outs)
            self.out_ptrs.append(
                (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
            )
        self.uploaded: List[Optional[Any]] = [None, None]
        self.flip = 0
        self.execs = 0
        # The op-stats byte bill (the JAX package's _CommPlan): leaf
        # bytes, and what the TCP wire ships for them.
        self.bytes = sum(c * dt.itemsize for c, (_, dt) in zip(counts, sig))
        if wire in ("q8", "q8ef"):
            total = sum(counts)
            self.wire_bytes = total + _q8_wire_overhead(
                _effective_stripes(total, stripes), world)
        elif wire == "bf16":
            self.wire_bytes = sum(
                c * (2 if dt == torch.float32 else dt.itemsize)
                for c, (_, dt) in zip(counts, sig))
        else:
            self.wire_bytes = self.bytes

    def next_outputs(self) -> Tuple[int, List[torch.Tensor], Any]:
        k = self.flip
        self.flip ^= 1
        if self.uploaded[k] is not None:
            self.uploaded[k].synchronize()
            self.uploaded[k] = None
        return k, self.out_sets[k], self.out_ptrs[k]


class OpStatsMixin:
    """Per-op phase-timing recorder (the JAX package's): every op drains
    through one ``pop_op_stats`` with the core keys ``op``, ``bytes``
    (the payload) and ``d2h_bytes`` (what crossed the device link), plus
    the op's own phase timings."""

    _op_stats: List[dict]

    def _record_op_stats(self, stats: dict) -> None:
        if not hasattr(self, "_op_stats"):
            self._op_stats = []
        self._op_stats.append(stats)
        # Bounded: diagnostics, not a log; 256 keeps a full per-step
        # breakdown window.
        del self._op_stats[:-256]

    def pop_op_stats(self) -> List[dict]:
        """Drains the recorded per-op phase timings (seconds). Ring
        entries carry ``wire_bytes`` and, for plans, the native per-bucket
        ``buckets`` (``pack_s``/``ring_s``/``unpack_s``); two-tier
        entries the per-tier seconds and measured bytes (``tiers``)."""
        out, self._op_stats = getattr(self, "_op_stats", []), []
        for st in out:
            # Plan entries carry their per-bucket stats as raw JSON: the
            # parse stays off the per-step path.
            raw = st.pop("_buckets_json", None)
            if raw is not None:
                st["buckets"] = json.loads(raw).get("buckets", [])
        return out


class HostCollectives(OpStatsMixin, Collectives):
    """Deterministic TCP ring collectives (native C++), the Gloo role,
    with the two-tier schedule over the quorum's region and host maps."""

    def __init__(
        self,
        timeout: timedelta = timedelta(seconds=60),
        connect_timeout: timedelta = timedelta(seconds=60),
        stripes: Optional[int] = None,
    ) -> None:
        """``stripes`` > 1 spreads every ring op over that many parallel
        TCP connections (or shm rings) per neighbour (default: env
        ``TORCHFT_HC_STRIPES``, else 4). All members of a ring must
        agree; configure() checks it through the store."""
        self._handle = _lib.tft_hc_create()
        self._timeout = timeout
        self._connect_timeout = connect_timeout
        if stripes is None:
            stripes = int(os.environ.get("TORCHFT_HC_STRIPES", "4"))
        self._stripes = min(max(int(stripes), 1), _MAX_STRIPES)
        self._world_size = 0
        self._rank = -1
        # One thread: collectives must issue in submission order.
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="host_collectives"
        )
        self._shutdown = False
        # Device wire packers keyed like plans. They hold the device EF
        # carries and survive configure() (the pack is ring-geometry-free).
        self._dev_packers: Dict[Any, _DeviceWirePacker] = {}
        # Comm plans keyed by (wire, treedef, signature, prepacked, pinned,
        # hier); None marks a signature no plan can take. Dropped at
        # configure(): the native layer drops its side at the same moment.
        self._plans: Dict[Any, Optional[_CommPlan]] = {}
        self._op_stats: List[dict] = []

    def _last_stripe_seconds(self) -> List[float]:
        """Per-stripe wall times (s) of the last native ring op; called on
        the op thread, where every ring call runs."""
        buf = (ctypes.c_int64 * _MAX_STRIPES)()
        n = _lib.tft_hc_last_stripe_ns(self._handle, buf, _MAX_STRIPES)
        return [buf[i] / 1e9 for i in range(min(n, _MAX_STRIPES))]

    # -- lifecycle --

    def configure(
        self,
        store_addr: str,
        rank: int,
        world_size: int,
        regions: Optional[Sequence[str]] = None,
        hosts: Optional[Sequence[str]] = None,
    ) -> None:
        """Rebuilds the rings for a new membership. ``regions`` and
        ``hosts`` (one label per rank) build the two-tier schedule beside
        the flat ring when usable: >= 2 distinct regions with every rank
        labeled, and/or >= 2 ranks sharing a (region, host) pair with
        every rank host-labeled. Co-hosted ranks reduce over
        shared-memory rings (loopback TCP under ``TORCHFT_HC_SHM=0``); a
        segment that cannot be created or attached fails the configure."""
        # Abort synchronously so a wedged op can't block the executor,
        # then run the (blocking) rendezvous on the op thread.
        _lib.tft_hc_abort(self._handle)
        region_list = [str(r) for r in regions] if regions else []
        host_list = [str(h) for h in hosts] if hosts else []
        for name, labels in (("regions", region_list), ("hosts", host_list)):
            if labels and len(labels) != world_size:
                raise ValueError(
                    f"{name} must carry one label per rank ({len(labels)} "
                    f"labels for world_size {world_size})"
                )

        def do_configure() -> None:
            if world_size > 1:
                hostport, _, prefix = store_addr.partition("/")
                store = _native.StoreClient(
                    hostport, connect_timeout=self._connect_timeout
                )
                mine = _fingerprint(self._stripes, region_list, host_list)
                key = f"{prefix}/pipecfg" if prefix else "pipecfg"
                if rank == 0:
                    store.set(key, mine.encode())
                else:
                    theirs = store.get(
                        key, timeout=self._connect_timeout
                    ).decode()
                    if theirs != mine:
                        raise RuntimeError(
                            f"ring config mismatch: rank {rank} has {mine}, "
                            f"rank 0 has {theirs} — all ring members must "
                            "use the same ring settings and see the same "
                            "region and host maps"
                        )
            _check(
                _lib.tft_hc_configure_hier(
                    self._handle, store_addr.encode(), rank, world_size,
                    _ms(self._connect_timeout), self._stripes,
                    self._stripes,
                    json.dumps(region_list).encode() if region_list else b"",
                    json.dumps(host_list).encode() if host_list else b"",
                )
            )
            self._rank = rank
            self._world_size = world_size
            self._plans = {}
            # A host-packing member's carry died with its plan just now;
            # the device carries zero too, so the two stay bit-identical.
            for packer in self._dev_packers.values():
                packer.reset_feedback()

        self._executor.submit(do_configure).result()

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        _lib.tft_hc_abort(self._handle)
        self._executor.shutdown(wait=True)
        # Deterministic teardown of sockets and shm segments: named kernel
        # resources must not wait for garbage collection.
        _lib.tft_hc_release(self._handle)

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle and getattr(_lib, "_cdll", None) is not None:
            try:
                self.shutdown()
            except Exception:
                pass
            self._handle = None
            _lib.tft_hc_destroy(handle)

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank

    def _submit(self, fn: Callable[[], Any]) -> Work:
        if self._shutdown:
            raise RuntimeError("collectives already shut down")
        return Work(self._executor.submit(fn))

    # -- plain allreduce --

    def allreduce(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
    ) -> Work:
        timeout_ms = _ms(self._timeout)
        return self._submit(
            lambda: self._allreduce_sync(tree, op, timeout_ms, divisor)
        )

    def _allreduce_sync(
        self,
        tree: Any,
        op: ReduceOp,
        timeout_ms: int,
        divisor: Optional[float] = None,
    ) -> Any:
        if divisor is not None and op != ReduceOp.SUM:
            raise ValueError("divisor only composes with ReduceOp.SUM")
        leaves, treedef = _flatten(tree)
        if op == ReduceOp.AVG:
            divisor = self._world_size
        if self._world_size == 1 or not leaves:
            return _identity(tree, leaves, treedef, divisor)
        native_op = int(ReduceOp.SUM if op == ReduceOp.AVG else op)
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        groups: Dict[torch.dtype, List[int]] = {}
        for i, l in enumerate(leaves):
            acc = l.dtype if l.dtype in _NATIVE_DTYPES else torch.float32
            groups.setdefault(acc, []).append(i)
        # One ring op per dtype group: the JAX package's per-bucket record
        buckets: Dict[str, dict] = {}
        stripe_sum: List[float] = []
        pack_s = d2h_bytes = 0
        for acc, idxs in groups.items():
            t0 = time.perf_counter()
            host = [leaves[i].detach().to("cpu", acc).reshape(-1) for i in idxs]
            t1 = time.perf_counter()
            # cat copies, so the ring may reduce the buffer in place
            buf = torch.cat(host)
            t2 = time.perf_counter()
            _check(
                _lib.tft_hc_allreduce(
                    self._handle, buf.data_ptr(), buf.numel(),
                    _NATIVE_DTYPES[acc], native_op, timeout_ms,
                )
            )
            stripe_s = self._last_stripe_seconds()
            if divisor is not None:
                buf = _divide(buf, divisor)
            t3 = time.perf_counter()
            offset = 0
            for i in idxs:
                n = leaves[i].numel()
                out[i] = (
                    buf[offset:offset + n].reshape(leaves[i].shape)
                    .to(leaves[i].device, leaves[i].dtype)
                )
                offset += n
            pack_s += t2 - t1
            d2h_bytes += sum(leaves[i].numel() for i in idxs
                             if leaves[i].is_cuda) * buf.element_size()
            buckets[_NP_NAMES[acc]] = {
                "bytes": buf.numel() * buf.element_size(), "d2h": t1 - t0,
                "ring": t3 - t2, "h2d": time.perf_counter() - t3,
                "stripe_s": stripe_s,
                "stripe_wall": max(stripe_s) if stripe_s else 0.0,
            }
            for k, x in enumerate(stripe_s):
                if k < len(stripe_sum):
                    stripe_sum[k] += x
                else:
                    stripe_sum.append(x)
        self._record_op_stats({
            "op": "allreduce",
            "bytes": sum(b["bytes"] for b in buckets.values()),
            "d2h_bytes": d2h_bytes,
            "chunks": len(buckets),
            "pack": pack_s,
            "d2h": sum(b["d2h"] for b in buckets.values()),
            "ring": sum(b["ring"] for b in buckets.values()),
            "h2d": sum(b["h2d"] for b in buckets.values()),
            "stripe_s": stripe_sum,
            "buckets": buckets,
        })
        return _unflatten(treedef, out)

    # -- two-tier (topology-aware) ops --

    def hier_capable(self) -> bool:
        """Whether the last configure received a usable topology map (a
        region map with >= 2 distinct labels and/or a host map grouping
        >= 2 co-hosted ranks) and built the two-tier schedule beside the
        flat ring."""
        return bool(_lib.tft_hc_hier_capable(self._handle))

    def host_tier_transport(self) -> str:
        """Transport of the host (intra-host) tier after the last
        configure: ``"shm"`` (shared-memory rings), ``"tcp"`` (loopback,
        under ``TORCHFT_HC_SHM=0``) or ``"none"`` (this rank's (region,
        host) group has fewer than 2 ranks)."""
        code = int(_lib.tft_hc_host_tier_transport(self._handle))
        return {0: "none", 1: "tcp", 2: "shm"}[code]

    def _last_hier_dict(self) -> dict:
        out = ctypes.c_void_p()
        _check(_lib.tft_hc_last_hier_json(self._handle, ctypes.byref(out)))
        return json.loads(_native._take_string(out))

    @staticmethod
    def _hier_stats_fields(h: dict) -> dict:
        """The op-stat fragment of the bulk and plan two-tier paths: per
        tier phase seconds and MEASURED tx bytes (one schema for both)."""
        out = {
            # measured socket traffic only: the shm host tier hands the
            # kernel nothing (host_tx_bytes is non-zero only under TCP)
            "wire_bytes": h["intra_tx_bytes"] + h["inter_tx_bytes"]
            + h["host_tx_bytes"],
            "intra_rs_s": h["intra_rs_s"],
            "intra_ag_s": h["intra_ag_s"],
            "inter_ring_s": h["inter_ring_s"],
            "intra_bcast_s": h["intra_bcast_s"],
            "tiers": {
                "intra": {
                    "tx_bytes": h["intra_tx_bytes"],
                    "world": h["intra_world"],
                    "eff": h["eff_intra"],
                    "rs_s": h["intra_rs_s"],
                    "ag_s": h["intra_ag_s"],
                    "bcast_s": h["intra_bcast_s"],
                },
                "inter": {
                    "tx_bytes": h["inter_tx_bytes"],
                    "rs_tx_bytes": h["inter_rs_tx_bytes"],
                    "ag_tx_bytes": h["inter_ag_tx_bytes"],
                    "world": h["inter_world"],
                    "eff": h["eff_inter"],
                    "ring_s": h["inter_ring_s"],
                    "leader": h["leader"],
                },
            },
        }
        if h.get("host_world", 0) > 1:
            # the intra-host tier: tx_bytes is kernel traffic (0 under
            # shm), shm_bytes the ring movement
            out["shm_rs_s"] = h["shm_rs_s"]
            out["shm_ag_s"] = h["shm_ag_s"]
            out["shm_bcast_s"] = h["shm_bcast_s"]
            out["tiers"]["host"] = {
                "tx_bytes": h["host_tx_bytes"],
                "shm_bytes": h["shm_bytes"],
                "world": h["host_world"],
                "eff": h["eff_host"],
                "rs_s": h["shm_rs_s"],
                "ag_s": h["shm_ag_s"],
                "bcast_s": h["shm_bcast_s"],
                "leader": h["host_leader"],
                "transport": "shm" if h["host_shm"] else "tcp",
            }
        return out

    @staticmethod
    def _merge_hier_stats(acc: Optional[dict], h: dict) -> dict:
        """Sums the per-group native breakdowns of one op (each native
        op overwrites the last one's)."""
        if acc is None:
            return dict(h)
        for k in (
            "intra_rs_s", "intra_ag_s", "inter_ring_s", "intra_bcast_s",
            "intra_tx_bytes", "inter_tx_bytes", "inter_rs_tx_bytes",
            "inter_ag_tx_bytes", "payload_bytes",
            "shm_rs_s", "shm_ag_s", "shm_bcast_s", "host_tx_bytes",
            "shm_bytes",
        ):
            acc[k] += h[k]
        return acc

    def allreduce_hier(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
    ) -> Work:
        """Two-tier allreduce: host-tier reduce-scatter/allgather (shm),
        intra-region ring among host leaders, inter-region ring among one
        leader per region, then the broadcasts back down. ``wire``
        (``None`` | ``"bf16"`` | ``"q8"``) encodes the inter hop only.
        Raises without a hier-capable configure (the Manager latches it)."""
        timeout_ms = _ms(self._timeout)
        if wire not in _HIER_WIRES:
            raise ValueError(f"unsupported hier wire: {wire!r}")
        if op == ReduceOp.AVG:
            if divisor is not None:
                raise ValueError("divisor only composes with ReduceOp.SUM")
            divisor, op = float(self._world_size), ReduceOp.SUM
        if divisor is not None and op != ReduceOp.SUM:
            raise ValueError("divisor only composes with ReduceOp.SUM")
        if wire is not None and op != ReduceOp.SUM:
            raise ValueError("hier wire bf16/q8 supports SUM/AVG only")
        return self._submit(
            lambda: self._allreduce_hier_sync(tree, op, divisor, wire,
                                              timeout_ms)
        )

    def _allreduce_hier_sync(
        self,
        tree: Any,
        op: ReduceOp,
        divisor: Optional[float],
        wire: Optional[str],
        timeout_ms: int,
    ) -> Any:
        leaves, treedef = _flatten(tree)
        if self._world_size == 1 or not leaves:
            return _identity(tree, leaves, treedef, divisor)
        t0 = time.perf_counter()
        groups: Dict[torch.dtype, List[int]] = {}
        for i, l in enumerate(leaves):
            if wire == "q8":
                acc = torch.float32  # the quantized hop reduces one f32 group
            else:
                acc = l.dtype if l.dtype in _NATIVE_DTYPES else torch.float32
            groups.setdefault(acc, []).append(i)
        # the JAX package's op order: groups sorted by numpy dtype name
        names = sorted(groups, key=lambda dt: _NP_NAMES[dt])
        host = {
            acc: torch.cat([leaves[i].detach().to("cpu", acc).reshape(-1)
                            for i in groups[acc]])
            for acc in names
        }
        d2h_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        hier_stats: Optional[dict] = None
        for acc in names:
            # The wire applies where it means something: q8 groups are one
            # f32 buffer, bf16 compresses f32 groups only.
            if wire == "q8":
                gw = _HIER_WIRES["q8"]
            elif wire == "bf16" and acc == torch.float32:
                gw = _HIER_WIRES["bf16"]
                host[acc] = _canonical_nan(host[acc])  # F1
            else:
                gw = _HIER_WIRES[None]
            buf = host[acc]
            _check(
                _lib.tft_hc_allreduce_hier(
                    self._handle, buf.data_ptr(), buf.numel(),
                    _NATIVE_DTYPES[acc], int(op), gw, timeout_ms,
                )
            )
            hier_stats = self._merge_hier_stats(
                hier_stats, self._last_hier_dict())
            if divisor is not None and divisor != 1:
                host[acc] = _divide(buf, divisor)
        ring_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for acc in names:
            offset = 0
            for i in groups[acc]:
                n = leaves[i].numel()
                out[i] = (host[acc][offset:offset + n]
                          .reshape(leaves[i].shape)
                          .to(leaves[i].device, leaves[i].dtype))
                offset += n
        total = sum(b.numel() * b.element_size() for b in host.values())
        st: dict = {
            "op": "allreduce_hier",
            "wire": wire,
            "bytes": total,
            "d2h_bytes": total if all(l.is_cuda for l in leaves) else 0,
            "d2h": d2h_s,
            "ring": ring_s,
            "h2d": time.perf_counter() - t2,
        }
        if hier_stats is not None:
            st.update(self._hier_stats_fields(hier_stats))
        self._record_op_stats(st)
        return _unflatten(treedef, out)

    # -- planned allreduce (the gradient hot path) --

    def plan_allreduce(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
        device_pack: bool = True,
        hier: bool = False,
    ) -> Work:
        """One native call per step over a cached, precompiled plan.

        Flat (``hier=False``): leaves on the card are always packed
        there, by the port's kernels (wires ``None``/``"bf16"``/
        ``"q8ef"``; any other wire, or ``device_pack=False``, raises).
        For CPU leaves ``device_pack`` picks the pack: the kernels' plain
        versions (``True``) or the native host pack (``False``, and the
        only pack of wire ``"q8"``). The two are bit-identical. A device
        pack that cannot be built or launched raises (latched by the
        Manager): nothing falls back to the host pack.

        ``hier=True`` runs the plan over the two-tier schedule (a
        hier-capable configure is required; otherwise the op raises and
        the Manager latches it). The wire is applied at the leader's
        inter-region hop, not at pack, so this schedule has no
        pre-packed form: the leaves always go through the native host
        pack and ``device_pack`` is ignored. Card leaves are copied into
        pinned host tensors the plan owns (allocated once with the plan,
        so no step allocates staging); that is this schedule's contract,
        as in the JAX package, not a fallback. With one region the
        result is the f32 average (no inter hop, so no wire encoding)."""
        timeout_ms = _ms(self._timeout)
        if wire not in _PLAN_WIRES:
            raise ValueError(f"unsupported wire: {wire!r}")
        if op == ReduceOp.AVG:
            if divisor is not None:
                raise ValueError("divisor only composes with ReduceOp.SUM")
            divisor, op = float(self._world_size), ReduceOp.SUM
        if op != ReduceOp.SUM:
            raise ValueError("plan_allreduce supports SUM/AVG only")
        leaves, _ = _flatten(tree)
        caller = None  # (stream, event) of a caller whose leaves are on the card
        if any(l.is_cuda for l in leaves):
            if not hier and (not device_pack or wire not in _DEVICE_PACK_WIRES):
                raise ValueError(
                    f"leaves on the card are packed there by the port's "
                    f"kernels, on wires {_DEVICE_PACK_WIRES}; got wire "
                    f"{wire!r}, device_pack={device_pack!r}"
                )
            # Marks the leaves as written on the caller's stream: the
            # pack (or the staging copy) waits on this event, not on
            # whatever is queued later.
            stream = torch.cuda.current_stream(leaves[0].device)
            caller = (stream, stream.record_event())
        prepacked = device_pack and wire in _DEVICE_PACK_WIRES and not hier
        return self._submit(
            lambda: self._plan_allreduce_sync(
                tree, divisor, wire, timeout_ms, prepacked, caller, hier
            )
        )

    def _plan_for(
        self, leaves: Sequence[torch.Tensor], treedef: Any,
        wire: Optional[str], prepacked: bool, hier: bool = False,
    ) -> Optional[_CommPlan]:
        # The signature stays in the key: a same-treedef tree with other
        # shapes would pack with the wrong per-leaf counts.
        sig = _signature(leaves)
        pin = any(l.is_cuda for l in leaves)
        key = (wire, treedef, sig, prepacked, pin, hier)
        if key not in self._plans:
            try:
                self._plans[key] = _CommPlan(
                    self._handle, sig, wire, prepacked, pin, hier=hier,
                    stripes=self._stripes, world=self._world_size,
                    device=leaves[0].device if pin else None,
                )
            except (KeyError, RuntimeError):
                # Non-native leaf dtype, or a wire/dtype pair the native
                # plan rejects; remembered so no step re-attempts it.
                self._plans[key] = None
        return self._plans[key]

    def _plan_allreduce_sync(
        self,
        tree: Any,
        divisor: Optional[float],
        wire: Optional[str],
        timeout_ms: int,
        prepacked: bool,
        caller: Optional[Tuple[Any, Any]] = None,
        hier: bool = False,
    ) -> Any:
        leaves, treedef = _flatten(tree)
        if not leaves:
            return tree
        if hier:
            return self._plan_hier_sync(
                leaves, treedef, tree, divisor, wire, timeout_ms, caller
            )
        plan = self._plan_for(leaves, treedef, wire, prepacked)
        if plan is None:
            if wire is None and not prepacked:
                return self._allreduce_sync(
                    tree, ReduceOp.SUM, timeout_ms, divisor
                )
            raise ValueError(
                f"plan wire {wire!r} cannot take leaf dtypes "
                f"{sorted({str(l.dtype) for l in leaves})}"
            )
        div = float(divisor if divisor is not None else 1.0)
        has_div = 0 if divisor is None else 1
        out_set, outs, out_ptrs = plan.next_outputs()
        if prepacked:
            key = (wire, treedef, plan.sig, leaves[0].device)
            packer = self._dev_packers.get(key)
            if packer is None:
                packer = self._dev_packers[key] = _DeviceWirePacker(
                    leaves, wire
                )
            payloads, scales = packer.pack_step(
                leaves, caller[1] if caller else None
            )
            for gi, p in enumerate(payloads):
                plan.group_in[gi] = p.data_ptr()
                plan.group_aux[gi] = scales[gi].data_ptr() if scales else None
            t2 = time.perf_counter()
            _check(
                _lib.tft_plan_execute_pre(
                    self._handle, plan.plan_id, plan.group_in,
                    plan.group_aux, out_ptrs, div, has_div, timeout_ms,
                )
            )
            plan.execs += 1
            pack_s, d2h_s = packer.last_split
            self._record_op_stats({
                "op": "plan_allreduce",
                "wire": wire,
                "device_pack": True,
                "bytes": plan.bytes,
                "wire_bytes": plan.wire_bytes,
                # the device link carried the wire encoding
                "d2h_bytes": sum(t.numel() * t.element_size()
                                 for t in (*payloads, *scales)),
                "pack": pack_s,  # kernel launches + copies queued (host clock)
                "d2h": d2h_s,    # until the copies landed in pinned staging
                "ring": time.perf_counter() - t2,  # decode + ring + unpack
                "_buckets_json": self._plan_stats_json(plan.plan_id),
                "py_staging_allocs": 0,
                "plan_execs": plan.execs,
            })
        else:
            t0 = time.perf_counter()
            refs, staging_allocs = self._host_inputs(plan, leaves, wire)
            t1 = time.perf_counter()
            _check(
                _lib.tft_plan_execute(
                    self._handle, plan.plan_id, plan.in_ptrs, out_ptrs,
                    div, has_div, timeout_ms,
                )
            )
            ring_s = time.perf_counter() - t1
            del refs
            plan.execs += 1
            self._record_op_stats({
                "op": "plan_allreduce",
                "wire": wire,
                "device_pack": False,
                "bytes": plan.bytes,
                "wire_bytes": plan.wire_bytes,
                # the host pack reads every leaf at its full width
                "d2h_bytes": plan.bytes,
                "d2h": t1 - t0,  # pointer gather: host leaves are not copied
                "ring": ring_s,  # the native call: pack + ring + unpack
                "_buckets_json": self._plan_stats_json(plan.plan_id),
                "py_staging_allocs": staging_allocs,
                "plan_execs": plan.execs,
            })
        return self._upload(plan, out_set, outs, leaves, treedef, caller)

    def _host_inputs(
        self, plan: _CommPlan, leaves: Sequence[torch.Tensor],
        wire: Optional[str],
    ) -> Tuple[List[torch.Tensor], int]:
        """Points the plan's inputs at the CPU leaves (no copy unless a
        leaf is not contiguous, or carries a NaN on the bf16 wire, whose
        canonical copy survives the native pack: F1). Returns the tensors
        to keep alive across the native call and the copies made."""
        refs, copies = [], 0
        for i, l in enumerate(leaves):
            a = l.detach()
            if not a.is_contiguous():
                a = a.contiguous()
                copies += 1
            if wire == "bf16" and a.dtype == torch.float32:
                c = _canonical_nan(a)
                copies += c is not a
                a = c
            refs.append(a)
            plan.in_ptrs[i] = a.data_ptr()
        return refs, copies

    def _plan_hier_sync(
        self,
        leaves: Sequence[torch.Tensor],
        treedef: Any,
        tree: Any,
        divisor: Optional[float],
        wire: Optional[str],
        timeout_ms: int,
        caller: Optional[Tuple[Any, Any]],
    ) -> Any:
        """Two-tier plan execute: one native call runs the whole schedule
        per group (pack streamed into the host/intra reduce-scatter,
        unpack out of the broadcast), the wire at the leader's inter hop."""
        if self._world_size > 1 and not self.hier_capable():
            raise RuntimeError(
                "plan_allreduce(hier=True) needs a hier-capable configure: "
                "the quorum's region map had < 2 distinct labels and no two "
                "ranks shared a host label (or members were unlabeled)"
            )
        plan = self._plan_for(leaves, treedef, wire, False, hier=True)
        if plan is None:
            if wire is None and caller is None:
                # non-native leaf dtypes: the bulk op groups them into f32
                return self._allreduce_hier_sync(
                    tree, ReduceOp.SUM, divisor, None, timeout_ms)
            raise ValueError(
                f"hier plan wire {wire!r} cannot take leaf dtypes "
                f"{sorted({str(l.dtype) for l in leaves})}"
            )
        t0 = time.perf_counter()
        refs: List[torch.Tensor] = []
        staging_allocs = 0
        if caller is None:
            refs, staging_allocs = self._host_inputs(plan, leaves, wire)
        else:
            # Card leaves into the plan's pinned inputs, on its stream,
            # after the event the caller recorded once they were written.
            with torch.cuda.device(leaves[0].device), \
                    torch.cuda.stream(plan.stream):
                plan.stream.wait_event(caller[1])
                for host, l in zip(plan.staging, leaves):
                    host.copy_(l.detach(), non_blocking=True)
                copied = plan.stream.record_event()
            copied.synchronize()
            if wire == "bf16":
                for host in plan.staging:  # F1, in place
                    if host.dtype == torch.float32:
                        c = _canonical_nan(host)
                        if c is not host:
                            host.copy_(c)
        t1 = time.perf_counter()
        out_set, outs, out_ptrs = plan.next_outputs()
        _check(
            _lib.tft_plan_execute(
                self._handle, plan.plan_id, plan.in_ptrs, out_ptrs,
                float(divisor if divisor is not None else 1.0),
                0 if divisor is None else 1, timeout_ms,
            )
        )
        ring_s = time.perf_counter() - t1
        del refs
        plan.execs += 1
        st: dict = {
            "op": "plan_allreduce",
            "wire": wire,
            "hier": True,
            "device_pack": False,
            "bytes": plan.bytes,
            "d2h_bytes": plan.bytes,
            # CPU leaves: the pointer gather; card leaves: until the copies
            # into the plan's pinned inputs landed
            "d2h": t1 - t0,
            "ring": ring_s,  # the native call: the whole two-tier schedule
            "_buckets_json": self._plan_stats_json(plan.plan_id),
            "py_staging_allocs": staging_allocs,
            "plan_execs": plan.execs,
        }
        if self._world_size > 1:
            st.update(self._hier_stats_fields(self._last_hier_dict()))
        else:
            st["wire_bytes"] = plan.wire_bytes
        self._record_op_stats(st)
        return self._upload(plan, out_set, outs, leaves, treedef, caller)

    def _upload(self, plan: _CommPlan, out_set: int,
                outs: List[torch.Tensor], leaves: Sequence[torch.Tensor],
                treedef: Any, caller: Optional[Tuple[Any, Any]]) -> Any:
        if caller is None:
            return _unflatten(treedef, outs)
        # Results for card leaves are uploaded on the caller's stream,
        # ordered before whatever it queues once it holds them.
        with torch.cuda.stream(caller[0]):
            result = [o.to(l.device, non_blocking=True)
                      for o, l in zip(outs, leaves)]
            plan.uploaded[out_set] = caller[0].record_event()
        return _unflatten(treedef, result)

    def _plan_stats_json(self, plan_id: int) -> str:
        out = ctypes.c_void_p()
        _check(_lib.tft_plan_stats_json(self._handle, plan_id,
                                        ctypes.byref(out)))
        return _native._take_string(out)

    def plan_reset_feedback(self) -> None:
        """Zeroes the EF carry of every cached q8ef plan (flat and
        two-tier, whose carry sits at the region leader) and of every
        device packer; runs on the op thread so it cannot interleave with
        an in-flight execute."""

        def reset() -> None:
            for plan in self._plans.values():
                if plan is not None and plan.wire == "q8ef":
                    _check(
                        _lib.tft_plan_reset_feedback(self._handle, plan.plan_id)
                    )
            for packer in self._dev_packers.values():
                packer.reset_feedback()

        self._submit(reset).wait()


def _identity(tree: Any, leaves: Sequence[torch.Tensor], treedef: Any,
              divisor: Optional[float]) -> Any:
    """A SUM of one member is the identity (the result may alias the
    input; treat op results as read-only), then the divisor."""
    if divisor is None or divisor == 1 or not leaves:
        return tree
    return _unflatten(treedef, [_divide(l, divisor) for l in leaves])


def _divide(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """Same-dtype divide for the divisor/AVG contract: integers
    floor-divide, floats keep their dtype (bf16 divides in f32)."""
    if not t.is_floating_point():
        return torch.div(t, int(divisor), rounding_mode="floor")
    if t.dtype == torch.bfloat16:
        return (t.float() / divisor).to(torch.bfloat16)
    return t / divisor
