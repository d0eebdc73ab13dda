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

The legacy (non-plan) data plane packs a tree into one flat buffer per
dtype group on the leaves' device and pipelines it through the ring in
chunks: ``allreduce`` (``wire="q8"``: the quantized ring), ``allgather``
(grouped by exact dtype, byte-preserving), ``broadcast`` and
``barrier``. The sharded plan (:meth:`HostCollectives.plan_reduce_scatter`
/ :meth:`HostCollectives.plan_allgather_into`) splits the fused plan at
the reduce-scatter boundary for per-step ZeRO.

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
from dataclasses import dataclass, replace
from datetime import timedelta
from enum import IntEnum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import _native
from ._native import _check, _lib, _ms
from ._tree import flatten as _flatten
from ._tree import unflatten as _unflatten
from .ops import quantize_kernels as qk
from .quantize import flat_buffer


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

    def result(self, timeout: Optional[timedelta] = None) -> Any:
        return self.wait(timeout)

    def done(self) -> bool:
        return self._future.done()

    def exception(self) -> Optional[BaseException]:
        return self._future.exception()

    def add_done_callback(self, fn: Callable[["Future[Any]"], None]) -> None:
        self._future.add_done_callback(fn)

    def then(self, fn: Callable[[Any], Any]) -> "Work":
        """A Work whose result is ``fn(result)``; errors propagate."""
        out: "Future[Any]" = Future()

        def chain(f: "Future[Any]") -> None:
            exc = f.exception()
            if exc is not None:
                out.set_exception(exc)
                return
            try:
                out.set_result(fn(f.result()))
            except Exception as e:  # noqa: BLE001 - into the future
                out.set_exception(e)

        self._future.add_done_callback(chain)
        return Work(out)


def _completed(value: Any) -> Work:
    f: "Future[Any]" = Future()
    f.set_result(value)
    return Work(f)


@dataclass
class TreeShard:
    """This rank's shard of a flat-packed tree, what the split ops'
    two legs trade in: :meth:`Collectives.reduce_scatter` (or the
    sharded plan's :meth:`Collectives.plan_reduce_scatter`) returns one,
    :meth:`Collectives.allgather_into` (``plan_allgather_into``) takes
    it back.

    The tree packs into one flat buffer per group (the sharded plan and
    the q8 wire: one f32 group); the shard is the union of the
    per-stripe ring chunks this rank owns, compacted in stripe order.
    ``values`` is what a caller updates in place of the full tree; the
    rest is layout bookkeeping that rides along unchanged so every
    member scatters back onto the identical schedule. Keys are the
    groups' numpy dtype names (``"float32"``), as in the JAX package."""

    # group name -> this rank's flat shard
    values: Dict[str, torch.Tensor]
    # group name -> total flat elements of the group's full buffer
    counts: Dict[str, int]
    # group name -> [(start, len)] element ranges this rank owns, in
    # compaction order (positions within the group's flat buffer)
    ranges: Dict[str, List[Tuple[int, int]]]
    # group name -> the stripe partition pinned for the two legs
    layout: Dict[str, int]
    dtypes: Dict[str, torch.dtype]
    # group name -> leaf indices packed into the group (signature order)
    groups: Dict[str, List[int]]
    treedef: Any
    sig: Any
    rank: int
    world_size: int
    # the sharded comm plan that produced the shard (plan ops)
    plan: Any = None
    # the bulk ops' pack of the tree's signature (its group layout)
    packer: Any = None
    # where the reduced tree's leaves lived (the gathered tree returns
    # there); None for CPU leaves
    device: Optional[torch.device] = None

    def replace_values(self, values: Dict[str, torch.Tensor]) -> "TreeShard":
        """Same layout, new per-group values (the updated shard)."""
        return replace(self, values=values)


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
        wire: Optional[str] = None,
    ) -> Work:
        """Reduces a tree of tensors across the group; the result has the
        same structure, dtypes and devices, bit-identical on every rank.
        ``divisor`` (SUM only) divides the reduced result. ``wire="q8"``
        (SUM/AVG only) ships int8 chunks with per-chunk f32 scales through
        the ring, dequant-accumulating per hop: about 4x fewer bytes than
        f32, constant in world size, lossy at the int8 class.
        Implementations without a quantized wire may raise for it."""

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

    # The bulk split ops: not abstract, so a backend without a
    # reduce-scatter boundary keeps working; callers feature-detect by
    # catching NotImplementedError.
    def reduce_scatter(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
        grid_shard: bool = False,
    ) -> Work:
        """Reduces a tree but stops at the reduce-scatter boundary: the
        result is a :class:`TreeShard` holding only the ~1/world of the
        flat-packed reduction this rank owns. Composed with
        :meth:`allgather_into` at the same wire dtype it is bit-identical
        to :meth:`allreduce`; updating the shard BEFORE the allgather is
        the sharded weight update. ``divisor``/``op``/``wire`` as in
        :meth:`allreduce` (``wire="q8"`` reduces one f32 group over the
        quantized ring; the shard is full f32). ``grid_shard`` (q8 only)
        applies the fused op's phase-2 owner quantize+decode to the
        shard, so the two legs reproduce ``allreduce(wire="q8")`` bit
        for bit."""
        raise NotImplementedError(
            f"{type(self).__name__} has no sharded split ops"
        )

    def allgather_into(
        self, shard: TreeShard, wire: Optional[str] = None
    ) -> Work:
        """Gathers every rank's (possibly updated) :class:`TreeShard` back
        into the full tree, phase 2 of the ring on current values.
        ``wire="bf16"`` ships f32 groups as bfloat16 (every member, the
        owner included, adopts the decoded words, so results stay
        bit-identical across ranks). All ranks pass shards from the same
        logical reduce_scatter."""
        raise NotImplementedError(
            f"{type(self).__name__} has no sharded split ops"
        )

    def plan_reduce_scatter(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
        ag_wire: Optional[str] = None,
    ) -> Work:
        """Reduces a tree (SUM/AVG) through a persistent SHARDED comm plan
        but stops at the reduce-scatter boundary: the result is a
        :class:`TreeShard` of this rank's ~1/world of the flat-packed
        reduction, full f32 on every wire. ``wire`` encodes the grad leg
        (None | "bf16" | "q8"), ``ag_wire`` pre-declares the param leg's
        (None | "bf16"). Pass the shard (values replaced) back to
        :meth:`plan_allgather_into`: both legs share the plan's
        partition. f32 leaves only."""
        raise NotImplementedError(
            f"{type(self).__name__} has no sharded comm plans"
        )

    def plan_allgather_into(
        self, shard: TreeShard, wire: Optional[str] = None
    ) -> Work:
        """Param leg of the sharded plan: gathers every rank's (updated)
        shard back into the full tree through the plan that produced it.
        ``wire`` must match the plan's ``ag_wire`` (``"bf16"``: every
        member adopts the identical decoded words)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no sharded comm plans"
        )

    @abstractmethod
    def allgather(self, tree: Any) -> Work:
        """Gathers each rank's tree; the result is a list of trees in rank
        order (every rank passes the same structure and shapes)."""

    @abstractmethod
    def broadcast(self, tree: Any, root: int = 0) -> Work:
        """Broadcasts root's tree to every rank."""

    @abstractmethod
    def barrier(self) -> Work:
        ...

    @abstractmethod
    def size(self) -> int:
        ...

    @abstractmethod
    def rank(self) -> int:
        ...

    def abort(self) -> None:
        """Unblocks in-flight ops with an error (safe from any thread)."""

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


# numpy dtype names, which order the JAX package's bulk groups on the
# wire (sorted as strings)
_NP_NAMES = {
    torch.float32: "float32",
    torch.float64: "float64",
    torch.float16: "float16",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.int16: "int16",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.bool: "bool",
    torch.bfloat16: "bfloat16",
}

# Wires the device pack serves. Plain "q8" ships RAW f32 to the quantized
# ring by contract; quantizing at the device boundary would change its
# numerics ("q8ef" is what PipelinedDDP's q8 mode uses).
_DEVICE_PACK_WIRES = (None, "bf16", "q8ef")


def _resolve_device_pack_setting(setting: Any) -> Optional[bool]:
    """The ``TORCHFT_DEVICE_PACK`` knob, one parser for every layer
    (``HostCollectives``, ``PipelinedDDP``, ``AdaptiveDDP``): a ctor or
    env setting to True (pack on the card), False (host pack) or None
    (auto: the card packs its own leaves on the wires it serves, CPU
    leaves pack on the host). ``None`` reads the env (default
    ``auto``); junk raises ValueError at once, so a typo fails loudly
    instead of latching every step."""
    if setting is None:
        setting = os.environ.get("TORCHFT_DEVICE_PACK", "auto")
    if isinstance(setting, str):
        try:
            return {"on": True, "off": False, "auto": None}[setting]
        except KeyError:
            raise ValueError(
                f"TORCHFT_DEVICE_PACK={setting!r} (want auto|on|off)"
            ) from None
    return bool(setting)


def _fingerprint(stripes: int, stripes_inter: int, regions: Sequence[str],
                 hosts: Sequence[str], chunks: int, min_bytes: int,
                 wire_crc: bool) -> str:
    """The ring-schedule fingerprint every member checks through the
    store at configure. The first two fields are the legacy pipeline's
    knobs (they decide how many native ops one allreduce issues), then
    the flat and the inter-region stripe counts, the region map,
    ``:crc1`` only when the ring's CRC trailer is on (a CRC-off fleet
    keeps the fingerprint of peers without the knob), and, only when
    every rank carries a host label, the host map and the shm knobs
    (transport and ring capacity: the two ends of a shm ring must
    agree). Identical to a JAX member's with the same knobs, so members
    of both packages share a ring."""
    fp = (f"{chunks}:{min_bytes}:{stripes}:{stripes_inter}"
          f":{','.join(regions)}" + (":crc1" if wire_crc else ""))
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

    A host-packed plan (two-tier, or flat with ``device_pack=False``)
    over card leaves also owns one pinned host tensor per leaf, the
    native host pack's input, and the stream that copies the leaves into
    them; the input pointers are set here once."""

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
        if pin and not prepacked:
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


class _ShardedPlan:
    """Python handle for one native SHARDED comm plan (per-step ZeRO).

    As for :class:`_CommPlan`, a step allocates nothing: the input
    pointer array, two alternating f32 shard buffers for the grad leg (a
    caller may still hold step k's shard while step k+1 reduces) and two
    alternating full-leaf output sets for the param leg. Over card
    leaves the buffers are pinned, and the plan also owns the grad leg's
    pinned inputs (one per leaf, pointers set once), the param leg's
    pinned shard input and the stream that copies into them; an output
    set or shard buffer is not rewritten before the event recorded after
    its upload has passed."""

    def __init__(self, handle: Any, sig: Sig, treedef: Any,
                 wire: Optional[str], ag_wire: Optional[str],
                 stripes: int = 1, world: int = 1, pin: bool = False,
                 device: Optional[torch.device] = None) -> None:
        if any(dt != torch.float32 for _, dt in sig):
            raise KeyError("sharded plans take f32 leaves only")
        self.treedef = treedef
        self.sig = sig
        self.wire = wire
        self.ag_wire = ag_wire
        n = len(sig)
        counts = [math.prod(s) for s, _ in sig]
        plan_id = _lib.tft_plan_build_sharded(
            handle, (ctypes.c_int64 * n)(*counts),
            (ctypes.c_int32 * n)(*[_NATIVE_DTYPES[dt] for _, dt in sig]), n,
            _PLAN_WIRES[wire], _PLAN_WIRES[ag_wire],
        )
        if plan_id < 0:
            _check(2)
        self.plan_id = plan_id
        meta = (ctypes.c_int64 * 3)()
        _check(_lib.tft_plan_sharded_meta(handle, plan_id, meta))
        self.shard_count, self.eff, self.total = int(meta[0]), int(meta[1]), int(meta[2])
        self.in_ptrs = (ctypes.c_void_p * n)()
        self.shard_sets = [torch.empty(self.shard_count, dtype=torch.float32,
                                       pin_memory=pin) for _ in range(2)]
        self.shard_uploaded: List[Optional[Any]] = [None, None]
        self.shard_flip = 0
        self.out_sets: List[List[torch.Tensor]] = []
        self.out_ptrs: List[Any] = []
        for _ in range(2):
            outs = [torch.empty(s, dtype=torch.float32, pin_memory=pin)
                    for s, _ in sig]
            self.out_sets.append(outs)
            self.out_ptrs.append(
                (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]))
        self.uploaded: List[Optional[Any]] = [None, None]
        self.flip = 0
        self.execs = 0
        self.staging: List[torch.Tensor] = []
        self.shard_in: Optional[torch.Tensor] = None
        self.stream = None
        if pin:
            self.staging = [torch.empty(s, dtype=torch.float32, pin_memory=True)
                            for s, _ in sig]
            for i, t in enumerate(self.staging):
                self.in_ptrs[i] = t.data_ptr()
            self.shard_in = torch.empty(self.shard_count, dtype=torch.float32,
                                        pin_memory=True)
            self.stream = torch.cuda.Stream(device)
        self.bytes = self.total * 4
        # per-leg wire bills: the grad leg runs one ring phase at the rs
        # wire, the param leg one at the ag wire
        if wire == "q8":
            self.rs_wire_bytes = self.total + _q8_wire_overhead(
                self.eff, world, phases=1)
        else:
            self.rs_wire_bytes = self.total * (2 if wire == "bf16" else 4)
        self.ag_wire_bytes = self.total * (2 if ag_wire == "bf16" else 4)

    next_outputs = _CommPlan.next_outputs


class _LegacyPacker:
    """The legacy (non-plan) ops' pack of a fixed tree signature: one flat
    buffer per group, groups in the JAX package's wire order (numpy dtype
    names, sorted), the role of its jitted ``_DevicePacker``.

    ``mode`` picks the grouping: ``"acc"`` by accumulation dtype (native
    dtypes as they are, others in f32; the reductions), ``"f32"`` one f32
    group (the quantized ring), ``"exact"`` by each leaf's own dtype (the
    byte-preserving allgather). For leaves on the card a group whose
    leaves are already consecutive views of one flat buffer (the
    quantize pack's outputs) is read in place, any other is concatenated
    on the card (``torch.cat``, a plain copy, not a kernel), and the
    buffers cross into pinned host memory allocated once here, on the
    packer's own stream after the event the caller recorded. A host
    buffer is not rewritten before the event recorded after the last
    upload out of it has passed."""

    def __init__(self, leaves: Sequence[torch.Tensor], mode: str) -> None:
        self.sig = _signature(leaves)
        groups: Dict[torch.dtype, List[int]] = {}
        for i, (_, dt) in enumerate(self.sig):
            if mode == "f32":
                acc = torch.float32
            elif mode == "exact":
                acc = dt
            else:
                acc = dt if dt in _NATIVE_DTYPES else torch.float32
            groups.setdefault(acc, []).append(i)
        self.groups = [(acc, groups[acc])
                       for acc in sorted(groups, key=lambda d: _NP_NAMES[d])]
        self.counts = [sum(math.prod(self.sig[i][0]) for i in idxs)
                       for _, idxs in self.groups]
        self.device = leaves[0].device if leaves[0].is_cuda else None
        self.stream = (torch.cuda.Stream(self.device) if self.device is not None
                       else None)
        self.host: List[torch.Tensor] = []
        if self.device is not None:
            self.host = [torch.empty(c, dtype=acc, pin_memory=True)
                         for c, (acc, _) in zip(self.counts, self.groups)]
        self.uploaded: Optional[Any] = None
        # allgather: the pinned gather buffer, by world size
        self.gathered: Dict[int, torch.Tensor] = {}

    def group_flat(self, leaves: Sequence[torch.Tensor], g: int,
                   copy: bool) -> torch.Tensor:
        """Group ``g`` as one flat tensor on the leaves' device: the flat
        buffer its leaves are views of (unless ``copy``), else their
        concatenation in the group's dtype."""
        acc, idxs = self.groups[g]
        ls = [leaves[i].detach() for i in idxs]
        if not copy:
            buf = flat_buffer(ls, acc)
            if buf is not None:
                return buf
        return torch.cat([l.to(acc).reshape(-1) for l in ls])

    def wait_uploaded(self) -> None:
        if self.uploaded is not None:
            self.uploaded.synchronize()
            self.uploaded = None


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
        pipeline_chunks: Optional[int] = None,
        pipeline_min_bytes: int = 4 << 20,
        stripes_inter: Optional[int] = None,
        wire_crc: Optional[bool] = None,
    ) -> None:
        """``stripes`` > 1 spreads every ring op over that many parallel
        TCP connections (or shm rings) per neighbour (default: env
        ``TORCHFT_HC_STRIPES``, else 4). ``pipeline_chunks`` > 1 splits
        each group buffer of the legacy ``allreduce`` of at least
        ``pipeline_min_bytes`` into that many ring ops, so the card's
        d2h copy, the ring and the upload overlap (default: env
        ``TORCHFT_HC_PIPELINE_CHUNKS``, else 4); chunk boundaries depend
        only on sizes, so results stay bit-identical across ranks.
        ``stripes_inter`` is the inter-region (leader) ring's connection
        count under the two-tier schedule (default: env
        ``TORCHFT_HC_STRIPES_INTER``; <= 0 follows ``stripes``).
        ``wire_crc`` puts a CRC32C trailer on every ring frame, and a
        mismatch raises :class:`~._native.WireCorruption` (latched by the
        Manager, the step discarded) instead of committing corrupted
        bytes (default: env ``TORCHFT_WIRE_CRC`` in 1/on/true; off, the
        frames are those of peers without the knob). All members of a
        ring must agree on all of these; configure() checks them through
        the store."""
        self._handle = _lib.tft_hc_create()
        self._timeout = timeout
        self._connect_timeout = connect_timeout
        if pipeline_chunks is None:
            pipeline_chunks = int(
                os.environ.get("TORCHFT_HC_PIPELINE_CHUNKS", "4"))
        self._pipeline_chunks = max(int(pipeline_chunks), 1)
        self._pipeline_min_bytes = int(pipeline_min_bytes)
        if stripes is None:
            stripes = int(os.environ.get("TORCHFT_HC_STRIPES", "4"))
        self._stripes = min(max(int(stripes), 1), _MAX_STRIPES)
        if stripes_inter is None:
            stripes_inter = int(
                os.environ.get("TORCHFT_HC_STRIPES_INTER", "0"))
        # <= 0: follow stripes (resolved at configure, so the fingerprint
        # carries the effective count)
        self._stripes_inter = min(int(stripes_inter), _MAX_STRIPES)
        if wire_crc is None:
            wire_crc = os.environ.get("TORCHFT_WIRE_CRC", "").lower() in (
                "1", "on", "true")
        self._wire_crc = bool(wire_crc)
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
        # hier), sharded plans by (wires, treedef, signature, "sharded");
        # None marks a signature no plan can take. Dropped at configure():
        # the native layer drops its side at the same moment.
        self._plans: Dict[Any, Any] = {}
        # The legacy ops' packers keyed by (mode, treedef, signature,
        # device): their pinned staging survives configure().
        self._packers: Dict[Any, _LegacyPacker] = {}
        # per card: the stream a shard crosses down on (allgather_into)
        self._side_streams: Dict[torch.device, Any] = {}
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

        stripes_inter = (self._stripes_inter if self._stripes_inter > 0
                         else self._stripes)

        def do_configure() -> None:
            if world_size > 1:
                hostport, _, prefix = store_addr.partition("/")
                store = _native.StoreClient(
                    hostport, connect_timeout=self._connect_timeout
                )
                mine = _fingerprint(self._stripes, stripes_inter,
                                    region_list, host_list,
                                    self._pipeline_chunks,
                                    self._pipeline_min_bytes, self._wire_crc)
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
            _lib.tft_hc_set_wire_crc(self._handle, 1 if self._wire_crc else 0)
            _check(
                _lib.tft_hc_configure_hier(
                    self._handle, store_addr.encode(), rank, world_size,
                    _ms(self._connect_timeout), self._stripes,
                    stripes_inter,
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

    def abort(self) -> None:
        _lib.tft_hc_abort(self._handle)

    def prewarm(self, tree: Any = None, wire: Optional[str] = "q8ef") -> None:
        """Warm-up for a hot-spare standby: starts the op thread and, given
        a tree shaped like the payload the promoted worker will sync (its
        gradient tree), runs the device pack for ``wire`` (the plan wire
        of ``plan_allreduce``; ``"q8ef"`` is ``PipelinedDDP``'s q8) once
        on zeros of those shapes. The kernels load (K1a and K1b on
        ``q8ef``, K3 on ``bf16``), the packer's device buffers and pinned
        staging are allocated, and the first ``plan_allreduce`` after the
        promotion reuses that packer, its carry zeroed. No ring is
        touched (the ring exists only after ``configure``), so a parked
        standby stays invisible to the quorum. CPU leaves run the
        kernels' plain versions."""
        ready: Any = None
        zeros: List[torch.Tensor] = []
        treedef: Any = None
        if tree is not None:
            leaves, treedef = _flatten(tree)
            if not all(isinstance(l, torch.Tensor) for l in leaves):
                raise ValueError("prewarm takes a tree of tensors")
            zeros = [torch.zeros_like(l) for l in leaves]
            if zeros and zeros[0].is_cuda:
                ready = torch.cuda.current_stream(
                    zeros[0].device).record_event()

        def warm() -> None:
            if not zeros:
                return
            key = (wire, treedef, _signature(zeros), zeros[0].device)
            packer = self._dev_packers.get(key)
            if packer is None:
                packer = self._dev_packers[key] = _DeviceWirePacker(
                    zeros, wire)
            packer.pack_step(zeros, ready)
            packer.reset_feedback()

        self._submit(warm).wait()

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

    # -- legacy (non-plan) data plane --

    def allreduce(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
    ) -> Work:
        """One ring pass per dtype group over flat buffers packed on the
        leaves' device (card leaves cross into pinned host chunks, see
        ``pipeline_chunks``), or, with ``wire="q8"``, one pass of the
        whole tree as one f32 buffer over the quantized ring. Results
        come back on the leaves' devices in their dtypes."""
        timeout_ms = _ms(self._timeout)
        if wire not in (None, "q8"):
            raise ValueError(f"unsupported wire: {wire!r}")
        if wire == "q8":
            if op == ReduceOp.AVG:
                if divisor is not None:
                    raise ValueError("divisor only composes with ReduceOp.SUM")
                divisor, op = float(self._world_size), ReduceOp.SUM
            if op != ReduceOp.SUM:
                raise ValueError("wire='q8' supports SUM/AVG only")
        caller = self._caller_event(tree)
        return self._submit(
            lambda: self._allreduce_sync(tree, op, timeout_ms, divisor,
                                         wire, caller)
        )

    @staticmethod
    def _caller_event(tree: Any) -> Optional[Tuple[Any, Any]]:
        """(stream, event) marking a tree's card leaves as written on the
        caller's stream, or None for CPU leaves: an op's copies wait on
        this event, not on whatever the caller queues later."""
        leaves, _ = _flatten(tree)
        if not any(isinstance(l, torch.Tensor) and l.is_cuda for l in leaves):
            return None
        stream = torch.cuda.current_stream(next(
            l for l in leaves if isinstance(l, torch.Tensor) and l.is_cuda
        ).device)
        return stream, stream.record_event()

    def _packer_for(self, leaves: Sequence[torch.Tensor], treedef: Any,
                    mode: str) -> _LegacyPacker:
        key = (mode, treedef, _signature(leaves), leaves[0].device)
        packer = self._packers.get(key)
        if packer is None:
            if leaves[0].is_cuda and any(l.device != leaves[0].device
                                         for l in leaves):
                raise ValueError("card leaves of one op must share a device")
            packer = self._packers[key] = _LegacyPacker(leaves, mode)
        return packer

    def _chunks(self, count: int, itemsize: int) -> List[Tuple[int, int]]:
        """The pipeline's chunk bounds of a group buffer: sizes only, so
        every rank issues the same ring ops."""
        k = self._pipeline_chunks
        if k <= 1 or count * itemsize < self._pipeline_min_bytes:
            return [(0, count)]
        bounds = [count * i // k for i in range(k + 1)]
        return list(zip(bounds, bounds[1:]))

    def _stage_down(self, packer: _LegacyPacker, leaves: Sequence[torch.Tensor],
                    caller: Optional[Tuple[Any, Any]], chunked: bool
                    ) -> Tuple[List[torch.Tensor], List[Tuple[int, int, int, Any]]]:
        """Each group as one writable host buffer (the ring reduces in
        place), and the chunk schedule ``(group, start, end, event)``. CPU
        leaves are concatenated (a copy). Card leaves are packed on the
        packer's stream and every chunk's d2h copy is queued before the
        first is waited on (``event`` is each chunk's landing)."""
        schedule: List[Tuple[int, int, int, Any]] = []
        if caller is None:
            hosts = [packer.group_flat(leaves, g, copy=True)
                     for g in range(len(packer.groups))]
            for g, (h, (acc, _)) in enumerate(zip(hosts, packer.groups)):
                bounds = (self._chunks(h.numel(), h.element_size()) if chunked
                          else [(0, h.numel())])
                schedule += [(g, a, b, None) for a, b in bounds]
            return hosts, schedule
        packer.wait_uploaded()
        with torch.cuda.device(packer.device), torch.cuda.stream(packer.stream):
            packer.stream.wait_event(caller[1])
            for g, host in enumerate(packer.host):
                dev = packer.group_flat(leaves, g, copy=False)
                bounds = (self._chunks(host.numel(), host.element_size())
                          if chunked else [(0, host.numel())])
                for a, b in bounds:
                    host[a:b].copy_(dev[a:b], non_blocking=True)
                    schedule.append((g, a, b, packer.stream.record_event()))
        return packer.host, schedule

    def _unpack(self, packer: _LegacyPacker, bufs: Sequence[torch.Tensor],
                leaves: Sequence[torch.Tensor], treedef: Any) -> Any:
        """Leaves as views of the group buffers, in their own dtypes."""
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for buf, (_, idxs) in zip(bufs, packer.groups):
            off = 0
            for i in idxs:
                n = leaves[i].numel()
                out[i] = buf[off:off + n].view(leaves[i].shape).to(leaves[i].dtype)
                off += n
        return _unflatten(treedef, out)

    def _allreduce_sync(
        self,
        tree: Any,
        op: ReduceOp,
        timeout_ms: int,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
        caller: Optional[Tuple[Any, Any]] = None,
    ) -> Any:
        if divisor is not None and op != ReduceOp.SUM:
            raise ValueError("divisor only composes with ReduceOp.SUM")
        leaves, treedef = _flatten(tree)
        if op == ReduceOp.AVG:
            divisor = self._world_size
        if self._world_size == 1 or not leaves:
            return _identity(tree, leaves, treedef, divisor)
        native_op = int(ReduceOp.SUM if op == ReduceOp.AVG else op)
        q8 = wire == "q8"
        packer = self._packer_for(leaves, treedef, "f32" if q8 else "acc")
        t_pack = time.perf_counter()
        # the quantized ring takes the whole tree in one op, as in the
        # JAX package; the plain ring pipelines big groups in chunks
        hosts, schedule = self._stage_down(packer, leaves, caller,
                                           chunked=not q8)
        pack_s = time.perf_counter() - t_pack
        outs = hosts
        if caller is not None:
            with torch.cuda.stream(caller[0]):
                outs = [torch.empty(h.numel(), dtype=h.dtype,
                                    device=packer.device) for h in hosts]
        buckets: Dict[str, dict] = {
            _NP_NAMES[acc]: {"bytes": 0, "d2h": 0.0, "ring": 0.0, "h2d": 0.0,
                             "stripe_s": [], "stripe_wall": 0.0}
            for acc, _ in packer.groups}
        stripe_sum: List[float] = []
        for g, a, b, landed in schedule:
            st = buckets[_NP_NAMES[packer.groups[g][0]]]
            t0 = time.perf_counter()
            if landed is not None:
                landed.synchronize()
            t1 = time.perf_counter()
            chunk = hosts[g][a:b]
            if q8:
                _check(_lib.tft_hc_allreduce_q8(
                    self._handle, chunk.data_ptr(), chunk.numel(), timeout_ms))
            else:
                _check(_lib.tft_hc_allreduce(
                    self._handle, chunk.data_ptr(), chunk.numel(),
                    _NATIVE_DTYPES[chunk.dtype], native_op, timeout_ms))
            stripe_s = self._last_stripe_seconds()
            if divisor is not None:
                _divide_(chunk, divisor)
            t2 = time.perf_counter()
            if caller is not None:
                # the upload starts now and overlaps the next chunk's ring
                with torch.cuda.stream(caller[0]):
                    outs[g][a:b].copy_(chunk, non_blocking=True)
            st["bytes"] += chunk.numel() * chunk.element_size()
            st["d2h"] += t1 - t0
            st["ring"] += t2 - t1
            st["h2d"] += time.perf_counter() - t2
            for k, x in enumerate(stripe_s):
                for acc_list in (st["stripe_s"], stripe_sum):
                    if k < len(acc_list):
                        acc_list[k] += x
                    else:
                        acc_list.append(x)
            if stripe_s:
                st["stripe_wall"] += max(stripe_s)
        if caller is not None:
            packer.uploaded = caller[0].record_event()
        total = sum(b["bytes"] for b in buckets.values())
        stats = {
            "op": "allreduce_q8" if q8 else "allreduce",
            "bytes": total,
            # what crossed the card link: the group buffers, at full width
            "d2h_bytes": total if caller is not None else 0,
            "chunks": len(schedule),
            "pack": pack_s,
            "d2h": sum(b["d2h"] for b in buckets.values()),
            "ring": sum(b["ring"] for b in buckets.values()),
            "h2d": sum(b["h2d"] for b in buckets.values()),
            "stripe_s": stripe_sum,
            "buckets": buckets,
        }
        if q8:
            # int8 chunks + the per-(stripe, ring chunk) scales + header
            n = sum(packer.counts)
            stats["wire_bytes"] = n + _q8_wire_overhead(
                _effective_stripes(n, self._stripes), self._world_size)
        self._record_op_stats(stats)
        return self._unpack(packer, outs, leaves, treedef)

    def allgather(self, tree: Any) -> Work:
        """Gathers every rank's tree (a list in rank order). The tree packs
        by exact dtype, byte for byte, into one buffer per dtype in the
        JAX package's wire order (its device-packed layout: an int8
        ``{"q", "scale"}`` payload ships as the f32 scales, then the int8
        codes), so members of both packages share the gather."""
        timeout_ms = _ms(self._timeout)
        caller = self._caller_event(tree)
        return self._submit(
            lambda: self._allgather_sync(tree, timeout_ms, caller))

    def _allgather_sync(self, tree: Any, timeout_ms: int,
                        caller: Optional[Tuple[Any, Any]]) -> List[Any]:
        if self._world_size == 1:
            return [tree]
        leaves, treedef = _flatten(tree)
        world = self._world_size
        t0 = time.perf_counter()
        if not leaves:  # still one ring op, as every member issues it
            _check(_lib.tft_hc_allgather(self._handle, None, None, 0,
                                         timeout_ms))
            return [tree] * world
        packer = self._packer_for(leaves, treedef, "exact")
        hosts, schedule = self._stage_down(packer, leaves, caller,
                                           chunked=False)
        t1 = time.perf_counter()
        for *_, landed in schedule:
            if landed is not None:
                landed.synchronize()
        t2 = time.perf_counter()
        sizes = [h.numel() * h.element_size() for h in hosts]
        nbytes = sum(sizes)
        # one contiguous input of the groups in wire order
        inbuf = torch.cat([h.view(-1).view(torch.uint8) for h in hosts])
        out = packer.gathered.get(world)
        if out is None or caller is None:
            out = torch.empty(world * nbytes, dtype=torch.uint8,
                              pin_memory=caller is not None)
            if caller is not None:
                packer.gathered[world] = out
        t2b = time.perf_counter()  # host staging copies are not the wire
        _check(_lib.tft_hc_allgather(self._handle, inbuf.data_ptr(),
                                     out.data_ptr(), nbytes, timeout_ms))
        t3 = time.perf_counter()
        stripe_s = self._last_stripe_seconds()
        results: List[Any] = []
        ctx = (torch.cuda.stream(caller[0]) if caller is not None
               else contextlib.nullcontext())
        with ctx:
            for r in range(world):
                off = r * nbytes
                bufs = []
                for (acc, _), count, size in zip(packer.groups, packer.counts,
                                                 sizes):
                    buf = torch.empty(count, dtype=acc, device=packer.device)
                    buf.view(torch.uint8).copy_(out[off:off + size],
                                                non_blocking=caller is not None)
                    bufs.append(buf)
                    off += size
                results.append(self._unpack(packer, bufs, leaves, treedef))
            if caller is not None:
                packer.uploaded = caller[0].record_event()
        self._record_op_stats({
            "op": "allgather", "bytes": nbytes,
            # this rank's groups cross down once; the gathered members
            # come back on the h2d leg
            "d2h_bytes": nbytes if caller is not None else 0,
            "pack": t1 - t0, "d2h": t2 - t1, "host_copy": t2b - t2,
            "ring": t3 - t2b, "h2d": time.perf_counter() - t3,
            "stripe_s": stripe_s,
        })
        return results

    def broadcast(self, tree: Any, root: int = 0) -> Work:
        """Broadcasts root's tree, leaf bytes in tree order; the result
        comes back on each leaf's device."""
        timeout_ms = _ms(self._timeout)
        caller = self._caller_event(tree)
        return self._submit(lambda: self._broadcast_sync(tree, root,
                                                         timeout_ms, caller))

    def _broadcast_sync(self, tree: Any, root: int, timeout_ms: int,
                        caller: Optional[Tuple[Any, Any]] = None) -> Any:
        if self._world_size == 1:
            if root != 0:
                raise RuntimeError(f"bad broadcast root {root} for world size 1")
            return tree
        leaves, treedef = _flatten(tree)
        if caller is not None:  # the card leaves are written
            caller[1].synchronize()
        host = [l.detach().to("cpu").contiguous().reshape(-1) for l in leaves]
        packed = (torch.cat([h.view(torch.uint8) for h in host]) if host
                  else torch.empty(0, dtype=torch.uint8))
        nbytes = packed.numel()
        _check(_lib.tft_hc_broadcast(
            self._handle, packed.data_ptr() if nbytes else None, nbytes, root,
            timeout_ms))
        out, off = [], 0
        for l, h in zip(leaves, host):
            size = h.numel() * h.element_size()
            # a copy: the slice may sit off the dtype's alignment
            out.append(packed[off:off + size].clone().view(l.dtype)
                       .view(l.shape).to(l.device))
            off += size
        return _unflatten(treedef, out)

    def barrier(self) -> Work:
        timeout_ms = _ms(self._timeout)
        return self._submit(
            lambda: _check(_lib.tft_hc_barrier(self._handle, timeout_ms)))

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
        device_pack: Any = True,
        hier: bool = False,
    ) -> Work:
        """One native call per step over a cached, precompiled plan.

        Flat (``hier=False``): ``device_pack`` picks where the wire
        encoding runs. ``True`` packs on the leaves' device with the
        port's kernels (their plain versions for CPU leaves) on wires
        ``None``/``"bf16"``/``"q8ef"``; card leaves on any other wire
        raise, CPU leaves take the host pack (the only pack of wire
        ``"q8"``). ``False`` is the native host pack: card leaves are
        copied into pinned host tensors the plan owns (allocated once
        with it), the schedule the caller chose, not a fallback. ``None``
        / ``"auto"`` (the ``TORCHFT_DEVICE_PACK`` discipline): card
        leaves pack on the card where the wire allows it, CPU leaves on
        the host. Every pack is bit-identical. A device pack that cannot
        be built or launched raises (latched by the Manager): nothing
        falls back to the host pack.

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
        setting = _resolve_device_pack_setting(device_pack)
        leaves, _ = _flatten(tree)
        on_card = any(l.is_cuda for l in leaves)
        if setting is None:  # auto
            setting = on_card and wire in _DEVICE_PACK_WIRES
        caller = None  # (stream, event) of a caller whose leaves are on the card
        if on_card:
            if not hier and setting and wire not in _DEVICE_PACK_WIRES:
                raise ValueError(
                    f"leaves on the card are packed there by the port's "
                    f"kernels on wires {_DEVICE_PACK_WIRES}; got wire "
                    f"{wire!r} (pass device_pack=False for the host pack)"
                )
            # Marks the leaves as written on the caller's stream: the
            # pack (or the staging copy) waits on this event, not on
            # whatever is queued later.
            stream = torch.cuda.current_stream(leaves[0].device)
            caller = (stream, stream.record_event())
        prepacked = bool(setting) and wire in _DEVICE_PACK_WIRES and not hier
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
                    tree, ReduceOp.SUM, timeout_ms, divisor, None, caller
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
            refs, staging_allocs = self._stage_inputs(plan, leaves, wire,
                                                      caller)
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
                # CPU leaves: the pointer gather; card leaves: until the
                # copies into the plan's pinned inputs landed
                "d2h": t1 - t0,
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

    def _stage_inputs(
        self, plan: _CommPlan, leaves: Sequence[torch.Tensor],
        wire: Optional[str], caller: Optional[Tuple[Any, Any]],
    ) -> Tuple[List[torch.Tensor], int]:
        """The native host pack's inputs: the CPU leaves themselves
        (:meth:`_host_inputs`), or card leaves copied into the plan's
        pinned inputs on its stream, after the event the caller recorded
        once they were written (the bf16 wire's NaN canonicalised in
        place: F1). Returns what :meth:`_host_inputs` returns."""
        if caller is None:
            return self._host_inputs(plan, leaves, wire)
        with torch.cuda.device(leaves[0].device), \
                torch.cuda.stream(plan.stream):
            plan.stream.wait_event(caller[1])
            for host, l in zip(plan.staging, leaves):
                host.copy_(l.detach(), non_blocking=True)
            copied = plan.stream.record_event()
        copied.synchronize()
        if wire == "bf16":
            for host in plan.staging:
                if host.dtype == torch.float32:
                    c = _canonical_nan(host)
                    if c is not host:
                        host.copy_(c)
        return [], 0

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
        refs, staging_allocs = self._stage_inputs(plan, leaves, wire, caller)
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

    # -- sharded plans (per-step ZeRO) --

    def _shard_ranges(self, count: int, esize: int,
                      eff: int) -> List[Tuple[int, int]]:
        """(start, len) element ranges this rank owns of a count-element
        group at the pinned stripe partition (the native layout)."""
        if self._world_size == 1:
            return [(0, count)]
        buf = (ctypes.c_int64 * (2 * _MAX_STRIPES))()
        n = _lib.tft_hc_shard_ranges(self._handle, count, esize, self._rank,
                                     eff, buf, _MAX_STRIPES)
        if n < 0:
            _check(2)
        return [(buf[2 * i], buf[2 * i + 1]) for i in range(n)]

    # -- bulk split ops (the sharded outer sync) --

    def reduce_scatter(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
        grid_shard: bool = False,
    ) -> Work:
        """Phase 1 of the ring only, per group of the legacy pack (the
        JAX device pack's layout; ``wire="q8"``: one f32 group): the full
        tree crosses down once, the ring reduces it in place, and only
        the owned shard comes back (to the leaves' device). See
        :meth:`Collectives.reduce_scatter`."""
        timeout_ms = _ms(self._timeout)
        if wire not in (None, "q8"):
            raise ValueError(f"unsupported wire: {wire!r}")
        if grid_shard and wire != "q8":
            raise ValueError("grid_shard only applies to wire='q8'")
        if op == ReduceOp.AVG:
            divisor, op = float(self._world_size), ReduceOp.SUM
        if op != ReduceOp.SUM and (divisor is not None or wire == "q8"):
            raise ValueError(
                "divisor / wire='q8' compose with ReduceOp.SUM/AVG only")
        caller = self._caller_event(tree)
        return self._submit(lambda: self._reduce_scatter_sync(
            tree, op, divisor, wire, grid_shard, timeout_ms, caller))

    def _reduce_scatter_sync(
        self, tree: Any, op: ReduceOp, divisor: Optional[float],
        wire: Optional[str], grid_shard: bool, timeout_ms: int,
        caller: Optional[Tuple[Any, Any]],
    ) -> TreeShard:
        leaves, treedef = _flatten(tree)
        if not leaves:
            raise ValueError("reduce_scatter of an empty tree")
        packer = self._packer_for(leaves, treedef,
                                  "f32" if wire == "q8" else "acc")
        t0 = time.perf_counter()
        hosts, schedule = self._stage_down(packer, leaves, caller,
                                           chunked=False)
        for *_, landed in schedule:
            if landed is not None:
                landed.synchronize()
        d2h_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        values: Dict[str, torch.Tensor] = {}
        counts: Dict[str, int] = {}
        ranges: Dict[str, List[Tuple[int, int]]] = {}
        layout: Dict[str, int] = {}
        dtypes: Dict[str, torch.dtype] = {}
        groups: Dict[str, List[int]] = {}
        stripe_s: List[float] = []
        wire_bytes = 0
        for (acc, idxs), buf in zip(packer.groups, hosts):
            name = _NP_NAMES[acc]
            count = buf.numel()
            esize = 1 if wire == "q8" else buf.element_size()
            eff = _effective_stripes(count * esize, self._stripes)
            rng = self._shard_ranges(count, esize, eff)
            shard = torch.empty(sum(n for _, n in rng), dtype=acc,
                                pin_memory=caller is not None)
            if self._world_size == 1:
                shard.copy_(buf)
            elif wire == "q8":
                _check(_lib.tft_hc_reduce_scatter_q8(
                    self._handle, buf.data_ptr(), count, shard.data_ptr(),
                    1 if grid_shard else 0, eff, timeout_ms))
            else:
                _check(_lib.tft_hc_reduce_scatter(
                    self._handle, buf.data_ptr(), count, _NATIVE_DTYPES[acc],
                    int(op), shard.data_ptr(), eff, timeout_ms))
            if self._world_size > 1:
                stripe_s.extend(self._last_stripe_seconds())
            if divisor is not None and divisor != 1:
                _divide_(shard, divisor)
            values[name], counts[name], ranges[name] = shard, count, rng
            layout[name], dtypes[name], groups[name] = eff, acc, list(idxs)
            wire_bytes += (count + _q8_wire_overhead(
                eff, self._world_size, phases=1) if wire == "q8"
                else count * buf.element_size())
        ring_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        if caller is not None:
            with torch.cuda.stream(caller[0]):
                values = {k: v.to(packer.device, non_blocking=True)
                          for k, v in values.items()}
                # the pinned shards are fresh per op: nothing to guard
        nbytes = sum(h.numel() * h.element_size() for h in hosts)
        self._record_op_stats({
            "op": "reduce_scatter",
            "bytes": nbytes,
            "shard_bytes": sum(v.numel() * v.element_size()
                               for v in values.values()),
            # q8 counts its scale sidecar (one quantized phase) + header
            "wire_bytes": wire_bytes,
            # the full tree crosses down once from the card; only the
            # shard returns
            "d2h_bytes": nbytes if caller is not None else 0,
            "d2h": d2h_s, "ring": ring_s,
            "h2d": time.perf_counter() - t2,
            "stripe_s": stripe_s,
        })
        return TreeShard(
            values=values, counts=counts, ranges=ranges, layout=layout,
            dtypes=dtypes, groups=groups, treedef=treedef, sig=packer.sig,
            rank=self._rank, world_size=self._world_size, packer=packer,
            device=packer.device,
        )

    def allgather_into(
        self, shard: TreeShard, wire: Optional[str] = None
    ) -> Work:
        """Phase 2 of the ring on the shard's CURRENT values: each member
        ships its shard (card values cross down at the wire's width: on
        ``wire="bf16"`` K3 casts them on the card first), every member
        ends with the identical full tree, on the device the reduced
        leaves lived on."""
        timeout_ms = _ms(self._timeout)
        if wire not in (None, "bf16"):
            raise ValueError(f"unsupported wire: {wire!r}")
        caller = self._caller_event(shard.values)
        return self._submit(lambda: self._allgather_into_sync(
            shard, wire, timeout_ms, caller))

    def _shard_down(self, vals: torch.Tensor, gdtype: torch.dtype,
                    wdtype: torch.dtype,
                    caller: Optional[Tuple[Any, Any]]) -> torch.Tensor:
        """A shard's values as a contiguous host tensor of the wire dtype.
        Card values are cast there (K3 for the bf16 wire) and copied into
        pinned memory on a side stream after the caller's event, so
        nothing waits on work the caller queued later; CPU values go
        through K3's plain version."""
        if vals.dtype != gdtype:
            vals = vals.to(gdtype)
        if not vals.is_cuda:
            if wdtype == gdtype:
                return vals.contiguous()
            w = torch.empty(vals.numel(), dtype=wdtype)
            qk.cast_bf16_group([vals], w)
            return w
        assert caller is not None
        stream = self._side_streams.get(vals.device)
        if stream is None:
            stream = self._side_streams[vals.device] = torch.cuda.Stream(
                vals.device)
        host = torch.empty(vals.numel(), dtype=wdtype, pin_memory=True)
        with torch.cuda.device(vals.device), torch.cuda.stream(stream):
            stream.wait_event(caller[1])
            if wdtype != gdtype:
                w = torch.empty(vals.numel(), dtype=wdtype,
                                device=vals.device)
                qk.cast_bf16_group([vals], w)
                vals = w
            host.copy_(vals, non_blocking=True)
            landed = stream.record_event()
        landed.synchronize()
        return host

    def _allgather_into_sync(
        self, shard: TreeShard, wire: Optional[str], timeout_ms: int,
        caller: Optional[Tuple[Any, Any]],
    ) -> Any:
        t0 = time.perf_counter()
        stripe_s: List[float] = []
        wire_bytes = d2h_bytes = 0
        dest = shard.device
        fulls: Dict[str, torch.Tensor] = {}
        for name in sorted(shard.counts):
            count, eff = shard.counts[name], shard.layout[name]
            gdtype = shard.dtypes[name]
            vals = shard.values[name].detach().reshape(-1)
            expected = sum(n for _, n in shard.ranges[name])
            if vals.numel() != expected:
                raise ValueError(
                    f"shard group {name!r} has {vals.numel()} elements, the "
                    f"layout expects {expected}: pass the TreeShard from "
                    "reduce_scatter (values replaced, layout intact)")
            wdtype = gdtype
            if wire == "bf16":
                if gdtype == torch.float32:
                    wdtype = torch.bfloat16
                elif gdtype != torch.bfloat16:
                    raise ValueError(
                        "wire='bf16' applies to f32/bf16 groups only")
            host = self._shard_down(vals, gdtype, wdtype, caller)
            if vals.is_cuda:
                d2h_bytes += host.numel() * host.element_size()
            full = torch.empty(count, dtype=wdtype,
                               pin_memory=dest is not None)
            if self._world_size == 1:
                full.copy_(host)
            else:
                _check(_lib.tft_hc_allgather_into(
                    self._handle, host.data_ptr(), full.data_ptr(), count,
                    _NATIVE_DTYPES[wdtype], eff, timeout_ms))
                stripe_s.extend(self._last_stripe_seconds())
            wire_bytes += count * full.element_size()
            fulls[name] = full
        ring_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        out: List[Optional[torch.Tensor]] = [None] * len(shard.sig)
        ctx = contextlib.nullcontext()
        if dest is not None:
            ctx = torch.cuda.stream(caller[0] if caller is not None
                                    else torch.cuda.current_stream(dest))
        with ctx:
            for name, idxs in shard.groups.items():
                buf = fulls[name]
                if dest is not None:
                    # the wire's words go up; bf16 widens on the card (exact)
                    buf = buf.to(dest, non_blocking=True)
                buf = buf.to(shard.dtypes[name])
                off = 0
                for i in idxs:
                    shape, dt = shard.sig[i]
                    n = math.prod(shape)
                    out[i] = buf[off:off + n].view(shape).to(dt)
                    off += n
        self._record_op_stats({
            "op": "allgather_into",
            "bytes": sum(b.numel() * b.element_size() for b in fulls.values()),
            "wire_bytes": wire_bytes,
            # only this rank's (updated) shard crosses down; the gathered
            # tree returns on the h2d leg
            "d2h_bytes": d2h_bytes,
            "ring": ring_s,
            "h2d": time.perf_counter() - t1,
            "stripe_s": stripe_s,
        })
        return _unflatten(shard.treedef, out)

    def plan_reduce_scatter(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
        ag_wire: Optional[str] = None,
    ) -> Work:
        """The grad leg: one native call over a precompiled sharded plan
        (pack, the rs ring phase, shard compaction and the divisor). At
        ``wire=None`` the shard is bit-identical to the matching slice of
        ``plan_allreduce(wire=None)``'s result. Card leaves reach the
        native call through pinned inputs the plan owns; the shard comes
        back as a card tensor."""
        timeout_ms = _ms(self._timeout)
        if wire not in (None, "bf16", "q8"):
            raise ValueError(f"unsupported wire: {wire!r}")
        if ag_wire not in (None, "bf16"):
            raise ValueError(f"unsupported ag_wire: {ag_wire!r}")
        if op == ReduceOp.AVG:
            if divisor is not None:
                raise ValueError("divisor only composes with ReduceOp.SUM")
            divisor, op = float(self._world_size), ReduceOp.SUM
        if op != ReduceOp.SUM:
            raise ValueError("plan_reduce_scatter supports SUM/AVG only")
        caller = self._caller_event(tree)
        return self._submit(lambda: self._plan_reduce_scatter_sync(
            tree, divisor, wire, ag_wire, timeout_ms, caller))

    def _sharded_plan_for(self, leaves: Sequence[torch.Tensor], treedef: Any,
                          wire: Optional[str], ag_wire: Optional[str]
                          ) -> Optional[_ShardedPlan]:
        sig = _signature(leaves)
        pin = leaves[0].is_cuda
        key = (wire, ag_wire, treedef, sig, pin, "sharded")
        if key not in self._plans:
            try:
                self._plans[key] = _ShardedPlan(
                    self._handle, sig, treedef, wire, ag_wire,
                    stripes=self._stripes, world=self._world_size, pin=pin,
                    device=leaves[0].device if pin else None)
            except (KeyError, RuntimeError):
                # non-f32 leaves, or wires the native plan rejects
                self._plans[key] = None
        return self._plans[key]

    def _plan_reduce_scatter_sync(
        self, tree: Any, divisor: Optional[float], wire: Optional[str],
        ag_wire: Optional[str], timeout_ms: int,
        caller: Optional[Tuple[Any, Any]],
    ) -> TreeShard:
        leaves, treedef = _flatten(tree)
        if not leaves:
            raise ValueError("plan_reduce_scatter of an empty tree")
        plan = self._sharded_plan_for(leaves, treedef, wire, ag_wire)
        if plan is None:
            raise ValueError(
                "sharded comm plans take f32 leaves only (keep f32 master "
                "weights, or use the fused plan path)")
        t0 = time.perf_counter()
        refs: List[torch.Tensor] = []
        staging_allocs = 0
        if caller is None:
            refs, staging_allocs = self._host_inputs(plan, leaves, None)
        else:
            with torch.cuda.device(leaves[0].device), \
                    torch.cuda.stream(plan.stream):
                plan.stream.wait_event(caller[1])
                for host, l in zip(plan.staging, leaves):
                    host.copy_(l.detach(), non_blocking=True)
                copied = plan.stream.record_event()
            copied.synchronize()
        t1 = time.perf_counter()
        # shards double-buffer like plan outputs
        k = plan.shard_flip
        plan.shard_flip ^= 1
        if plan.shard_uploaded[k] is not None:
            plan.shard_uploaded[k].synchronize()
            plan.shard_uploaded[k] = None
        shard_buf = plan.shard_sets[k]
        _check(_lib.tft_plan_execute_rs(
            self._handle, plan.plan_id, plan.in_ptrs,
            ctypes.cast(shard_buf.data_ptr(), ctypes.POINTER(ctypes.c_float)),
            float(divisor if divisor is not None else 1.0),
            0 if divisor is None else 1, timeout_ms))
        ring_s = time.perf_counter() - t1
        del refs
        plan.execs += 1
        t2 = time.perf_counter()
        value = shard_buf
        if caller is not None:
            with torch.cuda.stream(caller[0]):
                value = shard_buf.to(leaves[0].device, non_blocking=True)
                plan.shard_uploaded[k] = caller[0].record_event()
        self._record_op_stats({
            # its own key: the grad leg bills apart from the param leg
            "op": "plan_reduce_scatter",
            "wire": wire,
            "bytes": plan.bytes,
            "shard_bytes": plan.shard_count * 4,
            "wire_bytes": plan.rs_wire_bytes,
            # the full tree crosses down once (from the card); only the
            # shard returns
            "d2h_bytes": plan.bytes if caller is not None else 0,
            "d2h": t1 - t0,
            "ring": ring_s,
            "h2d": time.perf_counter() - t2,
            "_buckets_json": self._plan_stats_json(plan.plan_id),
            "py_staging_allocs": staging_allocs,
            "plan_execs": plan.execs,
        })
        return TreeShard(
            values={"float32": value},
            counts={"float32": plan.total},
            ranges={"float32": self._shard_ranges(plan.total, 4, plan.eff)},
            layout={"float32": plan.eff},
            dtypes={"float32": torch.float32},
            groups={"float32": list(range(len(leaves)))},
            treedef=treedef, sig=plan.sig, rank=self._rank,
            world_size=self._world_size, plan=plan,
            device=leaves[0].device if caller is not None else None,
        )

    def plan_allgather_into(
        self, shard: TreeShard, wire: Optional[str] = None
    ) -> Work:
        """The param leg: gathers every rank's updated shard into the
        plan's double-buffered outputs (one native call at the plan's ag
        wire), then up to the card when the reduced leaves lived there."""
        timeout_ms = _ms(self._timeout)
        if wire not in (None, "bf16"):
            raise ValueError(f"unsupported wire: {wire!r}")
        caller = self._caller_event(shard.values)
        return self._submit(lambda: self._plan_allgather_into_sync(
            shard, wire, timeout_ms, caller))

    def _plan_allgather_into_sync(
        self, shard: TreeShard, wire: Optional[str], timeout_ms: int,
        caller: Optional[Tuple[Any, Any]],
    ) -> Any:
        plan = shard.plan
        if plan is None:
            raise ValueError("pass the TreeShard from plan_reduce_scatter")
        if wire != plan.ag_wire:
            raise ValueError(
                f"plan_allgather_into wire {wire!r} does not match the "
                f"plan's ag_wire {plan.ag_wire!r} (declared at "
                "plan_reduce_scatter; the header pins it cohort-wide)")
        vals = shard.values.get("float32")
        if vals is None or len(shard.values) != 1:
            raise ValueError("pass the TreeShard from plan_reduce_scatter "
                             "(values replaced, layout intact)")
        if vals.numel() != plan.shard_count:
            raise ValueError(
                f"shard has {vals.numel()} elements, the plan's layout "
                f"expects {plan.shard_count}: pass the TreeShard from "
                "plan_reduce_scatter (values replaced, layout intact)")
        t0 = time.perf_counter()
        d2h_bytes = 0
        if caller is not None:
            with torch.cuda.device(vals.device), torch.cuda.stream(plan.stream):
                plan.stream.wait_event(caller[1])
                plan.shard_in.copy_(vals.detach().reshape(-1),
                                    non_blocking=True)
                copied = plan.stream.record_event()
            copied.synchronize()
            v = plan.shard_in
            d2h_bytes = v.numel() * 4
        else:
            v = vals.detach().reshape(-1).to(torch.float32).contiguous()
        t1 = time.perf_counter()
        k, outs, out_ptrs = plan.next_outputs()
        _check(_lib.tft_plan_execute_ag(
            self._handle, plan.plan_id,
            ctypes.cast(v.data_ptr(), ctypes.POINTER(ctypes.c_float)),
            out_ptrs, timeout_ms))
        ring_s = time.perf_counter() - t1
        plan.execs += 1
        t2 = time.perf_counter()
        dest = shard.device if shard.device is not None else (
            vals.device if vals.is_cuda else None)
        result: List[torch.Tensor] = list(outs)
        if dest is not None:
            stream = (caller[0] if caller is not None
                      else torch.cuda.current_stream(dest))
            with torch.cuda.stream(stream):
                result = [o.to(dest, non_blocking=True) for o in outs]
                plan.uploaded[k] = stream.record_event()
        self._record_op_stats({
            # the param leg's own key, billed at the ag wire
            "op": "plan_allgather_into",
            "wire": wire,
            "bytes": plan.bytes,
            "wire_bytes": plan.ag_wire_bytes,
            # only this rank's updated shard crosses down; the gathered
            # tree returns on the h2d leg
            "d2h_bytes": d2h_bytes,
            "d2h": t1 - t0,
            "ring": ring_s,
            "h2d": time.perf_counter() - t2,
            "_buckets_json": self._plan_stats_json(plan.plan_id),
            "plan_execs": plan.execs,
        })
        return _unflatten(shard.treedef, result)

    def plan_reset_feedback(self) -> None:
        """Zeroes the EF carry of every cached q8ef plan (flat and
        two-tier, whose carry sits at the region leader) and of every
        device packer; runs on the op thread so it cannot interleave with
        an in-flight execute."""

        def reset() -> None:
            for plan in self._plans.values():
                if isinstance(plan, _CommPlan) and plan.wire == "q8ef":
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


def _divide_(t: torch.Tensor, divisor: float) -> None:
    """:func:`_divide` in place (a host chunk the ring reduced)."""
    if t.dtype in (torch.float32, torch.float64):
        torch.div(t, divisor, out=t)
    else:
        t.copy_(_divide(t, divisor))


def _divide(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """Same-dtype divide for the divisor/AVG contract: integers
    floor-divide, floats keep their dtype (bf16 divides in f32)."""
    if not t.is_floating_point():
        return torch.div(t, int(divisor), rounding_mode="floor")
    if t.dtype == torch.bfloat16:
        return (t.float() / divisor).to(torch.bfloat16)
    return t / divisor


class DummyCollectives(Collectives):
    """No-op fake for tests and wrapper semantics (the JAX package's
    ``DummyCollectives``): every op completes at once as if this member
    were alone, lossless, and counts itself in ``op_count``."""

    def __init__(self, rank: int = 0, world_size: int = 1) -> None:
        self._rank = rank
        self._world_size = world_size
        self.configure_count = 0
        self.op_count = 0
        self.last_regions: Optional[List[str]] = None
        self.last_hosts: Optional[List[str]] = None
        self._hier = False

    def configure(
        self,
        store_addr: str,
        rank: int,
        world_size: int,
        regions: Optional[Sequence[str]] = None,
        hosts: Optional[Sequence[str]] = None,
    ) -> None:
        self.configure_count += 1
        self._rank = rank
        self._world_size = world_size
        self.last_regions = list(regions) if regions else None
        self.last_hosts = list(hosts) if hosts else None
        # the host ring's capability rule: several regions, or a
        # (region, host) pair grouping >= 2 ranks
        multi_region = bool(regions and len(set(regions)) >= 2
                            and all(regions) and world_size > 1)
        host_grouped = False
        if hosts and all(hosts) and world_size > 1:
            keys = [((regions[i] if regions and all(regions) else ""),
                     hosts[i]) for i in range(len(hosts))]
            host_grouped = any(keys.count(k) >= 2 for k in keys)
        self._hier = multi_region or host_grouped

    def hier_capable(self) -> bool:
        return self._hier

    def allreduce_hier(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
    ) -> Work:
        """Lossless fake of the two-tier schedule; raises without a usable
        topology map, like the real backend."""
        if not self._hier and self._world_size > 1:
            raise RuntimeError("DummyCollectives: no region map configured")
        return self.allreduce(tree, op, divisor=divisor)

    def allreduce(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,  # accepted, ignored (lossless fake)
    ) -> Work:
        self.op_count += 1
        if divisor is not None and divisor != 1:
            # the manager's AVG divides here; the fake honours it
            leaves, treedef = _flatten(tree)
            tree = _unflatten(treedef, [_divide(l, divisor) for l in leaves])
        return _completed(tree)

    def plan_allreduce(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,  # accepted, ignored (lossless fake)
        device_pack: bool = True,  # accepted, ignored
        hier: bool = False,
    ) -> Work:
        """The fake allreduce under the plan's call shape; ``hier`` keeps
        the real backend's capability rule."""
        if op == ReduceOp.AVG:
            if divisor is not None:
                raise ValueError("divisor only composes with ReduceOp.SUM")
            divisor = float(self._world_size)
        if hier and not self._hier and self._world_size > 1:
            raise RuntimeError("DummyCollectives: no region map configured")
        return self.allreduce(tree, ReduceOp.SUM, divisor=divisor)

    def reduce_scatter(
        self,
        tree: Any,
        op: ReduceOp = ReduceOp.SUM,
        divisor: Optional[float] = None,
        wire: Optional[str] = None,
        grid_shard: bool = False,  # accepted, ignored (lossless fake)
    ) -> Work:
        """Lossless fake: the shard is the whole flat-packed tree (the
        world-size-1 layout), so reduce_scatter -> update ->
        allgather_into round-trips exactly."""
        self.op_count += 1
        leaves, treedef = _flatten(tree)
        flat = (torch.cat([l.detach().to(torch.float32).reshape(-1)
                           for l in leaves]) if leaves
                else torch.zeros(0, dtype=torch.float32))
        if divisor is not None and divisor != 1:
            flat = flat / divisor
        return _completed(TreeShard(
            values={"float32": flat}, counts={"float32": flat.numel()},
            ranges={"float32": [(0, flat.numel())]}, layout={"float32": 1},
            dtypes={"float32": torch.float32},
            groups={"float32": list(range(len(leaves)))},
            treedef=treedef, sig=_signature(leaves), rank=self._rank,
            world_size=self._world_size,
        ))

    def allgather_into(
        self, shard: TreeShard, wire: Optional[str] = None
    ) -> Work:
        self.op_count += 1
        buf = shard.values["float32"]
        if wire == "bf16":
            buf = buf.to(torch.bfloat16).to(torch.float32)
        out, off = [], 0
        for shape, dt in shard.sig:
            n = math.prod(shape)
            out.append(buf[off:off + n].view(shape).to(dt))
            off += n
        return _completed(_unflatten(shard.treedef, out))

    def allgather(self, tree: Any) -> Work:
        self.op_count += 1
        return _completed([tree] * self._world_size)

    def broadcast(self, tree: Any, root: int = 0) -> Work:
        self.op_count += 1
        return _completed(tree)

    def barrier(self) -> Work:
        self.op_count += 1
        return _completed(None)

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank
