"""Fault-tolerant data parallelism across replica groups.

The gradient tree of a step (``grad_fn(params, *batch) -> (loss,
grads)``, e.g. ``torch.autograd.grad`` over the parameter tree) is
averaged across replica groups as one unit: the collectives layer packs
the whole tree into one ring pass per group.

Intra-replica-group parallelism stays in user code; these wrappers only
average across groups. ``PipelinedDDP`` runs its sync over the comm plan
(the port's default) or the legacy managed ops; ``hier=True`` runs the
plan over the two-tier schedule (the quorum's region and host maps).
``transport="iso"`` runs the legacy payload through the manager's
isolated data plane (:mod:`.isolated_xla`). ``ShardedDDP`` is per-step
ZeRO over the sharded comm plan. ``AdaptiveDDP`` probes the schedules on
the cohort's own hardware and locks the cohort-agreed fastest.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ._tree import flatten, tree_map, unflatten
from .collectives import ReduceOp, Work, _resolve_device_pack_setting
from .manager import Manager
from .quantize import (_views, cast_bf16_tree, make_dequant_average,
                       quantize_with_feedback)
from .train_state import FTTrainState, build_shard_apply_step

logger: logging.Logger = logging.getLogger(__name__)

# PipelinedDDP compress mode -> comm-plan wire.
_WIRES = {None: None, "bf16": "bf16", "q8": "q8ef"}


def _device_pack_available() -> bool:
    """Whether the port's wire kernels import here (the capability gate
    of AdaptiveDDP's device-pack candidate). True wherever the package
    imports: on the CPU the kernels' plain versions serve the pack, so a
    cohort of JAX and port members builds the same candidate list."""
    try:
        from .ops import quantize_kernels  # noqa: F401

        return True
    except Exception:  # noqa: BLE001 - any import failure = unavailable
        return False


class DistributedDataParallel:
    """Averages gradient trees across replica groups, fault-tolerantly::

        ddp = DistributedDataParallel(manager)
        loss, grads = grad_fn(state.params, batch)
        grads = ddp.allreduce_grads(grads).wait()

    or wraps a function returning ``(value, grads)`` so the average
    happens on call: ``loss, grads = ddp.wrap_grad_fn(grad_fn)(params,
    batch)``.
    """

    def __init__(self, manager: Manager) -> None:
        self._manager = manager

    def allreduce_grads(self, grads: Any) -> Work:
        """Starts the async cross-group average; the Work resolves to the
        averaged tree (the input on error, with the error latched for
        ``should_commit``)."""
        return self._manager.allreduce(grads)

    def wrap_grad_fn(
        self, grad_fn: Callable[..., Tuple[Any, Any]]
    ) -> Callable[..., Tuple[Any, Any]]:
        """Wraps a function returning ``(value, grads)`` so the grads it
        returns are already averaged across replica groups (blocking)."""

        def wrapped(*args: Any, **kwargs: Any) -> Tuple[Any, Any]:
            value, grads = grad_fn(*args, **kwargs)
            return value, self.allreduce_grads(grads).wait()

        return wrapped


class PipelinedDDP:
    """Per-step DDP with the cross-group ring overlapped with compute.

    Step ``i``'s ring pass runs while the card computes step ``i+1``'s
    forward/backward (a one-step-stale schedule, pipelined SGD with delay
    1). Every step still runs the full transaction — quorum, managed
    allreduce, AND-vote commit — one iteration behind the compute. When a
    heal lands at the commit safe point, the already-computed gradients
    came from pre-heal weights, so they are recomputed from the recovered
    state before being contributed.

    ``compress``: ``None`` ships native dtypes, ``"bf16"`` casts f32
    gradients to bfloat16 for the wire (ring hops accumulate in f32),
    ``"q8"`` quantizes each leaf to int8 with error feedback (the
    quantization error carries into the next step; rolled back on a
    discarded step, dropped on a heal), ``"int8"`` (legacy transport
    only) ships the int8 codes and per-leaf scales themselves through a
    managed allgather and dequantize-averages them on settle (the card
    link carries int8; traffic grows with the cohort).

    ``transport="plan"`` (the default here; the JAX package defaults to
    ``"legacy"``) rides ``Manager.plan_allreduce``, the persistent native
    comm plan: the wire encoding happens at pack (``"q8"`` is plan wire
    ``q8ef``), on the card by the port's kernels. For CPU gradients
    ``device_pack`` picks the kernels' plain versions (``True``) or the
    native host pack (``False``); both are bit-identical. ``hier=True``
    runs the plan over the two-tier schedule (the quorum must carry a
    usable region or host map, else every sync latches an error).

    ``transport="legacy"`` rides the managed ops: the payload is encoded
    on the leaves' device first (``"bf16"``: one K3 launch per 64 f32
    leaves into one bf16 buffer; ``"q8"``/``"int8"``:
    :func:`.quantize.quantize_with_feedback`, one K1a + K1b launch pair
    and one K2 launch), then ``Manager.allreduce`` (``wire="q8"`` for
    ``"q8"``: int8 on the TCP ring, f32 on the card link) or
    ``Manager.allgather`` (``"int8"``). The EF carry is two flat f32
    buffers on the device: a step reads one and writes the other, and
    the commit flips them, so a discarded step rolls back exactly.

    ``transport="iso"`` encodes the payload as the legacy transport does
    (so ``"q8"`` runs K1a/K1b and K2 through
    :func:`.quantize.quantize_with_feedback`) and averages it through
    ``Manager.iso_allreduce``, the isolated data plane, which serves every
    wire losslessly; it needs ``Manager(iso_collectives=...)`` and has no
    ``"int8"`` form.

    Usage::

        ddp = PipelinedDDP(manager, state, grad_fn, compress="q8")
        for batch in batches:
            loss = ddp.step(batch)
        ddp.flush()      # settle the final in-flight step
    """

    def __init__(
        self,
        manager: Manager,
        state: FTTrainState,
        grad_fn: Callable[..., Tuple[Any, Any]],
        compress: Optional[str] = None,
        transport: str = "plan",
        device_pack: Any = True,
        hier: bool = False,
    ) -> None:
        """``device_pack``: True/"on", False/"off", or None/"auto" (the
        ``TORCHFT_DEVICE_PACK`` env, default auto: card leaves pack on
        the card, CPU leaves on the host); parsed here, so a bad value
        raises at once."""
        if compress not in (None, "bf16", "q8", "int8"):
            raise ValueError(f"unsupported compress: {compress!r}")
        if transport not in ("legacy", "plan", "iso"):
            raise ValueError(f"unsupported transport: {transport!r}")
        if transport in ("plan", "iso") and compress == "int8":
            raise ValueError(
                "compress='int8' rides a managed allgather; the plan and "
                "isolated transports have no allgather form (use "
                "compress='q8')")
        if transport == "iso" and not getattr(
                manager, "has_iso_plane", lambda: False)():
            raise ValueError(
                "transport='iso' needs Manager(iso_collectives=...)")
        if hier and transport != "plan":
            raise ValueError("hier=True rides the plan transport (the "
                             "two-tier schedule is a comm-plan form)")
        self._manager = manager
        self._state = state
        self._grad_fn = grad_fn
        self._compress_mode = compress
        self._transport = transport
        self._device_pack = _resolve_device_pack_setting(device_pack)
        self._hier = hier
        self._inflight: Optional[Work] = None
        # the transport AT dispatch: the settle branches on what the work
        # went through, not on the (switchable) current setting
        self._inflight_transport = transport
        self._inflight_dtypes: List[torch.dtype] = []
        # Outcome of the most recent settle (None before the first).
        self.last_commit: Optional[bool] = None
        self._combine = make_dequant_average()
        # q8/int8 on the legacy transport: the EF carry, two flat f32
        # buffers; _carry is the committed one, _next the one the
        # in-flight step wrote (None when nothing is pending)
        self._carries: Optional[List[torch.Tensor]] = None
        self._carry = 0
        self._next: Optional[int] = None

    # -- legacy transport: the wire payload --

    def _carry_views(self, grads: Any) -> Tuple[Any, torch.Tensor]:
        """(the committed carry as a tree of views, the buffer the step's
        new carry goes to). A new signature (or a dropped carry) starts
        from zeros."""
        leaves, treedef = flatten(grads)
        n = sum(l.numel() for l in leaves)
        dev = leaves[0].device
        if (self._carries is None or self._carries[0].numel() != n
                or self._carries[0].device != dev):
            self._carries = [torch.zeros(n, dtype=torch.float32, device=dev),
                             torch.empty(n, dtype=torch.float32, device=dev)]
            self._carry = 0
        self._next = 1 - self._carry
        cur = self._carries[self._carry]
        return (unflatten(treedef, _views(cur, [l.shape for l in leaves])),
                self._carries[self._next])

    def _compress(self, grads: Any) -> Any:
        leaves, treedef = flatten(grads)
        self._inflight_dtypes = [l.dtype for l in leaves]
        mode = self._compress_mode
        if mode is None or not leaves:
            return grads
        if mode in ("q8", "int8"):
            residual, res_out = self._carry_views(grads)
            out = quantize_with_feedback(grads, residual, res_out=res_out)
            if mode == "int8":
                return {"q": out["q"], "scale": out["scale"]}
            return out["dq"]
        # bf16: the f32 leaves into one bf16 buffer (K3), others as they are
        return cast_bf16_tree(grads)

    def _decompress(self, avg: Any) -> Any:
        if self._compress_mode != "bf16":
            return avg
        leaves, treedef = flatten(avg)
        return unflatten(treedef, [l.to(d) for l, d in
                                   zip(leaves, self._inflight_dtypes)])

    def _dispatch(self, grads: Any) -> Work:
        self._inflight_transport = self._transport
        if self._transport == "plan":
            return self._manager.plan_allreduce(
                grads, wire=_WIRES[self._compress_mode],
                device_pack=self._device_pack, hier=self._hier,
            )
        payload = self._compress(grads)
        if self._transport == "iso":
            # the legacy payload through the isolated plane (lossless on
            # every wire)
            return self._manager.iso_allreduce(
                payload, wire="q8" if self._compress_mode == "q8" else None)
        if self._compress_mode == "int8":
            return self._manager.allgather(payload)
        if self._compress_mode == "q8":
            return self._manager.allreduce(payload, wire="q8")
        return self._manager.allreduce(payload)

    def _settle(self) -> bool:
        """Waits the in-flight ring pass, votes, applies on commit."""
        assert self._inflight is not None
        result = self._inflight.wait()
        self._inflight = None
        committed = self._manager.should_commit()
        self.last_commit = committed
        if self._inflight_transport == "plan":
            if committed:
                # A committed step never sees the None failure default (an
                # error would have failed the vote).
                self._state.apply_gradients(result)
            elif self._compress_mode == "q8":
                # The discarded step advanced the EF carry (the device
                # packer's, or the region leader's on the two-tier
                # schedule); drop it (only the abandoned step's
                # quantization error is lost).
                self._manager.reset_plan_feedback()
            return committed
        if committed:
            if self._compress_mode == "int8":
                # member-wise decode, averaged over PARTICIPANTS (a
                # healing/spare member's entry arrives zeroed)
                avg = self._combine(
                    result, float(max(self._manager.num_participants(), 1)))
            else:
                avg = self._decompress(result)
            self._state.apply_gradients(avg)
        if self._next is not None:
            # commit: the step's new carry becomes the carry; discard: the
            # pre-dispatch carry stays (its quantization error belongs to
            # an abandoned payload)
            if committed:
                self._carry = self._next
            self._next = None
        return committed

    def blocking_step(self, *batch: Any) -> Any:
        """One unpipelined step: quorum, dispatch, settle, the whole
        transaction in the step. Settles any step ``step`` left in flight
        first, so the two schedules can be mixed."""
        if self._inflight is not None:
            self._settle()
        self._manager.start_quorum()
        loss, grads = self._grad_fn(self._state.params, *batch)
        self._inflight = self._dispatch(grads)
        self._settle()
        return loss

    def step(self, *batch: Any) -> Any:
        """One pipelined step: computes this batch's gradients, settles
        the PREVIOUS step's transaction, then contributes these gradients
        to a newly started quorum. Returns the loss (a device tensor; do
        not block on it in the hot loop)."""
        loss, grads = self._grad_fn(self._state.params, *batch)
        if self._inflight is not None:
            healed = self._manager.is_healing()
            self._settle()
            if healed:
                # The gradients came from pre-heal weights: recompute from
                # the recovered state; the EF carry belongs to the
                # abandoned trajectory.
                loss, grads = self._grad_fn(self._state.params, *batch)
                self._carries = None
                if self._transport == "plan":
                    self._manager.reset_plan_feedback()
        self._manager.start_quorum()
        self._inflight = self._dispatch(grads)
        return loss

    def flush(self) -> bool:
        """Settles the final in-flight step; returns whether it committed."""
        if self._inflight is None:
            return False
        return self._settle()


class ShardedDDP:
    """Per-step ZeRO across replica groups: each step reduce-scatters the
    gradients, runs the optimizer on this group's ~1/W shard of the
    flat-packed parameters, and allgathers the updated parameters back,
    so optimizer state and update work scale with the shard.

    The data plane is the sharded comm plan
    (``Manager.plan_reduce_scatter`` / ``plan_allgather_into``), one
    native call per leg. On the f32 wire the step is bit-identical to the
    fused plan-f32 step (same partition, same ring sums, same f32 divide,
    an elementwise optimizer). ``shard_wire="q8"`` quantizes the grad
    leg's ring hops while the owned shard stays full f32;
    ``param_wire="bf16"`` (the default when ``shard_wire="q8"``) halves
    the param leg, every member adopting the identical decoded words, so
    params stay bit-identical across the cohort on every wire.

    Fault tolerance: the optimizer shard is keyed by ``quorum_id``; a
    membership change re-partitions it through a cohort mask-allgather
    (first owner wins; positions a departed member took with it restart
    at zero), and a heal voids the meta (``load_state_dict`` sets
    ``quorum_id=-1``) so the healed member re-shards the donor's shard
    at its next step. Any leg's failure latches, the vote fails, and
    params and the optimizer shard keep their pre-step values.

    Requires f32 master params. Build the state with ``opt_state=()`` so
    no full-size optimizer state is ever allocated, and wire the
    manager's state callbacks to :meth:`state_dict` /
    :meth:`load_state_dict` so a heal carries the shard::

        state = FTTrainState(model.params(), AdamW(1e-3), opt_state=())
        ddp = ShardedDDP(manager, state, grad_fn, shard_wire="q8")
        for batch in batches:
            loss = ddp.step(batch)
    """

    def __init__(
        self,
        manager: Manager,
        state: FTTrainState,
        grad_fn: Optional[Callable[..., Tuple[Any, Any]]],
        shard_wire: Optional[str] = None,
        param_wire: Optional[str] = "auto",
    ) -> None:
        """``grad_fn(params, *batch) -> (loss, grads)`` (None when only
        :meth:`apply_gradients` is used, as ``ShardedOptimizerWrapper``
        does). ``param_wire="auto"``: bf16 when ``shard_wire="q8"``, f32
        otherwise (pass ``None`` to force the f32 param leg)."""
        if shard_wire not in (None, "bf16", "q8"):
            raise ValueError(f"unsupported shard_wire: {shard_wire!r}")
        if param_wire == "auto":
            param_wire = "bf16" if shard_wire == "q8" else None
        if param_wire not in (None, "bf16"):
            raise ValueError(f"unsupported param_wire: {param_wire!r}")
        bad = {str(l.dtype) for l in flatten(state.params)[0]
               if l.dtype != torch.float32}
        if bad:
            raise ValueError(
                f"ShardedDDP requires f32 master params (found "
                f"{sorted(bad)}); keep masters in f32 and use "
                "shard_wire/param_wire for wire compression")
        self._manager = manager
        self._state = state
        self._grad_fn = grad_fn
        self._shard_wire = shard_wire
        self._param_wire = param_wire
        # built at the first committed step over the shard this replica
        # owns under the quorum's partition
        self._opt_shard: Any = None
        self._shard_meta: Optional[Dict[str, Any]] = None
        # per partition: the (leaf, start, end) pieces of the owned ranges
        self._slice_segs: Dict[Any, List[Tuple[int, int, int]]] = {}
        self._apply = build_shard_apply_step(state.tx)
        self.last_commit: Optional[bool] = None

    # -- train-loop surface (every step blocks) --

    def step(self, *batch: Any) -> Any:
        """One full sharded step: quorum, grads, rs -> shard update ->
        ag, vote. Returns the loss."""
        assert self._grad_fn is not None, "construct with a grad_fn"
        self._manager.start_quorum()
        loss, grads = self._grad_fn(self._state.params, *batch)
        self.apply_gradients(grads)
        return loss

    def blocking_step(self, *batch: Any) -> Any:
        """Alias of :meth:`step` (every ShardedDDP step is blocking)."""
        return self.step(*batch)

    def flush(self) -> bool:
        """Nothing is left in flight; returns the last step's outcome."""
        return bool(self.last_commit)

    def apply_gradients(self, grads: Any) -> bool:
        """The sharded transaction for already-computed ``grads``:
        reduce-scatter, shard-local optimizer update, param allgather,
        commit vote. Applies iff committed; returns whether it did. The
        quorum must already be started."""
        shard = self._manager.plan_reduce_scatter(
            grads, op=ReduceOp.AVG, wire=self._shard_wire,
            ag_wire=self._param_wire,
        ).wait()
        gathered = new_opt = new_meta = None
        resharded = False
        if shard is not None:
            try:
                qid = self._manager.quorum_id()
                opt_shard, resharded = self._opt_state_for(shard, qid)
                new_p, new_opt = self._apply(
                    self._slice_params(shard), opt_shard,
                    shard.values["float32"])
                gathered = self._manager.plan_allgather_into(
                    shard.replace_values({"float32": new_p}),
                    wire=self._param_wire,
                ).wait()
                new_meta = {
                    "quorum_id": qid,
                    "counts": dict(shard.counts),
                    "ranges": {k: [tuple(r) for r in v]
                               for k, v in shard.ranges.items()},
                }
            except Exception as e:  # noqa: BLE001 - latch, vote, roll back
                logger.exception("sharded step failed: %s", e)
                self._manager.report_error(e)
                gathered = None
        committed = self._manager.should_commit() and gathered is not None
        self.last_commit = committed
        if committed:
            with torch.no_grad():
                torch._foreach_copy_(flatten(self._state.params)[0],
                                     flatten(gathered)[0])
            self._opt_shard = new_opt
            self._shard_meta = new_meta
            if resharded:
                # a new partition: publish the shard's resident bytes
                self._manager.report_opt_state_bytes(self.opt_state_bytes())
        # discarded: params and the optimizer shard keep their pre-step
        # values (the update wrote fresh buffers)
        return committed

    # -- sharded optimizer state --

    def opt_state_bytes(self) -> int:
        """Resident bytes of this replica's optimizer-state shard (0
        before the first committed step); ~1/W of the full state."""
        return sum(l.numel() * l.element_size()
                   for l in flatten(self._opt_shard)[0]
                   if isinstance(l, torch.Tensor))

    def begin_fresh_shard(self) -> None:
        """Drops the shard and its meta, so the next step initializes the
        optimizer afresh over the live params on every member."""
        self._opt_shard = None
        self._shard_meta = None

    def _opt_state_for(self, shard: Any, qid: int) -> Tuple[Any, bool]:
        """The optimizer state matching ``shard``'s partition, and whether
        it was (re)built: reused while the quorum (and so the partition)
        holds, initialized at the first step, re-partitioned through a
        cohort mask-allgather after a membership change."""
        meta = self._shard_meta
        if (self._opt_shard is not None and meta is not None
                and meta["quorum_id"] == qid
                and meta["counts"] == shard.counts
                and _ranges(shard.ranges) == _ranges(meta["ranges"])):
            return self._opt_shard, False
        if self._opt_shard is None:
            return self._state.tx.init(self._slice_params(shard)), True
        return self._reshard_opt_state(shard), True

    def _slice_params(self, shard: Any) -> torch.Tensor:
        """This rank's owned flat slice of the master params, a fresh
        tensor on their device. Leaf order is the flatten order the plan
        packed the gradients in, so the slice aligns with the grad shard
        element for element; which pieces of which leaves make it is
        worked out once per partition."""
        leaves = flatten(self._state.params)[0]
        rng = tuple(tuple(r) for r in shard.ranges["float32"])
        segs = self._slice_segs.get(rng)
        if segs is None:
            segs = self._slice_segs[rng] = _range_segments(
                [(i, l.numel()) for i, l in enumerate(leaves)], rng)
        with torch.no_grad():
            pieces = [leaves[i].detach().reshape(-1)[a:b] for i, a, b in segs]
            if not pieces:
                return torch.zeros(0, dtype=torch.float32,
                                   device=leaves[0].device)
            return torch.cat(pieces)

    def _reshard_opt_state(self, shard: Any) -> Any:
        """Re-partitions the optimizer shard after a membership change
        (:func:`_reshard_shard_state`)."""
        meta = self._shard_meta
        assert meta is not None
        return _reshard_shard_state(
            self._manager, self._opt_shard, meta["ranges"]["float32"],
            shard.ranges["float32"], shard.counts["float32"],
            shard.values["float32"].device)

    # -- checkpoint plumbing (the manager's state callbacks) --

    def state_dict(self) -> Dict[str, Any]:
        return {
            "state": self._state.state_dict(),
            "opt_shard": self._opt_shard,
            "shard_meta": self._shard_meta,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._state.load_state_dict(sd["state"])
        dev = flatten(self._state.params)[0][0].device
        self._opt_shard = None if sd["opt_shard"] is None else tree_map(
            lambda l: _as_tensor(l, dev), sd["opt_shard"])
        # The restored shard is the donor's: keep its meta so the next
        # re-shard scatters it at the right positions, and force that
        # re-partition by voiding the quorum id (this replica's join
        # moved it anyway).
        meta = sd.get("shard_meta")
        if meta is not None:
            meta = {"quorum_id": -1,
                    "counts": {k: int(v) for k, v in meta["counts"].items()},
                    "ranges": _ranges(meta["ranges"])}
        self._shard_meta = meta


class AdaptiveDDP:
    """Per-step DDP that PICKS its schedule per cohort: a runtime probe
    times a few steps of each candidate, then locks in the cohort-agreed
    fastest. Candidates, in probe order:

    - ``blocking``: settle every step, legacy transport;
    - ``plan``: settle every step, the comm plan (host pack while
      ``plan_devpack`` races it);
    - ``plan_devpack``: the plan with the card's wire pack (under
      ``TORCHFT_DEVICE_PACK=auto`` with the kernels importable);
    - ``plan_hier``: the plan over the two-tier schedule (when this
      member carries a region label or the operator set
      ``TORCHFT_HOST``; on a cohort that is not hier-capable every probe
      step latches and records the failure sentinel);
    - ``pipelined``: the one-step-stale overlap, legacy transport;
    - ``ddp_sharded``: per-step ZeRO (``TORCHFT_DDP_SHARDED=1``, f32
      masters, not ``int8``);
    - ``xla_iso``: settle every step through the isolated data plane
      (when the manager carries one, not ``int8``). Membership follows
      the manager's construction, never the child's health: a child that
      cannot spawn records the failure sentinel and never wins.

    ``blocking`` comes first and ties resolve to it, so the locked mode
    is never slower than blocking as measured on this cohort.

    Cohort agreement: after the probe every member allgathers its
    per-candidate seconds (a float64 vector, the JAX package's layout)
    and takes the argmin of the cohort sums: one decision from identical
    data, no leader. ``decision`` records it, and the manager's metrics
    get ``ddp_probe_<mode>`` and ``ddp_mode_<mode>``.

    Lockstep: the probe clock counts ATTEMPTED steps since the step
    where this member first observed the current ``quorum_id``, which
    every member observes at the same transaction. A probe step whose
    transaction failed records ``1e9`` s instead of its wall time, so a
    candidate that cannot run here never wins. A clean membership change
    re-probes; a quorum-id bump on an errored step (the forced
    reconfigure) does not. A run of consecutive errored steps locks
    ``blocking`` (the error backstop). ``reprobe_steps`` (env
    ``TORCHFT_DDP_REPROBE_STEPS``, 0 = never) revalidates the lock every
    N steps. Crossing the ``ddp_sharded`` tenure resets the optimizer
    state deterministically on every member.

    ``TORCHFT_DDP_MODE`` pins the mode and skips probing (``auto`` by
    default). All members must use the same settings.

    Usage (PipelinedDDP's surface)::

        ddp = AdaptiveDDP(manager, state, grad_fn, compress="q8")
        for batch in batches:
            loss = ddp.step(batch)
        ddp.flush()
    """

    _CANDIDATES = ("blocking", "plan", "pipelined")

    # Recorded for a probe step whose transaction failed: a failing
    # candidate never wins, and it stays finite (a zeroed entry of a
    # non-participant is 0, never inf * 0).
    _PROBE_FAILED_S = 1e9

    def __init__(
        self,
        manager: Manager,
        state: FTTrainState,
        grad_fn: Callable[..., Tuple[Any, Any]],
        compress: Optional[str] = None,
        mode: Optional[str] = None,
        probe_steps: int = 3,
        device_pack: Any = None,
        reprobe_steps: Optional[int] = None,
    ) -> None:
        mode = mode or os.environ.get("TORCHFT_DDP_MODE", "auto")
        if mode not in ("auto", "blocking", "pipelined", "plan",
                        "plan_hier", "xla_iso", "ddp_sharded"):
            raise ValueError(f"unsupported TORCHFT_DDP_MODE: {mode!r}")
        self._manager = manager
        # one engine; mode switches flip its transport and schedule
        self._ddp = PipelinedDDP(manager, state, grad_fn, compress,
                                 transport="legacy")
        self._devpack_setting = _resolve_device_pack_setting(device_pack)
        self._candidates = [c for c in self._CANDIDATES
                            if not (c == "plan" and compress == "int8")]
        f32_masters = all(l.dtype == torch.float32
                          for l in flatten(state.params)[0])
        if mode == "ddp_sharded":
            if compress == "int8":
                raise ValueError("compress='int8' has no sharded transport")
            if not f32_masters:
                raise ValueError(
                    "TORCHFT_DDP_MODE=ddp_sharded requires f32 master "
                    "params (the flat shard layout is one f32 group)")
        if (os.environ.get("TORCHFT_DDP_SHARDED", "")
                not in ("", "0", "false", "off")
                and compress != "int8" and f32_masters):
            self._candidates.append("ddp_sharded")
        # topology opt-in: a region label, or an explicit TORCHFT_HOST
        # (the hostname default is not enough)
        region_labeled = bool(getattr(manager, "_region", "")
                              or os.environ.get("TORCHFT_REGION", ""))
        host_labeled = bool(os.environ.get("TORCHFT_HOST", ""))
        if "plan" in self._candidates and (region_labeled or host_labeled):
            self._candidates.insert(self._candidates.index("plan") + 1,
                                    "plan_hier")
        if (self._devpack_setting is None  # TORCHFT_DEVICE_PACK=auto
                and "plan" in self._candidates
                and _device_pack_available()):
            self._candidates.insert(self._candidates.index("plan") + 1,
                                    "plan_devpack")
        has_iso = getattr(manager, "has_iso_plane", lambda: False)()
        if has_iso and compress != "int8":
            self._candidates.append("xla_iso")
        if mode in ("plan", "plan_hier") and compress == "int8":
            raise ValueError("compress='int8' has no plan transport")
        if mode == "xla_iso":
            if compress == "int8":
                raise ValueError("compress='int8' has no iso transport")
            if not has_iso:
                raise ValueError(
                    "TORCHFT_DDP_MODE=xla_iso needs "
                    "Manager(iso_collectives=...)")
        self._probe_steps = max(int(probe_steps), 2)
        self._sharded_engine: Optional[ShardedDDP] = None
        # the mode the previous step ran (the ddp_sharded tenure resets)
        self._prev_run_mode: Optional[str] = None
        self._mode: Optional[str] = mode if mode != "auto" else None
        self._auto = mode == "auto"
        # probe clock: attempted steps since the anchor transaction
        self._probe_qid: Optional[int] = None
        self._probe_idx = 0
        self._probe_t: List[List[float]] = [[] for _ in self._candidates]
        self._decision_qid: Optional[int] = None
        self.decision: Optional[dict] = None
        self._consec_errors = 0
        self._error_backstop = max(6, 3 * self._probe_steps)
        # only a clean step FOLLOWING a clean step reads a new quorum id
        # as a membership change (an error's reconfigure echoes once)
        self._last_errored = False
        if reprobe_steps is None:
            reprobe_steps = int(os.environ.get("TORCHFT_DDP_REPROBE_STEPS",
                                               "0"))
        self._reprobe_steps = max(int(reprobe_steps), 0)
        self._steps_since_lock = 0

    @property
    def mode(self) -> Optional[str]:
        """The locked mode, or None while probing."""
        return self._mode

    def _plan_device_pack(self) -> Optional[bool]:
        """The ``plan`` candidate's pack: the host pack while
        ``plan_devpack`` races it, else the caller's setting."""
        if "plan_devpack" in self._candidates:
            return False
        return self._devpack_setting

    def _sharded(self) -> ShardedDDP:
        if self._sharded_engine is None:
            d = self._ddp
            self._sharded_engine = ShardedDDP(
                self._manager, d._state, d._grad_fn,
                shard_wire=d._compress_mode)
        return self._sharded_engine

    def _run_step(self, mode: str, *batch: Any) -> Any:
        d = self._ddp
        if mode != self._prev_run_mode:
            # The two regimes hold optimizer state in different shapes:
            # entering ddp_sharded drops the stale shard, leaving it
            # re-inits the full state. Both are deterministic from the
            # cohort-identical params, so members stay identical.
            if mode == "ddp_sharded":
                self._sharded().begin_fresh_shard()
            elif self._prev_run_mode == "ddp_sharded":
                st = d._state
                st.opt_state = st.tx.init(st.params)
        self._prev_run_mode = mode
        if mode == "ddp_sharded":
            if d._inflight is not None:
                d.flush()  # settle a pipelined step before sharding
            s = self._sharded()
            loss = s.step(*batch)
            d.last_commit = s.last_commit  # the probe's error signal
            return loss
        if mode == "pipelined":
            d._transport = "legacy"
            if d._inflight is None:
                # a fresh pipeline only dispatches: no outcome yet
                d.last_commit = None
            return d.step(*batch)
        if mode in ("plan", "plan_devpack", "plan_hier"):
            d._transport = "plan"
        elif mode == "xla_iso":
            d._transport = "iso"
        else:
            d._transport = "legacy"
        # the two-tier schedule is plan_hier's alone (host pack only)
        d._hier = mode == "plan_hier"
        if mode == "plan_devpack":
            d._device_pack = True
        elif mode == "plan":
            d._device_pack = self._plan_device_pack()
        elif mode == "plan_hier":
            d._device_pack = False
        return d.blocking_step(*batch)

    def _decide(self) -> None:
        # Median per candidate over its CLEAN samples: one transient
        # cohort error must not knock a working candidate (blocking
        # above all) out. Only a candidate without a clean sample
        # carries the failure sentinel.
        def candidate_s(samples: List[float]) -> float:
            clean = [t for t in samples if t < self._PROBE_FAILED_S]
            return float(np.median(clean)) if clean else self._PROBE_FAILED_S

        mine = np.array([candidate_s(t) for t in self._probe_t], np.float64)
        gathered = self._manager.allgather(
            {"probe_t": torch.from_numpy(mine)}).wait()
        vecs = [np.asarray(_host(e["probe_t"]), np.float64) for e in gathered]
        if self._manager.errored() is not None or any(
                v.shape != mine.shape for v in vecs):
            # the gather failed, or the cohort's candidate lists differ:
            # no agreed argmin exists; lock the safe default
            total = mine
            best = 0
        else:
            total = np.zeros_like(mine)
            for v in vecs:
                total = total + v
            total = np.where(np.isfinite(total), total, self._PROBE_FAILED_S)
            best = int(np.argmin(total))  # ties: the lowest index, blocking
        self._mode = self._candidates[best]
        self._decision_qid = self._probe_qid
        self._steps_since_lock = 0
        self.decision = {
            "mode": self._mode,
            "probe_s": {c: round(float(total[i]), 6)
                        for i, c in enumerate(self._candidates)},
            "quorum_id": self._decision_qid,
        }
        metrics = self._manager.metrics()
        for i, c in enumerate(self._candidates):
            metrics.record(f"ddp_probe_{c}", float(total[i]))
        metrics.incr(f"ddp_mode_{self._mode}")

    def _restart_probe(self, qid: Optional[int]) -> None:
        """Re-anchors the probe clock at the current transaction."""
        if self._ddp._inflight is not None:
            self._ddp.flush()
        self._mode = None
        self._probe_qid = qid
        self._probe_idx = 0
        self._probe_t = [[] for _ in self._candidates]

    def _observed_qid(self) -> Optional[int]:
        try:
            return self._manager.quorum_id()
        except Exception:  # noqa: BLE001 - quorum failed; next step retries
            return self._probe_qid

    def _note_errored(self, errored: bool) -> bool:
        """Tracks the consecutive-error run; True when the backstop just
        tripped (blocking is locked)."""
        if not errored:
            self._consec_errors = 0
            return False
        self._consec_errors += 1
        if self._consec_errors < self._error_backstop:
            return False
        if self._ddp._inflight is not None:
            self._ddp.flush()
        self._mode = "blocking"
        self._decision_qid = self._observed_qid()
        self.decision = {
            "mode": "blocking",
            "fallback": f"{self._consec_errors} consecutive errored "
                        "steps — locked the safe default",
            "quorum_id": self._decision_qid,
        }
        self._manager.metrics().incr("ddp_mode_blocking_backstop")
        self._consec_errors = 0
        self._steps_since_lock = 0
        return True

    def step(self, *batch: Any) -> Any:
        if self._mode is not None:
            loss = self._run_step(self._mode, *batch)
            if self._auto:
                errored = self._errored_now()
                clean = not errored and not self._last_errored
                self._last_errored = errored
                if self._note_errored(errored):
                    return loss
                qid = self._observed_qid()
                if qid != self._decision_qid:
                    if clean:
                        # membership moved: every member re-probes here
                        self._restart_probe(qid)
                        return loss
                    # (possibly) an errored step's reconfigure echo
                    self._decision_qid = qid
                self._steps_since_lock += 1
                if (self._reprobe_steps > 0
                        and self._steps_since_lock >= self._reprobe_steps
                        and clean):
                    self._manager.metrics().incr("ddp_reprobe")
                    self._restart_probe(qid)
            return loss

        # Probe: candidate = attempted steps since the anchor / probe_steps
        idx = self._probe_idx
        cand = min(idx // self._probe_steps, len(self._candidates) - 1)
        t0 = time.perf_counter()
        loss = self._run_step(self._candidates[cand], *batch)
        self._sync_card()
        elapsed = time.perf_counter() - t0
        errored = self._errored_now()
        clean = not errored and not self._last_errored
        self._last_errored = errored
        if self._note_errored(errored):
            return loss
        qid = self._observed_qid()
        if qid != self._probe_qid:
            if clean:
                # a fresh cohort (or a membership change mid-probe):
                # anchor here, time nothing from the transition step
                self._restart_probe(qid)
                return loss
            self._probe_qid = qid  # an error's reconfigure: keep the clock
        if idx % self._probe_steps != 0 or errored:
            # a candidate's first step is its warm-up (plan build,
            # staging, pipeline fill), never timed
            self._probe_t[cand].append(
                self._PROBE_FAILED_S if errored else elapsed)
        self._probe_idx += 1
        if self._probe_idx >= len(self._candidates) * self._probe_steps:
            if self._ddp._inflight is not None:
                self._ddp.flush()  # a pipelined probe leaves one in flight
            self._decide()
        return loss

    def _sync_card(self) -> None:
        """Waits for the step's card work on the caller's stream, so a
        probe sample is the step's wall time, not its dispatch."""
        leaf = flatten(self._ddp._state.params)[0][0]
        if leaf.is_cuda:
            torch.cuda.current_stream(leaf.device).synchronize()

    def _errored_now(self) -> bool:
        """Whether the step that just ran failed its transaction: the
        settle outcome PipelinedDDP records (a pipelined step ends with
        start_quorum, which clears the manager's latched error)."""
        return self._ddp.last_commit is False

    def flush(self) -> bool:
        """Settles any in-flight overlap step; call once after the loop."""
        return self._ddp.flush()


def _host(x: Any) -> Any:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _range_segments(sizes: List[Tuple[int, int]],
                    ranges: Any) -> List[Tuple[int, int, int]]:
    """The ``(leaf, start, end)`` pieces of the leaves that the element
    ``ranges`` of a flat group cover, in range order. ``sizes``: each
    leaf's index and element count, in the group's packing order."""
    bounds, off = [], 0
    for i, n in sizes:
        bounds.append((i, off, off + n))
        off += n
    segs = []
    for s, n in ranges:
        for i, a, b in bounds:
            if b <= s or a >= s + n:
                continue
            segs.append((i, max(s, a) - a, min(s + n, b) - a))
    return segs


def _reshard_shard_state(manager: Manager, state: Any, old_ranges: Any,
                         new_ranges: Any, count: int,
                         device: torch.device) -> Any:
    """Re-partitions sharded state (``ShardedDDP``'s optimizer shard,
    sharded ``DiLoCo``'s outer state) after a membership change: every
    member scatters its OLD shard of each shard-shaped state leaf (1-D,
    the old shard's length) into a full-size (mask, values) pair, the
    cohort allgathers them, and this member slices its NEW ranges out of
    the first-owner-wins merge. Positions no surviving member owned
    restart at zero. The payload is one byte buffer laid out as the JAX
    package's ``{"m": mask, "v": [values...]}`` gather ships (the mask,
    then each leaf's f32 values), so members of both packages share the
    reshard."""
    old_ranges = [tuple(r) for r in old_ranges]
    old_len = sum(n for _, n in old_ranges)
    state_leaves, state_def = flatten(state)
    shard_like = [i for i, l in enumerate(state_leaves)
                  if isinstance(l, torch.Tensor) and l.dim() == 1
                  and l.numel() == old_len]
    mask = torch.zeros(count, dtype=torch.uint8, device=device)
    for s, n in old_ranges:
        mask[s:s + n] = 1
    parts = [mask]
    for i in shard_like:
        arr = state_leaves[i].to(device, torch.float32)
        full = torch.zeros(count, dtype=torch.float32, device=device)
        off = 0
        for s, n in old_ranges:
            full[s:s + n] = arr[off:off + n]
            off += n
        parts.append(full.view(torch.uint8))
    members = manager.allgather({"m": torch.cat(parts)}).wait()
    new_leaves = list(state_leaves)
    for j, i in enumerate(shard_like):
        acc = torch.zeros(count, dtype=torch.float32, device=device)
        seen = torch.zeros(count, dtype=torch.bool, device=device)
        for m in members:
            blob = m["m"].to(device)
            mm = blob[:count].bool()
            lo = count + 4 * count * j
            # a copy: the slice may sit off the f32 alignment
            vals = blob[lo:lo + 4 * count].clone().view(torch.float32)
            take = mm & ~seen
            acc = torch.where(take, vals, acc)
            seen |= take
        new_leaves[i] = torch.cat([acc[s:s + n] for s, n in new_ranges])
    return unflatten(state_def, new_leaves)


def _ranges(ranges: Dict[str, Any]) -> Dict[str, List[Tuple[int, int]]]:
    return {k: [(int(s), int(n)) for s, n in v] for k, v in ranges.items()}


def _as_tensor(leaf: Any, device: torch.device) -> Any:
    """A healed optimizer-shard leaf as a tensor on ``device`` (the heal's
    pickled paths deliver numpy); non-array leaves (the step count) stay
    as they are."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.array(leaf)).to(device)
    return leaf
