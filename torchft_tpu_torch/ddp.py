"""Fault-tolerant data parallelism across replica groups.

The gradient tree of a step (``grad_fn(params, *batch) -> (loss,
grads)``, e.g. ``torch.autograd.grad`` over the parameter tree) is
averaged across replica groups as one unit: the collectives layer packs
the whole tree into one ring pass per group.

Intra-replica-group parallelism stays in user code; these wrappers only
average across groups. ``PipelinedDDP`` runs its sync over the comm plan
(the port's default) or the legacy managed ops; ``hier=True`` runs the
plan over the two-tier schedule (the quorum's region and host maps).
``ShardedDDP`` is per-step ZeRO over the sharded comm plan. The JAX
package's ``AdaptiveDDP`` and isolated transport are not ported.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ._tree import flatten, tree_map, unflatten
from .collectives import ReduceOp, Work
from .manager import Manager
from .ops import quantize_kernels as qk
from .quantize import _views, make_dequant_average, quantize_with_feedback
from .train_state import FTTrainState, build_shard_apply_step

logger: logging.Logger = logging.getLogger(__name__)

# PipelinedDDP compress mode -> comm-plan wire.
_WIRES = {None: None, "bf16": "bf16", "q8": "q8ef"}


class DistributedDataParallel:
    """Averages gradient trees across replica groups, fault-tolerantly::

        ddp = DistributedDataParallel(manager)
        loss, grads = grad_fn(state.params, batch)
        grads = ddp.allreduce_grads(grads).wait()
    """

    def __init__(self, manager: Manager) -> None:
        self._manager = manager

    def allreduce_grads(self, grads: Any) -> Work:
        """Starts the async cross-group average; the Work resolves to the
        averaged tree (the input on error, with the error latched for
        ``should_commit``)."""
        return self._manager.allreduce(grads)


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
        device_pack: bool = True,
        hier: bool = False,
    ) -> None:
        if compress not in (None, "bf16", "q8", "int8"):
            raise ValueError(f"unsupported compress: {compress!r}")
        if transport not in ("legacy", "plan"):
            raise ValueError(
                f"unsupported transport: {transport!r} (the port has the "
                "plan and legacy transports)")
        if transport == "plan" and compress == "int8":
            raise ValueError(
                "compress='int8' rides a managed allgather; the plan "
                "transport has no allgather form (use compress='q8')")
        if hier and transport != "plan":
            raise ValueError("hier=True rides the plan transport (the "
                             "two-tier schedule is a comm-plan form)")
        self._manager = manager
        self._state = state
        self._grad_fn = grad_fn
        self._compress_mode = compress
        self._transport = transport
        self._device_pack = device_pack
        self._hier = hier
        self._inflight: Optional[Work] = None
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
        idx = [i for i, l in enumerate(leaves) if l.dtype == torch.float32]
        if not idx:
            return grads
        buf = torch.empty(sum(leaves[i].numel() for i in idx),
                          dtype=torch.bfloat16, device=leaves[0].device)
        qk.cast_bf16_group([leaves[i] for i in idx], buf)
        out = list(leaves)
        for i, v in zip(idx, _views(buf, [leaves[i].shape for i in idx])):
            out[i] = v
        return unflatten(treedef, out)

    def _decompress(self, avg: Any) -> Any:
        if self._compress_mode != "bf16":
            return avg
        leaves, treedef = flatten(avg)
        return unflatten(treedef, [l.to(d) for l, d in
                                   zip(leaves, self._inflight_dtypes)])

    def _dispatch(self, grads: Any) -> Work:
        if self._transport == "plan":
            return self._manager.plan_allreduce(
                grads, wire=_WIRES[self._compress_mode],
                device_pack=self._device_pack, hier=self._hier,
            )
        payload = self._compress(grads)
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
        if self._transport == "plan":
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
            segs = []
            starts, off = [], 0
            for l in leaves:
                starts.append(off)
                off += l.numel()
            for s, n in rng:
                end = s + n
                for i, (a, l) in enumerate(zip(starts, leaves)):
                    b = a + l.numel()
                    if b <= s or a >= end:
                        continue
                    segs.append((i, max(s, a) - a, min(end, b) - a))
            self._slice_segs[rng] = segs
        with torch.no_grad():
            pieces = [leaves[i].detach().reshape(-1)[a:b] for i, a, b in segs]
            if not pieces:
                return torch.zeros(0, dtype=torch.float32,
                                   device=leaves[0].device)
            return torch.cat(pieces)

    def _reshard_opt_state(self, shard: Any) -> Any:
        """Re-partitions the optimizer shard after a membership change:
        every member scatters its OLD shard of each shard-shaped state
        leaf into a full-size (mask, values) pair, the cohort allgathers
        them, and this member slices its NEW ranges out of the
        first-owner-wins merge. Positions no surviving member owned
        restart at zero. The payload is one byte buffer laid out as the
        JAX package's ``{"m": mask, "v": [values...]}`` gather ships (the
        mask, then each leaf's f32 values), so members of both packages
        share the reshard."""
        meta = self._shard_meta
        assert meta is not None
        count = shard.counts["float32"]
        old_ranges = [tuple(r) for r in meta["ranges"]["float32"]]
        old_len = sum(n for _, n in old_ranges)
        state_leaves, state_def = flatten(self._opt_shard)
        shard_like = [i for i, l in enumerate(state_leaves)
                      if isinstance(l, torch.Tensor) and l.dim() == 1
                      and l.numel() == old_len]
        dev = shard.values["float32"].device
        mask = torch.zeros(count, dtype=torch.uint8, device=dev)
        for s, n in old_ranges:
            mask[s:s + n] = 1
        parts = [mask]
        for i in shard_like:
            arr = state_leaves[i].to(dev, torch.float32)
            full = torch.zeros(count, dtype=torch.float32, device=dev)
            off = 0
            for s, n in old_ranges:
                full[s:s + n] = arr[off:off + n]
                off += n
            parts.append(full.view(torch.uint8))
        members = self._manager.allgather({"m": torch.cat(parts)}).wait()
        new_leaves = list(state_leaves)
        for j, i in enumerate(shard_like):
            acc = torch.zeros(count, dtype=torch.float32, device=dev)
            seen = torch.zeros(count, dtype=torch.bool, device=dev)
            for m in members:
                blob = m["m"].to(dev)
                mm = blob[:count].bool()
                lo = count + 4 * count * j
                # a copy: the slice may sit off the f32 alignment
                vals = blob[lo:lo + 4 * count].clone().view(torch.float32)
                take = mm & ~seen
                acc = torch.where(take, vals, acc)
                seen |= take
            new_leaves[i] = torch.cat(
                [acc[s:s + n] for s, n in shard.ranges["float32"]])
        return unflatten(state_def, new_leaves)

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
