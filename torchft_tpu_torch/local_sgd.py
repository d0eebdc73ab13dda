"""Fault-tolerant LocalSGD and DiLoCo: communication-efficient data
parallelism across replica groups.

The port of ``torchft_tpu/local_sgd.py``. Inner steps run purely
locally (no cross-group traffic); every ``sync_every`` steps the groups
synchronize through the manager: a quorum, a fault-tolerant collective
and the commit vote. On a failed commit the whole window is discarded
and the parameters go back to the last synchronized state, so every
committed window is exactly ``sync_every`` steps.

The train loop calls ``local_sgd.step(grads)`` (the inner update, then
the window accounting) or, after a fused train step
(:func:`.models.transformer.make_train_step`), ``step_applied()``. The
backup of the last synchronized parameters is a copy on the parameters'
own device: a card-to-card copy per window instead of two transfers over
the host link. Parameters are updated in place, as everywhere in the
port: a restore copies into the live tensors.

DiLoCo (https://arxiv.org/pdf/2311.08105): at the window boundary the
pseudogradient Δ = θ_global_old − θ_local_new is averaged across groups
and fed to an outer optimizer (``SGD`` with Nesterov momentum, typically)
on the restored global parameters; the sign follows the paper.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import torch

from ._tree import flatten, tree_map, unflatten
from .collectives import ReduceOp
from .ddp import _as_tensor, _range_segments, _ranges, _reshard_shard_state
from .manager import Manager
from .quantize import (cast_bf16_tree, make_dequant_average,
                       quantize_with_feedback)
from .train_state import FTTrainState, _copy_into

logger: logging.Logger = logging.getLogger(__name__)


def _detached_copy(tree: Any) -> Any:
    """A copy of every tensor leaf on its own device."""
    return tree_map(lambda l: l.detach().clone(), tree)


@torch.no_grad()
def _assign(dst: Any, src: Any) -> None:
    """Copies ``src``'s leaves into ``dst``'s tensors, in place."""
    torch._foreach_copy_(flatten(dst)[0], flatten(src)[0])


@torch.no_grad()
def _sub(a: Any, b: Any) -> Any:
    """``a - b`` leaf by leaf, as a tree shaped like ``a``."""
    la, treedef = flatten(a)
    return unflatten(treedef, torch._foreach_sub(la, flatten(b)[0]))


class LocalSGD:
    """Periodic parameter averaging (https://arxiv.org/pdf/1805.09767),
    fault-tolerant.

    Usage::

        local = LocalSGD(manager, state, sync_every=32)
        for batch in data:
            loss, grads = grad_fn(state.params, batch)
            local.step(grads)           # inner update; syncs every 32 steps

    Wire the manager's state callbacks to :meth:`state_dict` /
    :meth:`load_state_dict` (not the bare train state), so a recovering
    replica receives the backup copy and the window bookkeeping too.
    """

    def __init__(self, manager: Manager, state: FTTrainState,
                 sync_every: int) -> None:
        assert sync_every >= 1, "sync_every must be >= 1"
        self._manager = manager
        self._state = state
        self._sync_every = sync_every
        self._local_step = 0
        self._backup_params: Any = _detached_copy(state.params)
        # Outcome of the most recent window sync (None before the first).
        self.last_sync_commit: Optional[bool] = None

    # -- train-loop surface --

    def step(self, grads: Any) -> None:
        """One inner optimizer step; synchronizes on the window boundary."""
        self._state.apply_gradients(grads)
        self.step_applied()

    def step_applied(self) -> None:
        """Window accounting for a caller that applied the inner update
        itself (a fused train step)::

            train_step = make_train_step(cfg, AdamW(1e-3))
            for batch in data:
                _, _, loss = train_step(state.params, state.opt_state, batch)
                local.step_applied()      # syncs every sync_every steps
        """
        self._local_step += 1
        if self._local_step >= self._sync_every:
            self.sync()

    def sync(self) -> None:
        """Synchronizes across replica groups."""
        self._manager.start_quorum()
        self._perform_sync()
        self._local_step = 0

    def begin_fresh_window(self) -> None:
        """Re-anchors the window at the CURRENT params: the backup becomes
        the live params and the inner-step count restarts (a strategy
        switch hands control to this engine mid-run). Outer-optimizer
        state is left alone."""
        self._save_parameters()
        self._local_step = 0
        self.last_sync_commit = None

    # -- checkpoint plumbing (manager state callbacks) --

    def state_dict(self) -> Dict[str, Any]:
        return {
            "state": self._state.state_dict(),
            "backup_params": self._backup_params,
            "local_step": self._local_step,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._state.load_state_dict(sd["state"])
        _copy_into(self._backup_params, sd["backup_params"])
        self._local_step = int(sd["local_step"])

    # -- internals --

    def _save_parameters(self) -> None:
        _assign(self._backup_params, self._state.params)

    def _restore_parameters(self) -> None:
        _assign(self._state.params, self._backup_params)

    def _perform_sync(self) -> None:
        """Average params; commit -> new backup, abort -> roll the whole
        window back."""
        averaged = self._manager.allreduce(
            self._state.params, op=ReduceOp.AVG).wait()
        committed = self._manager.should_commit()
        self.last_sync_commit = committed
        if committed:
            _assign(self._state.params, averaged)
            self._save_parameters()
        else:
            self._restore_parameters()


class DiLoCo(LocalSGD):
    """Distributed Low-Communication training.

    Requires a synchronous quorum (``Manager(use_async_quorum=False)``),
    so a recovering replica restores the checkpoint before its first
    inner step. ``outer_tx`` is an optimizer with the port's idiom
    (``init``, an in-place ``update_``), typically
    ``SGD(0.7, momentum=0.9, nesterov=True)``.

    ``sharded=True`` replaces "full allreduce + W redundant outer
    updates" with the weight-update-sharded schedule: reduce-scatter the
    pseudogradient (``Manager.reduce_scatter``), run the outer optimizer
    on the ~1/W shard this replica owns, then allgather the updated
    parameters (``Manager.allgather_into``). The outer state shrinks ~W
    times. On a membership change (the manager's quorum id moved) the
    sharded outer state is re-partitioned through a cohort allgather;
    slices owned by a departed replica restart at zero. The outer
    optimizer must be elementwise and the masters f32.

    ``shard_wire="q8"`` ships the reduce-scatter over the quantized ring
    with error feedback on the card (``quantize_with_feedback``: K1a,
    K1b, K2); the residual joins the next window's delta, and the owned
    shard lands in full f32. ``param_wire="bf16"`` rounds the parameter
    allgather to bfloat16 (K3 on the card); every member adopts the
    decoded words, so params stay bit-identical across the cohort.

    ``hier=True`` (unsharded only) averages the pseudogradient over the
    two-tier schedule (``Manager.allreduce_hier``), ``hier_wire``
    (None | "bf16" | "q8") compressing the inter-region hop only; on a
    cohort without a usable topology the sync latches an error and the
    window is discarded."""

    def __init__(
        self,
        manager: Manager,
        state: FTTrainState,
        outer_tx: Any,
        sync_every: int,
        sharded: bool = False,
        shard_wire: Optional[str] = None,
        param_wire: Optional[str] = None,
        hier: bool = False,
        hier_wire: Optional[str] = None,
    ) -> None:
        if manager._use_async_quorum:
            raise ValueError(
                "DiLoCo requires synchronous quorum: construct the Manager "
                "with use_async_quorum=False")
        if shard_wire not in (None, "q8"):
            raise ValueError(f"unsupported shard_wire: {shard_wire!r}")
        if param_wire not in (None, "bf16"):
            raise ValueError(f"unsupported param_wire: {param_wire!r}")
        if (shard_wire or param_wire) and not sharded:
            raise ValueError("shard_wire/param_wire require sharded=True")
        if hier_wire not in (None, "bf16", "q8"):
            raise ValueError(f"unsupported hier_wire: {hier_wire!r}")
        if hier_wire is not None and not hier:
            raise ValueError("hier_wire requires hier=True")
        if hier and sharded:
            raise ValueError(
                "hier=True composes with the unsharded outer sync only "
                "(the sharded schedule's shard layout is the FLAT ring's)")
        if sharded:
            bad = {str(l.dtype) for l in flatten(state.params)[0]
                   if l.dtype != torch.float32}
            if bad:
                raise ValueError(
                    "sharded DiLoCo requires f32 master params (found "
                    f"{sorted(bad)}); keep masters in f32 and use "
                    "shard_wire/param_wire for wire compression")
        super().__init__(manager, state, sync_every)
        self._outer_tx = outer_tx
        self._sharded = sharded
        self._hier = hier
        self._hier_wire = hier_wire
        self._shard_wire = shard_wire
        self._param_wire = param_wire
        # sharded: built at the first sync, over the shard this replica
        # owns under the quorum's partition
        self._outer_state: Any = None if sharded else outer_tx.init(
            state.params)
        self._outer_shard_meta: Optional[Dict[str, Any]] = None
        self._shard_residual: Any = None  # q8 wire error-feedback carry
        # per partition: the (leaf, start, end) pieces of the owned ranges
        self._slice_segs: Dict[Any, List[Tuple[int, int, int]]] = {}

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        sd["outer_state"] = self._outer_state
        if self._sharded:
            sd["outer_shard_meta"] = self._outer_shard_meta
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        super().load_state_dict(sd)
        dev = flatten(self._state.params)[0][0].device
        self._outer_state = None if sd["outer_state"] is None else tree_map(
            lambda l: _as_tensor(l, dev), sd["outer_state"])
        if self._sharded:
            # The restored shard is the donor's: keep its meta so the next
            # re-shard scatters it at the right positions, and force that
            # re-partition by voiding the quorum id.
            meta = sd.get("outer_shard_meta")
            if meta is not None:
                meta = {"quorum_id": -1,
                        "counts": {k: int(v)
                                   for k, v in meta["counts"].items()},
                        "ranges": _ranges(meta["ranges"])}
            self._outer_shard_meta = meta
        # The EF carry is trajectory-local: after a heal the replica is
        # on another trajectory's params.
        self._shard_residual = None

    def begin_fresh_window(self) -> None:
        super().begin_fresh_window()
        self._shard_residual = None

    def _perform_sync(self) -> None:
        """Sharded: RS -> outer step on the owned shard -> param
        allgather. Unsharded: average pseudogradients, outer-step from
        the restored global params on commit."""
        if self._sharded:
            self._perform_sync_sharded()
            return
        old_global = self._backup_params
        # Paper sign: Δ = θ_global_old − θ_local_new.
        pseudo_grads = _sub(old_global, self._state.params)
        if self._hier:
            averaged = self._manager.allreduce_hier(
                pseudo_grads, op=ReduceOp.AVG, wire=self._hier_wire).wait()
        else:
            averaged = self._manager.allreduce(
                pseudo_grads, op=ReduceOp.AVG).wait()
        self._restore_parameters()
        committed = self._manager.should_commit()
        self.last_sync_commit = committed
        if committed:
            self._outer_tx.update_(self._state.params, self._outer_state,
                                   averaged)
            self._save_parameters()

    # -- sharded outer sync --

    def _perform_sync_sharded(self) -> None:
        """reduce-scatter(Δ) -> outer step on the owned shard ->
        allgather the updated params. Every leg rides the manager's
        error discipline: any failure latches, the vote fails, and every
        member rolls the window back."""
        old_global = self._backup_params
        new_residual = None
        if self._shard_wire == "q8":
            ship, new_residual = self._quantized_delta(old_global)
        else:
            ship = _sub(old_global, self._state.params)
        rs_work = self._manager.reduce_scatter(
            ship, op=ReduceOp.AVG, wire=self._shard_wire)
        self._restore_parameters()
        shard = rs_work.wait()  # TreeShard | None (the failure default)
        gathered = new_outer = new_meta = None
        if shard is not None:
            try:
                qid = self._manager.quorum_id()
                outer_state = self._outer_state_for(shard, qid, old_global)
                # the update writes fresh buffers: a discarded window keeps
                # the outer state it started from
                new_outer = tree_map(lambda l: l.clone(), outer_state)
                new_vals = self._slice_params(old_global, shard)
                self._outer_tx.update_(new_vals, new_outer, shard.values)
                gathered = self._manager.allgather_into(
                    shard.replace_values(new_vals),
                    wire=self._param_wire).wait()
                new_meta = {
                    "quorum_id": qid,
                    "counts": dict(shard.counts),
                    "ranges": _ranges(shard.ranges),
                }
            except Exception as e:  # noqa: BLE001 - latch, vote, roll back
                logger.exception("sharded outer step failed: %s", e)
                self._manager.report_error(e)
                gathered = None
        committed = self._manager.should_commit() and gathered is not None
        self.last_sync_commit = committed
        if committed:
            _assign(self._state.params, gathered)
            self._outer_state = new_outer
            self._outer_shard_meta = new_meta
            if new_residual is not None:
                self._shard_residual = new_residual
            self._save_parameters()
        # discarded: params are restored; the outer state, its meta and
        # the EF carry keep their pre-window values

    def _quantized_delta(self, old_global: Any) -> Tuple[Any, Any]:
        """Δ = B − θ on the int8 grid with error feedback: the residual of
        the rounding joins the next window's delta (committed only with
        its window). Returns (the decoded delta to ship, the new carry)."""
        if self._shard_residual is None:
            self._shard_residual = tree_map(
                lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                      device=l.device), self._state.params)
        out = quantize_with_feedback(
            _sub(old_global, self._state.params), self._shard_residual)
        return out["dq"], out["res"]

    def _outer_state_for(self, shard: Any, qid: int, old_global: Any) -> Any:
        """The outer state matching ``shard``'s partition: reused while
        the quorum (and so the partition) holds, initialized at the first
        sync, re-partitioned through a cohort allgather after a
        membership change."""
        meta = self._outer_shard_meta
        if (self._outer_state is not None and meta is not None
                and meta["quorum_id"] == qid
                and meta["counts"] == shard.counts
                and _ranges(shard.ranges) == _ranges(meta["ranges"])):
            return self._outer_state
        if self._outer_state is None:
            return self._outer_tx.init(self._slice_params(old_global, shard))
        assert meta is not None
        (name,) = list(shard.counts)  # sharded mode packs ONE f32 group
        return _reshard_shard_state(
            self._manager, self._outer_state, meta["ranges"][name],
            shard.ranges[name], shard.counts[name],
            shard.values[name].device)

    def _slice_params(self, tree: Any, shard: Any) -> Dict[str, torch.Tensor]:
        """This rank's owned ranges of ``tree`` in the shard's flat
        layout, one fresh tensor per group on the leaves' device (the
        full flat buffer is never built). Which pieces of which leaves
        make a range is worked out once per partition."""
        leaves = flatten(tree)[0]
        out: Dict[str, torch.Tensor] = {}
        for name in sorted(shard.counts):
            idxs = shard.groups[name]
            rng = tuple(tuple(r) for r in shard.ranges[name])
            key = (name, tuple(idxs), rng)
            segs = self._slice_segs.get(key)
            if segs is None:
                segs = self._slice_segs[key] = _range_segments(
                    [(i, leaves[i].numel()) for i in idxs], rng)
            dtype = shard.dtypes[name]
            with torch.no_grad():
                pieces = [leaves[i].detach().reshape(-1)[a:b].to(dtype)
                          for i, a, b in segs]
                out[name] = (torch.cat(pieces) if pieces else torch.zeros(
                    0, dtype=dtype, device=leaves[0].device))
        return out


class AsyncDiLoCo(DiLoCo):
    """DiLoCo with the cross-group sync OVERLAPPED with the next window's
    inner steps (the delayed outer update of Streaming DiLoCo,
    https://arxiv.org/pdf/2501.18512): at a window boundary the
    pseudogradient allreduce is launched and training continues at once;
    the outer update lands one window late, reconciled against the inner
    progress made meanwhile.

    Let B be the last global params, θ the live params. At boundary k:
    finish window k-1's sync (below), then compute Δ = B − θ and launch
    its average. When the result lands (at boundary k+1):

      commit -> G' = outer_update(B, Δ_avg);  θ += G' − (B − Δ);  B = G'
      abort  -> θ += Δ   (rolls window k back, keeps window k+1's progress)

    With one group and outer ``SGD(1.0)``, G' = B − Δ and the correction
    vanishes: pure local training. Call :meth:`flush` before reading the
    final params, checkpointing or shutdown.

    The launched op reads the delta (a tensor of its own) after an event
    recorded at dispatch, while the inner steps go on writing the params
    on the caller's stream; the result comes back on that stream.
    """

    def __init__(
        self,
        manager: Manager,
        state: FTTrainState,
        outer_tx: Any,
        sync_every: int,
        compress: Optional[str] = None,
        overlap: bool = True,
    ) -> None:
        """``compress="bf16"`` casts the delta to bfloat16 on the card
        (K3, one launch per 64 leaves into one buffer) before the
        allreduce: half the link and wire bytes; the f32 masters are
        untouched.

        The quantized modes use per-leaf int8 with an f32 scale and
        error feedback (``quantize_with_feedback``: K1a, K1b, K2):
        ``"int8"`` ships the codes and scales through a managed
        allgather and dequantize-averages them member-wise (K2 per
        member), so the card link carries int8 (traffic grows with the
        cohort); ``"q8"`` ships the decoded delta over the ring's
        quantized wire (constant TCP bytes in cohort size; the ring's
        per-chunk regrid adds noise the error feedback does not see).

        ``overlap=False`` completes the sync AT the boundary (exact
        synchronous DiLoCo through the same ops)."""
        if compress not in (None, "bf16", "int8", "q8"):
            raise ValueError(f"unsupported compress mode: {compress}")
        super().__init__(manager, state, outer_tx, sync_every)
        self._compress = compress
        self._overlap = overlap
        # (work, shipped delta, pre-launch residual) of the in-flight window
        self._pending: Any = None
        self._combine = make_dequant_average()
        self._residual: Any = None  # int8/q8: error-feedback carry

    def sync(self) -> None:
        self._finish_pending()
        self._manager.start_quorum()
        self._launch_sync()
        if not self._overlap:
            self._finish_pending()
        self._local_step = 0

    def flush(self) -> None:
        """Completes any in-flight window sync."""
        self._finish_pending()

    def begin_fresh_window(self) -> None:
        # an in-flight sync belongs to the old tenure's trajectory
        self._finish_pending()
        super().begin_fresh_window()
        self._residual = None

    def state_dict(self) -> Dict[str, Any]:
        self._finish_pending()
        return super().state_dict()

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        super().load_state_dict(sd)
        self._residual = None  # trajectory-local, as the shard carry

    def _launch_sync(self) -> None:
        old_global = self._backup_params
        delta = _sub(old_global, self._state.params)
        if self._compress in ("int8", "q8"):
            if self._residual is None:
                self._residual = tree_map(
                    lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                          device=l.device),
                    self._state.params)
            prev_residual = self._residual
            out = quantize_with_feedback(delta, prev_residual)
            self._residual = out["res"]  # restored on abort
            if self._compress == "int8":
                work = self._manager.allgather(
                    {"q": out["q"], "scale": out["scale"]})
            else:
                work = self._manager.allreduce(out["dq"], op=ReduceOp.AVG,
                                               wire="q8")
            # reconcile against what was SHIPPED (the decoded delta)
            self._pending = (work, out["dq"], prev_residual)
            return
        if self._compress == "bf16":
            delta = cast_bf16_tree(delta)
        work = self._manager.allreduce(delta, op=ReduceOp.AVG)
        self._pending = (work, delta, None)

    @torch.no_grad()
    def _finish_pending(self) -> None:
        if self._pending is None:
            return
        work, delta, prev_residual = self._pending
        self._pending = None
        result = work.wait()
        if self._compress == "int8":
            # member-wise decode, averaged over PARTICIPANTS (a healing or
            # spare member's entry arrives zeroed)
            averaged = self._combine(
                result, float(max(self._manager.num_participants(), 1)))
        else:
            averaged = result
        committed = self._manager.should_commit()
        self.last_sync_commit = committed
        theta = flatten(self._state.params)[0]
        glob = flatten(self._backup_params)[0]
        d = [x.to(t.dtype) for x, t in zip(flatten(delta)[0], theta)]
        if committed:
            avg = [a.to(g.dtype) for a, g in zip(flatten(averaged)[0], glob)]
            launch_point = torch._foreach_sub(glob, d)  # L0 = B − Δ
            # B becomes G' in place: the outer update of the backup
            self._outer_tx.update_(glob, self._outer_state, avg)
            # θ += G' − L0: window k's local-only progress is replaced by
            # the agreed version, window k+1's (already in θ) is kept
            torch._foreach_add_(theta, torch._foreach_sub(glob, launch_point))
        else:
            torch._foreach_add_(theta, d)
            if prev_residual is not None:
                self._residual = prev_residual

