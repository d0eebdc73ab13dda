"""Fault-tolerant data parallelism across replica groups.

The gradient tree of a step (``grad_fn(params, *batch) -> (loss,
grads)``, e.g. ``torch.autograd.grad`` over the parameter tree) is
averaged across replica groups as one unit: the collectives layer packs
the whole tree into one ring pass per plan group.

Intra-replica-group parallelism stays in user code; these wrappers only
average across groups. ``PipelinedDDP(hier=True)`` runs the sync over
the two-tier schedule (the quorum's region and host maps). The JAX
package's ``ShardedDDP``, ``AdaptiveDDP`` and legacy and isolated
transports are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from .collectives import Work
from .manager import Manager
from .train_state import FTTrainState

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

    The gradient sync rides ``Manager.plan_allreduce`` (the persistent
    native comm plan). ``compress``: ``None`` ships native dtypes,
    ``"bf16"`` casts f32 gradients to bfloat16 on the wire (ring hops
    accumulate in f32), ``"q8"`` quantizes each leaf to int8 with error
    feedback (wire ``q8ef``; the quantization error carries into the next
    step, and is dropped on a discarded step or a heal).

    Gradients on the card are wire-encoded there by the port's kernels
    (the q8 carry stays on the card). For CPU gradients ``device_pack``
    picks the kernels' plain versions (``True``) or the native host pack
    (``False``); both are bit-identical, so members need not agree.

    ``hier=True`` (plan transport only) runs the sync over the two-tier
    schedule: co-hosted groups reduce over shared-memory rings, one
    leader per region over the inter-region ring, and the wire applies
    on that inter hop only (``compress="q8"`` is the leader-side q8 + EF
    wire; with one region there is no inter hop and the result is the
    f32 average). The quorum must carry a usable region or host map
    (``TORCHFT_REGION`` / ``TORCHFT_HOST``); otherwise every sync latches
    an error and its step is discarded. ``device_pack`` does not apply
    there (the schedule has no pre-packed form).

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
        if compress not in _WIRES:
            raise ValueError(f"unsupported compress: {compress!r}")
        if transport != "plan":
            raise ValueError(
                f"unsupported transport: {transport!r} (the port has the "
                "plan transport only)"
            )
        self._manager = manager
        self._state = state
        self._grad_fn = grad_fn
        self._compress = compress
        self._device_pack = device_pack
        self._hier = hier
        self._inflight: Optional[Work] = None
        # Outcome of the most recent settle (None before the first).
        self.last_commit: Optional[bool] = None

    def _dispatch(self, grads: Any) -> Work:
        return self._manager.plan_allreduce(
            grads, wire=_WIRES[self._compress], device_pack=self._device_pack,
            hier=self._hier,
        )

    def _settle(self) -> bool:
        """Waits the in-flight ring pass, votes, applies on commit."""
        assert self._inflight is not None
        result = self._inflight.wait()
        self._inflight = None
        committed = self._manager.should_commit()
        self.last_commit = committed
        if committed:
            # A committed step never sees the None failure default (an
            # error would have failed the vote).
            self._state.apply_gradients(result)
        elif self._compress == "q8":
            # The discarded step advanced the EF carry (the device
            # packer's, or the region leader's on the two-tier schedule);
            # drop it (only the abandoned step's quantization error is lost).
            self._manager.reset_plan_feedback()
        return committed

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
                self._manager.reset_plan_feedback()
        self._manager.start_quorum()
        self._inflight = self._dispatch(grads)
        return loss

    def flush(self) -> bool:
        """Settles the final in-flight step; returns whether it committed."""
        if self._inflight is None:
            return False
        return self._settle()
