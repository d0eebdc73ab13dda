"""Optimizer wrappers binding updates to the commit protocol.

``zero_grad()`` starts the quorum; ``step()`` applies the update only if
the distributed commit vote passes. ``should_commit`` applies a pending
heal into the state first, so the update starts from healed weights.
:class:`ShardedOptimizerWrapper` runs the same loop over per-step ZeRO.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .manager import Manager
from .train_state import FTTrainState


class OptimizerWrapper:
    """Quorum + commit gating around an :class:`FTTrainState`::

        state = FTTrainState(model.params(), AdamW(1e-3, weight_decay=1e-4))
        manager = Manager(..., state_dict=state.state_dict,
                          load_state_dict=state.load_state_dict)
        optimizer = OptimizerWrapper(manager, state)
        for batch in batches:
            optimizer.zero_grad()                    # starts async quorum
            loss, grads = grad_fn(state.params, batch)
            avg = manager.allreduce(grads).wait()    # fault-tolerant average
            optimizer.step(avg)                      # applies iff committed
    """

    def __init__(self, manager: Manager, state: FTTrainState) -> None:
        self.manager = manager
        self.state = state

    def zero_grad(self) -> None:
        """Starts the (async) quorum for this step."""
        self.manager.start_quorum()

    def step(self, grads: Any) -> bool:
        """Votes, then applies ``grads`` iff every rank committed. Returns
        whether the step committed."""
        if not self.manager.should_commit():
            return False
        self.state.apply_gradients(grads)
        return True


class ShardedOptimizerWrapper:
    """The :class:`OptimizerWrapper` loop over per-step ZeRO
    (:class:`~torchft_tpu_torch.ddp.ShardedDDP`): ``zero_grad()`` starts
    the quorum, ``step(grads)`` runs the whole sharded transaction
    (reduce-scatter, ~1/W shard-local optimizer update, param allgather,
    commit vote)::

        state = FTTrainState(model.params(), AdamW(1e-3), opt_state=())
        optimizer = ShardedOptimizerWrapper(manager, state, shard_wire="q8")
        for batch in batches:
            optimizer.zero_grad()                 # starts async quorum
            loss, grads = grad_fn(state.params, batch)
            optimizer.step(grads)                 # rs -> update -> ag

    Pass RAW gradients (the reduce-scatter averages them); there is no
    separate ``manager.allreduce``. Build the state with ``opt_state=()``
    and wire the manager's state callbacks to :meth:`state_dict` /
    :meth:`load_state_dict` so heals carry the optimizer shard."""

    def __init__(
        self,
        manager: Manager,
        state: FTTrainState,
        shard_wire: Optional[str] = None,
        param_wire: Optional[str] = "auto",
    ) -> None:
        from .ddp import ShardedDDP

        self.manager = manager
        self.state = state
        self._core = ShardedDDP(manager, state, grad_fn=None,
                                shard_wire=shard_wire, param_wire=param_wire)

    def zero_grad(self) -> None:
        """Starts the (async) quorum for this step."""
        self.manager.start_quorum()

    def step(self, grads: Any) -> bool:
        """Runs the sharded transaction for ``grads``; applies iff the
        cohort committed. Returns whether it did."""
        return self._core.apply_gradients(grads)

    @property
    def last_commit(self) -> Optional[bool]:
        return self._core.last_commit

    def opt_state_bytes(self) -> int:
        """Resident bytes of this replica's optimizer-state shard."""
        return self._core.opt_state_bytes()

    def state_dict(self) -> Dict[str, Any]:
        return self._core.state_dict()

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._core.load_state_dict(sd)
