"""Adaptive fault-tolerance policy engine: runtime strategy selection
one level above the data plane.

The fault-tolerance *strategy*, not only its schedule, is chosen at
runtime from observed conditions: churn rate and effective bandwidth
swing by orders of magnitude over a long run, and no fixed strategy is
right for all of it. The port has every strategy (per-step DDP over the
legacy, plan and isolated transports, per-step ZeRO, LocalSGD, DiLoCo with a
sharded outer sync, q8/bf16 wires) and every signal
(``Manager.signals()``: rolling churn from quorum-id bumps, effective
wire bandwidth from the op stats, heal costs). :class:`PolicyEngine`
closes the loop: it watches the measured signals and switches
**strategy x wire x sync-interval** at window boundaries.

Decision discipline (AdaptiveDDP's lockstep vote, one level up):

- every ``decide_every`` attempted steps, at a window boundary, the
  cohort runs ONE decision transaction: each member allgathers its
  float64 signal vector through the manager (the JAX package's layout,
  so a mixed cohort shares the gather), aggregates deterministically
  (slowest compute, bottleneck bandwidth, worst churn), prices every
  candidate with the same pure cost model, and takes the same argmin
  from identical data, with no leader;
- an errored or structurally unrunnable candidate carries a sentinel and
  can never win; ties, and anything within the hysteresis margin, fall
  to the current strategy;
- the switch is a voted, latched step. The decision rides one managed
  collective: a member failure mid-gather propagates ring-wide, every
  member's vote fails, and the whole cohort aborts the switch together.
  A member that received the gather but failed before acting on it
  discards the step, falls behind, and heals from a switched peer,
  adopting the donor's active strategy through ``state_dict``.

State carry across a switch reuses the engines' own machinery: a
windowed strategy re-anchors its window at the live params
(``begin_fresh_window``), DiLoCo's outer-optimizer state persists across
tenures, the sharded per-step engine re-partitions
(``begin_fresh_shard``), and error-feedback carries are dropped at the
tenure boundary.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._tree import flatten
from .ddp import PipelinedDDP, ShardedDDP
from .local_sgd import AsyncDiLoCo, DiLoCo, LocalSGD
from .manager import Manager
from .train_state import FTTrainState

logger: logging.Logger = logging.getLogger(__name__)

# Cost recorded for a candidate that cannot run (structurally unavailable
# anywhere in the cohort, or marked failed after erroring): large enough to
# never win an argmin, finite so gathered arithmetic stays clean (the
# sentinel discipline of AdaptiveDDP's probe).
SENTINEL_COST_S = 1e9

_WIRE_FACTOR = {None: 1.0, "bf16": 0.5, "q8": 0.25, "int8": 0.25}


def choose_target(costs: List[float], current: int, hysteresis: float) -> int:
    """Deterministic choice from cohort-identical costs: the argmin, but a
    challenger must beat the incumbent by the hysteresis margin — ties and
    near-ties stand still. A sentineled incumbent always loses (it cannot
    be run), unless everything is sentineled, in which case standing still
    is all that's left.

    Pure: every member feeds identical gathered costs through this and
    reaches the identical index.
    """
    best = int(np.argmin(costs))
    if costs[best] >= SENTINEL_COST_S:
        # Everything is sentineled (a cohort-wide misconfiguration):
        # standing still is all that's left.
        return current
    cur = costs[current]
    if cur >= SENTINEL_COST_S:
        return best
    if costs[best] < cur * (1.0 - hysteresis):
        return best
    return current


@dataclass(frozen=True)
class StrategySpec:
    """One candidate point in the strategy × wire × sync-interval space.

    ``kind``: ``"ddp"`` (per-step, blocking transaction), ``"localsgd"``
    (windowed parameter averaging) or ``"diloco"`` (windowed outer
    optimizer on pseudogradients). ``sync_every`` is the outer window in
    inner steps (1 for ddp). ``wire`` compresses the sync payload
    (``None`` f32 | ``"bf16"`` | ``"q8"``). ``transport`` (ddp only)
    selects the data path: ``"legacy"`` managed ring, ``"plan"``
    persistent native comm plan, ``"iso"`` the isolated data plane
    (structurally available when the Manager carries one:
    ``Manager(iso_collectives=...)``).
    ``sharded``: for diloco, the weight-update-sharded outer sync
    (requires f32 masters and an elementwise outer optimizer); for ddp,
    the per-step ZeRO engine (:class:`~torchft_tpu_torch.ddp.ShardedDDP`:
    reduce-scatter grads, ~1/W optimizer shard, bf16 param allgather;
    requires f32 masters and rides the sharded comm plan, so
    ``transport="plan"`` and the flat ring only). ``hier``
    (ddp/plan or diloco) runs the sync over the topology-aware
    hierarchical schedule (shm host rings -> intra-region rings -> the
    inter-region leader ring); such candidates are priced on the
    BOTTLENECK tier's measured bandwidth, not the folded flat average,
    and an un-hierarchical cohort latches them into the failure
    sentinel at runtime."""

    name: str
    kind: str
    sync_every: int = 1
    wire: Optional[str] = None
    transport: str = "legacy"
    sharded: bool = False
    hier: bool = False

    def __post_init__(self) -> None:
        if self.kind not in ("ddp", "localsgd", "diloco"):
            raise ValueError(f"unsupported strategy kind: {self.kind!r}")
        if self.kind == "ddp" and self.sync_every != 1:
            raise ValueError("ddp strategies are per-step (sync_every=1)")
        if self.kind != "ddp" and self.sync_every < 2:
            raise ValueError("windowed strategies need sync_every >= 2")
        if self.wire not in (None, "bf16", "q8"):
            raise ValueError(f"unsupported wire: {self.wire!r}")
        if self.transport not in ("legacy", "plan", "iso"):
            raise ValueError(f"unsupported transport: {self.transport!r}")
        if self.hier and self.kind == "localsgd":
            raise ValueError("localsgd has no hier schedule")
        if self.hier and self.kind == "ddp" and self.transport != "plan":
            raise ValueError("hier ddp rides the plan transport")
        if self.sharded and self.kind == "localsgd":
            raise ValueError("localsgd has no sharded form")
        if self.sharded and self.kind == "ddp":
            if self.transport != "plan":
                raise ValueError(
                    "sharded ddp rides the plan transport (the sharded "
                    "schedule IS a comm-plan form)"
                )
            if self.hier:
                raise ValueError(
                    "sharded ddp rides the flat ring (no hierarchical "
                    "reduce-scatter schedule is composed)"
                )

    def wire_factor(self) -> float:
        """Sync payload bytes relative to f32."""
        return _WIRE_FACTOR[self.wire]


def default_candidates(
    f32_masters: bool = True, topology_labeled: bool = False
) -> Tuple[StrategySpec, ...]:
    """The default ladder, ordered from tightest to loosest sync: per-step
    DDP (legacy and plan transports; plus ``ddp_sharded`` — the per-step
    ZeRO engine with q8 grad reduce-scatter, ~1/W optimizer shards and a
    bf16 param allgather — when the masters are f32), LocalSGD, and two
    DiLoCo(q8) window lengths, with the sharded outer sync when the
    masters are f32, plain q8 otherwise.
    Availability is still checked per cohort at construction (a diloco
    candidate without an outer optimizer or under an async-quorum manager
    simply can't win).

    ``topology_labeled`` (this member carries TORCHFT_REGION or an
    explicit TORCHFT_HOST) adds the ``ddp_plan_hier`` candidate, the plan
    transport over the two-tier schedule, priced on the bottleneck
    tier's measured bandwidth."""
    sharded = bool(f32_masters)
    ladder = [
        StrategySpec("ddp", "ddp"),
        StrategySpec("ddp_plan", "ddp", transport="plan"),
    ]
    if topology_labeled:
        ladder.append(
            StrategySpec("ddp_plan_hier", "ddp", transport="plan", hier=True)
        )
    if sharded:
        # Per-step ZeRO: q8 grad reduce-scatter + bf16 param allgather
        # through the sharded comm plan, optimizer state ~1/W. Wins
        # memory and update FLOPs; its wire term (q8 rs + bf16 ag) still
        # beats the f32 per-step candidates, though not fused q8 — the
        # cost model prices exactly that trade.
        ladder.append(
            StrategySpec(
                "ddp_sharded", "ddp", transport="plan", wire="q8",
                sharded=True,
            )
        )
    ladder += [
        StrategySpec("localsgd_h16", "localsgd", sync_every=16),
        StrategySpec(
            "diloco_q8_h16", "diloco", sync_every=16, wire="q8",
            sharded=sharded,
        ),
        StrategySpec(
            "diloco_q8_h64", "diloco", sync_every=64, wire="q8",
            sharded=sharded,
        ),
    ]
    return tuple(ladder)


@dataclass(frozen=True)
class CostKnobs:
    """Tunable weights of the cost model (env ``TORCHFT_POLICY_*``).

    ``staleness_weight``: convergence discount per inner step of window
    length — models that H-step-stale outer updates buy less progress per
    step than exact per-step sync, the term that makes per-step DDP win
    quiet fat links (0 optimizes raw step throughput only).
    ``sync_fixed_s``: per-sync fixed cost (packing, d2h, dispatch) added
    on top of the bytes/bandwidth wire term.
    ``surface_s``: how long a fault keeps poisoning the data plane before
    membership converges around it (≈ the failure-detection/lease window)
    — a fault inside this horizon of a transaction fails THAT transaction
    and discards the window, so windows shorter than the horizon are hit
    by essentially every fault while windows much longer than it absorb
    most faults in local compute.
    ``opt_mem_weight`` (env ``TORCHFT_POLICY_OPT_MEM``, default 0 =
    off): seconds of modeled cost per GiB of RESIDENT optimizer state —
    the memory-pressure term that lets ``ddp_sharded``'s ~1/W shard win
    against byte-equivalent unsharded candidates on memory-bound hosts.
    Pricing uses the adam-class estimate (2 f32 moments per master
    weight, / world for sharded-ddp candidates) rather than the measured
    ``opt_state_bytes`` signal: the measurement describes the ACTIVE
    strategy's residency, while every candidate must be priced by what
    it WOULD hold — the signal stays exported for observability and for
    validating the estimate."""

    staleness_weight: float = 0.05
    sync_fixed_s: float = 0.002
    hysteresis: float = 0.1
    surface_s: float = 1.0
    opt_mem_weight: float = 0.0

    @classmethod
    def from_env(cls) -> "CostKnobs":
        return cls(
            staleness_weight=float(
                os.environ.get("TORCHFT_POLICY_STALENESS", "0.05")
            ),
            sync_fixed_s=float(
                os.environ.get("TORCHFT_POLICY_SYNC_FIXED_S", "0.002")
            ),
            hysteresis=float(
                os.environ.get("TORCHFT_POLICY_HYSTERESIS", "0.1")
            ),
            surface_s=float(
                os.environ.get("TORCHFT_POLICY_SURFACE_S", "1.0")
            ),
            opt_mem_weight=float(
                os.environ.get("TORCHFT_POLICY_OPT_MEM", "0.0")
            ),
        )


def strategy_cost(
    spec: StrategySpec, signals: Dict[str, float], knobs: CostKnobs
) -> float:
    """Modeled seconds per EFFECTIVE inner step under ``signals`` — the
    pure function every member evaluates over identical aggregated data,
    so the argmin is cohort-identical by construction.

    Terms (all measured, none assumed):

    - inner compute: ``compute_s`` per step;
    - amortized sync: wire bytes (model bytes × wire factor) over the
      measured effective bandwidth, plus control cost (quorum + commit
      vote), divided by the window length;
    - churn: at measured fault rate λ, each fault costs a reconfigure,
      the UNHIDDEN part of a heal (a window of local steps hides up to
      (H-1)·compute of heal latency behind inner compute — the "longer
      windows as churn rises" effect), the expected cohort-wide discard
      when the fault lands mid-transaction, and the victim's lost half
      window (cohort-normalized) — the term that caps window growth;
    - staleness: a (1 + w·(H-1)) effective-progress discount, the term
      that keeps per-step DDP optimal on quiet fat links;
    - optimizer memory (off unless ``opt_mem_weight`` > 0): the modeled
      adam-class resident state (2 f32 moments per master weight),
      ~1/world for the sharded per-step engine — the term that lets
      ``ddp_sharded`` win on memory-bound hosts even though its wire
      (q8 rs + bf16 ag, factor 0.375) loses to fused q8 (0.25).
    """
    c = max(float(signals["compute_s"]), 1e-6)
    bw_mbps = float(signals.get("wire_eff_MBps") or 0.0)
    model_bytes = float(signals["model_bytes"])
    intra_bw = float(signals.get("tier_intra_MBps") or 0.0)
    inter_bw = float(signals.get("tier_inter_MBps") or 0.0)
    if spec.hier and (intra_bw > 0.0 or inter_bw > 0.0):
        # Hierarchical candidates are priced on the BOTTLENECK tier, not
        # the folded flat average: the schedule's phases are sequential,
        # so the wall is bounded below by its worst leg — the wire-
        # compressed inter hop at the measured inter bandwidth vs the
        # full-width intra/host legs (~2N per member: rs + ag) at the
        # measured intra bandwidth. An shm host tier simply makes the
        # host leg's measured bandwidth enormous, so it never bounds.
        legs = []
        if inter_bw > 0.0:
            legs.append(
                model_bytes * spec.wire_factor() / (inter_bw * (1 << 20))
            )
        if intra_bw > 0.0:
            legs.append(2.0 * model_bytes / (intra_bw * (1 << 20)))
        wire_s = max(legs)
    elif bw_mbps <= 0.0:
        # Unmeasured bandwidth: price syncs at the fixed cost only; the
        # first windows' op stats fill this in.
        wire_s = 0.0
    elif spec.kind == "ddp" and spec.sharded:
        # Two sequential legs over the same bottleneck link, each moving
        # ~half an allreduce's bytes: grad reduce-scatter at the shard
        # wire + the param allgather (bf16 when the shard wire is q8 —
        # ShardedDDP's "auto" default — else full f32). For the q8
        # default this folds to factor (0.25 + 0.5)/2 = 0.375: the
        # honest "wins memory/FLOPs, not bytes" accounting.
        ag_factor = 0.5 if spec.wire == "q8" else 1.0
        wire_s = (
            model_bytes * (spec.wire_factor() + ag_factor) / 2.0
            / (bw_mbps * (1 << 20))
        )
    else:
        wire_s = (
            model_bytes * spec.wire_factor() / (bw_mbps * (1 << 20))
        )
    sync_s = wire_s + knobs.sync_fixed_s
    ctrl_s = max(float(signals.get("ctrl_s") or 0.0), 0.0)
    h = float(spec.sync_every)
    t = c + (sync_s + ctrl_s) / h

    lam = max(float(signals.get("churn_per_min") or 0.0), 0.0) / 60.0
    if lam > 0.0:
        reconf_s = max(float(signals.get("reconf_s") or 0.0), 0.0)
        heal_s = max(float(signals.get("heal_s") or 0.0), 0.0)
        world = max(float(signals.get("world") or 1.0), 1.0)
        txn_s = sync_s + ctrl_s
        window_s = h * c + txn_s
        # A fault fails the transaction it lands in — and also the NEXT
        # one when it strikes within the surfacing horizon (the dead
        # member still holds its lease, so the ring forms around the
        # corpse and the op fails). Short windows are therefore hit by
        # essentially every fault; long windows absorb most faults in
        # local compute.
        p_txn = (
            min(1.0, (txn_s + knobs.surface_s) / window_s)
            if window_s > 0
            else 1.0
        )
        # A discarded transaction takes its whole window of inner work
        # with it (commit-or-rollback is window-granular).
        discard_s = p_txn * (h * c + sync_s)
        victim_s = (h * c / 2.0) / world
        exposed_heal_s = max(0.0, heal_s - (h - 1.0) * c)
        per_fault_s = reconf_s + exposed_heal_s + discard_s + victim_s
        # λ · per_fault is the fraction of wall time lost to faults;
        # goodput scales by (1 - loss), so cost scales by its inverse —
        # the saturating form matters exactly where strategies collapse
        # (a window longer than the fault interval almost never commits).
        t = t / max(1.0 - lam * per_fault_s, 0.05)

    cost = t * (1.0 + knobs.staleness_weight * (h - 1.0))
    if knobs.opt_mem_weight > 0.0:
        # Modeled resident optimizer state, NOT the measured
        # opt_state_bytes signal: every candidate is priced by what it
        # WOULD hold, and the pure model keeps the argmin
        # cohort-identical (see CostKnobs).
        mem_world = max(float(signals.get("world") or 1.0), 1.0)
        share = (
            1.0 / mem_world
            if (spec.kind == "ddp" and spec.sharded)
            else 1.0
        )
        cost += (
            knobs.opt_mem_weight * 2.0 * model_bytes * share / float(1 << 30)
        )
    return cost


class PolicyEngine:
    """Runtime strategy selection over per-step DDP, LocalSGD and DiLoCo.

    Usage (identical train-loop surface to AdaptiveDDP)::

        policy = PolicyEngine(manager, state, grad_fn, outer_tx=outer_sgd)
        for batch in batches:
            loss = policy.step(batch)
        policy.flush()

    Wire the manager's state callbacks to :meth:`state_dict` /
    :meth:`load_state_dict` so recovering replicas adopt the donor's
    ACTIVE strategy and window bookkeeping along with the weights.

    ``grad_fn(params, *batch) -> (loss, grads)``: the same contract as
    PipelinedDDP. ``outer_tx`` is the DiLoCo outer optimizer (elementwise,
    e.g. SGD+Nesterov); without one, diloco candidates are structurally
    unavailable and record sentinels. DiLoCo candidates also require a
    sync-quorum manager (``use_async_quorum=False``), like DiLoCo itself.

    Knobs (env):
    ``TORCHFT_POLICY_DECIDE_EVERY`` (attempted steps between decision
    transactions, default 32), ``TORCHFT_POLICY_HYSTERESIS`` (relative
    margin a challenger must beat the incumbent by, default 0.1),
    ``TORCHFT_POLICY_STALENESS``, ``TORCHFT_POLICY_SYNC_FIXED_S`` (cost
    model, see :class:`CostKnobs`), ``TORCHFT_POLICY_CHURN_WINDOW_S``
    (trailing window of the churn-rate signal, default 600).
    """

    def __init__(
        self,
        manager: Manager,
        state: FTTrainState,
        grad_fn: Callable[..., Tuple[Any, Any]],
        outer_tx: Any = None,
        candidates: Optional[Sequence[StrategySpec]] = None,
        decide_every: Optional[int] = None,
        knobs: Optional[CostKnobs] = None,
        initial: Optional[str] = None,
    ) -> None:
        self._manager = manager
        self._state = state
        self._grad_fn = grad_fn
        self._outer_tx = outer_tx
        if candidates is None:
            candidates = default_candidates(
                f32_masters=self._masters_are_f32(),
                topology_labeled=bool(
                    getattr(manager, "_region", "")
                    or os.environ.get("TORCHFT_REGION", "")
                    or os.environ.get("TORCHFT_HOST", "")
                ),
            )
        self._candidates: List[StrategySpec] = list(candidates)
        if not self._candidates:
            raise ValueError("need at least one candidate strategy")
        names = [c.name for c in self._candidates]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate candidate names: {names}")
        self._avail = [self._structurally_available(c) for c in self._candidates]
        if not any(self._avail):
            raise ValueError(
                "no candidate strategy is runnable here (diloco needs "
                "outer_tx and a sync-quorum manager; iso needs an iso "
                "plane)"
            )
        # Runtime failure latch, cleared when membership changes (a new
        # cohort deserves a fresh verdict — AdaptiveDDP's re-probe rule).
        self._failed = [False] * len(self._candidates)
        if initial is None:
            self._current = next(
                i for i, ok in enumerate(self._avail) if ok
            )
        else:
            self._current = names.index(initial)
            if not self._avail[self._current]:
                raise ValueError(f"initial strategy {initial!r} unavailable")
        if decide_every is None:
            decide_every = int(
                os.environ.get("TORCHFT_POLICY_DECIDE_EVERY", "32")
            )
        self._decide_every = max(int(decide_every), 1)
        self._knobs = knobs if knobs is not None else CostKnobs.from_env()
        self._churn_window_s = float(
            os.environ.get("TORCHFT_POLICY_CHURN_WINDOW_S", "600")
        )
        self._model_bytes = self._count_model_bytes()
        self._engines: Dict[str, Any] = {}
        # Lockstep clocks: ticks advance once per step() on every member;
        # the decision epoch counts decision transactions. Both ride the
        # state_dict so healed members resume aligned.
        self._ticks = 0
        self._last_decide_tick = 0
        self._decide_epoch = 0
        self._decide_qid: Optional[int] = None
        # Measured-signal accumulators (local; cohort-aggregated at
        # decision time through the gather).
        self._compute_samples: deque = deque(maxlen=64)
        self._consec_errors = 0
        self._error_backstop = 8
        self.last_commit: Optional[bool] = None
        self.decisions: List[dict] = []

    # -- construction-time capability checks --

    def _masters_are_f32(self) -> bool:
        leaves = flatten(self._state.params)[0]
        return bool(leaves) and all(
            getattr(l, "dtype", torch.float32) == torch.float32
            for l in leaves
        )

    def _structurally_available(self, spec: StrategySpec) -> bool:
        """Whether this member can run ``spec`` at all. Structural gates
        only — runtime failures are the sentinel latch's business. The
        verdict is still cohort-ANDed through the decision gather, so a
        heterogeneous cohort converges on the common subset."""
        if spec.kind == "ddp":
            if spec.transport == "iso":
                return bool(
                    getattr(self._manager, "has_iso_plane", lambda: False)()
                )
            if spec.sharded and not self._masters_are_f32():
                # ShardedDDP's shard/gather arithmetic is defined on f32
                # masters (the sharded plan carries one flat f32 group).
                return False
            return True
        if spec.kind == "localsgd":
            return True
        # diloco: needs the outer optimizer and an eager-heal manager
        if self._outer_tx is None:
            return False
        if getattr(self._manager, "_use_async_quorum", False):
            return False
        if spec.sharded and not self._masters_are_f32():
            return False
        if spec.sharded and spec.wire == "bf16":
            # the sharded outer sync has no bf16 REDUCE wire (bf16 serves
            # its param allgather leg, a different knob)
            return False
        return True

    def _count_model_bytes(self) -> int:
        return int(
            sum(
                int(np.prod(tuple(getattr(l, "shape", ())) or (1,))) * 4
                for l in flatten(self._state.params)[0]
            )
        )

    # -- engines --

    @property
    def strategy(self) -> StrategySpec:
        """The active strategy."""
        return self._candidates[self._current]

    def _engine(self, spec: StrategySpec) -> Any:
        eng = self._engines.get(spec.name)
        if eng is not None:
            return eng
        if spec.kind == "ddp" and spec.sharded:
            eng = ShardedDDP(
                self._manager, self._state, self._grad_fn,
                shard_wire=spec.wire,
            )
        elif spec.kind == "ddp":
            eng = PipelinedDDP(
                self._manager, self._state, self._grad_fn,
                compress=spec.wire, transport=spec.transport,
                hier=spec.hier,
            )
        elif spec.kind == "localsgd":
            eng = LocalSGD(self._manager, self._state, spec.sync_every)
        elif spec.sharded:
            eng = DiLoCo(
                self._manager, self._state, self._outer_tx,
                spec.sync_every, sharded=True, shard_wire=spec.wire,
            )
        else:
            # Unsharded DiLoCo over a compressed wire: AsyncDiLoCo with
            # overlap=False IS synchronous DiLoCo through the same ops,
            # and carries the q8/bf16 pseudogradient pipeline.
            eng = AsyncDiLoCo(
                self._manager, self._state, self._outer_tx,
                spec.sync_every, compress=spec.wire, overlap=False,
            )
        self._engines[spec.name] = eng
        return eng

    # -- train-loop surface --

    def step(self, *batch: Any) -> Any:
        """One training step under the active strategy; runs the decision
        transaction at window boundaries every ``decide_every`` attempted
        steps. Returns the loss."""
        spec = self._candidates[self._current]
        eng = self._engine(spec)
        t0 = time.perf_counter()
        synced = True
        if spec.kind == "ddp":
            loss = eng.blocking_step(*batch)
            self.last_commit = eng.last_commit
        else:
            loss, grads = self._grad_fn(self._state.params, *batch)
            eng.step(grads)
            synced = eng._local_step == 0
            if synced:
                self.last_commit = eng.last_sync_commit
        wall = time.perf_counter() - t0
        self._ticks += 1
        self._observe(spec, wall, synced)

        errored = synced and self.last_commit is False
        # The consecutive-error run counts TRANSACTIONS: inner (non-sync)
        # steps of a windowed strategy carry no verdict and must not
        # reset the counter, or the backstop could never trip for any
        # windowed strategy.
        tripped = self._note_errored(errored) if synced else False
        if not tripped:
            # Errored boundaries still decide: a data-plane error is
            # cohort-visible (ring failures fail fast everywhere), so the
            # cadence stays lockstep — and a strategy whose windows keep
            # dying under a fault storm must not get to postpone the
            # decision that would replace it until the storm ends.
            at_boundary = spec.kind == "ddp" or eng._local_step == 0
            if (
                at_boundary
                and self._ticks - self._last_decide_tick >= self._decide_every
            ):
                self._last_decide_tick = self._ticks
                self._decide_and_maybe_switch()
        return loss

    def flush(self) -> bool:
        """Settles anything the active strategy left in flight (call once
        after the loop); returns the last transaction's outcome."""
        eng = self._engines.get(self._candidates[self._current].name)
        if eng is None:
            return bool(self.last_commit)
        if isinstance(eng, (PipelinedDDP, ShardedDDP)):
            return eng.flush()
        if isinstance(eng, AsyncDiLoCo):
            eng.flush()
        return bool(self.last_commit)

    # -- measurement --

    def _observe(self, spec: StrategySpec, wall: float, synced: bool) -> None:
        """Folds one step's wall time into the local signal accumulators
        and routes the data plane's op stats through the manager (which
        maintains the rolling bandwidth estimate)."""
        entries = self._manager.observe_op_stats()
        if spec.kind != "ddp" and not synced:
            # A pure inner step: compute, no transaction — the cleanest
            # compute_s sample there is.
            self._compute_samples.append(wall)
        elif spec.kind == "ddp":
            # Subtract the measured op phases from the step wall; quorum
            # overlaps compute, so what remains approximates compute.
            op_s = sum(
                st.get("pack", 0.0) + st.get("d2h", 0.0)
                + st.get("ring", 0.0) + st.get("h2d", 0.0)
                for st in entries
            )
            self._compute_samples.append(max(wall - op_s, 1e-5))

    def _signal_vector(self) -> np.ndarray:
        """This member's measured conditions + per-candidate availability,
        as the fixed-length float64 vector the decision gather ships."""
        sig = self._manager.signals(self._churn_window_s)
        snap = self._manager.metrics().snapshot()
        timers = snap["timers_s"]

        def _p50(name: str) -> float:
            t = timers.get(name) or {}
            return float(t.get("p50") or 0.0)

        heal = sig.get("heal") or {}
        heal_fetch = (heal.get("fetch_s") or {}).get("p50") or 0.0
        heal_apply = (heal.get("apply_s") or {}).get("p50") or 0.0
        # Weight the heal cost by how often churn ACTUALLY heals: a
        # cohort-wide transaction abort bumps the churn clock but heals
        # nobody (everyone rolled back together), while a real kill heals
        # its victim every time. Charging a full heal per churn event
        # would otherwise let a single early heal dominate the fault term
        # at high abort rates.
        churn_n = (snap["events"].get("churn") or {}).get("n", 0)
        heal_frac = min(
            1.0, snap["counters"].get("heals", 0) / max(churn_n, 1)
        )
        compute_s = (
            float(np.median(self._compute_samples))
            if self._compute_samples
            else 0.0
        )
        tiers = sig.get("tier_eff_MBps") or {}
        head = [
            1.0,  # ok marker: a zeroed (non-participating) entry drops out
            compute_s,
            float(sig.get("wire_eff_MBps") or 0.0),
            float(sig.get("churn_per_min") or 0.0),
            _p50("quorum") + _p50("commit_vote"),
            _p50("reconfigure"),
            (float(heal_fetch) + float(heal_apply)) * heal_frac,
            # Per-tier measured bandwidth of the hierarchical schedule
            # (0 = unmeasured): what prices hier/shm candidates on the
            # bottleneck tier instead of the folded flat average.
            float(tiers.get("intra") or 0.0),
            float(tiers.get("inter") or 0.0),
            # Measured resident optimizer-state bytes (0 until a sharded
            # engine reports): observability + model validation — the
            # cost model prices candidates by the pure estimate instead.
            float(sig.get("opt_state_bytes") or 0.0),
        ]
        avail = [1.0 if a else 0.0 for a in self._avail]
        failed = [1.0 if f else 0.0 for f in self._failed]
        # float64 on the host, the JAX package's gather layout; a tensor,
        # so the manager zeroes a non-participating member's entry
        return torch.tensor(head + avail + failed, dtype=torch.float64)

    def _aggregate(self, entries: List[np.ndarray]) -> Dict[str, Any]:
        """Cohort-aggregates gathered signal vectors into ONE deterministic
        signal dict: slowest compute paces the cohort, the bottleneck
        connection bounds every sync, the worst churn is everyone's churn.
        Zeroed entries (healing/spare members) and non-finite residue are
        excluded."""
        k = len(self._candidates)
        live = [
            e for e in entries
            if e.shape == (10 + 2 * k,) and np.isfinite(e).all() and e[0] > 0.5
        ]
        if not live:
            raise RuntimeError("no live signal entries in decision gather")
        mat = np.stack(live)
        bws = mat[:, 2]
        bws = bws[bws > 0.0]

        def _tier_min(col: int) -> float:
            # Bottleneck across members, like the flat bandwidth: the
            # slowest member's measured tier bounds every phase.
            v = mat[:, col]
            v = v[v > 0.0]
            return float(v.min()) if v.size else 0.0

        avail = mat[:, 10:10 + k].min(axis=0)  # AND across members
        failed = mat[:, 10 + k:].max(axis=0)  # OR across members
        return {
            "compute_s": float(mat[:, 1].max()),
            "wire_eff_MBps": float(bws.min()) if bws.size else 0.0,
            "churn_per_min": float(mat[:, 3].max()),
            "ctrl_s": float(mat[:, 4].max()),
            "reconf_s": float(mat[:, 5].max()),
            "heal_s": float(mat[:, 6].max()),
            "tier_intra_MBps": _tier_min(7),
            "tier_inter_MBps": _tier_min(8),
            "opt_state_bytes": float(mat[:, 9].max()),
            "world": float(len(live)),
            "model_bytes": float(self._model_bytes),
            "avail": avail,
            "failed": failed,
        }

    def _costs(self, agg: Dict[str, Any]) -> List[float]:
        costs = []
        for i, spec in enumerate(self._candidates):
            if agg["avail"][i] < 0.5 or agg["failed"][i] > 0.5:
                costs.append(SENTINEL_COST_S)
            else:
                costs.append(strategy_cost(spec, agg, self._knobs))
        return costs

    def _choose(self, costs: List[float]) -> int:
        return choose_target(costs, self._current, self._knobs.hysteresis)

    # -- the decision transaction --

    def _decide_and_maybe_switch(self) -> None:
        """ONE voted, latched transaction: gather signals, compute the
        cohort-agreed target, vote. A failed gather latches EVERY member
        (ring failures propagate), so the cohort aborts together; a
        member that fails after the gather discards locally, lags, and
        heals into the cohort's choice (see the module docstring's
        split-brain analysis). Identical gathered data + a pure choice
        function = identical targets everywhere the gather succeeded."""
        m = self._manager
        m.start_quorum()
        qid: Optional[int] = None
        target = self._current
        agg: Optional[Dict[str, Any]] = None
        costs: Optional[List[float]] = None
        try:
            qid = m.quorum_id()
            if qid != self._decide_qid:
                # Membership changed since the last decision: failure
                # verdicts belong to the old cohort. Reset BEFORE building
                # the signal vector, so the fresh cohort's very first
                # decision doesn't gather the stale sentinels.
                self._failed = [False] * len(self._candidates)
            gathered = m.allgather(
                {"policy_sig": self._signal_vector()}
            ).wait()
            if m.errored() is None:
                agg = self._aggregate(
                    [
                        np.asarray(torch.as_tensor(e["policy_sig"]).cpu(),
                                   np.float64)
                        for e in gathered
                    ]
                )
                costs = self._costs(agg)
                target = self._choose(costs)
        except Exception as e:  # noqa: BLE001 - latch, vote, stand still
            logger.exception("policy decision failed: %s", e)
            m.report_error(e)
            target = self._current
        # Control transaction: the committed-step counter must advance (it
        # is the cohort's transaction clock) but no batch was trained, so
        # batches_committed must not inflate.
        committed = m.should_commit(count_batches=False)
        switched = committed and target != self._current
        decision = {
            "epoch": self._decide_epoch,
            "tick": self._ticks,
            "from": self._candidates[self._current].name,
            "to": self._candidates[target].name,
            "committed": bool(committed),
            "switched": bool(switched),
            "signals": {
                k: v
                for k, v in (agg or {}).items()
                if k not in ("avail", "failed")
            },
            "costs": {
                spec.name: round(float(c), 6)
                for spec, c in zip(self._candidates, costs or [])
            },
        }
        self._decide_epoch += 1
        self._decide_qid = qid if qid is not None else self._decide_qid
        self.decisions.append(decision)
        metrics = m.metrics()
        metrics.incr("policy_decisions")
        if switched:
            self._adopt(target)
            metrics.incr("policy_switches")
            logger.info(
                "policy switch %s -> %s (signals=%s)",
                decision["from"], decision["to"], decision["signals"],
            )
        elif committed:
            metrics.incr(f"policy_mode_{self._candidates[self._current].name}")
        else:
            metrics.incr("policy_decision_aborts")
        m.push_status(
            {
                "policy": {
                    "strategy": self._candidates[self._current].name,
                    "epoch": self._decide_epoch,
                    "decisions": len(self.decisions),
                }
            }
        )

    def _adopt(self, target: int) -> None:
        """Hands control to ``target``'s engine at the (boundary) switch
        point: windowed engines re-anchor their window at the live params
        (keeping DiLoCo outer state — momentum survives a round trip);
        DDP engines drop stale per-trajectory carries."""
        self._current = target
        spec = self._candidates[target]
        eng = self._engine(spec)
        if spec.kind == "ddp":
            eng.last_commit = None
            if isinstance(eng, ShardedDDP):
                # Tenure boundary for the sharded engine: void the
                # quorum-keyed shard meta so the first step under the new
                # tenure re-partitions against the live cohort, and let
                # the optimizer restart from a deterministic fresh init —
                # every member computes it from cohort-identical params,
                # so cross-member identity holds through the switch.
                eng.begin_fresh_shard()
            else:
                # the legacy transport's EF carry (a new one starts from
                # zeros)
                eng._carries = None
            if spec.transport == "plan" and spec.wire == "q8":
                # the NATIVE q8ef carry lives in the comm plan, not in
                # eng._residual — same tenure-boundary reset discipline
                self._manager.reset_plan_feedback()
        else:
            eng.begin_fresh_window()
        self._manager.metrics().incr(f"policy_mode_{spec.name}")

    def _note_errored(self, errored: bool) -> bool:
        """Sustained-failure backstop: a run of consecutive errored
        transactions marks the CURRENT strategy failed (sentinel — it can
        never win again this cohort) and falls back to the base strategy
        immediately. Errors are cohort-visible (the commit vote fails for
        everyone), so every member trips this at the same step."""
        if not errored:
            self._consec_errors = 0
            return False
        self._consec_errors += 1
        if self._consec_errors < self._error_backstop:
            return False
        self._consec_errors = 0
        base = next(i for i, ok in enumerate(self._avail) if ok)
        if self._current != base:
            self._failed[self._current] = True
            self._manager.metrics().incr("policy_backstops")
            logger.warning(
                "policy backstop: %s errored %d consecutive transactions; "
                "falling back to %s",
                self._candidates[self._current].name, self._error_backstop,
                self._candidates[base].name,
            )
            self._adopt(base)
        return True

    # -- checkpoint plumbing (manager state callbacks) --

    def state_dict(self) -> Dict[str, Any]:
        spec = self._candidates[self._current]
        if spec.kind == "ddp" and spec.sharded:
            # The sharded engine's own surface: ships the donor's opt
            # shard + quorum-keyed meta; the recipient voids the meta on
            # load so its first step re-partitions under the live cohort.
            inner: Dict[str, Any] = self._engine(spec).state_dict()
        elif spec.kind == "ddp":
            inner = {"state": self._state.state_dict()}
        else:
            inner = self._engine(spec).state_dict()
        return {
            "inner": inner,
            "policy": {
                "current": self._current,
                "ticks": self._ticks,
                "last_decide_tick": self._last_decide_tick,
                "decide_epoch": self._decide_epoch,
                "failed": list(self._failed),
            },
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        pol = sd["policy"]
        self._current = int(pol["current"])
        self._ticks = int(pol["ticks"])
        self._last_decide_tick = int(pol["last_decide_tick"])
        self._decide_epoch = int(pol["decide_epoch"])
        self._failed = [bool(f) for f in pol["failed"]]
        spec = self._candidates[self._current]
        if spec.kind == "ddp" and spec.sharded:
            self._engine(spec).load_state_dict(sd["inner"])
        elif spec.kind == "ddp":
            self._state.load_state_dict(sd["inner"]["state"])
        else:
            self._engine(spec).load_state_dict(sd["inner"])
        self._consec_errors = 0
