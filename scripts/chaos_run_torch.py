#!/usr/bin/env python3
"""Replayable chaos-invariant harness for the PyTorch port's step
transaction: the counterpart of ``scripts/chaos_run.py``, with the same
schedules, the same records and the same digest.

It runs seeded random :class:`~torchft_tpu_torch.chaos.FaultPlan`
schedules over a REAL multi-member TCP fleet (a lighthouse + N
single-rank replica groups of the port's ``Manager`` and
``HostCollectives``) in each data-plane configuration (per-step DDP,
the comm plan, hierarchical two-tier, two-tier over shared memory) and
asserts, per schedule, the transaction invariants:

  1. EPOCH PURITY: no committed step mixes quorum epochs (each member's
     step -> quorum_id map is monotonic; a step carries different epochs
     across members only inside a churn window).
  2. BIT IDENTITY: surviving members end bit-identical.
  3. DETECTION: a step whose window saw a corrupting fault (bit_flip /
     duplicate) never commits, and with the wire CRC on the typed
     WireCorruption is observed (zero silent commits).
  4. LIVENESS: once injection stops, the fleet reaches a clean commit
     within a bounded deadline.

Also here, as in the JAX harness: the root outage (a WAL'd primary and
a warm standby root, both subprocesses, under kill/restart/partition),
the per-step ZeRO re-partition after a mid-reduce-scatter death, the
whole-fleet loss restored from the durable tier (subprocess members,
``--fleet-member``), the policy-engine fleet, the serving-plane churn,
the isolated child's SIGKILL/SIGSTOP probes and the CRC overhead.

Members' trees live on the device (the card unless ``--device cpu``):

- ``--tree vector`` (default): one f32 leaf of 4096 with the JAX
  harness's per-step gradient, so digests compare bit for bit with
  ``scripts/chaos_run.py``;
- ``--tree dense``: the 39 f32 leaves (23,337,472 elements) of the dense
  LM ``bench.py`` runs by default, each step's gradients drawn from a
  generator seeded by (seed, group, attempted step), so a retried step
  contributes the same bytes.

``--wire`` is the wire of every ``allreduce`` / ``plan_allreduce``
(default: none, the JAX harness's); ``q8`` is the main path's
(``PipelinedDDP(compress="q8")``): the quantized ring for ``allreduce``
and the ``q8ef`` plan for ``plan_allreduce``, packed on the card by the
port's K1a/K1b.

A failing schedule prints its ``(seed, plan)`` and replays with::

    python scripts/chaos_run_torch.py --config ddp --seed 1234 [--plan '<json>']

Two departures from the JAX harness, both about how a run is driven,
not what it checks: a member leaves the step loop only once it is past
the last step AND its last step committed in a quorum of the whole
fleet, so the members leave together (``_done``); and the schedules
whose faults act on other processes (the fleet loss, the serving churn,
the iso probes) run on a thread beside the ring schedules, whose faults
arm this process's engine.

``--dryrun`` runs the seconds-scale subset and asserts the JAX
harness's dryrun records (a detected corruption, a SIGSTOP stall, a
root restart with WAL replay, a sharded re-partition, a whole-fleet-loss
restore, a serving-churn record). The full run prints its records, or
writes them where ``--out`` says; nothing is written by default.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torchft_tpu_torch import _native, chaos  # noqa: E402
from torchft_tpu_torch._device import resolve_device  # noqa: E402
from torchft_tpu_torch._native import Lighthouse, Store, WireCorruption  # noqa: E402
from torchft_tpu_torch.chaos import ChaosInjector, FaultEvent, FaultPlan  # noqa: E402
from torchft_tpu_torch.collectives import HostCollectives  # noqa: E402
from torchft_tpu_torch.manager import Manager  # noqa: E402
from torchft_tpu_torch.ops import launch_counts  # noqa: E402

# Corruption kinds whose danger is SILENT wrong bytes (drop/truncate/
# partition kill the op loudly on their own).
CORRUPTING_KINDS = ("bit_flip", "duplicate")

OP_TIMEOUT_S = 6.0

TREES = ("vector", "dense")
# bench.py's default LM (bench.py:164-174): 39 f32 leaves
DENSE_LM = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=6,
                d_ff=2048, max_seq_len=512)
DENSE_GRAD_SCALE = 1e-3
# The lighthouses' straggler window: the JAX harness's 200 ms for the
# vector tree, whose steps take milliseconds; for the dense tree, whose
# steps take a large part of a second, a member that late is no
# straggler, and a 200 ms window drops one member from every other
# quorum (membership then changes at each step).
JOIN_TIMEOUT_MS = {"vector": 200, "dense": 2000}
# A member past its last step whose quorum lacks part of the fleet
# steps once a quorum tick, so the members behind it can ask in time.
PACE_S = 0.05
# --wire onto the plan's wires, as PipelinedDDP maps compress="q8"
PLAN_WIRES = {None: None, "q8": "q8ef"}


# -- trees -------------------------------------------------------------------


def _np(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _digest(tree: Dict[str, Any]) -> str:
    """chaos_run.py's digest: sha256 over sorted keys and raw bytes."""
    h = hashlib.sha256()
    for key in sorted(tree):
        h.update(key.encode())
        h.update(np.ascontiguousarray(_np(tree[key])).tobytes())
    return h.hexdigest()


def _flat_items(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += _flat_items(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flat_items(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


_DENSE_INIT: Dict[str, torch.Tensor] = {}
_DENSE_LOCK = threading.Lock()


def _dense_init() -> Dict[str, torch.Tensor]:
    """The dense LM's initial parameters by path, drawn once per process
    on the CPU (seed 0), so every member starts from the same bits."""
    with _DENSE_LOCK:
        if not _DENSE_INIT:
            from torchft_tpu_torch.models import transformer as tt

            cfg = tt.TransformerConfig(**DENSE_LM)
            _DENSE_INIT.update(_flat_items(tt.init_params(cfg, 0, "cpu")))
        return _DENSE_INIT


class Tree:
    """A member's parameter tree (a flat dict of f32 tensors on
    ``device``) and its per-step gradients."""

    def __init__(self, kind: str, device: torch.device, elems: int = 4096,
                 seed: int = 0) -> None:
        if kind not in TREES:
            raise ValueError(f"unknown tree {kind!r}")
        self.kind = kind
        self.device = device
        self.elems = elems
        self.seed = seed
        self._shapes: List[Tuple[str, Tuple[int, ...]]] = []
        if kind == "dense":
            self._init = _dense_init()
            self._shapes = [(k, tuple(v.shape)) for k, v in self._init.items()]

    @property
    def numel(self) -> int:
        if self.kind == "vector":
            return self.elems
        return sum(int(np.prod(s)) for _, s in self._shapes)

    def params(self, fill: float = 1.0) -> Dict[str, torch.Tensor]:
        if self.kind == "vector":
            return {"w": torch.full((self.elems,), fill, dtype=torch.float32,
                                    device=self.device)}
        return {k: v.to(self.device, copy=True) for k, v in self._init.items()}

    def grads(self, gid: int, step: int) -> Dict[str, torch.Tensor]:
        """The JAX harness's constant gradient (vector), or a draw seeded
        by (seed, gid, step) on the device (dense)."""
        if self.kind == "vector":
            return {"w": torch.full((self.elems,), 0.01 * (gid + 1) + step * 0.001,
                                    dtype=torch.float32, device=self.device)}
        mix = chaos.splitmix64(self.seed ^ chaos.splitmix64(
            (gid + 1) ^ chaos.splitmix64(step + 1)))
        gen = torch.Generator(device=self.device).manual_seed(mix >> 1)
        flat = torch.randn(self.numel, generator=gen, device=self.device)
        flat.mul_(DENSE_GRAD_SCALE)
        out, at = {}, 0
        for k, shape in self._shapes:
            n = int(np.prod(shape))
            out[k] = flat[at:at + n].view(shape)
            at += n
        return out

    def load(self, leaves: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A received state's leaves (tensors from the streamed heal,
        numpy from its pickled fallbacks) as fresh f32 tensors here."""
        return {k: torch.as_tensor(_np(v) if not isinstance(v, torch.Tensor)
                                   else v).to(self.device, torch.float32,
                                              copy=True)
                for k, v in leaves.items()}


def apply_update(params: Dict[str, torch.Tensor], avg: Dict[str, Any],
                 lr: float = 0.1) -> Dict[str, torch.Tensor]:
    """``p - lr * avg`` with two roundings, as numpy computes the JAX
    harness's update."""
    keys = sorted(params)
    new = torch._foreach_sub([params[k] for k in keys],
                             torch._foreach_mul([avg[k] for k in keys], lr))
    return dict(zip(keys, new))


# -- records -----------------------------------------------------------------


class _MemberRecord:
    def __init__(self) -> None:
        self.commits: Dict[int, int] = {}  # committed step -> quorum_id
        self.discards: List[int] = []  # attempted steps that did not commit
        self.errors: List[str] = []  # error strings observed
        self.crc_detections = 0
        self.desync_detections = 0
        self.final_digest: Optional[str] = None
        self.alive = False


def _classify(record: _MemberRecord, err: Optional[Exception]) -> None:
    if err is None:
        return
    text = f"{type(err).__name__}: {err}"
    record.errors.append(text)
    if isinstance(err, WireCorruption) or "wire corruption" in str(err):
        record.crc_detections += 1
    if "protocol desync" in str(err):
        record.desync_detections += 1


def _vote_down(manager: Manager, e: Exception) -> None:
    """A raised step leaves the step unvoted; vote it down so the
    cohort's step clocks stay joined."""
    try:
        if manager.errored() is None:
            manager.report_error(e)
        manager.should_commit(timeout=timedelta(seconds=OP_TIMEOUT_S))
    except Exception:  # noqa: BLE001 - the vote may fail under chaos too
        pass


def _check_monotone(records: List[_MemberRecord], repro: str) -> None:
    for r in records:
        steps_sorted = sorted(r.commits)
        for a, b in zip(steps_sorted, steps_sorted[1:]):
            assert r.commits[a] <= r.commits[b], (
                f"quorum epoch went BACKWARD between committed steps "
                f"{a} (qid {r.commits[a]}) and {b} (qid {r.commits[b]}) "
                f"({repro})"
            )


def _check_bit_identity(records: List[_MemberRecord], repro: str) -> None:
    digests = {r.final_digest for r in records}
    assert len(digests) == 1, (
        f"survivors ended with diverged params {digests} (digests "
        f"{[r.final_digest[:12] for r in records]}, commits "
        f"{[r.commits for r in records]}, discards "
        f"{[r.discards for r in records]}, errors "
        f"{[r.errors[-3:] for r in records]}; {repro})"
    )


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: launch_counts[k] - before.get(k, 0) for k in launch_counts}


class _Member:
    """One single-rank replica group: its Store, HostCollectives and
    Manager, shut down together."""

    def __init__(self, lighthouse_addr: str, replica_id: str,
                 device: torch.device, state_dict: Callable[[], Any],
                 load_state_dict: Callable[[Any], None],
                 min_replica_size: int, crc: Optional[bool] = True,
                 quorum_timeout_s: float = OP_TIMEOUT_S * 4,
                 region: str = "", host_label: str = "") -> None:
        self.store = Store()
        self.collectives = HostCollectives(
            timeout=timedelta(seconds=OP_TIMEOUT_S),
            connect_timeout=timedelta(seconds=OP_TIMEOUT_S * 3),
            stripes=1,
            wire_crc=crc,
        )
        self.manager = Manager(
            collectives=self.collectives,
            load_state_dict=load_state_dict,
            state_dict=state_dict,
            min_replica_size=min_replica_size,
            use_async_quorum=False,
            timeout=timedelta(seconds=OP_TIMEOUT_S),
            quorum_timeout=timedelta(seconds=quorum_timeout_s),
            connect_timeout=timedelta(seconds=OP_TIMEOUT_S * 3),
            rank=0,
            world_size=1,
            store_addr=self.store.address(),
            lighthouse_addr=lighthouse_addr,
            replica_id=replica_id,
            region=region,
            host_label=host_label,
            device=device,
        )

    def shutdown(self) -> None:
        for fn in (self.manager.shutdown, self.collectives.shutdown):
            try:
                fn()
            except Exception:  # noqa: BLE001 - teardown after chaos
                pass
        self.store.shutdown()


def _params_member(tree: Tree, lighthouse_addr: str, replica_id: str,
                   min_replica_size: int, crc: Optional[bool] = True,
                   **kw: Any) -> Tuple[_Member, Dict[str, Any]]:
    """A member whose user state is ``{"params": box["params"]}``."""
    box: Dict[str, Any] = {"params": tree.params()}

    def state_dict() -> dict:
        return {"params": dict(box["params"])}

    def load_state_dict(sd: dict) -> None:
        box["params"] = tree.load(sd["params"])

    return _Member(lighthouse_addr, replica_id, tree.device, state_dict,
                   load_state_dict, min_replica_size, crc, **kw), box


def _attempt(member: _Member, box: Dict[str, Any], rec: _MemberRecord,
             attempted: int, reduce: Callable[[Dict[str, Any]], Any],
             grads: Callable[[], Dict[str, Any]]) -> int:
    """One step transaction: quorum, the reduce, the vote, the update.
    Returns the width of the quorum that committed it (0: discarded)."""
    manager = member.manager
    err: Optional[Exception] = None
    width = 0
    try:
        manager.start_quorum()
        avg = reduce(grads()).wait()
        latched = manager.errored()
        if latched is not None:
            err = latched
        committed = manager.should_commit()
        if committed and avg is not None:
            rec.commits[attempted] = manager.quorum_id()
            box["params"] = apply_update(box["params"], avg)
            width = manager.num_participants()
        else:
            rec.discards.append(attempted)
    except Exception as e:  # noqa: BLE001 - chaos surfaces here
        err = e
        _vote_down(manager, e)
        rec.discards.append(attempted)
    _classify(rec, err)
    return width


def _done(attempted: int, loop_steps: int, last_width: int,
          groups: int) -> bool:
    """A member leaves the loop once it has attempted ``loop_steps`` AND
    its last step committed in a quorum of the whole fleet. Every member
    of that quorum sees the same step and width, so they leave together;
    a member that ran ahead alone keeps stepping until the one behind
    rejoins and heals from it. (Leaving at ``loop_steps`` alone, as
    scripts/chaos_run.py does, lets a member that lagged behind a root
    outage commit the same steps again alone after the others left, and
    the fleet ends with two histories: ROADMAP Queue 3, F9.)"""
    return attempted >= loop_steps and last_width == groups


def _start_together(start: threading.Barrier) -> None:
    """Members built, they take their first step together: one built
    later than its peers' first quorum would take step 0 in a quorum of
    its own and heal, and a fault planned for its step 1 send would
    never fire. A member whose construction failed breaks the barrier;
    the rest go on."""
    try:
        start.wait(timeout=120)
    except threading.BrokenBarrierError:
        pass


def _run_threads(target: Callable[[int], None], n: int, name: str,
                 join_s: float) -> float:
    threads = [threading.Thread(target=target, args=(g,), name=f"{name}{g}")
               for g in range(n)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(join_s)
    return time.monotonic() - t0


# -- the data-plane schedules ------------------------------------------------


def run_schedule(
    seed: int,
    config: str,
    groups: int = 3,
    steps: int = 8,
    plan: Optional[FaultPlan] = None,
    crc: bool = True,
    seams: Tuple[str, ...] = ("ring_send",),
    events_target: int = 3,
    deadline_s: float = 180.0,
    device: Any = None,
    tree: str = "vector",
    wire: Optional[str] = None,
) -> dict:
    """One seeded schedule over one fleet configuration. Returns the
    invariant record; raises AssertionError (with the replaying (seed,
    plan) in the message) on any violated invariant."""
    dev = resolve_device(device)
    if plan is None:
        plan = FaultPlan.random(
            seed, steps=steps, members=groups, seams=seams,
            events_target=events_target,
        )
    repro = (f"replay: --config {config} --seed {seed} --tree {tree}"
             + (f" --wire {wire}" if wire else "")
             + f" --plan '{plan.to_json()}'")
    trees = [Tree(tree, dev, seed=seed) for _ in range(groups)]
    before = dict(launch_counts)
    injector = ChaosInjector(plan)
    lighthouse = Lighthouse(
        bind="[::]:0", min_replicas=1, join_timeout_ms=JOIN_TIMEOUT_MS[tree],
        quorum_tick_ms=50, heartbeat_timeout_ms=4000,
    )
    records = [_MemberRecord() for _ in range(groups)]
    # Windowed fault attribution: member 0 arms the plan at the top of
    # its step; the fired-count delta observed at the NEXT arm tells
    # which window each injection landed in.
    fired_by_window: Dict[int, Dict[str, int]] = {}
    window_lock = threading.Lock()
    last_fault_step = max((e.step for e in plan.events), default=0)
    loop_steps = max(steps, last_fault_step + 3)
    regions = (
        [f"r{i % 2}" for i in range(groups)] if config == "hier" else None
    )
    # hier_shm: one explicit host label for every group (they are
    # co-hosted), so the data plane builds the shared-memory host tier;
    # the live-segment count is the leak oracle.
    host_label = f"chaoshost_{seed}" if config == "hier_shm" else ""
    shm_base = _native.shm_live_count() if host_label else 0

    def reducer(manager: Manager) -> Callable[[Dict[str, Any]], Any]:
        if config == "plan":
            return lambda g: manager.plan_allreduce(g, wire=PLAN_WIRES[wire])
        if config in ("hier", "hier_shm"):
            return lambda g: (
                manager.allreduce_hier(g, wire=wire)
                if manager.hier_capable()
                else manager.allreduce(g, wire=wire))
        return lambda g: manager.allreduce(g, wire=wire)

    start = threading.Barrier(groups)

    def member_main(gid: int) -> None:
        member, box = _params_member(
            trees[gid], lighthouse.address(), f"chaos_{gid}",
            max(1, groups - 1), crc,
            region=(regions[gid] if regions else ""), host_label=host_label,
        )
        _start_together(start)
        manager = member.manager
        rec = records[gid]
        deadline = time.monotonic() + deadline_s
        prev_fired: Dict[str, int] = {}
        armed_for = -1
        reduce = reducer(manager)
        width = 0
        try:
            while time.monotonic() < deadline:
                attempted = manager.current_step()
                if _done(attempted, loop_steps, width, groups):
                    break
                if attempted >= loop_steps:
                    time.sleep(PACE_S)
                if gid == 0 and attempted != armed_for:
                    # Arm each attempted step's events exactly once (a
                    # discarded step retries at the same step); the
                    # deltas since the last arm belong to the window
                    # just closed.
                    stats = _native.fault_stats()
                    with window_lock:
                        for key, count in stats.get("fired", {}).items():
                            delta = count - prev_fired.get(key, 0)
                            if delta > 0:
                                fired_by_window.setdefault(
                                    armed_for, {})[key] = delta
                        prev_fired = dict(stats.get("fired", {}))
                    injector.begin_step(attempted)
                    armed_for = attempted
                width = _attempt(member, box, rec, attempted, reduce,
                                 lambda: trees[gid].grads(gid, attempted))
            rec.final_digest = _digest(box["params"])
            rec.alive = True
        finally:
            member.shutdown()

    wall_s = _run_threads(member_main, groups, "chaos_g", deadline_s + 30)
    stats = injector.finish()
    lighthouse.shutdown()

    survivors = [r for r in records if r.alive]
    assert survivors, f"no member finished ({repro})"

    # 0. SHM LEAK ORACLE (hier_shm fleets)
    if host_label:
        live = _native.shm_live_count()
        assert live == shm_base, (
            f"shm segment handles leaked after the chaos round: "
            f"{live - shm_base} live above baseline ({repro})"
        )

    # 1. EPOCH PURITY: monotone per member; mixed epochs at a step only
    # next to a quorum transition (a lagging member re-committing).
    _check_monotone(survivors, repro)
    for step in sorted(set().union(*(set(r.commits) for r in survivors))):
        qids = {r.commits[step] for r in survivors if step in r.commits}
        if len(qids) <= 1:
            continue
        near_churn = any(
            r.commits.get(step - 1) is None
            or r.commits.get(step + 1) is None
            or r.commits.get(step - 1) != r.commits.get(step + 1)
            for r in survivors
        )
        assert near_churn, (
            f"step {step} committed under mixed quorum epochs {qids} "
            f"with no adjacent quorum transition (commit maps: "
            f"{[r.commits for r in records]}, {repro})"
        )

    # 2. BIT IDENTITY
    _check_bit_identity(survivors, repro)

    # 3. DETECTION: every window with a corrupting injection has a
    # discarded step within one step of it; with CRC on, a typed
    # detection was observed.
    corrupt_windows = [
        w for w, by in fired_by_window.items()
        if any(key.split(":")[1] in CORRUPTING_KINDS for key in by)
    ]
    all_discards = set().union(*(set(r.discards) for r in records))
    silent = [w for w in corrupt_windows
              if not ({w - 1, w, w + 1} & all_discards)]
    assert not silent, (
        f"corrupting faults in windows {silent} committed silently "
        f"(discards={sorted(all_discards)}, fired={fired_by_window}, "
        f"{repro})"
    )
    total_corrupt_fired = sum(
        count for by in fired_by_window.values()
        for key, count in by.items() if key.split(":")[1] in CORRUPTING_KINDS
    )
    crc_detections = sum(r.crc_detections for r in records)
    desync_detections = sum(r.desync_detections for r in records)
    if crc and total_corrupt_fired:
        assert crc_detections + desync_detections >= 1, (
            f"{total_corrupt_fired} corrupting fault(s) fired but no "
            f"integrity/desync detection was observed ({repro})"
        )

    # 4. LIVENESS: a clean commit after the last fault step.
    post_fault_commits = [
        s for r in survivors for s in r.commits if s > last_fault_step
    ]
    assert post_fault_commits or not plan.events, (
        f"no clean commit after the last fault step {last_fault_step} "
        f"within {deadline_s:.0f}s (commits="
        f"{[sorted(r.commits) for r in records]}, discards="
        f"{[sorted(set(r.discards)) for r in records]}, errors="
        f"{[r.errors[-2:] for r in records]}, {repro})"
    )

    return {
        "config": config,
        "seed": seed,
        "groups": groups,
        "steps": steps,
        "crc": crc,
        "tree": tree,
        "wire": wire,
        "device": str(dev),
        "plan": json.loads(plan.to_json()),
        "wall_s": round(wall_s, 3),
        "faults_fired": stats.get("fired", {}),
        "faults_fired_total": stats.get("fired_total", 0),
        "python_faults": stats.get("python_fired", []),
        "commits_per_member": [len(r.commits) for r in records],
        "discards_per_member": [len(r.discards) for r in records],
        "crc_detections": crc_detections,
        "desync_detections": desync_detections,
        "corrupting_faults_fired": total_corrupt_fired,
        "final_digest": survivors[0].final_digest,
        "silent_commits": 0,
        "liveness_ok": True,
        "epoch_purity_ok": True,
        "bit_identity_ok": True,
        # this process's launches while the schedule ran (in a full or
        # dry run, the side schedules' too)
        "launches": _launches_since(before),
    }


# -- root-outage schedule (durable control plane) ----------------------------


def run_root_outage(
    seed: int,
    groups: int = 3,
    steps: int = 10,
    plan: Optional[FaultPlan] = None,
    deadline_s: float = 240.0,
    device: Any = None,
    tree: str = "vector",
) -> dict:
    """A seeded ROOT-OUTAGE schedule: the managers point at a
    two-endpoint root failover set (primary + warm standby, both WAL'd
    subprocesses on fixed ports) while root faults fire (SIGKILL the
    active root, restart a dead one on its WAL, SIGSTOP partitions).
    Asserts quorum_id monotone across root epochs, zero split-brain
    (bit-identical survivors), a commit after the last root fault by
    managers that were never restarted, and a WAL replay by every
    scheduled restart."""
    from torchft_tpu_torch.chaos import RootProcess, free_port

    dev = resolve_device(device)
    if plan is None:
        plan = FaultPlan.random(
            seed, steps=steps, members=1, seams=("root",), events_target=3
        )
    repro = (f"replay: --config root_outage --seed {seed} --tree {tree} "
             f"--plan '{plan.to_json()}'")
    # the JAX harness's outage members carry 2048 elements
    trees = [Tree(tree, dev, elems=2048, seed=seed) for _ in range(groups)]
    injector = ChaosInjector(plan)
    wal_dirs = [tempfile.mkdtemp(prefix="tft_wal_") for _ in range(2)]
    ports = [free_port(), free_port()]
    addrs = [f"http://localhost:{p}" for p in ports]
    roots = [
        RootProcess(
            ports[0], wal_dir=wal_dirs[0], peers=addrs[1],
            takeover_ms=1500, heartbeat_timeout_ms=4000,
            join_timeout_ms=JOIN_TIMEOUT_MS[tree],
        ),
        RootProcess(
            ports[1], wal_dir=wal_dirs[1], peers=addrs[0], standby=True,
            takeover_ms=1500, heartbeat_timeout_ms=4000,
            join_timeout_ms=JOIN_TIMEOUT_MS[tree],
        ),
    ]
    records = [_MemberRecord() for _ in range(groups)]
    stop_flag = threading.Event()
    monitor_rounds: List[dict] = []
    wal_replays_seen = 0
    monitor_lock = threading.Lock()
    # the seconds from each root kill to the next commit, and from a
    # kill to an endpoint reporting active again (the takeover)
    fault_times: List[Tuple[str, float]] = []

    def monitor() -> None:
        nonlocal wal_replays_seen
        while not stop_flag.is_set():
            round_rec: Dict[str, Any] = {"t": time.monotonic(), "active": []}
            for i, r in enumerate(roots):
                st = r.status(timeout=1.0)
                if st is None:
                    continue
                if st.get("wal_replayed") and r.restarts > 0:
                    with monitor_lock:
                        wal_replays_seen += 1
                if st.get("active"):
                    round_rec["active"].append({
                        "endpoint": i,
                        "root_epoch": st.get("root_epoch", 0),
                        "quorum_id": st.get("quorum_id", 0),
                    })
            monitor_rounds.append(round_rec)
            stop_flag.wait(0.1)

    def on_root_fault(e: FaultEvent) -> None:
        # Resolve the target NOW: kill/partition hit the active root,
        # restart revives a dead one (replay + fencing).
        def active_root() -> RootProcess:
            for r in roots:
                st = r.status(timeout=1.0)
                if st is not None and st.get("active"):
                    return r
            return roots[0]

        fault_times.append((e.kind, time.monotonic()))
        if e.kind == "kill":
            active_root().kill()
        elif e.kind == "restart":
            dead = [r for r in roots
                    if r.proc is None or r.proc.poll() is not None]
            (dead[0] if dead else active_root()).restart()
        elif e.kind == "partition":
            active_root().partition(max(0.3, e.param / 1000.0))

    injector.on("root", on_root_fault)
    last_fault_step = max((e.step for e in plan.events), default=0)
    loop_steps = max(steps, last_fault_step + 3)
    commit_times: List[float] = []

    start = threading.Barrier(groups)

    def member_main(gid: int) -> None:
        # The failover SET, not one endpoint: rotation on renewal failure
        # carries the fleet across the outages.
        member, box = _params_member(
            trees[gid], ",".join(addrs), f"outage_{gid}",
            max(1, groups - 1), crc=None,
            quorum_timeout_s=OP_TIMEOUT_S * 5,
        )
        _start_together(start)
        manager = member.manager
        rec = records[gid]
        deadline = time.monotonic() + deadline_s
        armed_for = -1
        width = 0
        try:
            while not stop_flag.is_set() and time.monotonic() < deadline:
                attempted = manager.current_step()
                if _done(attempted, loop_steps, width, groups):
                    break
                if attempted >= loop_steps:
                    time.sleep(PACE_S)
                if gid == 0 and attempted != armed_for:
                    injector.begin_step(attempted)
                    armed_for = attempted
                n = len(rec.commits)
                width = _attempt(member, box, rec, attempted,
                                 manager.allreduce,
                                 lambda: trees[gid].grads(gid, attempted))
                if gid == 0 and len(rec.commits) > n:
                    commit_times.append(time.monotonic())
            rec.final_digest = _digest(box["params"])
            rec.alive = True
        finally:
            member.shutdown()

    try:
        for r in roots:
            r.wait_serving()
        mon_thread = threading.Thread(target=monitor, name="root_monitor")
        mon_thread.start()
        try:
            wall_s = _run_threads(member_main, groups, "outage_g",
                                  deadline_s + 60)
        finally:
            stop_flag.set()
            mon_thread.join(10)
        stats = injector.finish()
        total_restarts = sum(r.restarts for r in roots)
        # Final sweep: a root restarted late may still be booting when
        # the loop drains; read its replay stamp directly.
        restarted_status = []
        for r in roots:
            if r.restarts == 0:
                continue
            try:
                st = r.wait_serving(deadline_s=20)
            except TimeoutError:
                continue
            restarted_status.append({
                "endpoint": r.address(),
                "wal_replayed": st.get("wal_replayed", False),
                "root_epoch": st.get("root_epoch", 0),
                "quorum_id": st.get("quorum_id", 0),
                "active": st.get("active", False),
            })
            if st.get("wal_replayed"):
                wal_replays_seen += 1
    finally:
        for r in roots:
            r.stop()
        for d in wal_dirs:
            shutil.rmtree(d, ignore_errors=True)

    survivors = [r for r in records if r.alive]
    assert survivors, f"no member finished ({repro})"

    # 1a. quorum_id monotone across root epochs (the active roots' view)
    max_qid = max_epoch = -1
    dual_active_rounds = 0
    for round_rec in monitor_rounds:
        actives = round_rec["active"]
        if len(actives) > 1:
            dual_active_rounds += 1
        if not actives:
            continue
        qid = max(a["quorum_id"] for a in actives)
        epoch = max(a["root_epoch"] for a in actives)
        assert qid >= max_qid, (
            f"active-root quorum_id REGRESSED {max_qid} -> {qid} at "
            f"epoch {epoch} (prev max epoch {max_epoch}) ({repro})"
        )
        max_qid = max(max_qid, qid)
        max_epoch = max(max_epoch, epoch)
    # 1b. per-member committed epoch maps stay monotone
    _check_monotone(survivors, repro)
    # 2. zero split-brain: survivors bit-identical
    _check_bit_identity(survivors, repro)
    # 3. a commit after the last root fault, by managers never restarted
    post = [s for r in survivors for s in r.commits if s > last_fault_step]
    assert post or not plan.events, (
        f"no commit after the last root fault step {last_fault_step} "
        f"(commits={[sorted(r.commits) for r in records]}, "
        f"errors={[r.errors[-2:] for r in records]}, {repro})"
    )
    # 4. at least one restart replayed its WAL (when one was scheduled)
    if any(e.kind == "restart" for e in plan.events):
        assert total_restarts >= 1 and wal_replays_seen >= 1, (
            f"scheduled root restart never replayed a WAL "
            f"(restarts={total_restarts}, replays={wal_replays_seen}, "
            f"{repro})"
        )

    def takeover_s(t_kill: float) -> Optional[float]:
        for round_rec in monitor_rounds:
            if round_rec["t"] > t_kill and round_rec["active"]:
                return round(round_rec["t"] - t_kill, 3)
        return None

    kills = [t for kind, t in fault_times if kind == "kill"]
    return {
        "config": "root_outage",
        "seed": seed,
        "groups": groups,
        "tree": tree,
        "device": str(dev),
        "plan": json.loads(plan.to_json()),
        "wall_s": round(wall_s, 3),
        "python_faults": stats.get("python_fired", []),
        "root_restarts": total_restarts,
        "restarted_status": restarted_status,
        "root_epochs_seen": sorted({a["root_epoch"] for rr in monitor_rounds
                                    for a in rr["active"]}),
        "max_active_quorum_id": max_qid,
        "wal_replays_seen": wal_replays_seen,
        "dual_active_rounds": dual_active_rounds,
        "kill_to_next_commit_s": [
            round(min((c for c in commit_times if c > t), default=t) - t, 3)
            for t in kills],
        "takeover_s": [takeover_s(t) for t in kills],
        "commits_per_member": [len(r.commits) for r in records],
        "discards_per_member": [len(r.discards) for r in records],
        "final_digest": survivors[0].final_digest,
        "quorum_id_monotone": True,
        "split_brain": 0,
        "manager_restarts": 0,
        "liveness_ok": True,
        "epoch_purity_ok": True,
        "bit_identity_ok": True,
    }


# -- SIGKILL vs SIGSTOP isolated-child probes --------------------------------


def _iso_probe(kind: str, device: Any = None) -> dict:
    """Kills (or SIGSTOPs) one isolated child mid-collective and measures
    fault -> error surfaced -> reconfigure -> next clean commit. Both
    kinds must produce the SAME key set: the stall path recovers exactly
    like the kill path."""
    from torchft_tpu_torch.isolated_xla import (
        ChildStalledError,
        IsolatedXLACollectives,
    )

    dev = resolve_device(device)
    store = Store()
    cols = [IsolatedXLACollectives(timeout=timedelta(seconds=8),
                                   connect_timeout=timedelta(seconds=30))
            for _ in range(2)]

    def configure(prefix: str) -> None:
        ts = [threading.Thread(target=cols[r].configure,
                               args=(f"{store.address()}/{prefix}", r, 2))
              for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    def sync_all() -> List[Optional[Exception]]:
        errs: List[Optional[Exception]] = [None, None]

        def do(r: int) -> None:
            try:
                cols[r].allreduce(
                    {"w": torch.ones(64, dtype=torch.float32, device=dev)}
                ).wait()
            except Exception as e:  # noqa: BLE001
                errs[r] = e

        ts = [threading.Thread(target=do, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return errs

    try:
        configure("cp0")
        errs = sync_all()
        assert all(e is None for e in errs), f"probe warmup failed: {errs}"
        victim = cols[0]._child.pid  # noqa: SLF001 - the probe IS the fault
        t_fault = time.monotonic()
        os.kill(victim, signal.SIGKILL if kind == "sigkill" else signal.SIGSTOP)
        errs = sync_all()
        surface_s = time.monotonic() - t_fault
        verdicts = [type(e).__name__ for e in errs if e is not None]
        assert verdicts, f"{kind}: fault never surfaced"
        stalled = any(isinstance(e, ChildStalledError) for e in errs if e)
        if kind == "sigstop":
            assert stalled, (
                f"SIGSTOP surfaced as {verdicts}, not a stall verdict")
            try:
                os.kill(victim, signal.SIGCONT)
            except ProcessLookupError:
                pass  # the stall verdict SIGKILLed and reaped it first (D8)
        t0 = time.monotonic()
        configure("cp1")
        reconfigure_s = time.monotonic() - t0
        t0 = time.monotonic()
        errs = sync_all()
        next_commit_s = time.monotonic() - t0
        recovered = all(e is None for e in errs)
    finally:
        for c in cols:
            c.shutdown()
        store.shutdown()
    return {
        "kind": kind,
        "surface_s": round(surface_s, 3),
        "verdict": "ChildStalledError" if stalled else verdicts[0],
        "stall_verdict": stalled,
        "reconfigure_s": round(reconfigure_s, 3),
        "next_commit_s": round(next_commit_s, 3),
        "recovered": recovered,
    }


def run_iso_probes(device: Any = None) -> List[dict]:
    kill = _iso_probe("sigkill", device)
    stall = _iso_probe("sigstop", device)
    assert set(kill) == set(stall), (
        "SIGSTOP recovery breakdown keys diverge from the SIGKILL path: "
        f"{sorted(set(kill) ^ set(stall))}"
    )
    assert stall["stall_verdict"] and stall["recovered"]
    assert kill["recovered"]
    return [kill, stall]


# -- CRC hot-path overhead ---------------------------------------------------


def run_crc_overhead(steps: int = 12, elems: int = 1 << 19,
                     device: Any = None) -> dict:
    """Planned-path steps/s with the wire CRC on vs off over a 2-member
    thread ring under a per-connection cap (TORCHFT_HC_WIRE_CAP_MBPS=12);
    the acceptance bound is on/off within 3%."""
    dev = resolve_device(device)
    os.environ["TORCHFT_HC_WIRE_CAP_MBPS"] = "12"
    results = {}
    store = Store()
    try:
        for label, crc in (("off", False), ("on", True)):
            cols = [HostCollectives(timeout=timedelta(seconds=60), stripes=1,
                                    wire_crc=crc) for _ in range(2)]
            ts = [threading.Thread(
                target=cols[r].configure,
                args=(f"{store.address()}/crc_{label}", r, 2))
                for r in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            trees = [{"w": torch.ones(elems, dtype=torch.float32, device=dev)}
                     for _ in range(2)]
            rates: List[float] = [0.0, 0.0]

            def member(r: int) -> None:
                for _ in range(2):  # warmup
                    cols[r].plan_allreduce(dict(trees[r])).wait()
                t0 = time.perf_counter()
                for _ in range(steps):
                    cols[r].plan_allreduce(dict(trees[r])).wait()
                rates[r] = steps / (time.perf_counter() - t0)

            _run_threads(member, 2, "crc_r", 300)
            results[label] = min(rates)
            for c in cols:
                c.shutdown()
    finally:
        store.shutdown()
        os.environ.pop("TORCHFT_HC_WIRE_CAP_MBPS", None)
    overhead = 1.0 - results["on"] / results["off"]
    return {
        "payload_bytes": elems * 4,
        "steps": steps,
        "cap_mbps": 12,
        "device": str(dev),
        "steps_per_s_off": round(results["off"], 3),
        "steps_per_s_on": round(results["on"], 3),
        "overhead_frac": round(overhead, 4),
        "within_3pct": overhead <= 0.03,
    }


# -- policy-engine configuration ---------------------------------------------


def run_policy_schedule(seed: int, deadline_s: float = 240.0,
                        device: Any = None, tree: str = "vector") -> dict:
    """A seeded ring-fault schedule under the POLICY ENGINE (2 groups,
    real TCP ring): asserts liveness and final bit-identity while native
    ring faults fire."""
    from torchft_tpu_torch.policy import CostKnobs, PolicyEngine
    from torchft_tpu_torch.train_state import SGD, FTTrainState

    dev = resolve_device(device)
    plan = FaultPlan.random(
        seed, steps=12, members=2, seams=("ring_send",), events_target=2
    )
    injector = ChaosInjector(plan)
    repro = (f"replay: --config policy --seed {seed} --tree {tree} "
             f"--plan '{plan.to_json()}'")
    lighthouse = Lighthouse(
        bind="[::]:0", min_replicas=2, join_timeout_ms=JOIN_TIMEOUT_MS[tree],
        quorum_tick_ms=50, heartbeat_timeout_ms=4000,
    )
    digests: List[Optional[str]] = [None, None]
    committed: List[int] = [0, 0]
    errors: List[List[str]] = [[], []]

    def member(gid: int) -> None:
        t = Tree(tree, dev, elems=2048, seed=seed)
        params = t.params(0.0) if tree == "vector" else t.params()
        state = FTTrainState(params, SGD(0.05))
        x = torch.ones(2048, dtype=torch.float32, device=dev)

        def grad_fn(p: Any, tick: int) -> Tuple[Any, Any]:
            if tree == "vector":
                # the gradient of mean((w - x)^2)
                d = p["w"] - x
                return (d * d).mean(), {"w": d * (2.0 / d.numel())}
            return torch.zeros((), device=dev), t.grads(0, tick)

        box: Dict[str, Any] = {}
        m = _Member(lighthouse.address(), f"chaos_pol_{gid}", dev,
                    lambda: box["p"].state_dict(),
                    lambda s: box["p"].load_state_dict(s), 2)
        try:
            box["p"] = PolicyEngine(
                m.manager, state, grad_fn, outer_tx=SGD(0.7),
                decide_every=4,
                knobs=CostKnobs(staleness_weight=0.0, sync_fixed_s=0.002,
                                hysteresis=0.1, surface_s=1.0),
            )
            deadline = time.monotonic() + deadline_s
            tick = 0
            while time.monotonic() < deadline and tick < 12:
                if gid == 0:
                    injector.begin_step(tick)
                try:
                    box["p"].step(tick)
                except Exception as e:  # noqa: BLE001
                    errors[gid].append(f"{type(e).__name__}: {e}")
                tick += 1
            committed[gid] = m.manager.batches_committed()
            digests[gid] = _digest(dict(_flat_items(state.params)))
        finally:
            m.shutdown()

    _run_threads(member, 2, "policy_g", deadline_s + 30)
    stats = injector.finish()
    lighthouse.shutdown()
    assert digests[0] is not None and digests[1] is not None, (
        f"policy fleet did not finish ({repro})"
    )
    assert digests[0] == digests[1], f"policy groups diverged ({repro})"
    assert min(committed) > 0, f"policy fleet never committed ({repro})"
    return {
        "config": "policy",
        "seed": seed,
        "tree": tree,
        "device": str(dev),
        "plan": json.loads(plan.to_json()),
        "faults_fired": stats.get("fired", {}),
        "batches_committed": committed,
        "errors": [e[-2:] for e in errors],
        "final_digest": digests[0],
        "bit_identity_ok": True,
        "liveness_ok": True,
    }


# -- per-step ZeRO re-partition ----------------------------------------------


def run_sharded_reshard(seed: int, deadline_s: float = 180.0,
                        device: Any = None, tree: str = "vector") -> dict:
    """The per-step ZeRO data plane under a mid-reduce-scatter death: 3
    groups run ShardedOptimizerWrapper steps; at the death step a seeded
    ring partition fires on the victim and the victim leaves without
    voting, the vote discards the step, the quorum shrinks to 2, the
    optimizer shards RE-PARTITION (each survivor's shard grows from ~1/3
    to ~1/2), and the next step commits bit-identically."""
    from torchft_tpu_torch.optim import ShardedOptimizerWrapper
    from torchft_tpu_torch.train_state import SGD, FTTrainState

    dev = resolve_device(device)
    groups, victim, death_step, loop_steps = 3, 2, 3, 8
    plan = FaultPlan(seed=seed, events=(
        FaultEvent(step=death_step, seam="ring_send", kind="partition",
                   member=victim),
    ))
    injector = ChaosInjector(plan)
    repro = (f"replay: --config sharded_reshard --seed {seed} --tree {tree} "
             f"--plan '{plan.to_json()}'")
    lighthouse = Lighthouse(
        bind="[::]:0", min_replicas=1, join_timeout_ms=JOIN_TIMEOUT_MS[tree],
        quorum_tick_ms=50, heartbeat_timeout_ms=4000,
    )
    records = [_MemberRecord() for _ in range(groups)]
    reshards: List[List[Tuple[int, int, int]]] = [[] for _ in range(groups)]
    start = threading.Barrier(groups)

    def member_main(gid: int) -> None:
        t = Tree(tree, dev, seed=seed)
        # the wrapper owns the ~1/W optimizer shard
        state = FTTrainState(t.params(), SGD(0.05, momentum=0.9),
                             opt_state=())
        box: Dict[str, Any] = {}
        m = _Member(lighthouse.address(), f"chaos_zero_{gid}", dev,
                    lambda: box["w"].state_dict(),
                    lambda s: box["w"].load_state_dict(s), groups - 1)
        manager = m.manager
        wrapper = box["w"] = ShardedOptimizerWrapper(manager, state,
                                                     shard_wire="q8")
        _start_together(start)
        rec = records[gid]
        deadline = time.monotonic() + deadline_s
        armed_for = -1
        last_shard: Optional[Tuple[int, int]] = None
        try:
            while time.monotonic() < deadline:
                attempted = manager.current_step()
                if attempted >= loop_steps:
                    break
                if gid == 0 and attempted != armed_for:
                    injector.begin_step(attempted)
                    armed_for = attempted
                err: Optional[Exception] = None
                try:
                    wrapper.zero_grad()
                    if wrapper.step(t.grads(gid, attempted)):
                        rec.commits[attempted] = manager.quorum_id()
                        meta = wrapper._core._shard_meta  # noqa: SLF001
                        shard_sig = (meta["quorum_id"],
                                     wrapper.opt_state_bytes())
                        if shard_sig != last_shard:
                            # a (re-)partition landed this step
                            reshards[gid].append((attempted,) + shard_sig)
                            last_shard = shard_sig
                    else:
                        err = manager.errored()
                        rec.discards.append(attempted)
                except Exception as e:  # noqa: BLE001 - chaos surfaces here
                    err = e
                    _vote_down(manager, e)
                    rec.discards.append(attempted)
                _classify(rec, err)
                if gid == victim and attempted >= death_step:
                    # the armed partition broke this member's
                    # reduce-scatter; it leaves the ring for good here
                    break
            rec.final_digest = _digest(dict(_flat_items(state.params)))
            rec.alive = gid != victim
        finally:
            m.shutdown()

    wall_s = _run_threads(member_main, groups, "zero_g", deadline_s + 30)
    stats = injector.finish()
    lighthouse.shutdown()

    survivors = [g for g in range(groups) if g != victim]
    for g in survivors:
        assert records[g].final_digest is not None, (
            f"survivor {g} did not finish ({repro})")
    # 1. the death window discarded on some survivor
    all_discards = set().union(*(set(records[g].discards) for g in survivors))
    assert {death_step - 1, death_step, death_step + 1} & all_discards, (
        f"no survivor discarded around the death step {death_step} "
        f"(discards={sorted(all_discards)}, {repro})"
    )
    # 2. RESHARD: every survivor re-partitioned after the death, under a
    # higher quorum id, with a bigger resident shard than its last
    # partition before it (~1/3 of the model -> ~1/2). Held against the
    # last pre-death partition, not the first: a member that joins the
    # fleet late makes the first quorum one of two.
    for g in survivors:
        pre = [r for r in reshards[g] if r[0] < death_step]
        post = [r for r in reshards[g] if r[0] >= death_step]
        assert pre and post, (
            f"survivor {g} never re-partitioned (reshards={reshards[g]}, "
            f"{repro})")
        _, pre_qid, pre_bytes = pre[-1]
        _, post_qid, post_bytes = post[-1]
        assert post_qid > pre_qid, (
            f"survivor {g}'s re-partition did not follow the quorum "
            f"change (reshards={reshards[g]}, {repro})")
        assert post_bytes > pre_bytes, (
            f"survivor {g}'s shard did not grow when W shrank 3->2 "
            f"(reshards={reshards[g]}, {repro})")
    # 3. LIVENESS on every survivor
    for g in survivors:
        assert any(s > death_step for s in records[g].commits), (
            f"survivor {g} never committed after the death "
            f"(commits={sorted(records[g].commits)}, {repro})")
    # 4. EPOCH PURITY + BIT IDENTITY across survivors
    _check_monotone([records[g] for g in survivors], repro)
    _check_bit_identity([records[g] for g in survivors], repro)
    return {
        "config": "sharded_reshard",
        "seed": seed,
        "groups": groups,
        "victim": victim,
        "death_step": death_step,
        "tree": tree,
        "device": str(dev),
        "plan": json.loads(plan.to_json()),
        "wall_s": round(wall_s, 3),
        "faults_fired": stats.get("fired", {}),
        "commits_per_member": [len(r.commits) for r in records],
        "discards_per_member": [len(r.discards) for r in records],
        "reshards_per_member": [[list(t) for t in reshards[g]]
                                for g in range(groups)],
        "final_digest": records[survivors[0]].final_digest,
        "resharded": True,
        "liveness_ok": True,
        "epoch_purity_ok": True,
        "bit_identity_ok": True,
    }


# -- whole-fleet loss (durable checkpoint tier) ------------------------------


def fleet_member_main(argv: List[str]) -> int:
    """One fleet-loss member, run as a SIGKILL-able subprocess. Phase 1
    trains with async durable snapshots until killed; phase 2 cold-starts
    with no donor anywhere, restores from the durable tier and commits a
    few more steps. Records go to ``--out`` as atomically renamed JSON
    files the parent asserts over."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--fleet-member", action="store_true")
    parser.add_argument("--root", required=True)
    parser.add_argument("--dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--gid", type=int, required=True)
    parser.add_argument("--groups", type=int, required=True)
    parser.add_argument("--phase", type=int, required=True)
    parser.add_argument("--extra-steps", type=int, default=2)
    parser.add_argument("--device", default=None)
    parser.add_argument("--tree", default="vector", choices=TREES)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--go-file", default=None,
                        help="start only once this file exists (a cold "
                        "member started ahead of the fault)")
    args = parser.parse_args(argv)

    from torchft_tpu_torch.durable import DurableCheckpointer

    dev = resolve_device(args.device)
    t = Tree(args.tree, dev, seed=args.seed)
    if args.go_file:
        gate = time.monotonic() + 600.0
        while not os.path.exists(args.go_file):
            if time.monotonic() > gate:
                return 3
            time.sleep(0.05)

    def emit(name: str, payload: dict) -> None:
        path = os.path.join(args.out, name)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    box = {"params": t.params()}

    class _State:
        def state_dict(self) -> dict:
            return {"params": dict(box["params"])}

        def load_state_dict(self, sd: dict) -> None:
            box["params"] = t.load(sd["params"])

    state = _State()
    # Full-width quorum only: every committed step's snapshot set tiles
    # all W members, so any commit record is fleet-restorable.
    m = _Member(args.root, f"fleet_{args.gid}", dev, state.state_dict,
                state.load_state_dict, args.groups,
                quorum_timeout_s=OP_TIMEOUT_S * 5)
    manager = m.manager
    ckpt = DurableCheckpointer(args.dir, manager, state, every=1, keep=10,
                               mode="async", device=dev)
    result: Dict[str, Any] = {"gid": args.gid, "phase": args.phase,
                              "commits": []}
    try:
        restored = ckpt.restore_latest()
        if args.phase == 2:
            result["restored_step"] = restored
            result["restored_digest"] = _digest(box["params"])
        stop_at = ((restored or 0) + args.extra_steps if args.phase == 2
                   else 1 << 30)
        deadline = time.monotonic() + 150.0
        while time.monotonic() < deadline:
            step = manager.current_step()
            if step >= stop_at:
                break
            try:
                manager.start_quorum()
                # identical on every member: both phases replay the same
                # trajectory
                avg = manager.allreduce(t.grads(0, step)).wait()
                if manager.should_commit() and avg is not None:
                    box["params"] = apply_update(box["params"], avg)
                    committed = manager.current_step()
                    ckpt.maybe_save()
                    result["commits"].append(committed)
                    if args.phase == 1:
                        emit(f"p1_g{args.gid}_s{committed:06d}.json", {
                            "step": committed,
                            "digest": _digest(box["params"]),
                            "quorum_id": manager.quorum_id(),
                        })
            except Exception as e:  # noqa: BLE001 - keep the loop alive
                _vote_down(manager, e)
        if args.phase == 2:
            if not ckpt.flush(30):
                result["flush_timeout"] = True
            result["final_step"] = manager.current_step()
            result["final_digest"] = _digest(box["params"])
            result["launches"] = dict(launch_counts)
            emit(f"p2_g{args.gid}.json", result)
    finally:
        try:
            ckpt.close()
        except Exception:  # noqa: BLE001
            pass
        m.shutdown()
    return 0


def run_fleet_loss(groups: int = 3, deadline_s: float = 240.0,
                   device: Any = None, tree: str = "vector",
                   seed: int = 0) -> dict:
    """WHOLE-FLEET LOSS: SIGKILL every member AND the root mid-step, tear
    the manifest inside its last record, cold-restart the fleet with no
    live donor. Asserts the resume comes from the newest surviving
    COMMITTED manifest (never the torn one), bit-identical to the
    pre-kill fleet at that step, and that the restored fleet commits on
    and stays bit-identical."""
    from torchft_tpu_torch.chaos import RootProcess, free_port, kill_process
    from torchft_tpu_torch.durable import _FRAME, LocalDirStore, ManifestLog

    dev = resolve_device(device)
    durable_dir = tempfile.mkdtemp(prefix="tft_fleet_ckpt_")
    out_dir = tempfile.mkdtemp(prefix="tft_fleet_out_")
    repro = (f"replay: --config fleet_loss --tree {tree} "
             f"(durable tier chaos, W={groups})")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")

    go_file = os.path.join(out_dir, "phase2.go")

    def spawn_members(root_addr: str, phase: int) -> List[Any]:
        gate = ["--go-file", go_file] if phase == 2 else []
        return [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fleet-member",
             "--root", root_addr, "--dir", durable_dir, "--out", out_dir,
             "--gid", str(g), "--groups", str(groups), "--phase", str(phase),
             "--device", str(dev), "--tree", tree, "--seed", str(seed),
             *gate], env=env) for g in range(groups)]

    manifest = ManifestLog(LocalDirStore(durable_dir))
    t0 = time.monotonic()
    # The cold fleet's root and processes start now, beside the first
    # fleet (a process start is seconds); the members wait on the go
    # file, written once the fault is in place, before they touch the
    # durable tier or the root.
    root, root2 = (RootProcess(free_port(), min_replicas=groups,
                               join_timeout_ms=JOIN_TIMEOUT_MS[tree],
                               heartbeat_timeout_ms=4000) for _ in range(2))
    procs: List[Any] = []
    procs2: List[Any] = []
    try:
        root.wait_serving()
        procs = spawn_members(root.address(), phase=1)
        procs2 = spawn_members(root2.address(), phase=2)
        # Phase 1 runs until >= 3 committed sets exist (>= 2 must survive
        # the tear below), then dies mid-step.
        poll_deadline = time.monotonic() + deadline_s
        while True:
            records, _ = manifest.replay()
            commits = [r for r in records if r.get("t") == "commit"]
            if len(commits) >= 3:
                break
            dead = [p for p in procs + procs2 if p.poll() is not None]
            assert not dead and time.monotonic() < poll_deadline, (
                f"phase-1 fleet never produced 3 committed manifests "
                f"(commits={len(commits)}, exited="
                f"{[p.returncode for p in dead]}, {repro})"
            )
            time.sleep(0.1)
        # THE FAULT: SIGKILL the whole fleet and its root mid-step.
        t_kill = time.monotonic()
        for p in procs:
            kill_process(p.pid)
        root.kill()
        for p in procs:
            p.wait(timeout=20)

        # THE TORN SEAM: truncate the manifest inside its last intact
        # record (frame-walk for the real boundary).
        mpath = os.path.join(durable_dir, "MANIFEST.log")
        with open(mpath, "rb") as f:
            raw = f.read()
        pos, frames = 0, []
        while pos + _FRAME.size <= len(raw):
            ln, _crc = _FRAME.unpack_from(raw, pos)
            if pos + _FRAME.size + ln > len(raw):
                break  # a natural torn tail from the SIGKILL itself
            frames.append((pos, pos + _FRAME.size + ln))
            pos = pos + _FRAME.size + ln
        assert len(frames) >= 3, f"too few intact records ({repro})"
        last_begin, last_end = frames[-1]
        torn_rec = json.loads(raw[last_begin + _FRAME.size:last_end])
        cut = last_begin + _FRAME.size + max(1, (last_end - last_begin) // 3)
        with open(mpath, "r+b") as f:
            f.truncate(cut)
        surviving = [json.loads(raw[b + _FRAME.size:e]) for b, e in frames[:-1]]
        retired = {r["dir"] for r in surviving if r.get("t") == "retire"}
        expect_step = max(int(r["step"]) for r in surviving
                          if r.get("t") == "commit" and r["dir"] not in retired)
        torn_step = (int(torn_rec["step"]) if torn_rec.get("t") == "commit"
                     else None)
        phase1_digests: Dict[int, set] = {}
        for fname in os.listdir(out_dir):
            if fname.startswith("p1_") and fname.endswith(".json"):
                with open(os.path.join(out_dir, fname)) as f:
                    rec = json.load(f)
                phase1_digests.setdefault(rec["step"], set()).add(rec["digest"])

        # Phase 2: cold fleet, fresh root, fresh processes, no donor.
        root2.wait_serving()
        with open(go_file, "w"):
            pass
        for p in procs2:
            p.wait(timeout=deadline_s)
            assert p.returncode == 0, (
                f"phase-2 member exited {p.returncode} ({repro})")
        restore_s = time.monotonic() - t_kill
        results = []
        for g in range(groups):
            path = os.path.join(out_dir, f"p2_g{g}.json")
            assert os.path.exists(path), (
                f"phase-2 member {g} left no result ({repro})")
            with open(path) as f:
                results.append(json.load(f))

        # 1+2. the newest COMMITTED manifest wins; the torn record never
        for r in results:
            assert r["restored_step"] == expect_step, (
                f"member {r['gid']} resumed from step {r['restored_step']}, "
                f"expected newest surviving commit {expect_step} "
                f"(torn record step={torn_step}, {repro})")
            if torn_step is not None and torn_step != expect_step:
                assert r["restored_step"] != torn_step, (
                    f"TORN manifest record won the restore ({repro})")
        # 3. bit identity with the phase-1 fleet at that step
        restored_digests = {r["restored_digest"] for r in results}
        assert len(restored_digests) == 1, (
            f"cold members restored diverged state {restored_digests} "
            f"({repro})")
        assert phase1_digests.get(expect_step) == restored_digests, (
            f"restored digest differs from the phase-1 fleet's at step "
            f"{expect_step}: {phase1_digests.get(expect_step)} vs "
            f"{restored_digests} ({repro})")
        # 4. liveness + post-resume identity
        for r in results:
            assert r["final_step"] > expect_step and r["commits"], (
                f"member {r['gid']} never committed after the cold restore "
                f"(final={r['final_step']}, {repro})")
        final_digests = {r["final_digest"] for r in results}
        assert len(final_digests) == 1, (
            f"cold fleet diverged after resume {final_digests} ({repro})")
        launches: Dict[str, int] = {}
        for r in results:
            for k, v in r.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
        return {
            "config": "fleet_loss",
            "groups": groups,
            "tree": tree,
            "device": str(dev),
            "wall_s": round(time.monotonic() - t0, 3),
            "kill_to_restored_commit_s": round(restore_s, 3),
            "commits_before_kill": len(frames),
            "torn_record_step": torn_step,
            "resumed_step": expect_step,
            "post_resume_steps": results[0]["final_step"] - expect_step,
            "pre_kill_digest": sorted(phase1_digests[expect_step])[0],
            "restored_digest": sorted(restored_digests)[0],
            "resumed_from_committed": True,
            "torn_manifest_wins": 0,
            "bit_identity_ok": True,
            "liveness_ok": True,
            "launches": launches,
        }
    finally:
        for p in procs + procs2:
            if p.poll() is None:
                kill_process(p.pid)
                p.wait()
        root.stop()
        root2.stop()
        shutil.rmtree(durable_dir, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)


# -- serving-plane churn -----------------------------------------------------


def run_serving_churn(
    seed: int,
    plan: Optional[FaultPlan] = None,
    dryrun: bool = False,
    deadline_s: float = 180.0,
    device: Any = None,
) -> dict:
    """SERVING-PLANE CHURN: a subprocess publisher dripping range bodies
    (so a SIGKILL lands mid-range), a two-tier relay chain and a seeded
    subscriber join/leave storm, with publisher kill/restart and relay
    partition faults from the plan. Asserts zero torn installs, counted
    detections, an honestly growing ``age_ms`` under partition, and
    every surviving subscriber converging on the live publisher."""
    from torchft_tpu_torch.chaos import PublisherProcess, free_port, splitmix64
    from torchft_tpu_torch.serving import (
        StaleWeightsError,
        WeightRelay,
        WeightSubscriber,
        WireDetection,
        _fetch_version,
        _http_json,
        tree_digest,
    )

    dev = resolve_device(device)
    rounds = 8 if dryrun else 12
    if plan is None:
        plan = FaultPlan.random(
            seed, steps=rounds, members=2, seams=("serving",),
            events_target=2 if dryrun else 3,
        )
        # Pin one kill and one partition if the seeded draw missed them
        # (the pinned events ride the serialized plan).
        kinds = {e.kind for e in plan.events}
        extra = []
        if not kinds & {"kill", "restart"}:
            extra.append(FaultEvent(step=rounds // 3, seam="serving",
                                    kind="kill", member=-1))
        if "partition" not in kinds:
            extra.append(FaultEvent(step=2 * rounds // 3, seam="serving",
                                    kind="partition", member=1, param=600))
        if extra:
            plan = FaultPlan(seed=seed, events=tuple(sorted(
                plan.events + tuple(extra),
                key=lambda e: (e.step, e.seam, e.kind, e.member))))
    repro = (f"replay: --config serving_churn --seed {seed} "
             f"--plan '{plan.to_json()}'")
    t0 = time.monotonic()
    deadline = t0 + deadline_s
    # 15 ms per 64 KiB chunk: each range stream spends >= 30 ms mid-body
    # per version, the SIGKILL window.
    pub = PublisherProcess(
        free_port(), wire="q8", leaves=4, elems=65536, seed=seed,
        publish_every_ms=150, snapshot_every=4, drip_ms=15,
        device=str(dev),
    )
    relays: List[Any] = []
    subs: List[Any] = []
    closed_stats: List[Dict[str, int]] = []
    counters = {"publisher_kills": 0, "publisher_restarts": 0,
                "relay_partitions": 0, "churn_joins": 0, "churn_leaves": 0,
                "probe_nonce_detections": 0}
    age_samples: List[Tuple[int, int]] = []  # (during, after) per partition
    try:
        pub.wait_serving(min_version=1)
        r1 = WeightRelay(pub.address(), name="churn-r1",
                         poll_timeout_ms=200).start()
        r2 = WeightRelay(r1.server.local_address(), name="churn-r2",
                         poll_timeout_ms=200).start()
        relays = [r1, r2]

        def join_sub(h: int) -> None:
            tier = relays[h % 2]
            s = WeightSubscriber(
                tier.server.local_address(),
                name=f"churn-s{counters['churn_joins']}",
                lease_ttl_ms=2000, device=dev,
            ).start(poll_ms=100)
            subs.append(s)
            counters["churn_joins"] += 1

        for i in range(3):
            join_sub(i)

        saved_manifest: Optional[dict] = None
        for rnd in range(rounds):
            assert time.monotonic() < deadline, f"deadline ({repro})"
            # seeded churn: one join or leave per round, floor of 2 subs
            h = splitmix64(seed ^ (0xC0FFEE + rnd))
            if h % 3 == 0 and len(subs) > 2:
                victim = subs.pop(h % len(subs))
                victim.close()
                closed_stats.append(victim.stats)
                counters["churn_leaves"] += 1
            else:
                join_sub(h)
            for e in plan.events_at(rnd):
                if e.kind in ("kill", "restart"):
                    st = pub.status()
                    if st is not None and st.get("latest", -1) >= 0:
                        saved_manifest = _http_json(
                            f"{pub.address()}/ps/manifest/{st['latest']}",
                            5.0)
                    pub.kill()
                    counters["publisher_kills"] += 1
                    time.sleep(0.3)  # let the short bodies land downstream
                    pub.restart()
                    counters["publisher_restarts"] += 1
                    pub.wait_serving(min_version=1)
                    if saved_manifest is not None:
                        # The pre-kill manifest against the respawned
                        # history must be REFUSED, never served.
                        try:
                            _fetch_version(pub.address(), saved_manifest, 1,
                                           10.0)
                            raise AssertionError(
                                f"stale manifest v{saved_manifest['version']}"
                                f" was served by the respawned publisher "
                                f"({repro})")
                        except WireDetection as d:
                            assert d.kind in ("nonce", "gone"), (
                                f"unexpected detection {d.kind} ({repro})")
                            counters["probe_nonce_detections"] += 1
                elif e.kind == "partition":
                    r2.set_partitioned(True)
                    counters["relay_partitions"] += 1
                    time.sleep(max(e.param, 300) / 1000.0)
                    st_mid = _http_json(
                        f"{r2.server.local_address()}/ps/status", 5.0)
                    # the partitioned relay still SERVES, admitting its
                    # staleness
                    assert st_mid["latest"] >= 0, f"stopped serving ({repro})"
                    assert st_mid["age_ms"] >= 250, (
                        f"age_ms {st_mid['age_ms']} not growing while "
                        f"partitioned ({repro})")
                    # a bounded read through this relay must refuse
                    behind = [s for s in subs
                              if s.base.endswith(f":{r2.server.port}")]
                    for s in behind:
                        if s.version() >= 0:
                            try:
                                s.current(max_age_ms=1)
                                raise AssertionError(
                                    f"over-age read served ({repro})")
                            except StaleWeightsError:
                                pass
                            break
                    r2.set_partitioned(False)
                    settle = time.monotonic() + 10.0
                    while time.monotonic() < settle:
                        if r2._age_ms() < st_mid["age_ms"]:  # noqa: SLF001
                            break
                        time.sleep(0.05)
                    age_samples.append((st_mid["age_ms"], r2._age_ms()))  # noqa: SLF001
                    assert r2._age_ms() < st_mid["age_ms"], (  # noqa: SLF001
                        f"age never recovered after partition ({repro})")
                # "churn" events are the storm itself, realized above
            time.sleep(0.25 if dryrun else 0.35)

        # LIVENESS + BIT IDENTITY: every surviving subscriber converges
        # on a version the live publisher serves, digest-identical.
        converged = 0
        for s in subs:
            ok = False
            conv_deadline = time.monotonic() + 30.0
            while time.monotonic() < conv_deadline:
                assert time.monotonic() < deadline, f"deadline ({repro})"
                v = s.version()
                listing = _http_json(f"{pub.address()}/ps/versions", 5.0)
                manifests = {int(m["version"]): m
                             for m in listing.get("versions", [])}
                if v in manifests:
                    _, tree, _ = s.current()
                    if tree_digest(tree) == manifests[v]["digest"]:
                        ok = True
                        break
                time.sleep(0.1)
            assert ok, (f"subscriber {s.name} never converged to the live "
                        f"publisher (v={s.version()}) ({repro})")
            converged += 1

        all_stats = closed_stats + [s.stats for s in subs]
        torn = sum(st["torn_installs"] for st in all_stats)
        detections = {k: sum(st[k] for st in all_stats)
                      for k in ("detect_crc", "detect_nonce", "detect_short",
                                "detect_gone", "detect_digest", "detect_gap")}
        detections["relay_upstream_errors"] = sum(
            r.node.counters["upstream_errors"] for r in relays)
        detections["probe_nonce"] = counters["probe_nonce_detections"]
        assert torn == 0, f"{torn} torn installs ({repro})"
        total_installs = sum(st["installs"] for st in all_stats)
        assert total_installs > 0, f"nobody ever installed ({repro})"
        if counters["publisher_kills"]:
            assert (detections["relay_upstream_errors"] > 0
                    or detections["probe_nonce"] > 0
                    or sum(detections[k] for k in (
                        "detect_crc", "detect_short", "detect_nonce",
                        "detect_gone")) > 0), (
                f"publisher kill produced no counted detection ({repro})")
        assert all(mid > after for mid, after in age_samples), (
            f"age samples not honest: {age_samples} ({repro})")
        return {
            "config": "serving_churn",
            "seed": seed,
            "device": str(dev),
            "fault_plan": plan.fingerprint(),
            "wall_s": round(time.monotonic() - t0, 3),
            "rounds": rounds,
            "subscribers_peak": counters["churn_joins"],
            "churn": {"joins": counters["churn_joins"],
                      "leaves": counters["churn_leaves"]},
            "publisher_kills": counters["publisher_kills"],
            "publisher_restarts": counters["publisher_restarts"],
            "relay_partitions": counters["relay_partitions"],
            "partition_age_ms_samples": [
                {"during": mid, "after": after} for mid, after in age_samples],
            "wire_detections": detections,
            "installs_total": total_installs,
            "torn_installs": 0,
            "converged_subscribers": converged,
            "age_honest": bool(age_samples)
            or counters["relay_partitions"] == 0,
            "bit_identity_ok": True,
            "liveness_ok": True,
        }
    finally:
        for s in subs:
            s.close()
        for r in relays:
            r.shutdown()
        pub.stop()


# -- entry point -------------------------------------------------------------


def _merge_counts(dicts: List[Dict[str, int]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def _say(msg: str) -> None:
    print(f"[chaos] {msg}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    args_in = sys.argv[1:] if argv is None else argv
    if "--fleet-member" in args_in:
        # subprocess re-entry: one fleet-loss member (see run_fleet_loss)
        return fleet_member_main(args_in)
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dryrun", action="store_true",
                        help="seconds-scale subset; no artifact")
    parser.add_argument("--seed", type=int, default=None,
                        help="replay one seed (with --config)")
    parser.add_argument("--plan", type=str, default=None,
                        help="replay an explicit plan JSON")
    parser.add_argument("--config", type=str, default="ddp",
                        choices=("ddp", "plan", "hier", "hier_shm",
                                 "policy", "root_outage",
                                 "sharded_reshard", "fleet_loss",
                                 "serving_churn"))
    parser.add_argument("--seeds", type=int, default=3,
                        help="seeds per configuration for the full run")
    parser.add_argument("--out", default=None,
                        help="write the full run's records here (JSON)")
    parser.add_argument("--device", default=None,
                        help="where members' trees live (default: the card)")
    parser.add_argument("--tree", default="vector", choices=TREES)
    parser.add_argument("--wire", default=None, choices=("q8",),
                        help="the wire of every allreduce / plan_allreduce")
    parser.add_argument("--deadline-s", type=float, default=None,
                        help="a replayed schedule's deadline (default: the "
                        "schedule's own)")
    args = parser.parse_args(args_in)
    dev = str(resolve_device(args.device))  # raises with no card
    common = {"device": dev, "tree": args.tree}
    t_start = time.monotonic()

    def emit(rec: Any) -> None:
        print(json.dumps(rec, indent=2), flush=True)

    if args.config == "serving_churn":
        plan = FaultPlan.from_json(args.plan) if args.plan else None
        emit(run_serving_churn(args.seed if args.seed is not None else 4242,
                               plan=plan, dryrun=args.dryrun, device=dev))
        return 0
    if args.config == "fleet_loss" and args.seed is None:
        # pinned, not seeded: --dryrun only shrinks the fleet
        emit(run_fleet_loss(groups=2 if args.dryrun else 3, **common))
        return 0
    if args.seed is not None:
        # replay mode: one schedule, loud verdict
        plan = FaultPlan.from_json(args.plan) if args.plan else None
        if args.deadline_s is not None:
            common["deadline_s"] = args.deadline_s
        if args.config == "policy":
            rec = run_policy_schedule(args.seed, **common)
        elif args.config == "sharded_reshard":
            rec = run_sharded_reshard(args.seed, **common)
        elif args.config == "fleet_loss":
            rec = run_fleet_loss(seed=args.seed, **common)
        elif args.config == "root_outage":
            rec = run_root_outage(args.seed, plan=plan, **common)
        else:
            rec = run_schedule(args.seed, args.config, plan=plan,
                               wire=args.wire, **common)
        emit(rec)
        return 0

    records: List[dict] = []
    seed_base = int(os.environ.get("TORCHFT_CHAOS_SEED", "1000"))

    # The schedules whose faults act on other processes (the fleet-loss
    # members and root, the publisher, the iso children) never arm this
    # process's fault engine, so they run on a thread beside the ring
    # schedules.
    side: Dict[str, Any] = {}

    def side_chain() -> None:
        try:
            side["fleet"] = run_fleet_loss(groups=2 if args.dryrun else 3,
                                           **common)
            side["serving"] = run_serving_churn(seed_base + 42,
                                                dryrun=args.dryrun, device=dev)
            side["probes"] = run_iso_probes(dev)
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            side["error"] = e

    side_thread = threading.Thread(target=side_chain, name="chaos_side")
    side_thread.start()
    n_seeds = 1 if args.dryrun else args.seeds
    config_salt = {"ddp": 0, "plan": 31, "hier": 62, "hier_shm": 77,
                   "policy": 93}
    configs = ("plan", "hier_shm") if args.dryrun else (
        "ddp", "plan", "hier", "hier_shm")
    for config in configs:
        for i in range(n_seeds):
            seed = seed_base + 17 * i + config_salt[config]
            # the co-hosted fleet draws from the shm_ring seam as well
            if config == "hier_shm":
                seams = (("shm_ring",) if args.dryrun
                         else ("shm_ring", "ring_send"))
            elif args.dryrun:
                seams = ("ring_send",)
            else:
                seams = ("ring_send", "ring_hdr", "net_send")
            rec = run_schedule(seed, config, seams=seams,
                               events_target=2 if args.dryrun else 3,
                               wire=args.wire, **common)
            _say(f"{config} seed={seed}: {rec['faults_fired_total']} faults "
                 f"fired {json.dumps(rec['faults_fired'])}, "
                 f"{rec['crc_detections']} CRC detections, "
                 f"commits={rec['commits_per_member']}, {rec['wall_s']:.1f}s")
            records.append(rec)

    # a guaranteed-corruption schedule: one bit flip, CRC on
    flip_plan = FaultPlan(seed=7, events=(
        FaultEvent(step=2, seam="ring_send", kind="bit_flip", member=0),
    ))
    rec = run_schedule(7, "plan" if args.dryrun else "ddp", plan=flip_plan,
                       wire=args.wire, **common)
    _say(f"pinned bit-flip: {rec['faults_fired_total']} fired, "
         f"{rec['crc_detections']} CRC detections, "
         f"{rec['desync_detections']} desync, {rec['wall_s']:.1f}s")
    records.append(rec)

    # Root outage: the dryrun pins kill at step 2, restart at step 4, so
    # the restart-with-replay record is guaranteed.
    outage_plan = FaultPlan(seed=11, events=(
        FaultEvent(step=2, seam="root", kind="kill", member=-1),
        FaultEvent(step=4, seam="root", kind="restart", member=-1),
    ))
    outage_rec = run_root_outage(11, groups=2 if args.dryrun else 3,
                                 plan=outage_plan if args.dryrun else None,
                                 **common)
    if not args.dryrun and outage_rec["root_restarts"] == 0:
        records.append(outage_rec)
        outage_rec = run_root_outage(11, plan=outage_plan, **common)
    records.append(outage_rec)
    _say(f"root outage: epochs={outage_rec['root_epochs_seen']}, "
         f"restarts={outage_rec['root_restarts']}, "
         f"wal_replays={outage_rec['wal_replays_seen']}, "
         f"takeover_s={outage_rec['takeover_s']}, "
         f"kill_to_next_commit_s={outage_rec['kill_to_next_commit_s']}, "
         f"commits={outage_rec['commits_per_member']}, "
         f"{outage_rec['wall_s']:.1f}s")

    reshard_rec = run_sharded_reshard(13, **common)
    records.append(reshard_rec)
    _say(f"sharded reshard: reshards={reshard_rec['reshards_per_member']}, "
         f"commits={reshard_rec['commits_per_member']}, "
         f"{reshard_rec['wall_s']:.1f}s")

    side_thread.join()
    if "error" in side:
        raise side["error"]
    fleet_rec = side["fleet"]
    records.append(fleet_rec)
    _say(f"fleet loss: resumed step {fleet_rec['resumed_step']} (torn record "
         f"step={fleet_rec['torn_record_step']}), "
         f"+{fleet_rec['post_resume_steps']} steps post-resume, kill to "
         f"restored commit {fleet_rec['kill_to_restored_commit_s']:.1f}s, "
         f"{fleet_rec['wall_s']:.1f}s")

    serving_rec = side["serving"]
    records.append(serving_rec)
    _say(f"serving churn: kills={serving_rec['publisher_kills']}, "
         f"partitions={serving_rec['relay_partitions']}, "
         f"installs={serving_rec['installs_total']}, "
         f"detections={json.dumps(serving_rec['wire_detections'])}, "
         f"converged={serving_rec['converged_subscribers']}, "
         f"{serving_rec['wall_s']:.1f}s")

    probes = side["probes"]
    _say(f"iso probes: {json.dumps(probes)}")

    detected = [r for r in records if r.get("crc_detections", 0) > 0]
    stalls = [p for p in probes if p.get("stall_verdict")]
    assert detected, "no schedule produced a detected corruption"
    assert stalls, "no SIGSTOP stall verdict was recorded"
    root_restart_records = [
        r for r in records if r.get("config") == "root_outage"
        and r.get("root_restarts", 0) >= 1 and r.get("quorum_id_monotone")]
    assert root_restart_records, (
        "no root-restart record with monotone quorum_id was produced")
    reshard_records = [r for r in records
                       if r.get("config") == "sharded_reshard"
                       and r.get("resharded")]
    assert reshard_records, "no sharded re-partition record was produced"
    fleet_records = [r for r in records if r.get("config") == "fleet_loss"
                     and r.get("resumed_from_committed")
                     and r.get("bit_identity_ok")
                     and r.get("torn_manifest_wins") == 0]
    assert fleet_records, (
        "no whole-fleet-loss durable-restore record was produced")
    serving_records = [r for r in records if r.get("config") == "serving_churn"
                       and r.get("torn_installs", 1) == 0
                       and r.get("bit_identity_ok") and r.get("age_honest")
                       and r.get("converged_subscribers", 0) > 0]
    assert serving_records, (
        "no zero-torn-install serving-churn record was produced")
    summary = {
        "schedules": len(records),
        "detected_corruption_records": len(detected),
        "sigstop_stall_records": len(stalls),
        "root_restart_records": len(root_restart_records),
        "sharded_reshard_records": len(reshard_records),
        "fleet_loss_records": len(fleet_records),
        "serving_churn_records": len(serving_records),
    }

    if args.dryrun:
        print(json.dumps({
            "dryrun": True, **summary, "tree": args.tree, "wire": args.wire,
            "device": dev, "wall_s": round(time.monotonic() - t_start, 3),
            "records": records, "iso_probes": probes,
            "launch_counts": _merge_counts(
                [dict(launch_counts), fleet_rec.get("launches", {})]),
        }), flush=True)
        print("chaos dryrun OK (no artifact written)")
        return 0

    policy_rec = run_policy_schedule(seed_base + 5, **common)
    _say(f"policy schedule ok: {policy_rec['faults_fired']}")
    crc_overhead = run_crc_overhead(device=dev)
    _say(f"crc overhead: {json.dumps(crc_overhead)}")
    artifact = {
        "host": {"cpus": os.cpu_count()},
        "device": dev,
        "tree": args.tree,
        "wire": args.wire,
        **summary,
        "schedules_run": len(records) + 1,
        "records": records,
        "policy": policy_rec,
        "iso_probes": probes,
        "crc_overhead": crc_overhead,
        "launch_counts": _merge_counts(
            [dict(launch_counts), fleet_rec.get("launches", {})]),
        "totals": {
            "faults_injected": sum(r.get("faults_fired_total", 0)
                                   for r in records),
            "faults_by_seam_kind": _merge_counts(
                [r.get("faults_fired", {}) for r in records]
                + [policy_rec.get("faults_fired", {})]),
            "crc_detections": sum(r.get("crc_detections", 0) for r in records),
            "desync_detections": sum(r.get("desync_detections", 0)
                                     for r in records),
            "silent_commits": 0,
            "liveness_deadline_hits": 0,
        },
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")
    else:
        print(json.dumps(artifact), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
