"""Conformance on the port: graftcheck's explored traces and the seeded
fleet replay against the PyTorch port's objects.

The counterpart of ``tests/test_graftcheck_conformance.py``, class for
class and test for test, with the same traces, schedules and assertions:
the protocol models (``tools/graftcheck/``) held against
``torchft_tpu_torch``'s policy engine, durable-tier fences and manifest
log, native WAL and lease/quorum entry points, serving catch-up planner,
and the step-transaction model against the port's chaos harness
(``scripts/chaos_run_torch.py``) on the CPU.

If a model drifts from the port's code it claims to verify, these tests
catch it. Nothing of the JAX package is imported here.

The fleet replay runs under a time limit of its own (``_time_limit``),
past the harness's deadline, so a stuck fleet fails with a traceback
rather than holding a test worker.
"""

import contextlib
import os
import signal
import sys
from pathlib import Path

import pytest

import torch_one_thread  # noqa: F401

REPO_ROOT = Path(__file__).resolve().parent.parent
# tools/ must outrank scripts/: scripts/graftcheck.py (the CLI) would
# otherwise shadow the tools/graftcheck package at import time.
sys.path.insert(0, str(REPO_ROOT / "scripts"))
sys.path.insert(0, str(REPO_ROOT / "tools"))
sys.path.insert(0, str(REPO_ROOT))

import graftcheck  # noqa: E402
from graftcheck import decision as decision_model  # noqa: E402
from graftcheck.core import explore, replay  # noqa: E402

from torchft_tpu_torch import _native  # noqa: E402
from torchft_tpu_torch._native import (  # noqa: E402
    WalLog,
    depart_apply,
    lease_apply,
    quorum_step,
    wal_recover,
)
from torchft_tpu_torch.durable import (  # noqa: E402
    MANIFEST_NAME,
    LocalDirStore,
    ManifestLog,
    inconsistent_marker,
    live_commits,
)
from torchft_tpu_torch.policy import (  # noqa: E402
    SENTINEL_COST_S,
    choose_target,
)
from torchft_tpu_torch.serving import WireDetection, _catch_up_plan  # noqa: E402


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Fails the test (with a traceback of where it stood) once
    ``seconds`` have passed; the harness's own deadline comes first."""

    def expired(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# The model's hysteresis constants (HYST_NUM/HYST_DEN = 3/4) express
# "challenger must beat cur * (1 - h)" with h = 1/4.
HYSTERESIS = 1.0 - decision_model.HYST_NUM / decision_model.HYST_DEN


def _to_real_costs(costs):
    """Model cost (saturated at SENT) -> the policy engine's float cost."""
    return [
        SENTINEL_COST_S if c >= decision_model.SENT else float(c)
        for c in costs
    ]


class TestDecisionConformance:
    """decision model <-> policy.choose_target: the identical-argmin the
    uniform_data_step property rides."""

    def _tables(self):
        # Every aggregated cost table reachable in the model: aggregate
        # of any non-empty multiset of MEASURES up to world=3 members.
        seen = set()
        meas = decision_model.MEASURES
        for a in range(len(meas)):
            for b in range(-1, len(meas)):
                for c in range(-1, len(meas)):
                    vecs = [meas[i] for i in (a, b, c) if i >= 0]
                    seen.add(decision_model.aggregate(vecs))
        return sorted(seen)

    def test_model_choose_matches_real_choose_target(self):
        tables = self._tables()
        assert len(tables) > 5
        for costs in tables:
            for cur in range(len(costs)):
                model_pick = decision_model.choose(costs, cur)
                real_pick = choose_target(
                    _to_real_costs(costs), cur, HYSTERESIS
                )
                assert model_pick == real_pick, (costs, cur)

    def test_all_sentinel_keeps_incumbent(self):
        # The argmin_all_sentinel broken variant's fence, on real code.
        costs = [SENTINEL_COST_S, SENTINEL_COST_S]
        assert choose_target(costs, 1, HYSTERESIS) == 1

    def test_sentineled_incumbent_always_loses(self):
        assert choose_target([3.0, SENTINEL_COST_S], 1, HYSTERESIS) == 0

    def test_hysteresis_near_tie_stands_still(self):
        # 3 does not beat 4 * 0.75; 2 does.
        assert choose_target([3.0, 4.0], 1, HYSTERESIS) == 1
        assert choose_target([2.0, 4.0], 1, HYSTERESIS) == 0


class TestDurableConformance:
    """durable model <-> inconsistent_marker / live_commits /
    ManifestLog replay."""

    def _marker(self, rank, step=3, quorum_id=2, world=2):
        return {
            "step": step,
            "quorum_id": quorum_id,
            "world": world,
            "total": world,
            "wire": "f32",
            "rank": rank,
        }

    def test_broken_commit_blocked_by_real_fence(self):
        # The acceptance-criteria counterexample: the broken model
        # commits set 1 after a single writer's shard+marker. Map the
        # trace's marker writes onto the real predicate: it must refuse.
        result = explore(
            graftcheck.make("durable", "commit_without_fence")
        )
        trace = result.violation.trace
        committed_set = next(
            lbl.split("_s")[1] for lbl in trace if lbl.startswith("commit_s")
        )
        writers = {
            int(lbl.rsplit("_w", 1)[1])
            for lbl in trace
            if lbl.startswith("marker_s%s_" % committed_set)
        }
        assert writers != {0, 1}  # the broken model committed early
        markers = {r: self._marker(r) for r in writers}
        bad = inconsistent_marker(
            markers, step=3, quorum_id=2, world=2, total=2, wire="f32"
        )
        assert bad is not None  # the real fence blocks this commit
        missing_rank = bad[0]
        assert missing_rank not in writers and bad[1] is None

    def test_complete_marker_set_is_commit_eligible(self):
        markers = {r: self._marker(r) for r in (0, 1)}
        assert (
            inconsistent_marker(
                markers, step=3, quorum_id=2, world=2, total=2, wire="f32"
            )
            is None
        )

    def test_stale_quorum_marker_rejected(self):
        # The model's fence action (stale qid writer abandoned).
        markers = {0: self._marker(0), 1: self._marker(1, quorum_id=1)}
        bad = inconsistent_marker(
            markers, step=3, quorum_id=2, world=2, total=2, wire="f32"
        )
        assert bad == (1, markers[1])

    def test_live_commits_matches_model_semantics(self):
        records = [
            {"t": "commit", "dir": "set-0"},
            {"t": "commit", "dir": "set-1"},
            {"t": "retire", "dir": "set-0"},
            {"t": "commit", "dir": "set-2"},
        ]
        assert [r["dir"] for r in live_commits(records)] == [
            "set-1",
            "set-2",
        ]

    def test_manifest_torn_tail_never_wins(self, tmp_path):
        # use_torn_tail's fence on the real log: a torn commit record
        # (crash mid-append) is dropped by replay, so the previous
        # commit stays the restorable winner.
        store = LocalDirStore(str(tmp_path))
        log = ManifestLog(store)
        log.append({"t": "commit", "dir": "set-0"})
        log.append({"t": "commit", "dir": "set-1"})
        torn = ManifestLog.frame({"t": "commit", "dir": "set-2"})[:-5]
        store.append(MANIFEST_NAME, torn)
        records, dropped = log.replay()
        assert dropped == len(torn)
        assert [r["dir"] for r in live_commits(records)] == [
            "set-0",
            "set-1",
        ]


class TestWalConformance:
    """wal model <-> the native DurableLog (WalLog/wal_recover): replay
    drops the torn tail, epochs survive, and the correct model refuses
    the broken variant's first move."""

    def test_torn_tail_dropped_promise_not_replayed(self, tmp_path):
        d = str(tmp_path / "wal")
        os.makedirs(d)
        log = WalLog(d)
        log.log_epoch(1)
        log.log_quorum(
            {"quorum_id": 1, "participants": [], "created_ms": 0}, 1, 1
        )
        log.close()
        path = os.path.join(d, "wal.log")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 4)  # crash mid-append of the quorum record
        rec = wal_recover(d, 0, 0)
        # The torn quorum promise is dropped, never partially applied;
        # the intact epoch record survives (publish-after-log means the
        # fleet never saw the promise either: no regression possible).
        assert rec["dropped_tail_bytes"] > 0
        assert rec["root_epoch"] == 1
        assert rec["quorum_gen"] == 0

    def test_clean_log_replays_promise(self, tmp_path):
        d = str(tmp_path / "wal")
        os.makedirs(d)
        log = WalLog(d)
        log.log_epoch(1)
        log.log_quorum(
            {"quorum_id": 1, "participants": [], "created_ms": 0}, 1, 1
        )
        log.close()
        rec = wal_recover(d, 0, 0)
        assert rec["dropped_tail_bytes"] == 0
        assert rec["quorum_gen"] == 1

    def test_correct_model_refuses_broken_first_move(self):
        # publish_before_log's counterexample rides a publish that
        # precedes the log write. Replayed against the CORRECT model,
        # the schedule either has no such labeled transition (the fence
        # removed it) or — where the label exists but is sequenced
        # behind the log write — ends in a state the correct model
        # still certifies clean. Either way the broken verdict cannot
        # be reproduced under the fence.
        broken = explore(graftcheck.make("wal", "publish_before_log"))
        correct = graftcheck.make("wal")
        from graftcheck.core import ReplayError

        try:
            states = replay(correct, broken.violation.trace)
        except ReplayError:
            return  # the fence removed the transition outright
        assert correct.check(states[-1]) == []


class TestLeaseConformance:
    """lease model <-> the port's pure _native lease/quorum API."""

    EMPTY = {
        "participants": {},
        "heartbeats": {},
        "lease_ttls": {},
        "prev_quorum": None,
        "quorum_id": 0,
    }

    def _entry(self, rid, ttl_ms, participating=True):
        return {
            "replica_id": rid,
            "ttl_ms": ttl_ms,
            "participating": participating,
            "member": {
                "replica_id": rid,
                "address": f"addr_{rid}",
                "store_address": f"store_{rid}",
                "step": 1,
                "world_size": 1,
                "shrink_only": False,
                "force_reconfigure": False,
            },
        }

    def _opts(self):
        return {
            "min_replicas": 1,
            "join_timeout_ms": 0,
            "quorum_tick_ms": 10,
            "heartbeat_timeout_ms": 5000,
        }

    def test_expired_member_never_in_formed_quorum(self):
        # The no_prune broken variant forms a quorum containing a member
        # whose lease ran out; the real quorum_step must prune it.
        s = lease_apply(
            self.EMPTY,
            [self._entry("a", 1000), self._entry("b", 10_000)],
            5,
        )
        r = quorum_step(2000, 2000, s, self._opts())  # a's lease expired
        names = [m["replica_id"] for m in r["quorum"]["participants"]]
        assert names == ["b"]

    def test_departed_member_leaves_immediately(self):
        s = lease_apply(
            self.EMPTY,
            [self._entry("a", 10_000), self._entry("b", 10_000)],
            5,
        )
        s = depart_apply(s, "a")
        assert "a" not in s["participants"]
        r = quorum_step(10, 10, s, self._opts())
        names = [m["replica_id"] for m in r["quorum"]["participants"]]
        assert names == ["b"]

    def test_quorum_id_monotone_across_reconfigs(self):
        # qid_monotone, realized: every membership change bumps the
        # quorum_id; it never regresses (the watermark the wal model's
        # restarted roots re-learn).
        s = lease_apply(self.EMPTY, [self._entry("a", 10_000)], 5)
        r1 = quorum_step(10, 10, s, self._opts())
        q1 = r1["quorum"]["quorum_id"]
        # renew every live member in the same batch as the joiner (the
        # canonical reconfig sequence test_lease.py establishes)
        s = lease_apply(
            r1["state"],
            [self._entry("a", 10_000), self._entry("b", 10_000)],
            20,
        )
        r2 = quorum_step(30, 30, s, self._opts())
        q2 = r2["quorum"]["quorum_id"]
        assert r2["changed"] and q2 > q1


class TestServingConformance:
    """serving model <-> _catch_up_plan: complete chains install, any
    gap aborts (a detection, never a torn install)."""

    def test_delta_chain_installs(self):
        manifests = {
            1: {"kind": "snapshot"},
            2: {"kind": "delta"},
            3: {"kind": "delta"},
        }
        assert _catch_up_plan(1, manifests) == [2, 3]
        assert _catch_up_plan(-1, manifests) == [1, 2, 3]

    def test_version_never_regresses(self):
        manifests = {1: {"kind": "snapshot"}}
        assert _catch_up_plan(1, manifests) == []
        assert _catch_up_plan(5, manifests) == []

    def test_gap_aborts_instead_of_torn_install(self):
        # no_integrity's verdict inverted: the real planner raises a
        # typed detection rather than assembling a torn mix.
        manifests = {1: {"kind": "snapshot"}, 3: {"kind": "delta"}}
        with pytest.raises(WireDetection):
            _catch_up_plan(1, manifests)


class TestStepTxnFleetConformance:
    """step_txn model <-> the port's live fleet (scripts/chaos_run_torch.py): the
    correct model's exhaustively-verified verdict — no silent commit, no
    mixed-epoch commit, liveness — replayed as a seeded schedule whose
    fault mirrors the model's message-corruption action (a ring bit flip
    is the wire realization of a corrupted vote/decide payload)."""

    @pytest.fixture(autouse=True)
    def _disarm_after(self):
        yield
        _native.fault_disarm()

    def test_seeded_fleet_reaches_model_verdict(self):
        import chaos_run_torch
        from torchft_tpu_torch.chaos import FaultEvent, FaultPlan

        # The model sweeps to 600k states violation-free; its verdict
        # for any single corrupted message is detect-and-discard.
        capped = explore(graftcheck.make("step_txn"), max_states=30_000)
        assert capped.violation is None

        with _time_limit(240):
            rec = chaos_run_torch.run_schedule(
                1237,
                "ddp",
                groups=2,
                steps=4,
                plan=FaultPlan(
                    seed=1237,
                    events=(FaultEvent(1, "ring_send", "bit_flip", 1),),
                ),
                deadline_s=120,
                device="cpu",
            )
        assert rec["silent_commits"] == 0
        assert rec["epoch_purity_ok"]
        assert rec["crc_detections"] >= 1
        assert rec["liveness_ok"] and rec["bit_identity_ok"]
