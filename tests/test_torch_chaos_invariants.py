"""The port's chaos-invariant harness (scripts/chaos_run_torch.py) held
against the JAX package's (scripts/chaos_run.py) in one process.

- The CI gate's four transaction-invariant cases, with the JAX harness's
  seeds, plans, group counts and assertions, on the port's fleet.
- Bit parity: a fault-free plan on ``ddp`` and ``plan`` and the pinned
  seed-7 bit flip give the same commits, the same discarded attempts and
  the same final digest in both harnesses (the vector tree, so both carry
  the same bytes).
- The port harness's other schedules keep every invariant: a root
  outage, a sharded re-partition, a whole-fleet loss and a policy fleet.
- The harness imports neither JAX nor the JAX package, and without a
  card it raises unless asked for the CPU.

Every test runs under a time limit of its own; the harnesses' deadlines
are generous, and nothing waits on a fixed sleep.
"""

import contextlib
import os
import signal
import subprocess
import sys

import pytest

import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torchft_tpu._native as jax_native  # noqa: E402
import torchft_tpu_torch._native as port_native  # noqa: E402
from torchft_tpu_torch.chaos import FaultEvent, FaultPlan  # noqa: E402

import chaos_run  # noqa: E402
import chaos_run_torch  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    jax_native.fault_disarm()
    port_native.fault_disarm()


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Fails the test (with a traceback of where it stood) once
    ``seconds`` have passed; the harness's own deadlines come first."""

    def expired(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _flip_plan(member=0, step=2):
    return FaultPlan(
        seed=7, events=(FaultEvent(step, "ring_send", "bit_flip", member),)
    )


class TestTransactionInvariants:
    """tests/test_chaos_invariants.py's gate on the port's fleet."""

    def test_ddp_bit_flip_discarded_then_recovers(self):
        with _time_limit(180):
            rec = chaos_run_torch.run_schedule(
                7, "ddp", groups=2, steps=4, plan=_flip_plan(),
                deadline_s=120, device=CPU,
            )
        assert rec["crc_detections"] >= 1
        assert rec["silent_commits"] == 0
        assert rec["liveness_ok"] and rec["bit_identity_ok"]

    def test_plan_path_seeded_schedule(self):
        with _time_limit(180):
            rec = chaos_run_torch.run_schedule(
                1031, "plan", groups=2, steps=4,
                plan=FaultPlan(
                    seed=1031,
                    events=(
                        FaultEvent(1, "ring_send", "bit_flip", 1),
                        FaultEvent(2, "ring_send", "drop", 0),
                    ),
                ),
                deadline_s=120, device=CPU,
            )
        assert rec["crc_detections"] >= 1
        assert rec["epoch_purity_ok"] and rec["bit_identity_ok"]

    @pytest.mark.slow
    def test_hier_seeded_schedule(self):
        with _time_limit(300):
            rec = chaos_run_torch.run_schedule(
                9000, "hier", groups=4, steps=6,
                plan=FaultPlan(
                    seed=9000,
                    events=(
                        FaultEvent(2, "ring_send", "bit_flip", 0),
                        FaultEvent(3, "ring_send", "partition", 2),
                    ),
                ),
                deadline_s=240, device=CPU,
            )
        assert rec["crc_detections"] >= 1
        assert rec["liveness_ok"]

    @pytest.mark.slow
    def test_random_seeds_ddp(self):
        with _time_limit(600):
            for seed in (101, 202):
                rec = chaos_run_torch.run_schedule(
                    seed, "ddp", groups=3, steps=6, deadline_s=240,
                    device=CPU,
                )
                assert rec["silent_commits"] == 0


class _Fleet:
    """What one harness run left behind: its members' records (commit
    maps, discarded attempts) and the digests they ended with."""

    def __init__(self, module, monkeypatch):
        self.records = []
        self.digests = []
        fleet = self

        class Record(module._MemberRecord):
            def __init__(self):
                super().__init__()
                fleet.records.append(self)

        digest = module._digest

        def recording_digest(tree):
            out = digest(tree)
            fleet.digests.append(out)
            return out

        # Both fleets of two wait for each other at their first quorum
        # (a lighthouse of min_replicas=2): a member that started late
        # would otherwise take step 0 alone, and the two runs would hold
        # different trajectories, not different harnesses.
        lighthouse = module.Lighthouse

        def fleet_lighthouse(**kw):
            return lighthouse(**{**kw, "min_replicas": 2})

        monkeypatch.setattr(module, "_MemberRecord", Record)
        monkeypatch.setattr(module, "_digest", recording_digest)
        monkeypatch.setattr(module, "Lighthouse", fleet_lighthouse)


def _both(monkeypatch, config, plan, steps):
    """One schedule through each harness, two groups; returns (port
    record, port fleet, JAX record, JAX fleet)."""
    with monkeypatch.context() as m:
        jax_fleet = _Fleet(chaos_run, m)
        jax_rec = chaos_run.run_schedule(
            plan.seed, config, groups=2, steps=steps, plan=plan,
            deadline_s=120,
        )
    with monkeypatch.context() as m:
        port_fleet = _Fleet(chaos_run_torch, m)
        port_rec = chaos_run_torch.run_schedule(
            plan.seed, config, groups=2, steps=steps, plan=plan,
            deadline_s=120, device=CPU,
        )
    return port_rec, port_fleet, jax_rec, jax_fleet


class TestBitParityWithJax:
    @pytest.mark.parametrize("config", ["ddp", "plan"])
    def test_fault_free_plan(self, monkeypatch, config):
        with _time_limit(240):
            port, pf, ref, jf = _both(
                monkeypatch, config, FaultPlan(seed=5, events=()), steps=4)
        assert port["commits_per_member"] == ref["commits_per_member"] == [4, 4]
        assert [r.commits for r in pf.records] == [r.commits for r in jf.records]
        assert len(set(pf.digests)) == 1
        assert pf.digests == jf.digests
        assert port["final_digest"] == jf.digests[0]

    def test_pinned_bit_flip(self, monkeypatch):
        with _time_limit(240):
            port, pf, ref, jf = _both(monkeypatch, "plan", _flip_plan(),
                                      steps=4)
        assert port["crc_detections"] >= 1 and ref["crc_detections"] >= 1
        # the same attempt discarded on every member of both fleets
        assert [r.discards for r in pf.records] == [r.discards for r in jf.records]
        assert all(2 in r.discards for r in pf.records)
        assert port["commits_per_member"] == ref["commits_per_member"]
        assert len(set(pf.digests)) == 1
        assert pf.digests == jf.digests


class TestPortSchedules:
    def test_root_outage(self):
        plan = FaultPlan(seed=11, events=(
            FaultEvent(2, "root", "kill", -1),
            FaultEvent(4, "root", "restart", -1),
        ))
        with _time_limit(300):
            rec = chaos_run_torch.run_root_outage(
                11, groups=2, plan=plan, deadline_s=240, device=CPU)
        assert rec["root_restarts"] >= 1 and rec["wal_replays_seen"] >= 1
        assert rec["quorum_id_monotone"] and rec["split_brain"] == 0
        assert rec["bit_identity_ok"] and rec["liveness_ok"]
        assert len(rec["root_epochs_seen"]) >= 2  # the standby took over

    def test_sharded_reshard(self):
        with _time_limit(240):
            rec = chaos_run_torch.run_sharded_reshard(13, device=CPU)
        assert rec["resharded"]
        # each survivor's last partition (W=2) holds more than its first
        # three-member one
        for g in (0, 1):
            sizes = [b for _, _, b in rec["reshards_per_member"][g]]
            assert sizes[-1] > min(sizes)
        assert rec["epoch_purity_ok"] and rec["bit_identity_ok"]
        assert rec["liveness_ok"]

    def test_fleet_loss(self):
        with _time_limit(300):
            rec = chaos_run_torch.run_fleet_loss(groups=2, device=CPU)
        assert rec["resumed_from_committed"] and rec["torn_manifest_wins"] == 0
        assert rec["restored_digest"] == rec["pre_kill_digest"]
        assert rec["bit_identity_ok"] and rec["liveness_ok"]
        assert rec["post_resume_steps"] >= 1

    def test_policy_schedule(self):
        with _time_limit(300):
            rec = chaos_run_torch.run_policy_schedule(1005, device=CPU)
        assert rec["bit_identity_ok"] and rec["liveness_ok"]
        assert min(rec["batches_committed"]) > 0


class TestHarnessTrees:
    def test_dense_tree_is_the_dense_lms(self):
        tree = chaos_run_torch.Tree("dense", chaos_run_torch.torch.device(CPU),
                                    seed=3)
        params = tree.params()
        assert len(params) == 39
        assert sum(p.numel() for p in params.values()) == 23_337_472
        g = tree.grads(1, 4)
        assert set(g) == set(params)
        assert all(g[k].shape == params[k].shape for k in params)
        # a retried attempt contributes the same bytes; another member
        # or step other bytes
        again = tree.grads(1, 4)
        assert all(bool((g[k] == again[k]).all()) for k in g)
        other = tree.grads(0, 4)
        assert not all(bool((g[k] == other[k]).all()) for k in g)

    def test_vector_update_rounds_as_numpy(self):
        import numpy as np

        torch = chaos_run_torch.torch
        tree = chaos_run_torch.Tree("vector", torch.device(CPU))
        p = tree.params()
        avg = tree.grads(2, 7)
        got = chaos_run_torch.apply_update(p, avg)
        want = np.full(4096, 1.0, np.float32) - 0.1 * np.full(
            4096, 0.01 * 3 + 7 * 0.001, np.float32)
        assert chaos_run_torch._digest(got) == chaos_run._digest({"w": want})


class TestHarnessProcess:
    def _run(self, code, env=None):
        return subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True,
            text=True, timeout=120, env=env,
        )

    def test_imports_neither_jax_nor_the_jax_package(self):
        out = self._run(
            "import sys\n"
            "sys.path.insert(0, 'scripts')\n"
            "import chaos_run_torch\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'torchft_tpu' or "
            "m.startswith('torchft_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n"
        )
        assert out.returncode == 0, out.stderr[-2000:]
        assert "clean" in out.stdout

    @pytest.mark.skipif(chaos_run_torch.torch.cuda.is_available(),
                        reason="a card is present: the harness runs on it")
    def test_raises_without_a_card_unless_asked_for_the_cpu(self):
        out = subprocess.run(
            [sys.executable, os.path.join("scripts", "chaos_run_torch.py"),
             "--config", "ddp", "--seed", "1"],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr
