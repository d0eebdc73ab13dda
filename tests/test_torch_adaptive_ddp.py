"""The port's AdaptiveDDP against the JAX package's: the probe/decision
discipline of ``tests/test_adaptive_ddp.py`` over the port's engines.

- The decision rule (cohort argmin, ties to ``blocking``, the failure
  sentinel, an errored gather) and, on the same injected timings, the
  same decision and ``probe_s`` as the JAX package's ``AdaptiveDDP``.
- Construction: the candidate lists of both packages are equal under
  every knob (``TORCHFT_DEVICE_PACK``, a region label, ``TORCHFT_HOST``,
  ``TORCHFT_DDP_SHARDED``, ``int8``), and the pins validate eagerly
  (``xla_iso`` needs an isolated plane the port does not have yet).
- End to end over a real manager, the re-probe on a quorum change, the
  probe refresh, and the ``plan_hier`` and ``ddp_sharded`` candidates
  (their sentinels on a backend that cannot serve them, the tenure
  resets of the optimizer state).
- A mixed ring: a JAX member and a port member on ``compress="q8"``
  probe every candidate in lockstep, lock one mode and end with
  bit-identical parameters.
"""

import threading
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp
import optax

import torchft_tpu as jft
from torchft_tpu import collectives as jcol
from torchft_tpu import ddp as jddp
import torchft_tpu_torch as tft
from torchft_tpu_torch import collectives as tcol
from torchft_tpu_torch import ddp as tddp
from torchft_tpu_torch.ddp import AdaptiveDDP, PipelinedDDP

_KNOBS = ("TORCHFT_DDP_MODE", "TORCHFT_DEVICE_PACK", "TORCHFT_REGION",
          "TORCHFT_HOST", "TORCHFT_DDP_SHARDED", "TORCHFT_DDP_REPROBE_STEPS")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)


def _grad_fn(params, x):
    w = params["w"].detach().requires_grad_(True)
    loss = torch.mean((x @ w) ** 2)
    (g,) = torch.autograd.grad(loss, [w])
    return loss.detach(), {"w": g}


def _state():
    return tft.FTTrainState({"w": torch.ones(8, 8)}, tft.SGD(0.1))


class _Metrics:
    def __init__(self, store):
        self._s = store

    def record(self, name, s):
        self._s[name] = s

    def incr(self, name, by=1):
        self._s[name] = self._s.get(name, 0) + by


class _FakeManager:
    """Just enough Manager surface for the decision rule."""

    def __init__(self, cohort_timings):
        self._cohort = cohort_timings
        self._metrics_records = {}
        self._qid = 7

    def allgather(self, tree):
        return tcol._completed(
            [{"probe_t": torch.tensor(t, dtype=torch.float64)}
             for t in self._cohort])

    def quorum_id(self):
        return self._qid

    def errored(self):
        return None

    def metrics(self):
        return _Metrics(self._metrics_records)


class _JaxFakeManager(_FakeManager):
    def allgather(self, tree):
        return jcol._completed(
            [{"probe_t": np.asarray(t, np.float64)} for t in self._cohort])


def _adaptive_with_fake(cohort, cls=AdaptiveDDP, mgr=_FakeManager):
    ddp = cls.__new__(cls)
    ddp._manager = mgr(cohort)
    ddp._candidates = list(cls._CANDIDATES)
    ddp._probe_t = [[t] for t in cohort[0]]
    ddp._auto = True
    ddp._mode = None
    ddp._probe_qid = 7
    ddp._probe_idx = 6
    ddp._decision_qid = None
    ddp.decision = None
    return ddp


S = AdaptiveDDP._PROBE_FAILED_S
_COHORTS = [
    [[0.10, 0.08, 0.09], [0.10, 0.05, 0.09]],
    [[0.10, 0.12, 0.11], [0.10, 0.09, 0.15]],
    [[0.10, 0.10, 0.10]],
    [[0.3, 0.2, 0.25], [0.31, 0.22, 0.24]],
    [[0.5, S, 0.4], [0.5, 0.001, 0.4]],
    [[S, S, S]],
]


class TestDecisionRule:
    def test_picks_cohort_fastest(self):
        ddp = _adaptive_with_fake([[0.10, 0.08, 0.09], [0.10, 0.05, 0.09]])
        ddp._decide()
        assert ddp.mode == "plan" and ddp.decision["mode"] == "plan"

    def test_never_slower_than_blocking(self):
        ddp = _adaptive_with_fake([[0.10, 0.12, 0.11], [0.10, 0.09, 0.15]])
        ddp._decide()
        assert ddp.mode == "blocking"

    def test_tie_resolves_to_blocking(self):
        ddp = _adaptive_with_fake([[0.10, 0.10, 0.10]])
        ddp._decide()
        assert ddp.mode == "blocking"

    def test_failed_candidate_cannot_win(self):
        ddp = _adaptive_with_fake([[0.5, S, 0.4], [0.5, 0.001, 0.4]])
        ddp._decide()
        assert ddp.mode == "pipelined"

    def test_all_failed_falls_back_to_blocking(self):
        ddp = _adaptive_with_fake([[S, S, S]])
        ddp._decide()
        assert ddp.mode == "blocking"

    def test_errored_gather_locks_blocking(self):
        ddp = _adaptive_with_fake([[0.5, 0.1, 0.2]])
        ddp._manager.errored = lambda: RuntimeError("gather failed")
        ddp._decide()
        assert ddp.mode == "blocking"

    def test_mismatched_candidate_lists_lock_blocking(self):
        ddp = _adaptive_with_fake([[0.5, 0.1, 0.2], [0.5, 0.1, 0.2, 0.3]])
        ddp._decide()
        assert ddp.mode == "blocking"

    @pytest.mark.parametrize("cohort", _COHORTS)
    def test_same_decision_as_the_jax_package(self, cohort):
        port = _adaptive_with_fake(cohort)
        ref = _adaptive_with_fake(cohort, jddp.AdaptiveDDP, _JaxFakeManager)
        port._decide()
        ref._decide()
        assert port.decision == ref.decision
        assert port._manager._metrics_records == ref._manager._metrics_records


class _ManagerStub:
    """Constructor-only stand-in (never stepped)."""


def _jax_state():
    return jft.FTTrainState({"w": jnp.ones((8, 8), jnp.float32)},
                            optax.sgd(0.1))


def _jax_grad_fn(params, x):
    return jax.value_and_grad(lambda p: jnp.mean((x @ p["w"]) ** 2))(params)


class TestConstruction:
    def test_env_mode_pins_without_probe(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_DDP_MODE", "blocking")
        assert AdaptiveDDP(_ManagerStub(), _state(), _grad_fn).mode == \
            "blocking"

    def test_bad_env_mode_rejected(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_DDP_MODE", "warp")
        with pytest.raises(ValueError, match="TORCHFT_DDP_MODE"):
            AdaptiveDDP(_ManagerStub(), _state(), _grad_fn)

    def test_bad_device_pack_rejected(self):
        with pytest.raises(ValueError, match="TORCHFT_DEVICE_PACK"):
            AdaptiveDDP(_ManagerStub(), _state(), _grad_fn, device_pack="x")
        with pytest.raises(ValueError, match="TORCHFT_DEVICE_PACK"):
            PipelinedDDP(_ManagerStub(), _state(), _grad_fn,
                         device_pack="maybe")

    def test_int8_drops_plan_candidate(self):
        ddp = AdaptiveDDP(_ManagerStub(), _state(), _grad_fn,
                          compress="int8", mode="auto")
        assert "plan" not in ddp._candidates
        with pytest.raises(ValueError, match="plan"):
            AdaptiveDDP(_ManagerStub(), _state(), _grad_fn,
                        compress="int8", mode="plan")

    def test_xla_iso_needs_an_isolated_plane(self):
        with pytest.raises(ValueError, match="iso_collectives"):
            AdaptiveDDP(_ManagerStub(), _state(), _grad_fn, mode="xla_iso")

    def test_device_pack_available(self):
        assert tddp._device_pack_available()

    @pytest.mark.parametrize("env,compress", [
        ({}, "q8"),
        ({"TORCHFT_DEVICE_PACK": "off"}, "q8"),
        ({"TORCHFT_DEVICE_PACK": "on"}, None),
        ({"TORCHFT_REGION": "east"}, "q8"),
        ({"TORCHFT_HOST": "h0", "TORCHFT_DDP_SHARDED": "1"}, "q8"),
        ({"TORCHFT_HOST": "h0", "TORCHFT_DDP_SHARDED": "1"}, "int8"),
        ({"TORCHFT_DDP_SHARDED": "1"}, "bf16"),
    ])
    def test_candidate_lists_match_the_jax_package(self, monkeypatch, env,
                                                   compress):
        """A mixed cohort's probe vectors line up only if both packages
        build the same list from the same knobs."""
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        port = AdaptiveDDP(_ManagerStub(), _state(), _grad_fn,
                           compress=compress)
        ref = jddp.AdaptiveDDP(_ManagerStub(), _jax_state(), _jax_grad_fn,
                               compress=compress)
        assert port._candidates == ref._candidates
        if env.get("TORCHFT_HOST") and compress == "q8":
            assert port._candidates == [
                "blocking", "plan", "plan_devpack", "plan_hier",
                "pipelined", "ddp_sharded"]


def _real_manager(collectives, replica_id, min_replicas=1, lighthouse=None):
    own = lighthouse is None
    if own:
        lighthouse = tft.Lighthouse(min_replicas=min_replicas,
                                    join_timeout_ms=200, quorum_tick_ms=50,
                                    heartbeat_timeout_ms=2000)
    store = tft.Store()
    manager = tft.Manager(
        collectives=collectives, load_state_dict=lambda s: None,
        state_dict=lambda: {}, min_replica_size=min_replicas, rank=0,
        world_size=1, use_async_quorum=False, timeout=timedelta(seconds=10),
        store_addr=store.address(), lighthouse_addr=lighthouse.address(),
        replica_id=replica_id, device="cpu",
    )

    def close():
        manager.shutdown()
        store.shutdown()
        if own:
            lighthouse.shutdown()

    return manager, close


class TestEndToEnd:
    def test_probe_locks_and_training_progresses(self):
        manager, close = _real_manager(
            tcol.HostCollectives(timeout=timedelta(seconds=10)), "e2e")
        ddp = AdaptiveDDP(manager, _state(), _grad_fn, probe_steps=2,
                          device_pack="off")
        x = torch.ones(4, 8)
        try:
            assert ddp.mode is None
            for _ in range(8):
                loss = ddp.step(x)
            ddp.flush()
            assert ddp.mode in ("blocking", "plan", "pipelined")
            assert ddp.decision["mode"] == ddp.mode
            assert set(ddp.decision["probe_s"]) == {"blocking", "plan",
                                                     "pipelined"}
            assert np.isfinite(float(loss))
            assert manager.current_step() == 8
            counters = manager.metrics().snapshot()["counters"]
            assert counters.get(f"ddp_mode_{ddp.mode}") == 1
        finally:
            close()

    def test_backend_without_plans_never_locks_plan(self):
        class NoPlans(tcol.DummyCollectives):
            plan_allreduce = tcol.Collectives.plan_allreduce  # raises

        manager, close = _real_manager(NoPlans(world_size=1), "noplan")
        try:
            ddp = AdaptiveDDP(manager, _state(), _grad_fn, probe_steps=2)
            for _ in range(12):
                ddp.step(torch.ones(4, 8))
            ddp.flush()
            assert ddp.mode is not None and ddp.mode != "plan"
            assert ddp.decision["probe_s"]["plan"] >= 1e8
        finally:
            close()

    def test_plan_transport_trains_equivalently(self):
        manager, close = _real_manager(
            tcol.HostCollectives(timeout=timedelta(seconds=10)), "equiv")
        try:
            results = {}
            for transport in ("legacy", "plan"):
                state = _state()
                ddp = PipelinedDDP(manager, state, _grad_fn,
                                   transport=transport)
                for _ in range(3):
                    ddp.step(torch.ones(4, 8))
                ddp.flush()
                results[transport] = state.params["w"].numpy().tobytes()
            assert results["legacy"] == results["plan"]
        finally:
            close()


class _ScriptedManager:
    """A scripted manager: always commits (unless a hier dispatch was
    made to fail), quorum id set by the test."""

    def __init__(self, region="", hier_works=True):
        self._region = region
        self._hier_works = hier_works
        self.qid = 1
        self.committed = 0
        self.hier_dispatches = 0
        self._fail_commit = False
        self._m = _FakeManager([[0.0] * 6])

    def start_quorum(self, **kw):
        pass

    def quorum_id(self):
        return self.qid

    def current_step(self):
        return self.committed

    def errored(self):
        return None

    def plan_allreduce(self, tree, op=None, wire=None, device_pack=None,
                       hier=False):
        if hier:
            self.hier_dispatches += 1
            if not self._hier_works:
                self._fail_commit = True
                return tcol._completed(None)
        return tcol._completed(tree)

    def allreduce(self, tree, op=None, wire=None):
        return tcol._completed(tree)

    def allgather(self, tree):
        return tcol._completed([tree])

    def should_commit(self, **kw):
        failed, self._fail_commit = self._fail_commit, False
        if not failed:
            self.committed += 1
        return not failed

    def is_healing(self):
        return False

    def metrics(self):
        return self._m.metrics()

    def reset_plan_feedback(self):
        pass


class TestReprobe:
    def test_quorum_move_restarts_probe(self):
        mgr = _ScriptedManager()
        ddp = AdaptiveDDP(mgr, _state(), _grad_fn, probe_steps=2,
                          device_pack="off")
        x = torch.ones(4, 8)
        for _ in range(7):  # the anchor, then 3 candidates x 2
            ddp.step(x)
        locked = ddp.mode
        assert locked is not None
        ddp.step(x)
        assert ddp.mode == locked
        mgr.qid = 2
        ddp.step(x)
        assert ddp.mode is None
        for _ in range(6):
            ddp.step(x)
        assert ddp.mode is not None
        ddp.flush()

    def test_locked_mode_reprobes_on_cadence(self):
        mgr = _ScriptedManager()
        ddp = AdaptiveDDP(mgr, _state(), _grad_fn, probe_steps=2,
                          device_pack="off", reprobe_steps=4)
        x = torch.ones(4, 8)
        for _ in range(7):
            ddp.step(x)
        assert ddp.mode is not None
        for _ in range(3):
            ddp.step(x)
        assert ddp.mode is not None
        ddp.step(x)
        assert ddp.mode is None
        assert mgr._m._metrics_records.get("ddp_reprobe") == 1
        for _ in range(6):
            ddp.step(x)
        assert ddp.mode is not None
        ddp.flush()

    def test_env_knob_sets_cadence(self, monkeypatch):
        assert AdaptiveDDP(_ManagerStub(), _state(), _grad_fn,
                           mode="blocking")._reprobe_steps == 0
        monkeypatch.setenv("TORCHFT_DDP_REPROBE_STEPS", "128")
        assert AdaptiveDDP(_ManagerStub(), _state(), _grad_fn,
                           mode="blocking")._reprobe_steps == 128

    def test_error_backstop_locks_blocking(self):
        # four candidates: the 8-step probe outlasts the 6-step backstop
        mgr = _ScriptedManager(region="east")
        mgr.should_commit = lambda **kw: False
        ddp = AdaptiveDDP(mgr, _state(), _grad_fn, probe_steps=2,
                          device_pack="off")
        for _ in range(ddp._error_backstop + 1):
            ddp.step(torch.ones(4, 8))
        assert ddp.mode == "blocking"
        assert "fallback" in ddp.decision


class TestPlanHierCandidate:
    def test_candidate_only_on_labeled_members(self, monkeypatch):
        ddp = AdaptiveDDP(_ScriptedManager(region=""), _state(), _grad_fn,
                          device_pack="off")
        assert "plan_hier" not in ddp._candidates
        ddp2 = AdaptiveDDP(_ScriptedManager(region="east"), _state(),
                           _grad_fn, device_pack="off")
        assert ddp2._candidates.index("plan_hier") == \
            ddp2._candidates.index("plan") + 1
        monkeypatch.setenv("TORCHFT_HOST", "h0")
        assert "plan_hier" in AdaptiveDDP(
            _ScriptedManager(), _state(), _grad_fn)._candidates

    def test_unusable_cohort_records_sentinel_never_wins(self):
        mgr = _ScriptedManager(region="east", hier_works=False)
        ddp = AdaptiveDDP(mgr, _state(), _grad_fn, probe_steps=2,
                          device_pack="off")
        for _ in range(1 + 2 * len(ddp._candidates) + 2):
            ddp.step(torch.ones(4, 8))
        ddp.flush()
        assert ddp.mode is not None and ddp.mode != "plan_hier"
        assert mgr.hier_dispatches >= 1
        assert ddp.decision["probe_s"]["plan_hier"] >= S

    def test_pinned_mode_accepts_plan_hier(self):
        mgr = _ScriptedManager(region="east")
        ddp = AdaptiveDDP(mgr, _state(), _grad_fn, mode="plan_hier",
                          device_pack="off")
        for _ in range(3):
            ddp.step(torch.ones(4, 8))
        ddp.flush()
        assert ddp.mode == "plan_hier" and mgr.hier_dispatches == 3


class TestShardedCandidate:
    def test_absent_by_default_present_on_opt_in(self, monkeypatch):
        assert "ddp_sharded" not in AdaptiveDDP(
            _ManagerStub(), _state(), _grad_fn)._candidates
        monkeypatch.setenv("TORCHFT_DDP_SHARDED", "1")
        assert "ddp_sharded" in AdaptiveDDP(
            _ManagerStub(), _state(), _grad_fn)._candidates

    def test_structural_gates(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_DDP_SHARDED", "1")
        assert "ddp_sharded" not in AdaptiveDDP(
            _ManagerStub(), _state(), _grad_fn, compress="int8")._candidates
        bf16 = tft.FTTrainState({"w": torch.ones(8, 8, dtype=torch.bfloat16)},
                                tft.SGD(0.1))
        assert "ddp_sharded" not in AdaptiveDDP(
            _ManagerStub(), bf16, _grad_fn)._candidates
        with pytest.raises(ValueError, match="int8"):
            AdaptiveDDP(_ManagerStub(), _state(), _grad_fn, compress="int8",
                        mode="ddp_sharded")
        with pytest.raises(ValueError, match="f32 master"):
            AdaptiveDDP(_ManagerStub(), bf16, _grad_fn, mode="ddp_sharded")

    def test_pinned_sharded_matches_plan(self):
        manager, close = _real_manager(
            tcol.HostCollectives(timeout=timedelta(seconds=10)), "pin")
        try:
            results = {}
            for mode in ("plan", "ddp_sharded"):
                state = _state()
                ddp = AdaptiveDDP(manager, state, _grad_fn, mode=mode,
                                  device_pack="off")
                for _ in range(3):
                    ddp.step(torch.ones(4, 8))
                ddp.flush()
                assert ddp._ddp.last_commit is True
                results[mode] = state.params["w"].numpy().tobytes()
            assert results["plan"] == results["ddp_sharded"]
        finally:
            close()

    def test_backend_without_sharded_plans_records_sentinel(self,
                                                            monkeypatch):
        monkeypatch.setenv("TORCHFT_DDP_SHARDED", "1")
        manager, close = _real_manager(tcol.DummyCollectives(world_size=1),
                                       "nosharded")
        try:
            ddp = AdaptiveDDP(manager, _state(), _grad_fn, probe_steps=2,
                              device_pack="off")
            assert "ddp_sharded" in ddp._candidates
            for _ in range(12):
                ddp.step(torch.ones(4, 8))
            ddp.flush()
            assert ddp.mode is not None and ddp.mode != "ddp_sharded"
            assert ddp.decision["probe_s"]["ddp_sharded"] >= 1e8
        finally:
            close()

    def test_tenure_boundary_resets_optimizer_state(self):
        manager, close = _real_manager(
            tcol.HostCollectives(timeout=timedelta(seconds=10)), "tenure")
        try:
            state = tft.FTTrainState({"w": torch.ones(8, 8)},
                                     tft.AdamW(1e-2))
            ddp = AdaptiveDDP(manager, state, _grad_fn, mode="ddp_sharded",
                              device_pack="off")
            ddp.step(torch.ones(4, 8))
            assert ddp._sharded()._opt_shard is not None
            state.opt_state["count"] = 99  # stale full-size state
            ddp._run_step("blocking", torch.ones(4, 8))
            assert state.opt_state["mu"]["w"].numel() == 64
            assert state.opt_state["count"] == 1  # re-initialized, one step
            ddp._run_step("ddp_sharded", torch.ones(4, 8))
            assert ddp._sharded()._shard_meta is not None
        finally:
            close()


# ---- a mixed ring: a JAX member and a port member ----------------------


def _w0():
    return np.random.default_rng(11).standard_normal((16, 8)).astype(np.float32)


def _scaled_grad_port(params, x):
    # an exact "gradient" (a power-of-two scaling): both packages compute
    # the same bits, so the cohort's parameters can be held bit for bit
    return torch.sum(params["w"]).detach(), {"w": params["w"].detach() * x}


def _scaled_grad_jax(params, x):
    return jnp.sum(params["w"]), {"w": params["w"] * x}


class TestMixedRing:
    def test_jax_and_port_members_lock_one_mode(self):
        lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=2000,
                                    quorum_tick_ms=50,
                                    heartbeat_timeout_ms=5000)
        steps = 1 + 4 * 2 + 3  # anchor, 4 candidates x 2, 3 locked
        out = {}
        errors = []

        def port_member():
            manager, close = _real_manager(
                tcol.HostCollectives(timeout=timedelta(seconds=20)),
                "port", min_replicas=2, lighthouse=lighthouse)
            try:
                state = tft.FTTrainState({"w": torch.from_numpy(_w0())},
                                         tft.SGD(0.125))
                ddp = AdaptiveDDP(manager, state, _scaled_grad_port,
                                  compress="q8", probe_steps=2)
                for _ in range(steps):
                    ddp.step(0.5)
                ddp.flush()
                out["port"] = (ddp._candidates, ddp.decision, ddp.mode,
                               state.params["w"].numpy().tobytes())
            finally:
                close()

        def jax_member():
            store = jft.Store()
            manager = jft.Manager(
                collectives=jcol.HostCollectives(timeout=timedelta(seconds=20)),
                load_state_dict=lambda s: None, state_dict=lambda: {},
                min_replica_size=2, rank=0, world_size=1,
                use_async_quorum=False, timeout=timedelta(seconds=10),
                store_addr=store.address(),
                lighthouse_addr=lighthouse.address(), replica_id="jax")
            try:
                state = jft.FTTrainState({"w": jnp.asarray(_w0())},
                                         optax.sgd(0.125))
                ddp = jddp.AdaptiveDDP(manager, state, _scaled_grad_jax,
                                       compress="q8", probe_steps=2)
                with jax.disable_jit():  # eager, as the port (F6)
                    for _ in range(steps):
                        ddp.step(0.5)
                    ddp.flush()
                out["jax"] = (ddp._candidates, ddp.decision, ddp.mode,
                              np.asarray(state.params["w"]).tobytes())
            finally:
                manager.shutdown()
                store.shutdown()

        def run(fn):
            try:
                fn()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=run, args=(f,))
                   for f in (port_member, jax_member)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
                assert not t.is_alive()
        finally:
            lighthouse.shutdown()
        if errors:
            raise errors[0]
        (pc, pd, pm, pw), (jc, jd, jm, jw) = out["port"], out["jax"]
        assert pc == jc == ["blocking", "plan", "plan_devpack", "pipelined"]
        assert pm == jm is not None
        assert pd["probe_s"] == jd["probe_s"]
        assert all(v < S for v in pd["probe_s"].values())
        assert pw == jw
