"""The port's policy engine against the JAX package's.

- ``strategy_cost`` and ``choose_target`` give the JAX functions' values
  on the same aggregates, over the default ladders and a grid of signals
  and knobs; ``StrategySpec`` validates alike.
- Solo on a tiny LM, with scripted conditions (a degraded link, a large
  model) on both: the port's engine takes the JAX engine's decisions,
  and its params stay within the F6 tolerance of the JAX trajectory
  (rtol 1e-5, atol 1e-6: the JAX engines are jitted).
- A port cohort of two switches together (decisions identical, params
  bit-identical); a member failure during the decision gather aborts
  the switch for both, and a later decision completes it.
- ``state_dict`` / ``load_state_dict`` carry the strategy and the clocks.
- A mixed cohort, one JAX member and one port member, gathers one
  float64 signal layout and takes the same decisions, costs included.
"""

import itertools
import threading
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp
import optax

import torchft_tpu as jft
from torchft_tpu import policy as jpol
from torchft_tpu.models import transformer as jt
import torchft_tpu_torch as tft
from torchft_tpu_torch import policy as tpol
from torchft_tpu_torch._tree import flatten
from torchft_tpu_torch.models import transformer as tt

_T = timedelta(seconds=30)

_SIGNALS = [
    dict(compute_s=0.01, wire_eff_MBps=4000.0, churn_per_min=0.0,
         ctrl_s=0.001, reconf_s=0.1, heal_s=3.0, world=2.0, model_bytes=4e6),
    dict(compute_s=0.2, wire_eff_MBps=2.0, churn_per_min=0.0, ctrl_s=0.01,
         reconf_s=0.1, heal_s=3.0, world=4.0, model_bytes=4.4e8),
    dict(compute_s=1.5, wire_eff_MBps=300.0, churn_per_min=6.0, ctrl_s=0.02,
         reconf_s=0.5, heal_s=20.0, world=8.0, model_bytes=1e9),
    dict(compute_s=0.05, wire_eff_MBps=0.0, churn_per_min=30.0, ctrl_s=0.0,
         reconf_s=2.0, heal_s=0.5, world=2.0, model_bytes=1e7,
         tier_intra_MBps=900.0, tier_inter_MBps=15.0),
    dict(compute_s=0.3, wire_eff_MBps=50.0, churn_per_min=1.0, ctrl_s=0.005,
         reconf_s=0.3, heal_s=8.0, world=3.0, model_bytes=2e8,
         tier_intra_MBps=0.0, tier_inter_MBps=40.0, opt_state_bytes=1e8),
]
_KNOBS = [dict(), dict(staleness_weight=0.0, sync_fixed_s=0.5),
          dict(hysteresis=0.0, surface_s=5.0, opt_mem_weight=2.0)]


@pytest.mark.parametrize("f32,topo", list(itertools.product([True, False],
                                                             repeat=2)))
def test_costs_and_choices_equal_the_jax_functions(f32, topo):
    port_c = tpol.default_candidates(f32_masters=f32, topology_labeled=topo)
    ref_c = jpol.default_candidates(f32_masters=f32, topology_labeled=topo)
    assert [vars(c) for c in port_c] == [vars(c) for c in ref_c]
    for sig, kn in itertools.product(_SIGNALS, _KNOBS):
        pk, jk = tpol.CostKnobs(**kn), jpol.CostKnobs(**kn)
        port = [tpol.strategy_cost(c, sig, pk) for c in port_c]
        ref = [jpol.strategy_cost(c, sig, jk) for c in ref_c]
        assert port == ref
        for cur in range(len(port)):
            assert (tpol.choose_target(port, cur, pk.hysteresis)
                    == jpol.choose_target(ref, cur, jk.hysteresis))
    sentinel = [tpol.SENTINEL_COST_S, 0.5, tpol.SENTINEL_COST_S]
    for cur in range(3):
        assert (tpol.choose_target(sentinel, cur, 0.1)
                == jpol.choose_target(sentinel, cur, 0.1))


def test_knobs_from_env_and_spec_validation_match(monkeypatch):
    monkeypatch.setenv("TORCHFT_POLICY_SYNC_FIXED_S", "0.25")
    monkeypatch.setenv("TORCHFT_POLICY_OPT_MEM", "1.5")
    assert vars(tpol.CostKnobs.from_env()) == vars(jpol.CostKnobs.from_env())
    bad = [("x", "warp"), ("x", "ddp", 4), ("x", "localsgd", 1),
           ("x", "diloco", 8, "fp4"), ("x", "localsgd", 4, None, "legacy",
                                       True)]
    for args in bad:
        with pytest.raises(ValueError) as p:
            tpol.StrategySpec(*args)
        with pytest.raises(ValueError) as j:
            jpol.StrategySpec(*args)
        assert str(p.value) == str(j.value)


# -- engines ------------------------------------------------------------------

_KW = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
           max_seq_len=32)
_CANDS = [("ddp", "ddp", 1, None), ("diloco_h4", "diloco", 4, None)]


def _tokens(g, i):
    return np.random.default_rng(100 * g + i).integers(
        0, _KW["vocab_size"], size=(2, 9), dtype=np.int32)


def _jax_init():
    cfg = jt.TransformerConfig(**_KW, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray,
                                  jt.init_params(cfg, jax.random.PRNGKey(0)))


def _port_params(cfg, init):
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_params(tt.params_from_jax(init, device="cpu"))
    return model.params()


def _script(policy, manager, bw=2.0):
    """Identical scripted conditions on every member: a degraded link and
    a model large enough that the windowed strategy wins decisively."""
    policy._model_bytes = 64 << 20
    manager.signals = lambda w=600.0: {"churn_per_min": 0.0,
                                       "wire_eff_MBps": bw, "heal": None}


def _cands(mod, cands):
    if callable(cands):
        return cands(mod)
    return [mod.StrategySpec(n, k, sync_every=h, wire=w)
            for n, k, h, w in cands]


def _member(pkg, g, lighthouse, steps, cands, decide_every=4,
            fail_epoch=None, barrier=None, heal_state=True):
    """One single-rank group of ``pkg`` under a PolicyEngine on the tiny
    LM (SGD inner, SGD(0.7) outer). Returns its decisions and params.
    ``heal_state=False`` heals nothing (a port member cannot load a JAX
    donor's optimizer state, ROADMAP D3; both start from one init)."""
    init = _jax_init()
    if pkg == "jax":
        m = jft
        cfg = jt.TransformerConfig(**_KW, dtype=jnp.float32)
        vg = jax.jit(jax.value_and_grad(lambda p, t: jt.loss_fn(cfg, p, t)))
        state = m.FTTrainState(jax.tree_util.tree_map(jnp.asarray, init),
                               optax.sgd(0.1))
        grad_fn, outer, extra = vg, optax.sgd(0.7), {}
        batch = lambda i: jnp.asarray(_tokens(g, i))  # noqa: E731
        leaves = lambda: [np.asarray(x) for x in  # noqa: E731
                          jax.tree_util.tree_leaves(state.params)]
    else:
        m = tft
        cfg = tt.TransformerConfig(**_KW, dtype=torch.float32)
        state = m.FTTrainState(_port_params(cfg, init), tft.SGD(0.1))
        grad_fn, outer, extra = tt.make_grad_fn(cfg), tft.SGD(0.7), {
            "device": "cpu"}
        batch = lambda i: torch.from_numpy(_tokens(g, i)).long()  # noqa: E731
        leaves = lambda: [x.detach().numpy().copy()  # noqa: E731
                          for x in flatten(state.params)[0]]
    store = m.Store()
    col = m.HostCollectives(timeout=_T)
    box = {}
    manager = m.Manager(
        collectives=col,
        load_state_dict=(lambda s: box["p"].load_state_dict(s))
        if heal_state else (lambda s: None),
        state_dict=(lambda: box["p"].state_dict()) if heal_state
        else (lambda: {}), min_replica_size=1,
        rank=0, world_size=1, use_async_quorum=False, timeout=_T,
        quorum_timeout=_T, store_addr=store.address(),
        lighthouse_addr=lighthouse, replica_id=f"pol_{g}", **extra)
    try:
        mod = jpol if pkg == "jax" else tpol
        policy = box["p"] = mod.PolicyEngine(
            manager, state, grad_fn, outer_tx=outer,
            candidates=_cands(mod, cands), decide_every=decide_every)
        _script(policy, manager)
        if fail_epoch is not None and g == 1:
            orig = manager.allgather

            def failing(tree):
                if "policy_sig" in tree and policy._decide_epoch == fail_epoch:
                    # a garbage frame of another length: the ring's
                    # mismatch fails fast on every member
                    tree = {"policy_sig": torch.zeros(3, dtype=torch.float64)}
                return orig(tree)

            manager.allgather = failing
        if barrier is not None:
            barrier.wait(timeout=60)
        losses = [float(policy.step(batch(i))) for i in range(steps)]
        policy.flush()
        return {"decisions": policy.decisions, "params": leaves(),
                "strategy": policy.strategy.name, "losses": losses,
                "step": manager.current_step()}
    finally:
        manager.shutdown()
        col.shutdown()
        store.shutdown()


def _cohort(members, **kw):
    lighthouse = tft.Lighthouse(min_replicas=len(members), join_timeout_ms=500,
                                quorum_tick_ms=50)
    barrier = threading.Barrier(len(members))
    try:
        with ThreadPoolExecutor(max_workers=len(members)) as ex:
            futs = [ex.submit(_member, pkg, g, lighthouse.address(),
                              barrier=barrier, **kw)
                    for g, pkg in enumerate(members)]
            return [f.result(timeout=240) for f in futs]
    finally:
        lighthouse.shutdown()


def _rows(decisions, keys=("from", "to", "committed", "switched")):
    return [tuple(d[k] for k in keys) for d in decisions]


def test_solo_run_takes_the_jax_decisions_within_f6():
    (port,) = _cohort(["port"], steps=14, cands=_CANDS)
    (ref,) = _cohort(["jax"], steps=14, cands=_CANDS)
    assert _rows(port["decisions"]) == _rows(ref["decisions"])
    assert port["strategy"] == ref["strategy"] == "diloco_h4"
    assert any(d["switched"] for d in port["decisions"])
    assert port["step"] == ref["step"]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    assert len(port["params"]) == len(ref["params"])
    for p, j in zip(port["params"], ref["params"]):
        np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-6)


def _q8_cands(mod):
    return [mod.StrategySpec("ddp_plan", "ddp", transport="plan", wire="q8"),
            mod.StrategySpec("diloco_q8_h4", "diloco", sync_every=4,
                             wire="q8", sharded=True)]


def test_port_cohort_switches_together():
    # the switch at tick 4, then windows of 4: the run ends on a sync
    a, b = _cohort(["port", "port"], steps=16, cands=_q8_cands)
    assert _rows(a["decisions"]) == _rows(b["decisions"])
    assert a["decisions"] == b["decisions"]
    assert a["strategy"] == b["strategy"] == "diloco_q8_h4"
    switch = next(d for d in a["decisions"] if d["switched"])
    assert switch["signals"]["wire_eff_MBps"] == 2.0  # the trigger
    for x, y in zip(a["params"], b["params"]):
        assert x.tobytes() == y.tobytes()


def _sharded_cands(mod):
    # the sharded outer sync assigns the gathered params: members end
    # bit-identical (AsyncDiLoCo's reconcile leaves each member's params
    # within its own rounding of the agreed backup)
    return [mod.StrategySpec("ddp", "ddp"),
            mod.StrategySpec("diloco_h4", "diloco", sync_every=4,
                             sharded=True)]


def test_member_failure_aborts_the_switch_for_all():
    # the aborted decision at tick 4, the switch at tick 8, then windows
    # of 4: the run ends on a sync
    a, b = _cohort(["port", "port"], steps=20, cands=_sharded_cands,
                   fail_epoch=0)
    assert (_rows(a["decisions"]) == _rows(b["decisions"]))
    first = a["decisions"][0]
    assert first["committed"] is False and first["switched"] is False
    assert any(d["switched"] for d in a["decisions"][1:])
    assert a["strategy"] == b["strategy"]
    for x, y in zip(a["params"], b["params"]):
        assert x.tobytes() == y.tobytes()


def test_mixed_cohort_takes_the_same_decisions():
    cands = [("ddp", "ddp", 1, None), ("localsgd_h4", "localsgd", 4, None)]
    jax_m, port_m = _cohort(["jax", "port"], steps=12, cands=cands,
                            heal_state=False)
    assert jax_m["decisions"] and port_m["decisions"]
    # one gathered aggregate, one pure cost model: the rows are equal,
    # signals and costs included
    assert jax_m["decisions"] == port_m["decisions"]
    assert port_m["strategy"] == "localsgd_h4"


def test_state_dict_round_trip_carries_strategy_and_clocks():
    lighthouse = tft.Lighthouse(min_replicas=1, join_timeout_ms=200)
    store = tft.Store()
    col = tft.HostCollectives(timeout=_T)
    manager = tft.Manager(
        collectives=col, load_state_dict=lambda s: None, state_dict=lambda: {},
        min_replica_size=1, rank=0, world_size=1, use_async_quorum=False,
        store_addr=store.address(), lighthouse_addr=lighthouse.address(),
        replica_id="policy_sd", device="cpu")
    cfg = tt.TransformerConfig(**_KW, dtype=torch.float32)
    init = _jax_init()
    try:
        cands = [tpol.StrategySpec("ddp", "ddp"),
                 tpol.StrategySpec("localsgd_h4", "localsgd", sync_every=4)]

        def engine():
            state = tft.FTTrainState(_port_params(cfg, init), tft.SGD(0.1))
            return state, tpol.PolicyEngine(
                manager, state, tt.make_grad_fn(cfg), candidates=cands,
                decide_every=2, initial="localsgd_h4")

        state, policy = engine()
        for i in range(3):
            policy.step(torch.from_numpy(_tokens(0, i)).long())
        sd = policy.state_dict()
        assert sd["policy"]["current"] == 1 and sd["policy"]["ticks"] == 3
        state2, policy2 = engine()
        policy2._current = 0
        policy2.load_state_dict(sd)
        assert (policy2._ticks, policy2._current, policy2._decide_epoch) == (
            policy._ticks, policy._current, policy._decide_epoch)
        assert policy2._engine(policy2.strategy)._local_step == 3
        for x, y in zip(flatten(state2.params)[0], flatten(state.params)[0]):
            assert torch.equal(x, y)
    finally:
        manager.shutdown()
        col.shutdown()
        store.shutdown()
        lighthouse.shutdown()


def test_construction_gates():
    lighthouse = tft.Lighthouse(min_replicas=1, join_timeout_ms=200)
    col = tft.HostCollectives(timeout=_T)
    manager = tft.Manager(
        collectives=col, load_state_dict=lambda s: None, state_dict=lambda: {},
        min_replica_size=1, rank=0, world_size=1,
        lighthouse_addr=lighthouse.address(), replica_id="gates",
        device="cpu")
    state = tft.FTTrainState({"w": torch.ones(4, 4)}, tft.SGD(0.1))
    try:
        # async quorum and no outer optimizer: diloco cannot run; the iso
        # plane waits for the Manager's isolated data plane
        only_diloco = [tpol.StrategySpec("d", "diloco", sync_every=4),
                       tpol.StrategySpec("i", "ddp", transport="iso")]
        with pytest.raises(ValueError, match="no candidate"):
            tpol.PolicyEngine(manager, state, None, candidates=only_diloco)
        eng = tpol.PolicyEngine(manager, state, None)
        names = [c.name for c in eng._candidates]
        assert names == [c.name for c in jpol.default_candidates(
            f32_masters=True, topology_labeled=bool(manager._region))]
        assert eng._model_bytes == 64
        assert [c.kind for c, ok in zip(eng._candidates, eng._avail)
                if not ok] == ["diloco", "diloco"]
    finally:
        manager.shutdown()
        col.shutdown()
        lighthouse.shutdown()
