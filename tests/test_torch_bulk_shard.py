"""The port's bulk split ops, sync quorum, card-leaf host pack,
``make_train_step`` and ``SGD`` against the JAX package.

- ``HostCollectives.reduce_scatter`` / ``allgather_into``: each member's
  shard, its ranges, layout and the gathered tree are bit-identical to a
  JAX ring's on the same numpy-seeded inputs, with a JAX member 0 in the
  port's ring (world 2 and 3, wires None/q8 and None/bf16, mixed dtypes
  on the f32 wire); ``grid_shard=True`` with the f32 allgather
  reproduces ``allreduce(wire="q8")`` bit for bit; the op stats carry
  the JAX package's keys.
- ``Manager(use_async_quorum=False)``: a late group heals inside
  ``start_quorum`` and takes part in that same step with its real
  contribution (it is participating, and its tree is not zeroed).
- ``plan_allreduce(device_pack=False)`` on card leaves (``cuda``).
- ``make_train_step`` against the JAX package's (f32 and bf16 working
  copies) and ``SGD`` against ``optax.sgd`` (plain, momentum, Nesterov),
  on full trees and on a 1-D shard.
"""

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
from torchft_tpu import collectives as jcol
from torchft_tpu import models as jmodels
from torchft_tpu._native import Store
import torchft_tpu_torch as tft
from torchft_tpu_torch import collectives as tcol
from torchft_tpu_torch._tree import flatten
from torchft_tpu_torch.models import transformer as tt

_T = timedelta(seconds=15)


@pytest.fixture
def store():
    s = Store()
    yield s
    s.shutdown()


def _ring(store, members, prefix):
    cols = [m() for m in members]
    addr = f"{store.address()}/{prefix}"
    with ThreadPoolExecutor(max_workers=len(cols)) as ex:
        for f in [ex.submit(c.configure, addr, r, len(cols))
                  for r, c in enumerate(cols)]:
            f.result(timeout=60)
    return cols


def _port(stripes=1):
    return lambda: tcol.HostCollectives(timeout=_T, stripes=stripes)


def _jax(stripes=1):
    return lambda: jcol.HostCollectives(timeout=_T, stripes=stripes)


def _run_all(cols, fn):
    results = [None] * len(cols)
    errors = []

    def run(r):
        try:
            results[r] = fn(r, cols[r])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,))
               for r in range(len(cols))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return results


def _shutdown(cols):
    for c in cols:
        c.shutdown()


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _leaves_bytes(tree):
    return [_np(l).tobytes() for l in flatten(tree)[0]]


# ---- the bulk reduce_scatter / allgather_into --------------------------


def _tree(r, n, mixed):
    rng = np.random.default_rng(70 + r)
    t = {"w": rng.standard_normal(n).astype(np.float32),
         "b": (rng.standard_normal((17, 13)) * 3).astype(np.float32)}
    if mixed:
        t["h"] = rng.standard_normal(301).astype(jnp.bfloat16)
        t["i"] = rng.integers(-50, 50, 97).astype(np.int32)
    return t


def _split_op(wire, ag_wire, n, mixed):
    def op(r, c):
        jaxy = isinstance(c, jcol.HostCollectives)
        g = _tree(r, n, mixed)
        if jaxy:
            g = jax.tree_util.tree_map(jnp.asarray, g)
        else:
            g = {k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                     if v.dtype == jnp.bfloat16 else torch.from_numpy(v))
                 for k, v in g.items()}
        rop = (jcol if jaxy else tcol).ReduceOp.AVG
        sh = c.reduce_scatter(g, rop, wire=wire).wait()
        vals = {k: _np(v).tobytes() for k, v in sh.values.items()}
        # an update of the f32 group: the param leg ships new values
        upd = dict(sh.values)
        upd["float32"] = sh.values["float32"] * 0.5 + 1.0
        out = c.allgather_into(sh.replace_values(upd), wire=ag_wire).wait()
        return (vals, {k: [tuple(x) for x in v] for k, v in sh.ranges.items()},
                dict(sh.layout), dict(sh.counts),
                {k: list(v) for k, v in sh.groups.items()},
                _leaves_bytes(out))
    return op


class TestBulkSplit:
    @pytest.mark.parametrize("wires,mixed", [((None, None), True),
                                             ((None, "bf16"), False),
                                             (("q8", None), False),
                                             (("q8", "bf16"), False)])
    @pytest.mark.parametrize("world", [2, 3])
    def test_legs_match_a_jax_ring(self, store, world, wires, mixed):
        """Shards, ranges, layout, groups and the gathered tree of every
        member equal a JAX-only ring's; the port's members share the
        ring with a JAX member 0."""
        wire, ag_wire = wires
        n = 70001  # > the 64 KiB stripe floor: more than one stripe
        op = _split_op(wire, ag_wire, n, mixed)
        tag = f"{world}{wire}{ag_wire}{mixed}"
        jcols = _ring(store, [_jax(4)] * world, "j" + tag)
        try:
            ref = _run_all(jcols, op)
        finally:
            _shutdown(jcols)
        mcols = _ring(store, [_jax(4)] + [_port(4)] * (world - 1), "m" + tag)
        try:
            got = _run_all(mcols, op)
            st = mcols[1].pop_op_stats()
        finally:
            _shutdown(mcols)
        assert got == ref
        rs = [s for s in st if s["op"] == "reduce_scatter"][-1]
        ag = [s for s in st if s["op"] == "allgather_into"][-1]
        for s in (rs, ag):
            assert {"bytes", "wire_bytes", "d2h_bytes", "ring", "h2d",
                    "stripe_s"} <= set(s)
        assert rs["shard_bytes"] < rs["bytes"] and rs["d2h_bytes"] == 0
        f32 = 4 * (n + 17 * 13)
        if not mixed:
            assert ag["wire_bytes"] == f32 // (2 if ag_wire else 1)
        # the ranges of the members tile each group
        for name, count in ref[0][3].items():
            seen = np.zeros(count, np.int32)
            for _, ranges, *_ in got:
                for s, ln in ranges[name]:
                    seen[s:s + ln] += 1
            assert (seen == 1).all()

    @pytest.mark.parametrize("world", [2, 3])
    def test_grid_shard_reproduces_the_fused_q8_allreduce(self, store, world):
        cols = _ring(store, [_port(4)] * world, f"grid{world}")
        try:
            def op(r, c):
                g = {k: torch.from_numpy(v)
                     for k, v in _tree(r, 70001, False).items()}
                fused = c.allreduce(g, tcol.ReduceOp.AVG, wire="q8").wait()
                sh = c.reduce_scatter(g, tcol.ReduceOp.AVG, wire="q8",
                                      grid_shard=True).wait()
                back = c.allgather_into(sh).wait()
                return _leaves_bytes(fused) == _leaves_bytes(back)

            assert all(_run_all(cols, op))
        finally:
            _shutdown(cols)

    def test_f32_legs_compose_to_the_allreduce(self, store):
        cols = _ring(store, [_port(1)] * 2, "compose")
        try:
            def op(r, c):
                g = {k: torch.from_numpy(v)
                     for k, v in _tree(r, 5003, False).items()}
                full = c.allreduce(g, tcol.ReduceOp.AVG).wait()
                sh = c.reduce_scatter(g, tcol.ReduceOp.AVG).wait()
                return _leaves_bytes(c.allgather_into(sh).wait()) == \
                    _leaves_bytes(full)

            assert all(_run_all(cols, op))
        finally:
            _shutdown(cols)

    def test_rejects_bad_arguments(self, store):
        cols = _ring(store, [_port()], "reject")
        c = cols[0]
        try:
            with pytest.raises(ValueError, match="unsupported"):
                c.reduce_scatter({"x": torch.ones(4)}, wire="bf16")
            with pytest.raises(ValueError, match="grid_shard"):
                c.reduce_scatter({"x": torch.ones(4)}, grid_shard=True)
            sh = c.reduce_scatter({"x": torch.ones(4)}).wait()
            with pytest.raises(ValueError, match="layout"):
                c.allgather_into(
                    sh.replace_values({"float32": torch.ones(3)})).wait()
            with pytest.raises(ValueError, match="unsupported"):
                c.allgather_into(sh, wire="q8")
        finally:
            _shutdown(cols)

    def test_dummy_round_trips(self):
        d = tft.DummyCollectives()
        g = {"a": torch.arange(6.0).view(2, 3), "b": torch.ones(4)}
        sh = d.reduce_scatter(g, divisor=2.0, wire="q8", grid_shard=True).wait()
        out = d.allgather_into(sh).wait()
        assert torch.equal(out["a"], g["a"] / 2) and torch.equal(out["b"], g["b"] / 2)


# ---- the synchronous quorum ---------------------------------------------


def _sync_scenario(pkg):
    """Group A trains alone, then group B joins with a fresh state: B's
    first ``start_quorum`` heals it and B takes part in that same step
    with its real contribution (the average of both, not A's alone).
    Returns what each group observed."""
    m = jft if pkg == "jax" else tft
    lighthouse = m.Lighthouse(min_replicas=1, join_timeout_ms=300,
                              quorum_tick_ms=50, heartbeat_timeout_ms=2000)
    joined = threading.Event()
    out, errors = {}, []

    def group(name, value, late):
        store = m.Store()
        if pkg == "jax":
            col = jcol.HostCollectives(timeout=_T)
            state = {"w": np.zeros(4, np.float32)}

            def load(sd):
                state["w"] = np.array(sd["w"], np.float32)

            def avg_of(v):
                return np.asarray(v["x"])
        else:
            col = tcol.HostCollectives(timeout=_T)
            state = {"w": torch.zeros(4)}

            def load(sd):
                state["w"].copy_(torch.as_tensor(np.asarray(sd["w"])))

            def avg_of(v):
                return v["x"].numpy()
        kw = {} if pkg == "jax" else {"device": "cpu"}
        manager = m.Manager(
            collectives=col, load_state_dict=load,
            state_dict=lambda: {"w": state["w"]}, min_replica_size=1,
            rank=0, world_size=1, use_async_quorum=False, timeout=_T,
            quorum_timeout=_T, store_addr=store.address(),
            lighthouse_addr=lighthouse.address(), replica_id=name, **kw)
        seen = []
        try:
            for step in range(40):
                manager.start_quorum()
                n = manager.num_participants()
                x = np.full(4, value, np.float32)
                contrib = ({"x": jnp.asarray(x)} if pkg == "jax"
                           else {"x": torch.from_numpy(x)})
                w_at_start = np.array(state["w"], np.float32)
                avg = avg_of(manager.allreduce(contrib).wait())
                ok = manager.should_commit()
                if ok and pkg == "jax":
                    state["w"] = state["w"] + 1.0
                elif ok:
                    state["w"].add_(1.0)
                seen.append({"n": n, "participating":
                             manager.is_participating(),
                             "avg": float(avg[0]), "commit": ok,
                             "w_at_start": float(w_at_start[0])})
                if not late and step == 2:
                    joined.set()
                if n == 2 and sum(s["n"] == 2 for s in seen) >= 2:
                    break
            counters = manager.metrics().snapshot()["counters"]
            out[name] = {"seen": seen,
                         "heals": counters.get("heals", 0)
                         + counters.get("init_sync_heals", 0)}
        finally:
            manager.shutdown()
            col.shutdown()
            store.shutdown()

    def run(name, value, late):
        try:
            if late:
                assert joined.wait(60)
            group(name, value, late)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=run, args=a)
          for a in (("a", 1.0, False), ("b", 3.0, True))]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]
    return out


class TestSyncQuorum:
    def test_healer_takes_part_in_its_join_step(self):
        got = _sync_scenario("port")
        b_first = got["b"]["seen"][0]
        # B healed inside start_quorum: its state is A's before the step
        assert got["b"]["heals"] >= 1
        assert b_first["w_at_start"] >= 3.0
        # ... and it contributed its own value, counted among two
        assert b_first["participating"] and b_first["n"] == 2
        assert b_first["avg"] == 2.0 and b_first["commit"]
        a_joint = [s for s in got["a"]["seen"] if s["n"] == 2]
        assert a_joint[0]["avg"] == 2.0
        assert all(s["commit"] for s in got["a"]["seen"])

    def test_matches_the_jax_package(self):
        """The same scenario through the JAX package's Manager: the same
        participation, divisors and averages at the join step."""
        port, ref = _sync_scenario("port"), _sync_scenario("jax")
        pick = ("n", "participating", "avg", "commit")
        assert [{k: s[k] for k in pick} for s in port["b"]["seen"]] == \
            [{k: s[k] for k in pick} for s in ref["b"]["seen"]]

    def test_async_quorum_healer_sits_its_step_out(self):
        got = _sync_scenario_async()
        b_first = got[0]
        assert not b_first["participating"] and b_first["n"] == 1


def _sync_scenario_async():
    """The async-quorum contrast: a healer's first step is zeroed and not
    counted (it heals at the vote)."""
    lighthouse = tft.Lighthouse(min_replicas=1, join_timeout_ms=300,
                                quorum_tick_ms=50, heartbeat_timeout_ms=2000)
    joined = threading.Event()
    seen_b, errors = [], []

    def group(name, late):
        store = tft.Store()
        col = tcol.HostCollectives(timeout=_T)
        w = torch.zeros(4)
        manager = tft.Manager(
            collectives=col, load_state_dict=lambda sd: w.copy_(
                torch.as_tensor(np.asarray(sd["w"]))),
            state_dict=lambda: {"w": w}, min_replica_size=1, rank=0,
            world_size=1, timeout=_T, quorum_timeout=_T,
            store_addr=store.address(), lighthouse_addr=lighthouse.address(),
            replica_id=name, device="cpu")
        try:
            joint = 0
            for step in range(40):
                manager.start_quorum()
                n = manager.num_participants()
                part = manager.is_participating()
                manager.allreduce({"x": torch.ones(4)}).wait()
                manager.should_commit()
                w.add_(1.0)
                if late:
                    seen_b.append({"n": n, "participating": part})
                    return
                if step == 2:
                    joined.set()
                joint += manager._collectives.size() == 2
                if joint >= 2:
                    return
        finally:
            manager.shutdown()
            col.shutdown()
            store.shutdown()

    def run(name, late):
        try:
            if late:
                assert joined.wait(60)
            group(name, late)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=run, args=a)
          for a in (("a", False), ("b", True))]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]
    return seen_b


# ---- the host pack of card leaves (needs the card) ------------------------


@pytest.mark.cuda
def test_card_leaves_take_the_host_pack_when_asked():
    """``plan_allreduce(device_pack=False)`` on card leaves copies them
    into the plan's pinned inputs and runs the native pack; the result
    returns to the card, equal to the device pack's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store = Store()
    c = tcol.HostCollectives(stripes=1)
    c.configure(f"{store.address()}/hp", 0, 1)
    try:
        dev = torch.device("cuda")
        g = {"w": torch.linspace(-2, 3, 5003, device=dev)}
        for wire in (None, "bf16", "q8ef"):
            host = c.plan_allreduce(g, wire=wire, device_pack=False).wait()
            card = c.plan_allreduce(g, wire=wire, device_pack=True).wait()
            assert host["w"].is_cuda and torch.equal(host["w"], card["w"])
        st = c.pop_op_stats()
        assert [s["device_pack"] for s in st] == [False, True] * 3
    finally:
        c.shutdown()
        store.shutdown()


# ---- make_train_step and SGD against the JAX package -------------------


_LM = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq_len=128)

# Max |port - JAX| of the params after two steps, relative to the largest
# update of the leaf: f32 compute differs in summation order only; a
# bf16 working copy accumulates multi-use gradients in bf16 (the two
# sides sum in different orders: 2.7e-3 read); bf16 compute adds the
# rounding XLA's CPU backend skips inside fused chains (1.6e-2 read).
_TRAIN_TOL = {("f32", False): (1e-4, 1e-6), ("f32", True): (1e-2, 1e-5),
              ("bf16", False): (5e-2, 1e-3), ("bf16", True): (5e-2, 1e-3)}


class TestMakeTrainStep:
    @pytest.mark.parametrize("dtype_name,bf16_params", sorted(_TRAIN_TOL))
    def test_matches_the_jax_package(self, dtype_name, bf16_params):
        jdt, tdt = {"f32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
        jcfg = jmodels.transformer.TransformerConfig(**_LM, dtype=jdt)
        tcfg = tt.TransformerConfig(**_LM, dtype=tdt)
        jp = jmodels.transformer.init_params(jcfg, jax.random.PRNGKey(0))
        p0 = jax.tree_util.tree_map(np.asarray, jp)
        tp = tt.params_from_jax(p0, device="cpu")
        toks = np.random.default_rng(0).integers(0, 256, size=(3, 33),
                                                 dtype=np.int32)
        jstep = jmodels.transformer.make_train_step(
            jcfg, optax.sgd(0.1), bf16_params=bf16_params)
        jo = optax.sgd(0.1).init(jp)
        tstep = tt.make_train_step(tcfg, tft.SGD(0.1),
                                   bf16_params=bf16_params)
        to = tft.SGD(0.1).init(tp)
        for _ in range(2):
            jp, jo, jl = jstep(jp, jo, jnp.asarray(toks))
            tp2, to, tl = tstep(tp, to, torch.from_numpy(toks))
            assert tp2 is tp  # updated in place
        rel, loss_rtol = _TRAIN_TOL[(dtype_name, bf16_params)]
        assert abs(float(tl) - float(jl)) <= loss_rtol * abs(float(jl))
        for a, b, p in zip(jax.tree_util.tree_leaves(jp), flatten(tp)[0],
                           jax.tree_util.tree_leaves(p0)):
            a = np.asarray(a)
            assert b.dtype == torch.float32  # the masters stay f32
            upd = np.max(np.abs(a - p))
            assert np.max(np.abs(b.numpy() - a)) <= rel * upd

    def test_bf16_working_copy_changes_the_gradients(self):
        cfg = tt.TransformerConfig(**_LM, dtype=torch.float32)
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, size=(2, 17)))
        outs = []
        for bf16 in (False, True):
            p = tt.init_params(cfg, seed=0, device="cpu")
            st = tft.AdamW(1e-3)
            o = st.init(p)
            tt.make_train_step(cfg, st, bf16_params=bf16)(p, o, toks)
            outs.append(torch.cat([l.reshape(-1) for l in flatten(p)[0]]))
        assert not torch.equal(outs[0], outs[1])
        assert torch.isfinite(outs[1]).all()


F32 = np.float32


def _t(x):
    return torch.from_numpy(np.array(x, F32))


class TestSGDMatchesOptax:
    @pytest.mark.parametrize("kw", [{}, {"momentum": 0.9},
                                    {"momentum": 0.9, "nesterov": True}])
    def test_tree_and_shard(self, kw):
        rng = np.random.default_rng(8)
        p = {"a": rng.standard_normal((6, 5)).astype(F32),
             "b": rng.standard_normal(9).astype(F32)}
        gs = [{k: rng.standard_normal(v.shape).astype(F32) for k, v in p.items()}
              for _ in range(4)]
        tx = optax.sgd(0.7, **kw)
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        js = tx.init(jp)
        port = tft.SGD(0.7, **kw)
        tp = {k: _t(v) for k, v in p.items()}
        ts = port.init(tp)
        # a 1-D shard (the sharded outer step's operand)
        shard = _t(p["a"].ravel()[3:17])
        ss = port.init({"float32": shard})
        jsh = jnp.asarray(p["a"].ravel()[3:17])
        jss = tx.init({"float32": jsh})
        with jax.disable_jit():
            for g in gs:
                u, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
                jp = optax.apply_updates(jp, u)
                port.update_(tp, ts, {k: _t(v) for k, v in g.items()})
                gsh = {"float32": jnp.asarray(g["a"].ravel()[3:17])}
                u2, jss = tx.update(gsh, jss, {"float32": jsh})
                jsh = optax.apply_updates({"float32": jsh}, u2)["float32"]
                port.update_({"float32": shard}, ss,
                             {"float32": _t(g["a"].ravel()[3:17])})
        for k in p:
            assert tp[k].numpy().tobytes() == np.asarray(jp[k]).tobytes()
        assert shard.numpy().tobytes() == np.asarray(jsh).tobytes()
        if kw:
            assert ss["trace"]["float32"].numpy().tobytes() == np.asarray(
                jax.tree_util.tree_leaves(jss)[0]).tobytes()


