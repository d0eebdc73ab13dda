"""The port's per-step ZeRO against the JAX package's.

- ``plan_reduce_scatter`` / ``plan_allgather_into``: each member's
  shard, its ranges and the gathered tree are bit-identical to a JAX
  ring's on the same numpy-seeded inputs (world 2 and 3, stripes 1 and
  4, the f32 and the q8/bf16 wires), with the JAX package's member 0 in
  the port's ring.
- ``ShardedDDP`` and ``ShardedOptimizerWrapper``: the cases of
  ``tests/test_sharded_ddp.py`` over the port's AdamW (f32 bit identity
  to the fused plan step, lossy wires cohort-identical, the ~1/W state,
  the reshard on a membership change against a full-vector oracle, the
  ``state_dict`` round trip, the heal's stream, an aborted step keeping
  the pre-step state); the port's trajectory against the JAX package's
  optax ``adamw`` one; and a JAX and a port member in one ring on both
  wires committing bit-identical params.

Over real ``HostCollectives`` rings with a deterministic manager fake
(fixed quorum, always commits), as the JAX package's tests run.
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
from torchft_tpu._native import Store
import torchft_tpu_torch as tft
from torchft_tpu_torch import checkpointing as ck
from torchft_tpu_torch import collectives as tcol
from torchft_tpu_torch._tree import flatten
from torchft_tpu_torch.train_state import build_shard_apply_step

_T = timedelta(seconds=15)


@pytest.fixture
def store():
    s = Store()
    yield s
    s.shutdown()


def _ring(store, members, prefix):
    """``members``: one HostCollectives factory per rank."""
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

    threads = [threading.Thread(target=run, args=(r,)) for r in range(len(cols))]
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
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree):
    leaves = (flatten(tree)[0] if not isinstance(tree, np.ndarray) else [tree])
    return np.concatenate([_np(l).ravel() for l in leaves])


# ---- the sharded plan ---------------------------------------------------


def _big_grads(r, n):
    rng = np.random.default_rng(50 + r)
    return {"w": rng.standard_normal(n).astype(np.float32),
            "b": rng.standard_normal((17, 13)).astype(np.float32) * 3}


class TestShardedPlan:
    @pytest.mark.parametrize("wires", [(None, None), ("q8", "bf16")])
    @pytest.mark.parametrize("world,stripes", [(2, 1), (2, 4), (3, 1), (3, 4)])
    def test_legs_match_a_jax_ring(self, store, world, stripes, wires):
        """Shard bits, ranges, layout and the gathered tree of every member
        equal a JAX-only ring's; the port's members share the ring with a
        JAX member 0."""
        wire, ag_wire = wires
        n = 70001  # > 4 stripes' worth of the 64 KiB stripe floor

        def op(r, c):
            jaxy = isinstance(c, jcol.HostCollectives)
            g = _big_grads(r, n)
            g = (jax.tree_util.tree_map(jnp.asarray, g) if jaxy
                 else {k: torch.from_numpy(v) for k, v in g.items()})
            rop = (jcol if jaxy else tcol).ReduceOp.AVG
            sh = c.plan_reduce_scatter(g, rop, wire=wire, ag_wire=ag_wire).wait()
            v = sh.values["float32"]
            upd = v * 0.5 + 1.0  # an update: the param leg ships new values
            out = c.plan_allgather_into(
                sh.replace_values({"float32": upd}), wire=ag_wire).wait()
            return (_np(v).tobytes(), [tuple(x) for x in sh.ranges["float32"]],
                    sh.layout["float32"], sh.counts["float32"],
                    [_np(l).tobytes() for l in flatten(out)[0]])

        jcols = _ring(store, [_jax(stripes)] * world, f"j{world}{stripes}{wire}")
        try:
            ref = _run_all(jcols, op)
        finally:
            _shutdown(jcols)
        mcols = _ring(store, [_jax(stripes)] + [_port(stripes)] * (world - 1),
                      f"m{world}{stripes}{wire}")
        try:
            got = _run_all(mcols, op)
            st = mcols[1].pop_op_stats()
        finally:
            _shutdown(mcols)
        assert got == ref
        rs, ag = [s for s in st if s["op"] == "plan_reduce_scatter"][-1], \
            [s for s in st if s["op"] == "plan_allgather_into"][-1]
        assert rs["shard_bytes"] < rs["bytes"] and rs["d2h_bytes"] == 0
        assert ag["wire_bytes"] == rs["bytes"] // (2 if ag_wire else 1)
        # the ranges of the members tile the flat tree
        seen = np.zeros(ref[0][3], np.int32)
        for _, ranges, *_ in got:
            for s, ln in ranges:
                seen[s:s + ln] += 1
        assert (seen == 1).all()

    def test_f32_shard_is_the_fused_plans_slice(self, store):
        cols = _ring(store, [_port()] * 2, "slice")
        try:
            def op(r, c):
                g = {k: torch.from_numpy(v) for k, v in _big_grads(r, 5003).items()}
                sh = c.plan_reduce_scatter(g, tcol.ReduceOp.AVG).wait()
                full = c.plan_allreduce(g, tcol.ReduceOp.AVG).wait()
                flat = _flat(full)
                want = np.concatenate([flat[s:s + ln] for s, ln in
                                       sh.ranges["float32"]])
                return _np(sh.values["float32"]).tobytes() == want.tobytes()

            assert all(_run_all(cols, op))
        finally:
            _shutdown(cols)

    def test_rejects_what_the_plan_cannot_take(self, store):
        cols = _ring(store, [_port()], "reject")
        try:
            with pytest.raises(ValueError, match="f32"):
                cols[0].plan_reduce_scatter(
                    {"x": torch.ones(4, dtype=torch.bfloat16)}).wait()
            sh = cols[0].plan_reduce_scatter({"x": torch.ones(4)},
                                             ag_wire="bf16").wait()
            with pytest.raises(ValueError, match="ag_wire"):
                cols[0].plan_allgather_into(sh, wire=None).wait()
            with pytest.raises(ValueError, match="unsupported"):
                cols[0].plan_reduce_scatter({"x": torch.ones(4)}, wire="q8ef")
        finally:
            _shutdown(cols)


# ---- ShardedDDP ---------------------------------------------------------


class _PlanRingManager:
    """A deterministic manager over a real ring with the sharded-plan
    surface: full participation, always commits, a fixed quorum id."""

    def __init__(self, col, quorum_id=1, rop=tcol.ReduceOp):
        self._col = col
        self._rop = rop
        self.qid = quorum_id
        self.commit = True
        self.opt_bytes_reports = []

    def start_quorum(self, **kw):
        pass

    def plan_reduce_scatter(self, tree, op=None, wire=None, ag_wire=None):
        return self._col.plan_reduce_scatter(
            tree, self._rop.SUM, divisor=float(self._col.size()), wire=wire,
            ag_wire=ag_wire)

    def plan_allgather_into(self, shard, wire=None):
        return self._col.plan_allgather_into(shard, wire=wire)

    def allgather(self, tree):
        return self._col.allgather(tree)

    def quorum_id(self):
        return self.qid

    def should_commit(self):
        return self.commit

    def report_error(self, e):
        raise e

    def report_opt_state_bytes(self, nbytes):
        self.opt_bytes_reports.append(int(nbytes))


# two leaves whose total (5003 + 257) no tested world size divides;
# dict keys sort in flatten order ("b" before "w")
_W_N, _B_N = 5003, 257
_TOTAL = _W_N + _B_N


def _params_np():
    return {"w": np.linspace(-1.0, 1.0, _W_N, dtype=np.float32),
            "b": np.linspace(0.5, 2.0, _B_N, dtype=np.float32)}


def _params():
    return {k: torch.from_numpy(v.copy()) for k, v in _params_np().items()}


def _grads_np(r, s):
    rng = np.random.default_rng(1000 + 37 * r + s)
    return {"w": rng.standard_normal(_W_N).astype(np.float32),
            "b": rng.standard_normal(_B_N).astype(np.float32)}


def _grads(r, s):
    return {k: torch.from_numpy(v) for k, v in _grads_np(r, s).items()}


def _tx():
    return tft.AdamW(1e-2)


def _run_sharded(store, world, prefix, steps, stripes=1, shard_wire=None,
                 param_wire=None):
    cols = _ring(store, [_port(stripes)] * world, prefix)

    def member(r, col):
        st = tft.FTTrainState(_params(), _tx(), opt_state=())
        m = _PlanRingManager(col)
        ddp = tft.ShardedDDP(m, st, grad_fn=None, shard_wire=shard_wire,
                             param_wire=param_wire)
        for s in range(steps):
            assert ddp.apply_gradients(_grads(r, s))
        return st, ddp, m

    try:
        return _run_all(cols, member)
    finally:
        _shutdown(cols)


def _run_unsharded_oracle(store, world, prefix, steps, stripes=1):
    """The fused path: the plan allreduce (SUM + the f32 divide the rs leg
    performs) and the same shard-local AdamW step over the whole flat
    vector (a shard of size total)."""
    cols = _ring(store, [_port(stripes)] * world, prefix)

    def member(r, col):
        params = torch.from_numpy(_flat(_params_np()))
        tx = _tx()
        opt = tx.init(params)
        apply = build_shard_apply_step(tx)
        for s in range(steps):
            avg = col.plan_allreduce(_grads(r, s), tcol.ReduceOp.SUM,
                                     divisor=float(world)).wait()
            params, opt = apply(params, opt, torch.from_numpy(_flat(avg)))
        return _np(params)

    try:
        return _run_all(cols, member)
    finally:
        _shutdown(cols)


class TestShardedStepBitIdentity:
    @pytest.mark.parametrize("world,stripes", [(2, 1), (2, 4), (3, 1), (5, 2)])
    def test_f32_matches_unsharded_bitwise(self, store, world, stripes):
        oracle = _run_unsharded_oracle(store, world, f"or{world}{stripes}",
                                       steps=3, stripes=stripes)
        res = _run_sharded(store, world, f"sh{world}{stripes}", steps=3,
                           stripes=stripes)
        for st, _, _ in res:
            assert _flat(st.params).tobytes() == oracle[0].tobytes()

    @pytest.mark.parametrize("shard_wire,param_wire",
                             [("bf16", None), ("q8", "bf16"), ("q8", None)])
    def test_lossy_wires_cohort_identical_and_close(self, store, shard_wire,
                                                    param_wire):
        oracle = _run_unsharded_oracle(store, 3, f"orl{shard_wire}{param_wire}",
                                       steps=3)
        res = _run_sharded(store, 3, f"shl{shard_wire}{param_wire}", steps=3,
                           shard_wire=shard_wire, param_wire=param_wire)
        flats = [_flat(st.params) for st, _, _ in res]
        for f in flats[1:]:
            assert f.tobytes() == flats[0].tobytes()
        np.testing.assert_allclose(flats[0], oracle[0], rtol=0.05, atol=0.05)

    def test_auto_param_wire_is_bf16_iff_q8(self):
        st = tft.FTTrainState(_params(), _tx(), opt_state=())
        assert tft.ShardedDDP(None, st, None, shard_wire="q8")._param_wire == "bf16"
        assert tft.ShardedDDP(None, st, None, shard_wire="bf16")._param_wire is None
        assert tft.ShardedDDP(None, st, None)._param_wire is None

    def test_rejects_non_f32_masters(self):
        st = tft.FTTrainState({"w": torch.ones(4, dtype=torch.bfloat16)},
                              _tx(), opt_state=())
        with pytest.raises(ValueError, match="f32 master"):
            tft.ShardedDDP(None, st, None)

    def test_opt_state_is_never_allocated_full_size(self):
        st = tft.FTTrainState(_params(), _tx(), opt_state=())
        assert st.opt_state == ()
        st.load_state_dict(st.state_dict())  # a heal of such a state


class TestShardedOptimizerState:
    def test_state_is_sharded_and_tiles_the_model(self, store):
        res = _run_sharded(store, 3, "mem", steps=1)
        seen = np.zeros(_TOTAL, np.int32)
        for _, ddp, m in res:
            meta = ddp._shard_meta
            assert meta is not None and meta["quorum_id"] == 1
            ln = 0
            for s, l in meta["ranges"]["float32"]:
                seen[s:s + l] += 1
                ln += l
            assert ln < _TOTAL
            # AdamW: mu and nu are shard-sized; the count is a Python int
            assert ddp._opt_shard["mu"].numel() == ddp._opt_shard["nu"].numel() == ln
            assert isinstance(ddp._opt_shard["count"], int)
            assert m.opt_bytes_reports[-1] == ddp.opt_state_bytes() == 2 * 4 * ln
        assert (seen == 1).all()

    def test_opt_state_bytes_scale_inverse_with_world(self, store):
        per_world = {w: sum(ddp.opt_state_bytes() for _, ddp, _ in
                            _run_sharded(store, w, f"scale{w}", steps=1))
                     for w in (2, 3)}
        assert per_world[2] == pytest.approx(per_world[3], rel=0.05)
        assert per_world[2] == 2 * 4 * _TOTAL


class TestReshardOnMembershipChange:
    def test_survivor_moments_carry_departed_restart_zero(self, store):
        """Three members take a step; member 2 departs and the survivors
        re-form at quorum 2. Their new shards hold the survivors' old
        moments and zeros where member 2's shard was, which a replay of
        the step over the whole vector (carried moments grafted in)
        confirms."""
        tx = _tx()
        cols3 = _ring(store, [_port()] * 3, "pre")

        def one_step(r, col):
            st = tft.FTTrainState(_params(), tx, opt_state=())
            m = _PlanRingManager(col, quorum_id=1)
            ddp = tft.ShardedDDP(m, st, grad_fn=None)
            assert ddp.apply_gradients(_grads(r, 0))
            return st, ddp, m

        try:
            res = _run_all(cols3, one_step)
        finally:
            _shutdown(cols3)
        states, ddps, mans = zip(*res)
        params_after1 = _flat(states[0].params)
        full = {k: np.zeros(_TOTAL, np.float32) for k in ("mu", "nu")}
        for ddp in ddps:
            for k in full:
                off = 0
                arr = _np(ddp._opt_shard[k])
                for s, ln in ddp._shard_meta["ranges"]["float32"]:
                    full[k][s:s + ln] = arr[off:off + ln]
                    off += ln
        carried = {k: v.copy() for k, v in full.items()}
        for s, ln in ddps[2]._shard_meta["ranges"]["float32"]:
            for k in carried:
                carried[k][s:s + ln] = 0.0

        cols2 = _ring(store, [_port()] * 2, "post")

        def resync(r, col):
            mans[r]._col = col
            mans[r].qid = 2
            assert ddps[r].apply_gradients(_grads(r, 1))

        try:
            _run_all(cols2, resync)
        finally:
            _shutdown(cols2)
        assert _flat(states[0].params).tobytes() == _flat(states[1].params).tobytes()
        avg = (_flat(_grads_np(0, 1)) + _flat(_grads_np(1, 1))) / np.float32(2)
        opt = {"count": 1, "mu": torch.from_numpy(carried["mu"]),
               "nu": torch.from_numpy(carried["nu"])}
        new_p, new_opt = build_shard_apply_step(tx)(
            torch.from_numpy(params_after1.copy()), opt, torch.from_numpy(avg))
        np.testing.assert_allclose(_flat(states[0].params), _np(new_p),
                                   rtol=1e-6, atol=1e-6)
        for r in (0, 1):
            meta = ddps[r]._shard_meta
            assert meta["quorum_id"] == 2
            for k in ("mu", "nu"):
                want = np.concatenate([_np(new_opt[k])[s:s + ln] for s, ln in
                                       meta["ranges"]["float32"]])
                np.testing.assert_allclose(_np(ddps[r]._opt_shard[k]), want,
                                           rtol=1e-6, atol=1e-9)
            assert len(mans[r].opt_bytes_reports) == 2


class TestHealAndCheckpoint:
    def test_state_dict_roundtrip_voids_meta_and_reshards(self, store):
        ((ref, _, _),) = _run_sharded(store, 1, "ref", steps=4)
        cols = _ring(store, [_port()], "ckpt")
        try:
            st = tft.FTTrainState(_params(), _tx(), opt_state=())
            ddp = tft.ShardedDDP(_PlanRingManager(cols[0]), st, grad_fn=None)
            for s in range(2):
                assert ddp.apply_gradients(_grads(0, s))
            sd = ddp.state_dict()
            st2 = tft.FTTrainState(_params(), _tx(), opt_state=())
            m2 = _PlanRingManager(cols[0])
            ddp2 = tft.ShardedDDP(m2, st2, grad_fn=None)
            ddp2.load_state_dict(sd)
            assert ddp2._shard_meta["quorum_id"] == -1
            assert ddp2._opt_shard is not None
            for s in range(2, 4):
                assert ddp2.apply_gradients(_grads(0, s))
            assert ddp2._shard_meta["quorum_id"] == 1
            assert m2.opt_bytes_reports
            assert _flat(st2.params).tobytes() == _flat(ref.params).tobytes()
        finally:
            _shutdown(cols)

    @pytest.mark.parametrize("wire", [None, "bf16"])
    def test_state_dict_heals_through_the_stream(self, store, wire):
        """A donor's ``ShardedDDP.state_dict`` (an ``opt_state=()`` state,
        the shard with its Python-int count, ``shard_meta`` of ints and
        tuples) through the streamed heal, loaded by a fresh member; a
        ``None`` shard too."""
        ((st, ddp, _),) = _run_sharded(store, 1, "heal", steps=2)
        server = ck.CheckpointServer(timeout=_T, device="cpu")
        try:
            for k, sd in enumerate((ddp.state_dict(),
                                    {**ddp.state_dict(), "opt_shard": None,
                                     "shard_meta": None})):
                server.send_checkpoint([1], k + 1, {"user": sd, "torchft": {}}, _T)
                out, stats = ck.CheckpointServer._fetch(
                    f"{server.address()}{k + 1}", _T, device="cpu", wire=wire)
                assert stats["path"] == "stream"
                healed = tft.ShardedDDP(
                    None, tft.FTTrainState(_params(), _tx(), opt_state=()), None)
                healed.load_state_dict(out["user"])
                assert _flat(healed._state.params).tobytes() == _flat(st.params).tobytes()
                if sd["opt_shard"] is None:
                    assert healed._opt_shard is None and healed._shard_meta is None
                    continue
                assert healed._opt_shard["count"] == 2
                for m in ("mu", "nu"):  # not under "opt_state": raw on either wire
                    assert _np(healed._opt_shard[m]).tobytes() == \
                        _np(ddp._opt_shard[m]).tobytes()
                assert healed._shard_meta == {**ddp._shard_meta, "quorum_id": -1}
        finally:
            server.shutdown()

    def test_begin_fresh_shard_drops_state(self, store):
        ((_, ddp, _),) = _run_sharded(store, 1, "fresh", steps=1)
        assert ddp._opt_shard is not None
        ddp.begin_fresh_shard()
        assert ddp._opt_shard is None and ddp._shard_meta is None


class TestShardedOptimizerWrapper:
    def test_wrapper_matches_engine_bitwise(self, store):
        ref = _run_sharded(store, 2, "eng", steps=3)
        cols = _ring(store, [_port()] * 2, "wrap")

        def member(r, col):
            st = tft.FTTrainState(_params(), _tx(), opt_state=())
            opt = tft.ShardedOptimizerWrapper(_PlanRingManager(col), st)
            for s in range(3):
                opt.zero_grad()
                assert opt.step(_grads(r, s))
            assert opt.last_commit is True and opt.opt_state_bytes() > 0
            return st

        try:
            res = _run_all(cols, member)
        finally:
            _shutdown(cols)
        for st, (ref_st, _, _) in zip(res, ref):
            assert _flat(st.params).tobytes() == _flat(ref_st.params).tobytes()

    def test_wrapper_state_dict_delegates(self):
        st = tft.FTTrainState(_params(), _tx(), opt_state=())
        opt = tft.ShardedOptimizerWrapper(None, st, shard_wire="q8")
        sd = opt.state_dict()
        assert set(sd) == {"state", "opt_shard", "shard_meta"}
        opt.load_state_dict(sd)
        assert opt._core._opt_shard is None


class TestAbortKeepsPreStepState:
    def test_failed_commit_rolls_back(self, store):
        cols = _ring(store, [_port()] * 2, "abort")

        def member(r, col):
            st = tft.FTTrainState(_params(), _tx(), opt_state=())
            m = _PlanRingManager(col)
            ddp = tft.ShardedDDP(m, st, grad_fn=None)
            assert ddp.apply_gradients(_grads(r, 0))
            p1 = _flat(st.params)
            opt1 = {k: _np(v).copy() if isinstance(v, torch.Tensor) else v
                    for k, v in ddp._opt_shard.items()}
            m.commit = False
            assert not ddp.apply_gradients(_grads(r, 1))
            assert ddp.last_commit is False
            assert _flat(st.params).tobytes() == p1.tobytes()
            for k, v in opt1.items():
                got = ddp._opt_shard[k]
                assert (_np(got).tobytes() == v.tobytes()
                        if isinstance(v, np.ndarray) else got == v)

        try:
            _run_all(cols, member)
        finally:
            _shutdown(cols)


# ---- against the JAX package --------------------------------------------


def _jax_member(col, tx, shard_wire, param_wire):
    st = jft.FTTrainState(jax.tree_util.tree_map(jnp.asarray, _params_np()),
                          tx, opt_state=())
    m = _PlanRingManager(col, rop=jcol.ReduceOp)
    return st, jft.ShardedDDP(m, st, grad_fn=None, shard_wire=shard_wire,
                              param_wire=param_wire)


def _jgrads(r, s):
    return jax.tree_util.tree_map(jnp.asarray, _grads_np(r, s))


class TestAgainstTheJaxPackage:
    def test_adamw_trajectory_tracks_optax(self, store):
        """Two port members and two JAX members (optax ``adamw``) on the
        same gradients, three f32-wire steps: the port's AdamW keeps
        within 1e-6 of optax's."""
        opt_kw = dict(learning_rate=1e-2, weight_decay=1e-4)
        jcols = _ring(store, [_jax()] * 2, "jtraj")
        try:
            jres = _run_all(jcols, lambda r, c: self._steps(
                *_jax_member(c, optax.adamw(**opt_kw), None, None), r, _jgrads))
        finally:
            _shutdown(jcols)
        tcols = _ring(store, [_port()] * 2, "ttraj")

        def port(r, c):
            st = tft.FTTrainState(_params(), tft.AdamW(**opt_kw), opt_state=())
            return self._steps(st, tft.ShardedDDP(_PlanRingManager(c), st, None),
                               r, _grads)

        try:
            tres = _run_all(tcols, port)
        finally:
            _shutdown(tcols)
        np.testing.assert_allclose(tres[0], jres[0], rtol=1e-6, atol=1e-6)

    @staticmethod
    def _steps(st, ddp, r, grads):
        for s in range(3):
            assert ddp.apply_gradients(grads(r, s))
        return _flat(st.params)

    @pytest.mark.parametrize("shard_wire", [None, "q8"])
    def test_mixed_ring_commits_identical_params(self, store, shard_wire):
        """A JAX member (optax ``adamw``) and a port member (``AdamW``) in
        one sharded ring: each updates its own shard, and both adopt the
        same gathered bits (``param_wire`` bf16 on the q8 wire)."""
        cols = _ring(store, [_jax(), _port()], f"mixed{shard_wire}")

        def member(r, c):
            if r == 0:
                st, ddp = _jax_member(c, optax.adamw(1e-2), shard_wire, "auto")
                return self._steps(st, ddp, r, _jgrads)
            st = tft.FTTrainState(_params(), _tx(), opt_state=())
            ddp = tft.ShardedDDP(_PlanRingManager(c), st, None,
                                 shard_wire=shard_wire)
            return self._steps(st, ddp, r, _grads)

        try:
            res = _run_all(cols, member)
        finally:
            _shutdown(cols)
        assert res[0].tobytes() == res[1].tobytes()
