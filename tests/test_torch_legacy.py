"""The port's legacy transport against the JAX package's.

- ``quantize_with_feedback`` and the dequant-average are bit-exact
  against the JAX functions on the same numpy-seeded inputs (the carry
  over three steps included; the JAX functions run eagerly, since under
  jit XLA contracts ``d - q*scale`` and ``acc + q*scale`` into FMAs:
  ROADMAP Queue 3, F6), and a poisoned leaf poisons every output.
- ``allreduce`` (plain and ``wire="q8"``), ``allgather``, ``broadcast``,
  ``barrier`` and ``DummyCollectives``: the JAX package's tests ported,
  with JAX members holding jax arrays in the same ring as port members
  wherever the op is exact.
- ``PipelinedDDP(transport="legacy")`` in every ``compress`` mode, a JAX
  and a port member in one ring over three steps: the averaged
  gradients applied and the EF carry agree bit for bit, and a discarded
  step rolls the carry back exactly; then two port groups through real
  Managers, pipelined and blocking.
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import ml_dtypes
import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp
import optax

import torchft_tpu as jft
from torchft_tpu import collectives as jcol
from torchft_tpu import quantize as jq
from torchft_tpu._native import Store
import torchft_tpu_torch as tft
from torchft_tpu_torch import collectives as tcol
from torchft_tpu_torch import quantize as tq
from torchft_tpu_torch._tree import flatten, unflatten

_T = timedelta(seconds=20)


@pytest.fixture
def store():
    s = Store()
    yield s
    s.shutdown()


def _configure(cols, store, prefix):
    addr = f"{store.address()}/{prefix}"
    with ThreadPoolExecutor(max_workers=len(cols)) as ex:
        for f in [ex.submit(c.configure, addr, r, len(cols))
                  for r, c in enumerate(cols)]:
            f.result(timeout=60)
    return cols


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
        t.join(timeout=90)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return results


def _port_ring(store, world, prefix, **kw):
    return _configure([tcol.HostCollectives(timeout=_T, **kw)
                       for _ in range(world)], store, prefix)


def _mixed_ring(store, world, prefix, **kw):
    """Member 0 of the JAX package, the others of the port."""
    return _configure([jcol.HostCollectives(timeout=_T, **kw)]
                      + [tcol.HostCollectives(timeout=_T, **kw)
                         for _ in range(world - 1)], store, prefix)


def _shutdown(cols):
    for c in cols:
        c.shutdown()


def _t(a):
    """numpy -> torch, bf16 by its bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _leaf_bytes(tree):
    if isinstance(tree, dict):
        return [b for k in sorted(tree) for b in _leaf_bytes(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [b for v in tree for b in _leaf_bytes(v)]
    return [_bytes(tree)]


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((7, 13)) * 3 * scale).astype(np.float32),
        "blocks": [rng.standard_normal(1001).astype(np.float32) * scale,
                   (rng.standard_normal(5) * 1e-3).astype(np.float32)],
    }


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _ttree(t):
    return jax.tree_util.tree_map(_t, t)


# ---- quantize.py --------------------------------------------------------


class TestQuantize:
    def test_three_ef_steps_match_jax(self):
        """q, scale, dq and the carry, step after step, bit for bit against
        the JAX function run eagerly (the numpy oracle's arithmetic)."""
        jres = _jtree(jax.tree_util.tree_map(np.zeros_like, _tree(0)))
        tres = _ttree(jax.tree_util.tree_map(np.zeros_like, _tree(0)))
        for step in range(3):
            g = _tree(10 + step)
            j = jq.quantize_with_feedback(_jtree(g), jres)
            t = tq.quantize_with_feedback(_ttree(g), tres)
            for k in ("q", "scale", "dq", "res"):
                assert _leaf_bytes(j[k]) == _leaf_bytes(t[k]), (step, k)
            jres, tres = j["res"], t["res"]

    def test_jitted_jax_differs_only_in_the_residual_fma(self):
        """ROADMAP F6: under jit XLA fuses ``d - q*scale``; the codes,
        scales and shipped values still agree bit for bit, the carry
        within one ulp of the leaf's largest shipped value (127 * scale,
        whose product the FMA keeps unrounded)."""
        g, r = _tree(1), _tree(2, scale=0.01)
        j = jax.jit(jq.quantize_with_feedback)(_jtree(g), _jtree(r))
        t = tq.quantize_with_feedback(_ttree(g), _ttree(r))
        for k in ("q", "scale", "dq"):
            assert _leaf_bytes(j[k]) == _leaf_bytes(t[k]), k
        for jl, tl, s in zip(jax.tree_util.tree_leaves(j["res"]),
                             flatten(t["res"])[0],
                             jax.tree_util.tree_leaves(j["scale"])):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=float(s) * 2.0 ** -16)

    def test_outputs_are_views_of_flat_buffers(self):
        g = _ttree(_tree(3))
        out = tq.quantize_with_feedback(
            g, jax.tree_util.tree_map(torch.zeros_like, g))
        for k, dt in (("q", torch.int8), ("scale", torch.float32),
                      ("dq", torch.float32), ("res", torch.float32)):
            leaves = flatten(out[k])[0]
            flat = tq.flat_buffer(leaves, dt)
            assert flat is not None and flat.numel() == sum(
                l.numel() for l in leaves), k

    def test_res_out_leaves_the_residual_untouched(self):
        """The carry flip: the step reads one flat carry and writes the
        other, so the pre-step carry is still there to roll back to."""
        g = _ttree(_tree(4))
        n = sum(l.numel() for l in flatten(g)[0])
        a = torch.randn(n) * 1e-3
        before = a.clone()
        # a previous step's carry as views of ``a``
        res_in = unflatten(flatten(g)[1],
                           tq._views(a, [l.shape for l in flatten(g)[0]]))
        b = torch.empty(n)
        out = tq.quantize_with_feedback(g, res_in, res_out=b)
        assert torch.equal(a.view(torch.int32), before.view(torch.int32))
        assert tq.flat_buffer(flatten(out["res"])[0], torch.float32) is b
        inplace = tq.quantize_with_feedback(g, res_in)
        assert _leaf_bytes(inplace["res"]) == _leaf_bytes(out["res"])

    @pytest.mark.parametrize("poison", [float("nan"), float("inf")])
    def test_poisoned_leaf_poisons_its_outputs(self, poison):
        """A non-finite leaf: codes 0, a NaN scale, NaN dq and carry (the
        kernels' 0x7FC00000); its neighbours quantize as if alone. The
        JAX function's codes and NaN bits for such a leaf differ (F6)."""
        g = _tree(5)
        g["blocks"][0][17] = poison  # leaf 0 (dict keys sort: "blocks")
        t = tq.quantize_with_feedback(
            _ttree(g), _ttree(jax.tree_util.tree_map(np.zeros_like, g)))
        q, s, dq, res = (flatten(t[k])[0] for k in ("q", "scale", "dq", "res"))
        assert torch.all(q[0] == 0) and torch.isnan(s[0])
        canon = 0x7FC00000
        assert torch.all(dq[0].view(torch.int32) == canon)
        assert torch.all(res[0].view(torch.int32) == canon)
        avg = tq.make_dequant_average()([{"q": t["q"], "scale": t["scale"]}], 1.0)
        assert torch.all(flatten(avg)[0][0].view(torch.int32) == canon)
        clean = tq.quantize_with_feedback(
            _ttree({"w": g["w"]}), _ttree({"w": np.zeros_like(g["w"])}))
        assert _bytes(clean["dq"]["w"]) == _bytes(t["dq"]["w"])
        j = jq.quantize_with_feedback(
            _jtree(g), _jtree(jax.tree_util.tree_map(np.zeros_like, g)))
        assert np.isnan(np.asarray(jax.tree_util.tree_leaves(j["dq"])[0])).all()

    @pytest.mark.parametrize("n", [1.0, 2.0, 3.0])
    def test_dequant_average_matches_jax(self, n):
        ents_j, ents_t = [], []
        for m in range(3):
            g = _tree(20 + m, scale=m + 1.0)
            z = jax.tree_util.tree_map(np.zeros_like, g)
            j = jq.quantize_with_feedback(_jtree(g), _jtree(z))
            t = tq.quantize_with_feedback(_ttree(g), _ttree(z))
            ents_j.append({"q": j["q"], "scale": j["scale"]})
            ents_t.append({"q": t["q"], "scale": t["scale"]})
        tout = tq.make_dequant_average()(ents_t, n)
        with jax.disable_jit():  # each product rounded, as numpy does
            jout = jq.make_dequant_average()(ents_j, n)
        assert _leaf_bytes(jout) == _leaf_bytes(tout)
        # F6: jitted, XLA fuses ``acc + q*scale``: the sums differ by the
        # products' roundings, an ulp of the largest product per member
        jit_out = jq.make_dequant_average()(ents_j, n)
        for k, (jl, tl) in enumerate(zip(jax.tree_util.tree_leaves(jit_out),
                                         flatten(tout)[0])):
            top = sum(127 * float(jax.tree_util.tree_leaves(e["scale"])[k])
                      for e in ents_j)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=top * 2.0 ** -23 / n)

    def test_dequant_average_takes_gathered_copies(self):
        """Entries that are not views of one buffer (copies) decode the
        same."""
        g = _ttree(_tree(6))
        t = tq.quantize_with_feedback(
            g, jax.tree_util.tree_map(torch.zeros_like, g))
        ent = {"q": t["q"], "scale": t["scale"]}
        copied = jax.tree_util.tree_map(torch.clone, ent)
        comb = tq.make_dequant_average()
        assert _leaf_bytes(comb([ent], 1.0)) == _leaf_bytes(comb([copied], 1.0))
        assert _leaf_bytes(comb([ent], 1.0)) == _leaf_bytes(t["dq"])


# ---- collectives --------------------------------------------------------


class TestLegacyCollectives:
    def test_work_surface(self):
        w = tcol._completed(3)
        assert w.done() and w.result() == 3 and w.exception() is None
        assert w.then(lambda x: x + 1).wait() == 4
        f = tcol.Future()
        f.set_exception(RuntimeError("boom"))
        chained = tcol.Work(f).then(lambda x: x)
        assert isinstance(chained.exception(), RuntimeError)

    def test_allgather(self, store):
        cols = _port_ring(store, 3, "ag")
        try:
            results = _run_all(cols, lambda r, c: c.allgather(
                {"x": torch.full((4,), float(r)),
                 "y": torch.tensor([r], dtype=torch.int64)}).wait())
            for out in results:
                assert len(out) == 3
                for r, tree in enumerate(out):
                    assert torch.equal(tree["x"], torch.full((4,), float(r)))
                    assert tree["y"].tolist() == [r]
        finally:
            _shutdown(cols)

    def test_allgather_int8_payload_shares_the_jax_layout(self, store):
        """The quantized payload ships by exact dtype (f32 scales, then
        int8 codes, as the JAX device pack lays it out): a JAX member with
        jax arrays and port members decode each other's entries."""
        cols = _mixed_ring(store, 3, "agq")

        def payload(r):
            return {
                "q": {"a": np.full((6,), r - 1, np.int8),
                      "b": np.full((2, 3), 2 * r, np.int8)},
                "scale": {"a": np.float32(0.5 + r), "b": np.float32(1.5 * r)},
                "extra_bf16": np.full((4,), r, ml_dtypes.bfloat16),
            }

        try:
            results = _run_all(cols, lambda r, c: c.allgather(
                _jtree(payload(r)) if r == 0 else _ttree(payload(r))).wait())
            for out in results:
                assert len(out) == 3
                for r, tree in enumerate(out):
                    assert _leaf_bytes(tree) == _leaf_bytes(payload(r))
            assert results[1][0]["q"]["a"].dtype == torch.int8
        finally:
            _shutdown(cols)

    @pytest.mark.parametrize("mixed", [False, True])
    def test_allreduce_q8_quantized_ring(self, store, mixed):
        """Within the int8 class of the exact average, and bit-identical
        on every member (phase 2 circulates owner-quantized codes), the
        JAX member included."""
        cols = (_mixed_ring if mixed else _port_ring)(store, 3, f"q8_{mixed}")
        rng = np.random.default_rng(7)
        base = {"w": rng.standard_normal((300,)).astype(np.float32),
                "b": rng.standard_normal((5, 7)).astype(np.float32) * 10.0}

        def op(r, c):
            tree = {k: v * (r + 1) for k, v in base.items()}
            if isinstance(c, jcol.HostCollectives):
                return c.allreduce(_jtree(tree), jcol.ReduceOp.AVG,
                                   wire="q8").wait()
            return c.allreduce(_ttree(tree), tcol.ReduceOp.AVG,
                               wire="q8").wait()

        try:
            results = _run_all(cols, op)
            exact = {k: v * 6 / 3 for k, v in base.items()}
            for out in results:
                for k in base:
                    tol = 6 * np.abs(exact[k]).max() / 127
                    np.testing.assert_allclose(np.asarray(out[k]), exact[k],
                                               atol=tol)
            for out in results[1:]:
                assert _leaf_bytes(out) == _leaf_bytes(results[0])
            st = cols[1].pop_op_stats()[-1]
            assert st["op"] == "allreduce_q8"
            assert st["wire_bytes"] < st["bytes"] / 2
            with pytest.raises(ValueError, match="SUM/AVG"):
                cols[1].allreduce(_ttree(base), tcol.ReduceOp.MAX, wire="q8")
        finally:
            _shutdown(cols)

    def test_allreduce_q8_nonfinite_poisons_all_members(self, store):
        cols = _port_ring(store, 3, "poison")
        base = np.random.default_rng(11).standard_normal(400).astype(np.float32)

        def op(r, c):
            arr = base * (r + 1)
            if r == 0:
                arr = arr.copy()
                arr[7] = np.nan
                arr[250] = np.inf
            return c.allreduce({"w": _t(arr)}, tcol.ReduceOp.SUM,
                               wire="q8").wait()

        try:
            results = _run_all(cols, op)
            for out in results:
                assert torch.isnan(out["w"][7]) and torch.isnan(out["w"][250])
            for out in results[1:]:
                assert _bytes(out["w"]) == _bytes(results[0]["w"])
        finally:
            _shutdown(cols)

    def test_op_schedule_pipeline_bit_identical_across_buckets(self, store):
        """Chunked (the d2h / ring / upload pipeline) or not, a mixed
        dtype tree reduces to the same bits, a JAX member pipelining its
        jax arrays in the same ring; every bucket records its chunks."""
        rng = np.random.default_rng(9)
        base_f32 = rng.standard_normal(5003).astype(np.float32)
        base_bf16 = (rng.integers(-16, 16, 1001) * 0.125).astype(
            ml_dtypes.bfloat16)
        base_i32 = rng.integers(-100, 100, 777, dtype=np.int32)

        def tree(r):
            return {"w": base_f32 * (r + 1),
                    "b": (base_bf16.astype(np.float32) * (r + 1)).astype(
                        ml_dtypes.bfloat16),
                    "n": base_i32 * (r + 1)}

        outs = {}
        for chunks in (1, 4):
            cols = _mixed_ring(store, 2, f"sched{chunks}",
                               pipeline_chunks=chunks, pipeline_min_bytes=0)
            try:
                results = _run_all(cols, lambda r, c: c.allreduce(
                    _jtree(tree(r)) if r == 0 else _ttree(tree(r))).wait())
                assert _leaf_bytes(results[0]) == _leaf_bytes(results[1])
                if chunks == 4:
                    st = [s for s in cols[1].pop_op_stats()
                          if s["op"] == "allreduce"][-1]
                    assert set(st["buckets"]) == {"bfloat16", "float32", "int32"}
                    assert st["chunks"] == 3 * 4
                outs[chunks] = _leaf_bytes(results[1])
            finally:
                _shutdown(cols)
        assert outs[1] == outs[4]

    def test_pipeline_knobs_ride_the_fingerprint(self, store):
        cols = [tcol.HostCollectives(timeout=_T, connect_timeout=timedelta(seconds=2),
                                     pipeline_chunks=c) for c in (4, 8)]
        # (rank 1's connect timeout bounds the mismatch's discovery)
        try:
            addr = f"{store.address()}/knobs"
            with ThreadPoolExecutor(max_workers=2) as ex:
                futs = [ex.submit(cols[r].configure, addr, r, 2) for r in range(2)]
                with pytest.raises(RuntimeError, match="mismatch"):
                    futs[1].result()
        finally:
            _shutdown(cols)

    def test_broadcast(self, store):
        cols = _mixed_ring(store, 3, "bcast")
        data = [np.full(8, r, np.float32) for r in range(3)]
        try:
            results = _run_all(cols, lambda r, c: c.broadcast(
                data[r] if r == 0 else {"x": _t(data[r])}["x"], root=1).wait())
            for out in results:
                np.testing.assert_array_equal(np.asarray(out), np.full(8, 1.0))
        finally:
            _shutdown(cols)

    def test_barrier(self, store):
        cols = _mixed_ring(store, 3, "barrier")
        try:
            assert _run_all(cols, lambda r, c: c.barrier().wait()) == [None] * 3
        finally:
            _shutdown(cols)

    def test_world_size_one_is_local(self):
        c = tcol.HostCollectives()
        try:
            c.configure("ignored:0/q", 0, 1)
            x = torch.arange(3, dtype=torch.float32)
            assert torch.equal(c.allreduce(x).wait(), x)
            assert torch.equal(c.allreduce(x, wire="q8").wait(), x)
            assert c.allgather(torch.ones(2)).wait()[0].tolist() == [1.0, 1.0]
            assert torch.equal(c.broadcast(x).wait(), x)
            assert c.barrier().wait() is None
        finally:
            c.shutdown()

    def test_dummy_collectives(self):
        d = tcol.DummyCollectives(rank=0, world_size=2)
        tree = {"w": torch.arange(6, dtype=torch.float32)}
        assert torch.equal(d.allreduce(tree, divisor=2.0).wait()["w"],
                           tree["w"] / 2)
        assert d.allgather(tree).wait() == [tree, tree]
        assert d.broadcast(tree).wait() is tree and d.barrier().wait() is None
        sh = d.reduce_scatter(tree, tcol.ReduceOp.SUM, divisor=2.0).wait()
        np.testing.assert_allclose(d.allgather_into(sh).wait()["w"].numpy(),
                                   np.arange(6) / 2.0)
        assert d.op_count == 6
        d.configure("x", 0, 2, regions=["a", "b"])
        assert d.hier_capable() and d.configure_count == 1
        with pytest.raises(NotImplementedError):
            d.plan_reduce_scatter(tree)
        # the JAX fake, on the same inputs
        jd = jcol.DummyCollectives(rank=0, world_size=2)
        jsh = jd.reduce_scatter({"w": np.arange(6, dtype=np.float32)},
                                jcol.ReduceOp.SUM, divisor=2.0).wait()
        assert _bytes(jd.allgather_into(jsh, wire="bf16").wait()["w"]) == \
            _bytes(d.allgather_into(sh, wire="bf16").wait()["w"])


# ---- the legacy PipelinedDDP -------------------------------------------


class _RingManager:
    """A deterministic manager over a real ring, for either package:
    every member participates and commits unless ``commit`` is False."""

    def __init__(self, col, avg):
        self._col = col
        self._avg = avg
        self.commit = True

    def start_quorum(self, **kw):
        pass

    def allreduce(self, tree, op=None, wire=None):
        return self._col.allreduce(tree, self._avg, wire=wire)

    def allgather(self, tree):
        return self._col.allgather(tree)

    def should_commit(self):
        return self.commit

    def num_participants(self):
        return self._col.size()

    def is_healing(self):
        return False

    def reset_plan_feedback(self):
        pass


def _ddp_grads(member, step):
    rng = np.random.default_rng(100 * member + step)
    return {"w": (rng.standard_normal((7, 13)) * 3).astype(np.float32),
            "b": [rng.standard_normal(1001).astype(np.float32),
                  (rng.standard_normal(5) * 1e-3).astype(np.float32)]}


def _params():
    return {"w": np.linspace(-1, 1, 91, dtype=np.float32).reshape(7, 13),
            "b": [np.linspace(0, 1, 1001, dtype=np.float32),
                  np.ones(5, np.float32)]}


def _jax_member(col, compress, rec):
    st = jft.FTTrainState(_jtree(_params()), optax.sgd(0.1))
    inner = st.apply_gradients

    def apply(g):
        rec.append(_leaf_bytes(g))
        inner(g)

    st.apply_gradients = apply
    m = _RingManager(col, jcol.ReduceOp.AVG)
    calls = [0]

    def grad_fn(params, member):
        calls[0] += 1
        return 0.0, _jtree(_ddp_grads(member, calls[0] - 1))

    ddp = jft.PipelinedDDP(m, st, grad_fn, compress=compress,
                           transport="legacy")
    # the eager JAX quantize and combine: the numpy oracle's arithmetic (F6)
    ddp._quant_jit = jq.quantize_with_feedback
    combine = jq.make_dequant_average()

    def eager_combine(entries, n):
        with jax.disable_jit():
            return combine(entries, n)

    ddp._combine_fns.update({n: eager_combine for n in range(1, 9)})
    return ddp, m


def _port_member(col, compress, rec):
    st = tft.FTTrainState(_ttree(_params()), tft.AdamW(1e-3))
    st.apply_gradients = lambda g: rec.append(_leaf_bytes(g))
    m = _RingManager(col, tcol.ReduceOp.AVG)
    calls = [0]

    def grad_fn(params, member):
        calls[0] += 1
        return 0.0, _ttree(_ddp_grads(member, calls[0] - 1))

    return tft.PipelinedDDP(m, st, grad_fn, compress=compress,
                            transport="legacy"), m


def _jax_carry(ddp):
    return None if ddp._residual is None else _leaf_bytes(ddp._residual)


def _port_carry(ddp):
    """The carry the next quantize reads, or, with a step in flight, the
    one it wrote (what the JAX member holds as ``_residual`` then)."""
    if ddp._carries is None:
        return None
    flat = ddp._carries[ddp._carry if ddp._next is None else ddp._next]
    g = _ttree(_ddp_grads(0, 0))
    return _leaf_bytes(unflatten(flatten(g)[1], tq._views(
        flat, [l.shape for l in flatten(g)[0]])))


class TestLegacyPipelinedDDP:
    @pytest.mark.parametrize("compress", [None, "bf16", "q8", "int8"])
    def test_jax_and_port_members_agree(self, store, compress):
        """Three pipelined steps and a flush, the second settle discarded
        by the vote, in a ring of a JAX member and two port members: every
        member applies the same bits at every commit, and the JAX member
        and the port member fed the same gradients hold the same EF carry
        after every step, the rolled-back one included."""
        cols = _mixed_ring(store, 3, f"ddp_{compress}", stripes=2)
        recs = [[], [], []]
        feeds = [0, 0, 2]  # whose gradients each member computes
        jddp, jm = _jax_member(cols[0], compress, recs[0])
        ddps, mans = [jddp], [jm]
        for r in (1, 2):
            d, m = _port_member(cols[r], compress, recs[r])
            ddps.append(d)
            mans.append(m)
        carries = [[], [], []]

        def run(r, c):
            ddp, m = ddps[r], mans[r]
            carry = _jax_carry if r == 0 else _port_carry
            for step in range(3):
                # step 2 settles step 1's transaction: the vote fails
                m.commit = step != 2
                ddp.step(feeds[r])
                carries[r].append(carry(ddp))
            m.commit = True
            assert ddp.flush()
            carries[r].append(carry(ddp))

        try:
            _run_all(cols, run)
        finally:
            _shutdown(cols)
        assert [len(r) for r in recs] == [2, 2, 2]  # steps 0 and 2 applied
        assert recs[0] == recs[1] == recs[2]
        assert carries[0] == carries[1]
        if compress in ("q8", "int8"):
            # step 2 quantized against step 0's carry: the discarded step
            # 1's was rolled back
            assert carries[1][2] != carries[1][1]
            assert carries[2][0] != carries[1][0]

    @pytest.mark.parametrize("compress", [None, "bf16", "q8", "int8"])
    def test_port_groups_through_managers(self, compress):
        """Two port groups with real Managers: pipelined then blocking
        steps commit, and both groups end bit-identical."""
        lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=200,
                                    quorum_tick_ms=50, heartbeat_timeout_ms=4000)

        def group(g):
            st = tft.FTTrainState(_ttree(_params()), tft.AdamW(1e-2))
            col = tft.HostCollectives(timeout=_T, stripes=2)
            man = tft.Manager(
                collectives=col, load_state_dict=st.load_state_dict,
                state_dict=st.state_dict, min_replica_size=2, timeout=_T,
                quorum_timeout=_T, connect_timeout=_T, rank=0, world_size=1,
                lighthouse_addr=lighthouse.address(), replica_id=f"g{g}",
                device="cpu")
            calls = [0]

            def grad_fn(params, member):
                calls[0] += 1
                return 0.0, _ttree(_ddp_grads(member, calls[0]))

            try:
                ddp = tft.PipelinedDDP(man, st, grad_fn, compress=compress,
                                       transport="legacy")
                for _ in range(2):
                    ddp.step(g)
                ddp.blocking_step(g)  # settles the pipelined step first
                assert ddp.last_commit
                ddp.step(g)
                assert ddp.flush()
                return man.current_step(), _leaf_bytes(st.params)
            finally:
                man.shutdown()
                col.shutdown()

        try:
            with ThreadPoolExecutor(max_workers=2) as ex:
                res = [f.result(timeout=120) for f in
                       [ex.submit(group, g) for g in range(2)]]
        finally:
            lighthouse.shutdown()
        assert res[0][0] == res[1][0] == 4
        assert res[0][1] == res[1][1]

    def test_int8_is_rejected_on_the_plan_transport(self):
        st = tft.FTTrainState(_ttree(_params()), tft.AdamW(1e-3))
        with pytest.raises(ValueError, match="allgather"):
            tft.PipelinedDDP(None, st, None, compress="int8")
        with pytest.raises(ValueError, match="plan transport"):
            tft.PipelinedDDP(None, st, None, transport="legacy", hier=True)
