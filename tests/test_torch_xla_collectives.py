"""The port's ``XLACollectives`` (a torch process group rebuilt per quorum)
against the JAX package's (a jitted psum over a ``jax.distributed`` mesh).

- The same seeded numpy inputs go through both: allreduce SUM / AVG /
  MAX / MIN / a divisor over f32 and int32 trees, allgather, broadcast
  and barrier. The JAX cohorts run in worker processes
  (``jax.distributed`` binds a whole process), the port's members in
  threads of this one, on gloo. At world 2 every result is bit-identical
  (a two-operand sum is order-free); at world 3 the integer results are
  too, and the f32 sums and averages agree within rtol 1e-6 (gloo's ring
  and XLA's reduction add three operands in different orders), while
  the port's members agree among themselves bit for bit.
- The port's own contracts: ``backend=None`` is gloo without CUDA, an
  explicit ``"nccl"`` that cannot initialise raises (it never becomes
  gloo), a solo world builds no group, ``configure`` onto a new
  membership orphans nothing (a registered ``FTTrainState`` keeps its
  tensors and bits) and is bounded, ``abort`` fails queued ops, the q8
  wire is served losslessly, and the op-stats keys are the JAX
  backend's. ``FTTrainState.snapshot`` / ``restore`` hold the JAX
  holder's bytes and copy back in place.
"""

import inspect
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax.numpy as jnp
import optax

from conftest import CPU_MULTIPROCESS_SKIP, HAS_CPU_MULTIPROCESS

import torchft_tpu as jft
from torchft_tpu._native import Store
import torchft_tpu_torch as tft
from torchft_tpu_torch.collectives import ReduceOp
from torchft_tpu_torch.xla_collectives import XLACollectives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_T = timedelta(seconds=30)
_DIVISOR = 3.0


def _inputs(rank: int) -> dict:
    rng = np.random.default_rng(1000 + rank)
    return {
        "f32": {"w": (rng.standard_normal((7, 13)) * 3).astype(np.float32),
                "b": rng.standard_normal(1001).astype(np.float32),
                "s": np.float32(rng.standard_normal()).reshape(())},
        "i32": {"i": rng.integers(-1000, 1000, 17).astype(np.int32),
                "j": rng.integers(-7, 7, (3, 4)).astype(np.int32)},
    }


# (name, tree, op, divisor): every allreduce both packages run
_REDUCES = [
    ("sum_f32", "f32", "SUM", None),
    ("avg_f32", "f32", "AVG", None),
    ("div_f32", "f32", "SUM", _DIVISOR),
    ("max_f32", "f32", "MAX", None),
    ("min_f32", "f32", "MIN", None),
    ("sum_i32", "i32", "SUM", None),
    ("avg_i32", "i32", "AVG", None),
    ("div_i32", "i32", "SUM", 2.0),
]

_JAX_WORKER = textwrap.dedent(
    """
    import os, sys, json
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from datetime import timedelta
    from torchft_tpu import XLACollectives
    from torchft_tpu.collectives import ReduceOp

    {inputs}
    _REDUCES = {reduces!r}

    rank, world, store_addr, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4])
    xc = XLACollectives(timeout=timedelta(seconds=60),
                        connect_timeout=timedelta(seconds=60))
    xc.configure(store_addr + "/xla", rank, world)
    inp = _inputs(rank)
    jtree = {{k: {{n: jnp.asarray(v) for n, v in d.items()}}
             for k, d in inp.items()}}
    res = {{}}
    for name, tree, op, div in _REDUCES:
        got = xc.allreduce(jtree[tree], getattr(ReduceOp, op),
                           divisor=div).wait()
        for k, v in got.items():
            res[f"{{name}}/{{k}}"] = np.asarray(v)
    for r, member in enumerate(xc.allgather(jtree["f32"]).wait()):
        for k, v in member.items():
            res[f"ag/{{r}}/{{k}}"] = np.asarray(v)
    got = xc.broadcast(jtree["f32"], root=world - 1).wait()
    for k, v in got.items():
        res[f"bc/{{k}}"] = np.asarray(v)
    xc.barrier().wait()
    np.savez(out + ".npz", **res)
    keys = {{}}
    for st in xc.pop_op_stats():
        keys.setdefault(st["op"], sorted(st))
    with open(out + ".json", "w") as f:
        json.dump(keys, f)
    xc.shutdown()
    print("JAX-XLA-OK")
    """
).format(repo=REPO, reduces=_REDUCES,
         inputs=textwrap.indent(inspect.getsource(_inputs), "    ").strip())


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's cohorts at world 2 and 3, all five worker
    processes at once: {world: [per-rank results]}, plus the op-stats
    keys."""
    if not HAS_CPU_MULTIPROCESS:
        pytest.skip(CPU_MULTIPROCESS_SKIP)
    d = tmp_path_factory.mktemp("jax_xla")
    store = Store()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    try:
        for world in (2, 3):
            for r in range(world):
                procs[(world, r)] = subprocess.Popen(
                    [sys.executable, "-c", _JAX_WORKER, str(r), str(world),
                     f"{store.address()}/w{world}", str(d / f"w{world}_{r}")],
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
        outs = {k: p.communicate(timeout=240)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        store.shutdown()
    for k, p in procs.items():
        assert p.returncode == 0 and "JAX-XLA-OK" in outs[k], outs[k]
    runs = {world: [dict(np.load(d / f"w{world}_{r}.npz"))
                    for r in range(world)] for world in (2, 3)}
    with open(d / "w2_0.json") as f:
        runs["stats_keys"] = json.load(f)
    return runs


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


def _ring(store, world, prefix, **kw):
    cols = [XLACollectives(timeout=_T, connect_timeout=_T, **kw)
            for _ in range(world)]
    addr = f"{store.address()}/{prefix}"
    _run_all(cols, lambda r, c: c.configure(addr, r, world))
    return cols


def _ttree(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _port_run(world):
    """The port's cohort over the workers' inputs, as the workers save
    them."""
    store = Store()
    cols = _ring(store, world, f"w{world}")

    def run(r, c):
        inp = _inputs(r)
        trees = {k: _ttree(v) for k, v in inp.items()}
        res = {}
        for name, tree, op, div in _REDUCES:
            got = c.allreduce(trees[tree], getattr(ReduceOp, op),
                              divisor=div).wait()
            for k, v in got.items():
                res[f"{name}/{k}"] = v.numpy()
        for m, member in enumerate(c.allgather(trees["f32"]).wait()):
            for k, v in member.items():
                res[f"ag/{m}/{k}"] = v.numpy()
        got = c.broadcast(trees["f32"], root=world - 1).wait()
        for k, v in got.items():
            res[f"bc/{k}"] = v.numpy()
        c.barrier().wait()
        return res

    try:
        return _run_all(cols, run)
    finally:
        for c in cols:
            c.shutdown()
        store.shutdown()


@pytest.fixture(scope="module")
def port_runs():
    return {world: _port_run(world) for world in (2, 3)}


_KEYS = ([f"{name}/{k}" for name, tree, _, _ in _REDUCES
          for k in _inputs(0)[tree]]
         + [f"ag/{m}/{k}" for m in range(2) for k in _inputs(0)["f32"]]
         + [f"bc/{k}" for k in _inputs(0)["f32"]])


@pytest.mark.parametrize("key", _KEYS)
def test_world2_bit_identical_to_jax(jax_runs, port_runs, key):
    for r in range(2):
        port, ref = port_runs[2][r][key], jax_runs[2][r][key]
        assert port.dtype == ref.dtype and port.shape == ref.shape, key
        assert port.tobytes() == ref.tobytes(), (key, r)


@pytest.mark.parametrize("key", _KEYS + [f"ag/2/{k}" for k in ("b", "s", "w")])
def test_world3_matches_jax(jax_runs, port_runs, key):
    """Members agree bit for bit; integers, gathers, broadcasts, MAX and
    MIN equal the JAX cohort's bits; f32 sums and averages (three
    operands, another order) within rtol 1e-6."""
    port = [port_runs[3][r][key] for r in range(3)]
    for p in port[1:]:
        assert p.tobytes() == port[0].tobytes(), key
    ref = jax_runs[3][0][key]
    assert port[0].dtype == ref.dtype and port[0].shape == ref.shape
    if port[0].dtype == np.float32 and key.split("/")[0] in (
            "sum_f32", "avg_f32", "div_f32"):
        np.testing.assert_allclose(port[0], ref, rtol=1e-6, atol=1e-6)
    else:
        assert port[0].tobytes() == ref.tobytes(), key


def test_op_stats_keys_are_the_jax_backends(jax_runs):
    store = Store()
    cols = _ring(store, 2, "stats")
    try:
        _run_all(cols, lambda r, c: c.allreduce(
            _ttree(_inputs(r)["f32"])).wait())
        _run_all(cols, lambda r, c: c.allgather(
            _ttree(_inputs(r)["f32"])).wait())
        _run_all(cols, lambda r, c: c.broadcast(
            _ttree(_inputs(r)["f32"])).wait())
        keys = {}
        for st in cols[0].pop_op_stats():
            keys.setdefault(st["op"], sorted(st))
        assert st["backend"] == "xla"
        for op in ("allreduce", "allgather", "broadcast"):
            assert keys[op] == jax_runs["stats_keys"][op], op
        assert cols[0].pop_op_stats() == []  # drained
    finally:
        for c in cols:
            c.shutdown()
        store.shutdown()


def test_backend_resolution():
    assert XLACollectives().backend == (
        "nccl" if torch.cuda.is_available() else "gloo")
    assert XLACollectives(backend="gloo").backend == "gloo"
    with pytest.raises(ValueError, match="backend"):
        XLACollectives(backend="mpi")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only host")
def test_explicit_nccl_without_cuda_raises_never_gloo():
    store = Store()
    cols = [XLACollectives(timeout=timedelta(seconds=5),
                           connect_timeout=timedelta(seconds=5),
                           backend="nccl") for _ in range(2)]
    try:
        with pytest.raises(RuntimeError, match="nccl"):
            _run_all(cols, lambda r, c: c.configure(
                f"{store.address()}/nccl", r, 2))
        assert all(c.size() == 0 and c.backend == "nccl" for c in cols)
    finally:
        for c in cols:
            c.shutdown()
        store.shutdown()


def test_solo_world_builds_no_group():
    store = Store()
    c = XLACollectives(timeout=_T)
    try:
        c.configure(f"{store.address()}/solo", 0, 1)
        assert c.size() == 1 and c.global_mesh() is None
        x = {"a": torch.full((3,), 4.0), "i": torch.arange(4)}
        assert c.allreduce(x, ReduceOp.AVG).wait() is x
        half = c.allreduce(x, ReduceOp.SUM, divisor=2.0).wait()
        assert torch.equal(half["a"], torch.full((3,), 2.0))
        assert torch.equal(half["i"], torch.tensor([0, 0, 1, 1]))
        assert c.allgather(x).wait() == [x]
        assert c.broadcast(x).wait() is x
        c.barrier().wait()
    finally:
        c.shutdown()
        store.shutdown()


def test_reconfigure_rebuilds_the_group_and_orphans_nothing():
    """Two members, then three on a new prefix: a new group, and a
    registered FTTrainState keeps its very tensors and bits (no round
    trip through the host)."""
    store = Store()
    cols = _ring(store, 2, "r0")
    states = [tft.FTTrainState({"w": torch.arange(6, dtype=torch.float32)},
                               tft.AdamW(1e-3)) for _ in range(3)]
    for c, s in zip(cols, states):
        c.register_state(s)
    ptrs = [s.params["w"].data_ptr() for s in states]
    before = [s.params["w"].clone() for s in states]
    try:
        old = cols[0].global_mesh()
        out = _run_all(cols, lambda r, c: c.allreduce(
            torch.full((4,), float(r + 1))).wait())
        assert torch.equal(out[0], torch.full((4,), 3.0))
        cols.append(XLACollectives(timeout=_T, connect_timeout=_T))
        cols[2].register_state(states[2])
        addr = f"{store.address()}/r1"
        _run_all(cols, lambda r, c: c.configure(addr, r, 3))
        assert cols[0].global_mesh() is not old
        assert [c.size() for c in cols] == [3, 3, 3]
        out = _run_all(cols, lambda r, c: c.allreduce(
            torch.full((4,), float(r + 1)), ReduceOp.AVG).wait())
        assert all(torch.equal(o, torch.full((4,), 2.0)) for o in out)
        for s, p, b in zip(states, ptrs, before):
            assert s.params["w"].data_ptr() == p
            assert torch.equal(s.params["w"], b)
    finally:
        for c in cols:
            c.shutdown()
        store.shutdown()


def test_configure_wait_is_bounded():
    """A member whose peer never comes fails its configure within the
    connect + op budget (the latchable TimeoutError, not a hang)."""
    store = Store()
    c = XLACollectives(timeout=timedelta(seconds=1),
                       connect_timeout=timedelta(seconds=1))
    try:
        t0 = time.perf_counter()
        with pytest.raises((TimeoutError, RuntimeError)):
            c.configure(f"{store.address()}/lonely", 1, 2)
        assert time.perf_counter() - t0 < 30.0
    finally:
        c.shutdown()
        store.shutdown()


def test_abort_fails_queued_ops():
    store = Store()
    c = XLACollectives(timeout=_T)
    try:
        c.configure(f"{store.address()}/ab", 0, 1)
        c.abort()
        with pytest.raises(RuntimeError, match="aborted"):
            c.allreduce(torch.ones(2)).wait()
        c.configure(f"{store.address()}/ab2", 0, 1)  # a configure clears it
        assert torch.equal(c.allreduce(torch.ones(2)).wait(), torch.ones(2))
    finally:
        c.shutdown()
        store.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        c.allreduce(torch.ones(2))


def test_q8_wire_is_served_losslessly():
    store = Store()
    cols = _ring(store, 2, "q8")
    try:
        def op(r, c):
            t = _ttree(_inputs(r)["f32"])
            return (c.allreduce(t, ReduceOp.AVG, wire="q8").wait(),
                    c.allreduce(t, ReduceOp.AVG).wait())

        for q8, f32 in _run_all(cols, op):
            for k in q8:
                assert q8[k].numpy().tobytes() == f32[k].numpy().tobytes()
    finally:
        for c in cols:
            c.shutdown()
        store.shutdown()


def test_results_take_their_leaves_devices_and_dtypes():
    store = Store()
    cols = _ring(store, 2, "dt")
    try:
        def op(r, c):
            t = {"h": torch.ones(3, dtype=torch.float16) * (r + 1),
                 "b": torch.ones(2, dtype=torch.bfloat16),
                 "x": torch.arange(3, dtype=torch.int64)}
            return c.allreduce(t).wait(), t

        for out, t in _run_all(cols, op):
            for k in t:
                assert out[k].dtype == t[k].dtype
                assert out[k].device == t[k].device
            assert torch.equal(out["h"], torch.full((3,), 3.0,
                                                    dtype=torch.float16))
            assert torch.equal(out["x"], torch.arange(3) * 2)
    finally:
        for c in cols:
            c.shutdown()
        store.shutdown()


def _jax_state():
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    return params


def test_snapshot_holds_the_jax_holders_bytes_and_restores_in_place():
    params = _jax_state()
    jstate = jft.FTTrainState({k: jnp.asarray(v) for k, v in params.items()},
                              optax.adamw(1e-3))
    tstate = tft.FTTrainState({k: torch.from_numpy(v.copy())
                               for k, v in params.items()}, tft.AdamW(1e-3))
    grads = {k: np.full_like(v, 0.5) for k, v in params.items()}
    jstate.apply_gradients({k: jnp.asarray(v) for k, v in grads.items()})
    tstate.apply_gradients({k: torch.from_numpy(v) for k, v in grads.items()})
    jsnap = jstate.snapshot()
    tsnap = tstate.snapshot()
    for k in params:
        assert isinstance(tsnap["params"][k], torch.Tensor)
        assert tsnap["params"][k].device.type == "cpu"
        assert (tsnap["params"][k].numpy().tobytes()
                == np.asarray(jsnap["params"][k]).tobytes())
        assert (tsnap["params"][k].data_ptr()
                != tstate.params[k].data_ptr())  # fresh buffers
    assert tsnap["opt_state"]["count"] == 1
    ptrs = {k: v.data_ptr() for k, v in tstate.params.items()}
    tstate.apply_gradients({k: torch.from_numpy(v) for k, v in grads.items()})
    assert not torch.equal(tstate.params["w"], tsnap["params"]["w"])
    tstate.restore(tsnap)
    for k in params:
        assert tstate.params[k].data_ptr() == ptrs[k]  # in place
        assert torch.equal(tstate.params[k], tsnap["params"][k])
    assert tstate.opt_state["count"] == 1
    assert torch.equal(tstate.opt_state["mu"]["w"], tsnap["opt_state"]["mu"]["w"])
