"""The port's LocalSGD / DiLoCo / AsyncDiLoCo against the JAX package's.

- Units (the classes of ``tests/test_local_sgd.py``) over an autospec'd
  port ``Manager``: window accounting, commit/abort, the outer step's
  sign, the one-window-late reconcile, the abort rollback, bf16/int8/q8
  payloads and the error feedback.
- Trajectories: the same numpy-seeded params and gradients through the
  port and the JAX package (its jitted pieces run eagerly under
  ``jax.disable_jit()``, as ``tests/test_torch_legacy.py`` runs its
  quantize: XLA's CPU jit contracts products into FMAs, F6) over
  windows that commit and abort: bit-identical params, backups and
  outer state for every algorithm, compress mode and overlap setting.
- Rings: sharded DiLoCo against the unsharded oracle (bit-exact on the
  f32 wires), the lossy wires cohort-identical, the ~1/W outer state,
  the re-partition after a member leaves and after one joins; mixed
  rings of a JAX member and port members: LocalSGD and sharded DiLoCo
  (f32 and q8/bf16, and the reshard after a join) bit-identical, and
  unsharded DiLoCo (flat and ``hier=True`` over two regions), whose
  outer step each member runs on its own, within 1e-6 relative.
- Integration over a real lighthouse: recovery of LocalSGD, DiLoCo and
  sharded DiLoCo (q8/bf16) through the sync quorum's heal, and a
  sharded cohort surviving a shrink.
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Dict
from unittest.mock import create_autospec

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp
import optax

import torchft_tpu as jft
from torchft_tpu import collectives as jcol
from torchft_tpu import local_sgd as jls
from torchft_tpu.manager import Manager as JaxManager
import torchft_tpu_torch as tft
from torchft_tpu_torch import collectives as tcol
from torchft_tpu_torch._tree import flatten
from torchft_tpu_torch.local_sgd import AsyncDiLoCo, DiLoCo, LocalSGD

_T = timedelta(seconds=15)
F32 = np.float32


def _t(x):
    return torch.from_numpy(np.array(x, F32))


def _state(value: float = 1.0) -> tft.FTTrainState:
    return tft.FTTrainState({"w": torch.full((4,), value)}, tft.SGD(0.1))


def _mock_manager(commit=True, participants=1):
    manager = create_autospec(tft.Manager, instance=True)
    manager.allreduce.side_effect = (
        lambda tree, op=None, wire=None: tcol._completed(tree))
    manager.allgather.side_effect = lambda tree: tcol._completed([tree])
    manager.num_participants.return_value = participants
    if isinstance(commit, list):
        manager.should_commit.side_effect = list(commit)
    else:
        manager.should_commit.return_value = commit
    manager._use_async_quorum = False
    return manager


def _w(st):
    return st.params["w"].numpy()


class TestLocalSGDUnit:
    def test_syncs_every_n_steps(self):
        manager = _mock_manager()
        local = LocalSGD(manager, _state(), sync_every=3)
        for _ in range(5):
            local.step({"w": torch.ones(4)})
        assert manager.start_quorum.call_count == 1
        local.step({"w": torch.ones(4)})
        assert manager.start_quorum.call_count == 2

    def test_step_applied_counts_and_syncs(self):
        manager = _mock_manager()
        st = _state(2.0)
        local = LocalSGD(manager, st, sync_every=2)
        before = _w(st).copy()
        local.step_applied()
        assert manager.start_quorum.call_count == 0
        assert np.array_equal(_w(st), before)
        local.step_applied()
        assert manager.start_quorum.call_count == 1

    def test_commit_saves_backup(self):
        st = _state(1.0)
        local = LocalSGD(_mock_manager(commit=True), st, sync_every=1)
        local.step({"w": torch.ones(4)})
        np.testing.assert_allclose(_w(st), 0.9, rtol=1e-6)
        np.testing.assert_allclose(local._backup_params["w"].numpy(), 0.9,
                                   rtol=1e-6)

    def test_abort_restores_backup(self):
        st = _state(1.0)
        local = LocalSGD(_mock_manager(commit=False), st, sync_every=2)
        local.step({"w": torch.ones(4)})
        local.step({"w": torch.ones(4)})
        np.testing.assert_allclose(_w(st), 1.0)
        assert local._local_step == 0

    def test_state_dict_roundtrip(self):
        st = _state(2.0)
        local = LocalSGD(_mock_manager(), st, sync_every=4)
        local.step({"w": torch.ones(4)})
        sd = local.state_dict()
        st2 = _state(0.0)
        local2 = LocalSGD(_mock_manager(), st2, sync_every=4)
        local2.load_state_dict(sd)
        assert np.array_equal(_w(st2), _w(st))
        assert local2._local_step == 1

    def test_begin_fresh_window_reanchors(self):
        st = _state(1.0)
        local = LocalSGD(_mock_manager(commit=False), st, sync_every=3)
        local.step({"w": torch.ones(4)})
        local.begin_fresh_window()
        assert local._local_step == 0
        assert np.array_equal(local._backup_params["w"].numpy(), _w(st))


class TestDiLoCoUnit:
    def test_requires_sync_quorum(self):
        manager = _mock_manager()
        manager._use_async_quorum = True
        with pytest.raises(ValueError, match="synchronous"):
            DiLoCo(manager, _state(), tft.SGD(0.5), sync_every=2)

    def test_rejects_bad_wires(self):
        m = _mock_manager()
        with pytest.raises(ValueError, match="shard_wire"):
            DiLoCo(m, _state(), tft.SGD(0.5), 2, shard_wire="q8")
        with pytest.raises(ValueError, match="hier"):
            DiLoCo(m, _state(), tft.SGD(0.5), 2, hier=True, sharded=True)
        with pytest.raises(ValueError, match="hier_wire"):
            DiLoCo(m, _state(), tft.SGD(0.5), 2, hier_wire="q8")

    def test_outer_step_moves_toward_inner(self):
        st = _state(1.0)
        diloco = DiLoCo(_mock_manager(commit=True), st, tft.SGD(1.0),
                        sync_every=2)
        for _ in range(2):
            diloco.step({"w": torch.ones(4)})
        # inner 1 - 0.1 - 0.1 = 0.8; Δ = 0.2; outer lr 1: 1 - 0.2
        np.testing.assert_allclose(_w(st), 0.8, rtol=1e-6)
        np.testing.assert_allclose(diloco._backup_params["w"].numpy(), 0.8,
                                   rtol=1e-6)

    def test_abort_restores_without_outer_step(self):
        st = _state(1.0)
        diloco = DiLoCo(_mock_manager(commit=False), st, tft.SGD(0.7),
                        sync_every=1)
        diloco.step({"w": torch.ones(4)})
        np.testing.assert_allclose(_w(st), 1.0)

    def test_hier_rides_allreduce_hier(self):
        m = _mock_manager()
        m.allreduce_hier.side_effect = (
            lambda tree, op=None, wire=None: tcol._completed(tree))
        st = _state(1.0)
        DiLoCo(m, st, tft.SGD(1.0), 1, hier=True, hier_wire="q8").step(
            {"w": torch.ones(4)})
        assert m.allreduce_hier.call_args.kwargs["wire"] == "q8"
        assert m.allreduce.call_count == 0
        np.testing.assert_allclose(_w(st), 0.9, rtol=1e-6)

    def test_sharded_requires_f32_masters(self):
        st = tft.FTTrainState({"w": torch.ones(4, dtype=torch.bfloat16)},
                              tft.SGD(0.1))
        with pytest.raises(ValueError, match="f32 master"):
            DiLoCo(_mock_manager(), st, tft.SGD(0.7), 2, sharded=True)


class TestAsyncDiLoCoUnit:
    def test_lr1_single_group_degenerates_to_local(self):
        st = _state(1.0)
        ad = AsyncDiLoCo(_mock_manager(commit=True), st, tft.SGD(1.0), 2)
        ref = _state(1.0)
        for _ in range(6):
            ad.step({"w": torch.ones(4)})
            ref.apply_gradients({"w": torch.ones(4)})
        ad.flush()
        np.testing.assert_allclose(_w(st), _w(ref), rtol=1e-6)

    def test_serial_mode_matches_sync_diloco(self):
        serial_state, ref_state = _state(1.0), _state(1.0)
        serial = AsyncDiLoCo(_mock_manager(), serial_state, tft.SGD(0.5), 2,
                             overlap=False)
        ref = DiLoCo(_mock_manager(), ref_state, tft.SGD(0.5), 2)
        for _ in range(4):
            serial.step({"w": torch.ones(4)})
            ref.step({"w": torch.ones(4)})
        assert serial._pending is None
        np.testing.assert_allclose(_w(serial_state), _w(ref_state), rtol=1e-6)

    def test_outer_update_applied_one_window_late(self):
        manager = _mock_manager(commit=True)
        ad = AsyncDiLoCo(manager, _state(1.0), tft.SGD(1.0), 2)
        for _ in range(2):
            ad.step({"w": torch.ones(4)})
        assert manager.allreduce.call_count == 1
        assert manager.should_commit.call_count == 0
        np.testing.assert_allclose(ad._backup_params["w"].numpy(), 1.0)
        for _ in range(2):
            ad.step({"w": torch.ones(4)})
        assert manager.should_commit.call_count == 1
        np.testing.assert_allclose(ad._backup_params["w"].numpy(), 0.8,
                                   rtol=1e-6)

    def test_abort_rolls_back_only_inflight_window(self):
        st = _state(1.0)
        ad = AsyncDiLoCo(_mock_manager(commit=False), st, tft.SGD(1.0), 2)
        for _ in range(4):
            ad.step({"w": torch.ones(4)})
        ad.flush()
        np.testing.assert_allclose(_w(st), 1.0, rtol=1e-6)
        np.testing.assert_allclose(ad._backup_params["w"].numpy(), 1.0)

    def test_bf16_compression_ships_bf16_and_tracks_local(self):
        manager = _mock_manager()
        seen = []

        def capture(tree, op=None, wire=None):
            seen.extend(l.dtype for l in flatten(tree)[0])
            return tcol._completed(tree)

        manager.allreduce.side_effect = capture
        st = _state(1.0)
        ad = AsyncDiLoCo(manager, st, tft.SGD(1.0), 2, compress="bf16")
        for _ in range(4):
            ad.step({"w": torch.ones(4)})
        ad.flush()
        assert seen and all(d == torch.bfloat16 for d in seen)
        np.testing.assert_allclose(_w(st), 0.6, rtol=2e-2)
        assert st.params["w"].dtype == torch.float32

    def test_state_dict_flushes_pending(self):
        ad = AsyncDiLoCo(_mock_manager(), _state(1.0), tft.SGD(1.0), 1)
        ad.step({"w": torch.ones(4)})
        sd = ad.state_dict()
        assert ad._pending is None
        np.testing.assert_allclose(sd["backup_params"]["w"].numpy(), 0.9,
                                   rtol=1e-6)


class TestInt8Compression:
    def test_int8_ships_quantized_payload_via_allgather(self):
        manager = _mock_manager()
        seen = []
        manager.allgather.side_effect = lambda tree: (
            seen.append(tree), tcol._completed([tree]))[1]
        st = _state(1.0)
        ad = AsyncDiLoCo(manager, st, tft.SGD(1.0), 2, compress="int8")
        for _ in range(4):
            ad.step({"w": torch.ones(4)})
        ad.flush()
        assert seen and all(l.dtype == torch.int8 for e in seen
                            for l in flatten(e["q"])[0])
        assert all("scale" in e for e in seen)
        np.testing.assert_allclose(_w(st), 0.6, atol=0.01)

    def test_ships_quantized_grid_over_q8_wire(self):
        manager = _mock_manager()
        seen = []

        def capture(tree, op=None, wire=None):
            seen.append((tree, op, wire))
            return tcol._completed(tree)

        manager.allreduce.side_effect = capture
        st = _state(1.0)
        ad = AsyncDiLoCo(manager, st, tft.SGD(1.0), 2, compress="q8")
        for _ in range(4):
            ad.step({"w": torch.ones(4)})
        ad.flush()
        assert seen
        for tree, op, wire in seen:
            assert wire == "q8" and op == tcol.ReduceOp.AVG
            for l in flatten(tree)[0]:
                arr = l.numpy().astype(np.float64)
                scale = np.abs(arr).max() / 127 if np.abs(arr).max() else 1.0
                np.testing.assert_allclose(arr / scale, np.round(arr / scale),
                                           atol=1e-3)
        np.testing.assert_allclose(_w(st), 0.6, atol=0.01)

    def test_error_feedback_prevents_drift(self):
        st = _state(1.0)
        ad = AsyncDiLoCo(_mock_manager(), st, tft.SGD(1.0), 1,
                         compress="int8")
        g = np.array([0.1, 0.0333, 0.00777, 0.0001], F32)
        for _ in range(20):
            ad.step({"w": _t(g)})
        ad.flush()
        expect = 1.0 - 20 * 0.1 * g
        step_q = 0.01 / 127
        assert np.max(np.abs(_w(st) - expect)) < 3 * step_q

    def test_abort_restores_residual_and_rolls_back(self):
        st = _state(1.0)
        ad = AsyncDiLoCo(_mock_manager(commit=False), st, tft.SGD(1.0), 1,
                         compress="int8")
        ad.step({"w": torch.ones(4)})
        ad.flush()
        np.testing.assert_allclose(_w(st), 1.0, atol=1e-6)
        np.testing.assert_allclose(ad._residual["w"].numpy(), 0.0, atol=1e-9)

    def test_averaged_result_applied_directly(self):
        manager = _mock_manager(participants=2)
        manager.allreduce.side_effect = (
            lambda tree, op=None, wire=None: tcol._completed(
                {k: v / 2 for k, v in tree.items()}))
        st = _state(1.0)
        ad = AsyncDiLoCo(manager, st, tft.SGD(1.0), 1, compress="q8")
        ad.step({"w": torch.ones(4)})
        ad.flush()
        np.testing.assert_allclose(_w(st), 0.95, atol=0.001)

    def test_int8_divides_by_participants(self):
        manager = _mock_manager(participants=2)
        manager.allgather.side_effect = lambda tree: tcol._completed(
            [tree, {"q": {k: torch.zeros_like(v) for k, v in tree["q"].items()},
                    "scale": tree["scale"]}])
        st = _state(1.0)
        ad = AsyncDiLoCo(manager, st, tft.SGD(1.0), 1, compress="int8")
        ad.step({"w": torch.ones(4)})
        ad.flush()
        # a zeroed member entry and a divisor of 2: half the own delta
        np.testing.assert_allclose(_w(st), 0.95, atol=0.001)


# ---- trajectories: the port and the JAX package on the same inputs ------


def _np_params():
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((5, 7)).astype(F32),
            "b": rng.standard_normal(11).astype(F32)}


def _np_grads(steps):
    rng = np.random.default_rng(4)
    return [{"w": rng.standard_normal((5, 7)).astype(F32),
             "b": (rng.standard_normal(11) * 3).astype(F32)}
            for _ in range(steps)]


def _jax_mock(commits):
    m = create_autospec(JaxManager, instance=True)
    m.allreduce.side_effect = (
        lambda tree, op=None, wire=None: jcol._completed(tree))
    m.allgather.side_effect = lambda tree: jcol._completed([tree])
    m.num_participants.return_value = 1
    m.should_commit.side_effect = list(commits)
    m._use_async_quorum = False
    return m


def _build(pkg, algo, opts, commits):
    p0 = _np_params()
    outer = dict(learning_rate=0.7, momentum=0.9, nesterov=True)
    if pkg == "jax":
        st = jft.FTTrainState(jax.tree_util.tree_map(jnp.asarray, p0),
                              optax.sgd(0.05))
        m = _jax_mock(commits)
        mod, tx = jls, optax.sgd(**outer)
    else:
        st = tft.FTTrainState({k: _t(v) for k, v in p0.items()},
                              tft.SGD(0.05))
        m = _mock_manager(commit=list(commits))
        mod = __import__("torchft_tpu_torch.local_sgd",
                         fromlist=["LocalSGD"])
        tx = tft.SGD(**outer)
    if algo == "local_sgd":
        return st, mod.LocalSGD(m, st, 2)
    if algo == "diloco":
        return st, mod.DiLoCo(m, st, tx, 2)
    return st, mod.AsyncDiLoCo(m, st, tx, 2, **opts)


def _bytes_of(tree):
    return [np.asarray(l.detach().numpy() if isinstance(l, torch.Tensor)
                       else l).tobytes()
            for l in (flatten(tree)[0] if not isinstance(
                next(iter(tree.values())), jax.Array)
                else jax.tree_util.tree_leaves(tree))]


def _trajectory(pkg, algo, opts, commits, steps=8, eager=True):
    st, engine = _build(pkg, algo, opts, commits)
    grads = _np_grads(steps)
    with jax.disable_jit(eager):
        for g in grads:
            if pkg == "jax":
                engine.step(jax.tree_util.tree_map(jnp.asarray, g))
            else:
                engine.step({k: _t(v) for k, v in g.items()})
        if algo == "async":
            engine.flush()
        out = {"params": _bytes_of(st.params),
               "backup": _bytes_of(engine._backup_params)}
        if algo != "local_sgd":
            outer = engine._outer_state
            leaves = (jax.tree_util.tree_leaves(outer) if pkg == "jax"
                      else flatten(outer)[0])
            out["outer"] = [np.asarray(l).tobytes() if pkg == "jax"
                            else l.numpy().tobytes() for l in leaves]
    return out


_COMMITS = [True, False, True, True]


class TestTrajectoriesMatchJax:
    @pytest.mark.parametrize("algo,opts", [
        ("local_sgd", {}), ("diloco", {}),
        ("async", {"compress": None}),
        ("async", {"compress": None, "overlap": False}),
        ("async", {"compress": "bf16"}),
        ("async", {"compress": "int8"}),
        ("async", {"compress": "int8", "overlap": False}),
        ("async", {"compress": "q8"}),
    ])
    def test_bit_identical(self, algo, opts):
        """Windows that commit and abort, Nesterov outer SGD, the
        delayed reconcile, the bf16 delta (K3's plain version) and the
        int8/q8 error feedback: every bit equal to the JAX package run
        eagerly."""
        ref = _trajectory("jax", algo, opts, _COMMITS)
        got = _trajectory("port", algo, opts, _COMMITS)
        assert got == ref

    @pytest.mark.parametrize("algo,opts", [
        ("local_sgd", {}), ("diloco", {}), ("async", {"compress": None}),
        ("async", {"compress": "bf16"}), ("async", {"compress": "int8"}),
        ("async", {"compress": "q8"})])
    def test_jitted_reference_within_tolerance(self, algo, opts):
        """Jitted, XLA's CPU backend contracts the JAX package's inner
        update (``p + (-lr) g``), quantize and reconcile into FMAs (F6):
        6-32 of the 46 params differ after 8 steps, by at most 4.8e-7
        (4.8e-6 relative). The port rounds every product."""
        ref = _trajectory("jax", algo, opts, _COMMITS, eager=False)
        got = _trajectory("port", algo, opts, _COMMITS)
        for a, b in zip(got["params"], ref["params"]):
            np.testing.assert_allclose(np.frombuffer(a, F32),
                                       np.frombuffer(b, F32),
                                       rtol=1e-5, atol=1e-6)


# ---- rings: sharded DiLoCo, and mixed JAX + port cohorts ---------------


class _RingManager:
    """A deterministic manager over a real HostCollectives ring (either
    package's): full participation, always commits, a fixed quorum id."""

    def __init__(self, col, quorum_id=1):
        self._col = col
        self._rop = (jcol if isinstance(col, jcol.HostCollectives)
                     else tcol).ReduceOp
        self._use_async_quorum = False
        self.qid = quorum_id
        self.commit = True

    def start_quorum(self, **kw):
        pass

    def _div(self, op):
        return float(self._col.size()) if op == self._rop.AVG else None

    def allreduce(self, tree, op=None, wire=None):
        return self._col.allreduce(tree, self._rop.SUM,
                                   divisor=self._div(op), wire=wire)

    def allreduce_hier(self, tree, op=None, wire=None):
        return self._col.allreduce_hier(tree, self._rop.SUM,
                                        divisor=self._div(op), wire=wire)

    def reduce_scatter(self, tree, op=None, wire=None):
        return self._col.reduce_scatter(tree, self._rop.SUM,
                                        divisor=self._div(op), wire=wire)

    def allgather_into(self, shard, wire=None):
        return self._col.allgather_into(shard, wire=wire)

    def allgather(self, tree):
        return self._col.allgather(tree)

    def quorum_id(self):
        return self.qid

    def num_participants(self):
        return self._col.size()

    def should_commit(self):
        return self.commit

    def report_error(self, e):
        raise e


def _ring(store, members, prefix, regions=None):
    cols = [m() for m in members]
    addr = f"{store.address()}/{prefix}"
    with ThreadPoolExecutor(max_workers=len(cols)) as ex:
        for f in [ex.submit(c.configure, addr, r, len(cols), regions)
                  for r, c in enumerate(cols)]:
            f.result(timeout=60)
    return cols


def _port_col():
    return tcol.HostCollectives(timeout=_T, stripes=1)


def _jax_col():
    return jcol.HostCollectives(timeout=_T, stripes=1)


def _ring_run(fns):
    out = [None] * len(fns)
    errs = []

    def go(r):
        try:
            with jax.disable_jit():
                out[r] = fns[r]()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=go, args=(r,)) for r in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive()
    if errs:
        raise errs[0]
    return out


@pytest.fixture
def store():
    s = jft.Store()
    yield s
    s.shutdown()


OUTER = dict(learning_rate=0.7, momentum=0.9, nesterov=True)


def _ring_params():
    return {"w": np.linspace(0.0, 1.0, 23, dtype=F32),
            "b": np.full((9,), 2.0, F32)}


def _ring_grads(s, r):
    return {"w": np.full((23,), 0.01 * (s + 1 + r), F32),
            "b": np.full((9,), 0.03 * (r + 1), F32)}


def _engine(col, qid, algo, **kw):
    """A member of either package over ``col``: (state, engine)."""
    m = _RingManager(col, qid)
    p0 = _ring_params()
    if isinstance(col, jcol.HostCollectives):
        st = jft.FTTrainState(jax.tree_util.tree_map(jnp.asarray, p0),
                              optax.sgd(0.05))
        cls = {"local_sgd": jls.LocalSGD, "diloco": jls.DiLoCo}[algo]
        tx = optax.sgd(**OUTER)
    else:
        st = tft.FTTrainState({k: _t(v) for k, v in p0.items()},
                              tft.SGD(0.05))
        cls = {"local_sgd": LocalSGD, "diloco": DiLoCo}[algo]
        tx = tft.SGD(**OUTER)
    if algo == "local_sgd":
        return st, cls(m, st, kw.pop("sync_every"))
    return st, cls(m, st, tx, kw.pop("sync_every"), **kw)


def _grads_for(col, g):
    if isinstance(col, jcol.HostCollectives):
        return jax.tree_util.tree_map(jnp.asarray, g)
    return {k: _t(v) for k, v in g.items()}


def _params_np(st):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v) for k, v in st.params.items()}


def _cohort(store, members, prefix, syncs, sync_every, algo="diloco",
            regions=None, **kw):
    cols = _ring(store, members, prefix, regions)

    def replica(r):
        st, eng = _engine(cols[r], 1, algo, sync_every=sync_every, **kw)
        for s in range(syncs * sync_every):
            eng.step(_grads_for(cols[r], _ring_grads(s, r)))
        return _params_np(st), eng

    try:
        return _ring_run([lambda r=r: replica(r) for r in range(len(cols))])
    finally:
        for c in cols:
            c.shutdown()


def _outer_flat(eng):
    """(full-size momentum, covered mask) of one member's outer shard."""
    meta = eng._outer_shard_meta
    (name,) = list(meta["ranges"])
    outer = eng._outer_state
    leaf = (jax.tree_util.tree_leaves(outer)[0]
            if not isinstance(outer, dict) or "trace" not in outer
            else flatten(outer)[0][0])
    tr = np.asarray(leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf)
    return name, [tuple(x) for x in meta["ranges"][name]], tr


class TestShardedDiLoCo:
    @pytest.mark.parametrize("world", [2, 3])
    def test_matches_unsharded_exactly(self, store, world):
        uns = _cohort(store, [_port_col] * world, f"uns{world}", 3, 2,
                      sharded=False)
        sh = _cohort(store, [_port_col] * world, f"sh{world}", 3, 2,
                     sharded=True)
        for r in range(world):
            for k in uns[0][0]:
                assert sh[r][0][k].tobytes() == uns[0][0][k].tobytes()

    def test_q8_wire_bf16_params_consistent_and_close(self, store):
        uns = _cohort(store, [_port_col] * 2, "unsq", 2, 2, sharded=False)
        sh = _cohort(store, [_port_col] * 2, "shq", 2, 2, sharded=True,
                     shard_wire="q8", param_wire="bf16")
        for k in sh[0][0]:
            assert sh[0][0][k].tobytes() == sh[1][0][k].tobytes()
            np.testing.assert_allclose(sh[0][0][k], uns[0][0][k],
                                       rtol=0.05, atol=0.05)

    def test_outer_state_is_sharded(self, store):
        res = _cohort(store, [_port_col] * 3, "mem", 1, 1, sharded=True)
        total = 23 + 9
        seen = np.zeros(total, np.int32)
        for _, eng in res:
            _, ranges, tr = _outer_flat(eng)
            ln = sum(n for _, n in ranges)
            for s, n in ranges:
                seen[s:s + n] += 1
            assert tr.size == ln < total
        assert (seen == 1).all()


def _reshard_case(store, first, second, tag):
    """A cohort of ``first`` members syncs once (qid 1); then the cohort
    ``second`` (the first members that stay, then any joiners, which
    load a first member's state as a heal delivers it) syncs at qid 2. Returns
    the pre-change momentum oracle, the old ranges, the members' final
    params and engines."""
    cols = _ring(store, first, tag + "pre")

    def one(r):
        st, eng = _engine(cols[r], 1, "diloco", sync_every=1, sharded=True)
        eng.step(_grads_for(cols[r], _ring_grads(0, r)))
        return st, eng

    try:
        firsts = _ring_run([lambda r=r: one(r) for r in range(len(cols))])
    finally:
        for c in cols:
            c.shutdown()
    total = 23 + 9
    full_mom = np.zeros(total, F32)
    old_ranges = []
    for _, eng in firsts:
        _, ranges, tr = _outer_flat(eng)
        old_ranges.append(ranges)
        off = 0
        for s, n in ranges:
            full_mom[s:s + n] = tr[off:off + n]
            off += n
    cols2 = _ring(store, second, tag + "post")
    # a joiner heals from a member of its own package (the state dicts'
    # optimizer layouts are each package's own)
    donors = {type(e._manager._col): e.state_dict() for _, e in firsts}

    def two(r):
        if r < len(firsts) and r < len(cols2) and type(cols2[r]) is type(
                firsts[r][1]._manager._col):
            st, eng = firsts[r]
            eng._manager._col = cols2[r]
            eng._manager.qid = 2
        else:  # a joiner: a fresh member healed from member 0's state
            st, eng = _engine(cols2[r], 2, "diloco", sync_every=1,
                              sharded=True)
            eng.load_state_dict(_as_pkg(donors[type(cols2[r])], cols2[r]))
        eng.step(_grads_for(cols2[r], _ring_grads(1, 0)))
        return _params_np(st), eng

    try:
        seconds = _ring_run([lambda r=r: two(r) for r in range(len(cols2))])
    finally:
        for c in cols2:
            c.shutdown()
    return full_mom, old_ranges, seconds


def _as_pkg(sd, col):
    """A state dict as the heal's pickled path delivers it (numpy
    leaves), for a member of ``col``'s package."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().numpy().copy()
        if isinstance(x, jax.Array):
            return np.asarray(x).copy()
        return x
    if isinstance(col, jcol.HostCollectives):
        return jax.tree_util.tree_map(host, sd)
    return _map_tree(host, sd)


def _map_tree(fn, t):
    if isinstance(t, dict):
        return {k: _map_tree(fn, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_map_tree(fn, v) for v in t)
    return fn(t)


class TestReshard:
    def test_after_a_leave_preserves_surviving_momentum(self, store):
        full_mom, old, res = _reshard_case(
            store, [_port_col] * 3, [_port_col] * 2, "leave")
        for k in res[0][0]:
            assert res[0][0][k].tobytes() == res[1][0][k].tobytes()
        covered = np.zeros(full_mom.size, bool)
        for ranges in old[:2]:
            for s, n in ranges:
                covered[s:s + n] = True
        assert not covered.all()  # the departed member's slice restarts
        for _, eng in res:
            _, ranges, tr = _outer_flat(eng)
            assert tr.size == sum(n for _, n in ranges)

    @pytest.mark.parametrize("mixed", [False, True])
    def test_after_a_join(self, store, mixed):
        """Two members sync, a third joins (healed from member 1's state);
        every member re-partitions the outer state and all three end
        bit-identical; with ``mixed`` member 0 is the JAX package's."""
        first = [_jax_col if mixed else _port_col, _port_col]
        full_mom, old, res = _reshard_case(
            store, first, first + [_port_col], f"join{mixed}")
        for r in (1, 2):
            for k in res[0][0]:
                assert res[r][0][k].tobytes() == res[0][0][k].tobytes()
        # the oracle of the new partition's momentum: the pre-change trace
        # (every position was owned, so all carry over), one more Nesterov
        # trace update with the averaged delta
        for _, eng in res:
            _, ranges, tr = _outer_flat(eng)
            assert tr.size == sum(n for _, n in ranges)


class TestMixedRings:
    @pytest.mark.parametrize("world", [2, 3])
    def test_local_sgd_bit_identical(self, store, world):
        ref = _cohort(store, [_jax_col] * world, f"jl{world}", 2, 2,
                      algo="local_sgd")
        got = _cohort(store, [_jax_col] + [_port_col] * (world - 1),
                      f"ml{world}", 2, 2, algo="local_sgd")
        for r in range(world):
            for k in ref[0][0]:
                assert got[r][0][k].tobytes() == ref[r][0][k].tobytes()

    @pytest.mark.parametrize("wires", [(None, None), ("q8", "bf16")])
    def test_sharded_diloco_bit_identical(self, store, wires):
        sw, pw = wires
        ref = _cohort(store, [_jax_col] * 2, f"js{sw}", 2, 2, sharded=True,
                      shard_wire=sw, param_wire=pw)
        got = _cohort(store, [_jax_col, _port_col], f"ms{sw}", 2, 2,
                      sharded=True, shard_wire=sw, param_wire=pw)
        for r in range(2):
            for k in ref[0][0]:
                assert got[r][0][k].tobytes() == ref[0][0][k].tobytes()

    @pytest.mark.parametrize("wire", [None, "q8"])
    def test_hier_diloco_within_tolerance(self, store, wire):
        """``hier=True`` over a two-region cohort (the inter hop on
        ``hier_wire``): the JAX member and the port member agree to 1e-6
        relative, as the unsharded outer step does."""
        regions = ["r0", "r1"]
        ref = _cohort(store, [_jax_col] * 2, f"jh{wire}", 2, 2,
                      regions=regions, hier=True, hier_wire=wire)
        got = _cohort(store, [_jax_col, _port_col], f"mh{wire}", 2, 2,
                      regions=regions, hier=True, hier_wire=wire)
        for r in range(2):
            for k in ref[0][0]:
                np.testing.assert_allclose(got[r][0][k], ref[0][0][k],
                                           rtol=1e-6, atol=0)

    def test_unsharded_diloco_within_tolerance(self, store):
        """Each member runs the outer step itself: the JAX member and the
        port member agree to 1e-6 relative (here: exactly, as both run
        the optax arithmetic eagerly)."""
        ref = _cohort(store, [_jax_col] * 2, "ju", 2, 2, sharded=False)
        got = _cohort(store, [_jax_col, _port_col], "mu", 2, 2,
                      sharded=False)
        for r in range(2):
            for k in ref[0][0]:
                np.testing.assert_allclose(got[r][0][k], ref[0][0][k],
                                           rtol=1e-6, atol=0)


# ---- integration: a real lighthouse, the sync quorum's heal -------------


class InjectedFailure(Exception):
    pass


def _run_replicas(algo, num_replicas, num_syncs, sync_every, fail_at,
                  sharded=False, shard_wire=None, param_wire=None,
                  stop_at=None):
    lighthouse = tft.Lighthouse(min_replicas=1, join_timeout_ms=200,
                                quorum_tick_ms=50, heartbeat_timeout_ms=1000)
    remaining = dict(fail_at)
    lock = threading.Lock()

    def run_replica(rid):
        for _ in range(3):
            try:
                return train(rid)
            except InjectedFailure:
                continue
        raise RuntimeError(f"replica {rid} exhausted attempts")

    def train(rid):
        store = tft.Store()
        col = tcol.HostCollectives(timeout=timedelta(seconds=10))
        st = tft.FTTrainState({"w": torch.full((8,), 1.0)}, tft.SGD(0.05))
        holder: Dict[str, Any] = {}
        manager = tft.Manager(
            collectives=col,
            load_state_dict=lambda sd: holder["algo"].load_state_dict(sd),
            state_dict=lambda: holder["algo"].state_dict(),
            min_replica_size=1,
            use_async_quorum=(algo == "local_sgd"),
            timeout=timedelta(seconds=10),
            quorum_timeout=timedelta(seconds=10),
            connect_timeout=timedelta(seconds=10),
            rank=0, world_size=1, store_addr=store.address(),
            lighthouse_addr=lighthouse.address(), replica_id=f"{algo}_{rid}",
            device="cpu",
        )
        if algo == "local_sgd":
            holder["algo"] = LocalSGD(manager, st, sync_every)
        else:
            holder["algo"] = DiLoCo(
                manager, st, tft.SGD(0.7, momentum=0.9, nesterov=True)
                if sharded else tft.SGD(0.7), sync_every, sharded=sharded,
                shard_wire=shard_wire, param_wire=param_wire)
        eng = holder["algo"]
        try:
            while manager.current_step() < num_syncs:
                if stop_at and stop_at.get(rid, num_syncs + 1) <= \
                        manager.current_step():
                    return None
                with lock:
                    if remaining.get(rid) == manager.current_step():
                        del remaining[rid]
                        raise InjectedFailure(str(rid))
                s = manager.current_step()
                eng.step({"w": torch.full((8,), 0.1 * (s + 1))})
            return {"params": st.params["w"].numpy().copy(),
                    "backup": eng._backup_params["w"].numpy().copy()}
        finally:
            manager.shutdown()
            col.shutdown()
            store.shutdown()

    try:
        with ThreadPoolExecutor(max_workers=num_replicas) as ex:
            futs = [ex.submit(run_replica, i) for i in range(num_replicas)]
            return [f.result(timeout=120) for f in futs]
    finally:
        lighthouse.shutdown()


class TestInteg:
    def test_local_sgd_recovery(self):
        res = _run_replicas("local_sgd", 2, 4, 2, fail_at={1: 1})
        assert res[0]["params"].tobytes() == res[1]["params"].tobytes()

    def test_diloco_recovery(self):
        res = _run_replicas("diloco", 2, 4, 2, fail_at={1: 1})
        assert res[0]["params"].tobytes() == res[1]["params"].tobytes()
        assert res[0]["backup"].tobytes() == res[1]["backup"].tobytes()

    def test_sharded_q8_bf16_diloco_recovery(self):
        res = _run_replicas("diloco", 2, 3, 2, fail_at={1: 1}, sharded=True,
                            shard_wire="q8", param_wire="bf16")
        assert res[0]["params"].tobytes() == res[1]["params"].tobytes()

    def test_sharded_diloco_survives_shrink(self):
        res = _run_replicas("diloco", 3, 3, 2, fail_at={}, sharded=True,
                            stop_at={2: 1})
        assert res[2] is None
        assert res[0]["params"].tobytes() == res[1]["params"].tobytes()
