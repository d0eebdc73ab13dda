"""The port's durable checkpoint tier against the JAX package's.

- The same plain-dict state (params plus dict moments; optax's tuple
  states do not cross packages, ROADMAP D3) written by both packages at
  W = 3 gives equal shard bytes, markers, manifest frames and
  ``shard_bounds``, all but the meta pickle (it names each package's
  slot class) and the timestamps; a restore at another width is
  bit-identical in both.
- The behaviour of the tier: async and sync modes, retention, the torn
  tail, the commit fence, backpressure, the quorum-move abort, the
  fallback to an older set, the port's ``zero_copy`` (one device-side
  copy, not a pin: an in-place update after the capture does not reach
  the shard), and the manager's one-shot cold-fleet consult.

Every wait has its own timeout (the writer's flush, the committer's
deadline, the manager's quorum).
"""

import json
import os
import struct
import threading
from datetime import timedelta

import ml_dtypes
import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import torchft_tpu.durable as jdur
import torchft_tpu_torch as tft
from torchft_tpu_torch import checkpointing as ck
from torchft_tpu_torch import durable as tdur
from torchft_tpu_torch._native import Lighthouse, Store

_T = timedelta(seconds=10)


def _bits(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


# ---------------------------------------------------------------------------
# multi-member fleet rig (fake managers over one shared store)


class _FakeManager:
    def __init__(self, rank, world, replica_id, quorum_id=1):
        self._rank, self._world = rank, world
        self._rid = replica_id
        self._step, self._bc, self._qid = 0, 0, quorum_id

    def current_step(self):
        return self._step

    def quorum_id(self):
        return self._qid

    def participating_rank(self):
        return self._rank

    def num_participants(self):
        return self._world

    def replica_id(self):
        return self._rid

    def state_dict(self):
        return {"step": self._step, "batches_committed": self._bc}

    def load_state_dict(self, sd):
        self._step = sd["step"]
        self._bc = sd["batches_committed"]

    def add_commit_hook(self, hook):
        pass


def _rep_arrays(seed=0, n=257):
    rng = np.random.RandomState(seed)
    return {
        "params": {"w": rng.randn(n).astype(np.float32),
                   "b": rng.randn(3, 5).astype(np.float32)},
        "opt_state": {"mu": {"w": rng.randn(n).astype(np.float32)},
                      "nu": {"w": rng.rand(n).astype(np.float32)},
                      "count": 3},
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


class _RepState:
    """Replicated user state of torch tensors: params + f32 moments (the
    bf16 wire's target); every member holds identical leaves."""

    def __init__(self, seed=0):
        self.sd = _to_torch(_rep_arrays(seed))

    def state_dict(self):
        return self.sd

    def load_state_dict(self, sd):
        self.sd = sd


class _JaxRepState:
    def __init__(self, seed=0):
        self.sd = _rep_arrays(seed)

    def state_dict(self):
        return self.sd

    def load_state_dict(self, sd):
        import jax

        self.sd = jax.tree_util.tree_map(np.asarray, sd)


def _fleet(root, world, store=None, pkg=tdur, state_cls=_RepState, **kw):
    store = store or pkg.LocalDirStore(str(root))
    kw.setdefault("commit_timeout_s", 20.0)
    if pkg is tdur:
        kw.setdefault("device", "cpu")
    mgrs = [_FakeManager(r, world, f"rep{r}") for r in range(world)]
    states = [state_cls(0) for _ in range(world)]
    cps = [pkg.DurableCheckpointer(str(root), mgrs[r], states[r], store=store,
                                   **kw)
           for r in range(world)]
    return store, mgrs, states, cps


def _fleet_step(mgrs, cps, step):
    for m in mgrs:
        m._step = step
        m._bc = step * len(mgrs)
    return [c.maybe_save() for c in cps]


def _cold(store, tmp_path, w_new=1, seed=99, **kw):
    st = _RepState(seed)
    cp = tdur.DurableCheckpointer(str(tmp_path), _FakeManager(0, w_new, "cold"),
                                  st, store=store, device="cpu", **kw)
    return st, cp


def _bf16_round(a):
    return a.astype(np.dtype(ml_dtypes.bfloat16)).astype(np.float32)


# ---------------------------------------------------------------------------
# against the JAX package


def _strip_meta(d):
    return {k: v for k, v in d.items()
            if k not in ("meta_nbytes", "meta_crc", "meta", "unix_ms")}


@pytest.mark.parametrize("wire", ["bf16", None])
def test_writes_match_the_jax_package(tmp_path, wire):
    """Both packages write the same W = 3 set of the same state."""
    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    fleets = {
        "jax": _fleet(roots["jax"], 3, pkg=jdur, state_cls=_JaxRepState,
                      every=1, wire=wire),
        "port": _fleet(roots["port"], 3, every=1, wire=wire),
    }
    for name, (_, mgrs, _, cps) in fleets.items():
        _fleet_step(mgrs, cps, 1)
        assert all(c.flush(30) for c in cps), name
        for c in cps:
            c.close()
    jstore, pstore = fleets["jax"][0], fleets["port"][0]
    names = pstore.list("")
    assert names == jstore.list("")
    total = fleets["port"][3][0].snapshots[0]["total_bytes"]
    assert total == fleets["jax"][3][0].snapshots[0]["total_bytes"]
    assert tdur.shard_bounds(total, 3) == jdur.shard_bounds(total, 3)
    for n in names:
        if n.endswith(".bin"):
            assert pstore.get(n) == jstore.get(n), n
        elif n.endswith(".json"):
            assert _strip_meta(json.loads(pstore.get(n))) == \
                _strip_meta(json.loads(jstore.get(n))), n
    precs, pdrop = tdur.ManifestLog(pstore).replay()
    jrecs, jdrop = jdur.ManifestLog(jstore).replay()
    assert pdrop == jdrop == 0
    assert [_strip_meta(r) for r in precs] == [_strip_meta(r) for r in jrecs]
    assert [r["meta"]["name"] for r in precs] == [r["meta"]["name"] for r in jrecs]
    # a record's frame is the JAX package's for the same record
    assert tdur.ManifestLog.frame(precs[0]) == jdur.ManifestLog.frame(precs[0])

    # restore at a new width: bit-identical in both packages
    st, cp = _cold(pstore, roots["port"], w_new=2)
    jst = _JaxRepState(seed=99)
    jcp = jdur.DurableCheckpointer(str(roots["jax"]),
                                   _FakeManager(0, 2, "cold"), jst,
                                   store=jstore)
    assert cp.restore_latest() == 1 and jcp.restore_latest() == 1
    want = _rep_arrays(0)
    got, jgot = st.sd, jst.sd
    for k in ("w", "b"):
        assert _bits(got["params"][k]) == want["params"][k].tobytes()
        assert jgot["params"][k].tobytes() == want["params"][k].tobytes()
    for m in ("mu", "nu"):
        exp = want["opt_state"][m]["w"]
        if wire == "bf16":
            exp = _bf16_round(exp)
        assert _bits(got["opt_state"][m]["w"]) == exp.tobytes()
        assert jgot["opt_state"][m]["w"].tobytes() == exp.tobytes()
    assert got["opt_state"]["count"] == jgot["opt_state"]["count"] == 3
    cp.close()
    jcp.close()


@pytest.mark.parametrize("world", [1, 3, 4])
def test_shard_staging_ranges_match_the_jax_package(world):
    """A shard-limited staging holds exactly the full stream's bytes of
    its range (straddling leaves sliced to whole wire elements), the JAX
    package's bytes, and refuses reads outside it."""
    from torchft_tpu import checkpointing as jck

    arrays = _rep_arrays(1)
    state = {"user": _to_torch(arrays), "torchft": {"step": 4}}
    full = ck._StreamStaging(state, "bf16")
    jfull = jck._StreamStaging({"user": arrays, "torchft": {"step": 4}}, "bf16")
    stream = bytes(full._host_view())
    assert stream == b"".join(
        bytes(jfull._seg(i)) for i in range(len(jfull._segments)))
    bounds = tdur.shard_bounds(full.total, world)
    captured = 0
    for r in range(world):
        sh = ck._StreamStaging(state, "bf16", shard_of=(r, world))
        jsh = jck._StreamStaging({"user": arrays, "torchft": {"step": 4}},
                                 "bf16", snapshot=True, shard_of=(r, world))
        b, e = bounds[r], bounds[r + 1]
        assert sh.total == full.total and sh.meta == full.meta
        assert sh.captured_bytes == jsh.captured_bytes
        assert e - b <= sh.captured_bytes <= (e - b) + 8  # whole elements
        captured += sh.captured_bytes

        class _W:
            def __init__(self):
                self.parts = []

            def write(self, mv):
                self.parts.append(bytes(mv))

        w = _W()
        sh.write_range(w, b, e)
        assert b"".join(w.parts) == stream[b:e]
        assert sh.range_crc32c(b, e) == jsh.range_crc32c(b, e)
        if world > 1:
            with pytest.raises(ValueError, match="outside captured span"):
                sh.range_crc32c(0, full.total)
    assert captured >= full.total


# ---------------------------------------------------------------------------
# behaviour, on the port alone


def test_shard_bytes_scale_inverse_w(tmp_path):
    totals = {}
    for world in (1, 2, 4):
        root = tmp_path / f"w{world}"
        _, mgrs, _, cps = _fleet(root, world, every=1)
        _fleet_step(mgrs, cps, 1)
        assert all(c.flush(30) for c in cps)
        rows = [c.snapshots[0] for c in cps]
        assert rows[0]["committed"], rows
        assert cps[0].committed_steps() == [1]
        total = rows[0]["total_bytes"]
        for r in rows:
            assert abs(r["shard_bytes"] - total // world) <= world
            assert r["captured_bytes"] <= r["shard_bytes"] + 8
        totals[world] = sum(r["shard_bytes"] for r in rows)
        for c in cps:
            c.close()
    assert len(set(totals.values())) == 1, totals


@pytest.mark.parametrize("w_new", [1, 2, 4])
def test_restore_across_widths_bit_identical(tmp_path, w_new):
    store, mgrs, states, cps = _fleet(tmp_path, 3, every=1)
    _fleet_step(mgrs, cps, 1)
    assert all(c.flush(30) for c in cps)
    for c in cps:
        c.close()
    want = _rep_arrays(0)
    mgr = _FakeManager(0, w_new, f"cold{w_new}")
    st = _RepState(seed=99)
    cp = tdur.DurableCheckpointer(str(tmp_path), mgr, st, store=store,
                                  device="cpu")
    assert cp.restore_latest() == 1
    assert mgr._step == 1 and mgr._bc == 3
    assert _bits(st.sd["params"]["w"]) == want["params"]["w"].tobytes()
    assert _bits(st.sd["opt_state"]["mu"]["w"]) == \
        _bf16_round(want["opt_state"]["mu"]["w"]).tobytes()
    assert st.sd["params"]["w"].device.type == "cpu"
    stats = cp.last_restore_stats
    assert stats["world"] == 3 and stats["dropped_tail_bytes"] == 0
    assert stats["device"] == "cpu"
    cp.close()


def test_raw_wire_restores_opt_state_exact(tmp_path):
    store, mgrs, states, cps = _fleet(tmp_path, 2, every=1, wire=None)
    _fleet_step(mgrs, cps, 1)
    assert all(c.flush(30) for c in cps)
    for c in cps:
        c.close()
    st, cp = _cold(store, tmp_path, seed=5)
    assert cp.restore_latest() == 1
    assert _bits(st.sd["opt_state"]["nu"]["w"]) == \
        _bits(states[0].sd["opt_state"]["nu"]["w"])
    cp.close()


class _GatedStore(tdur.LocalDirStore):
    """Blocks shard-payload writes until released: the writer thread
    stops mid-snapshot while the trainer runs ahead or the quorum moves."""

    def __init__(self, root):
        super().__init__(root)
        self.gate = threading.Event()

    def put_from(self, name, write_fn):
        if "/shard_" in name and name.endswith(".bin"):
            assert self.gate.wait(30), f"gate never released for {name}"
        return super().put_from(name, write_fn)


@pytest.mark.parametrize("zero_copy", [False, True])
def test_update_after_capture_does_not_reach_the_shard(tmp_path, zero_copy):
    """The optimizer updates in place; a snapshot captured at step N
    holds step N's values though the writer runs after steps N+1..N+3
    wrote the same tensors (``zero_copy`` included: the port copies at
    capture, it never holds a live tensor)."""
    store = _GatedStore(str(tmp_path))
    _, mgrs, states, cps = _fleet(tmp_path, 2, store=store, every=1,
                                  zero_copy=zero_copy)
    want = _rep_arrays(0)
    _fleet_step(mgrs, cps, 1)  # captured; the writer waits at the gate
    for _ in range(3):
        for st in states:
            st.sd["params"]["w"].add_(1.0)
            st.sd["opt_state"]["mu"]["w"].mul_(-1.0)
    store.gate.set()
    assert all(c.flush(30) for c in cps)
    for c in cps:
        c.close()
    st, cp = _cold(store, tmp_path, seed=7)
    assert cp.restore_latest() == 1
    assert _bits(st.sd["params"]["w"]) == want["params"]["w"].tobytes()
    assert _bits(st.sd["opt_state"]["mu"]["w"]) == \
        _bf16_round(want["opt_state"]["mu"]["w"]).tobytes()
    cp.close()


def test_quorum_change_mid_snapshot_aborts(tmp_path):
    store = _GatedStore(str(tmp_path))
    _, mgrs, states, cps = _fleet(tmp_path, 2, store=store, every=1)
    dirs = _fleet_step(mgrs, cps, 1)  # in flight under quorum_id=1
    assert all(dirs)
    for m in mgrs:
        m._qid = 2  # membership moved
        m._step = 2
    _ = [c.maybe_save() for c in cps]  # fences the old set, captures anew
    store.gate.set()
    assert all(c.flush(30) for c in cps)
    for c in cps:
        c.close()
    assert cps[0].committed_steps() == [2]
    assert cps[0].snapshots[0]["aborted"], cps[0].snapshots
    assert cps[0].snapshots[1]["committed"]
    assert all(not n.endswith(".json") for n in store.list(dirs[0] + "/"))
    records, _ = tdur.ManifestLog(store).replay()
    assert all(r.get("dir") != dirs[0] for r in records)


def test_committer_timeout_abandons_partial_set(tmp_path):
    store = tdur.LocalDirStore(str(tmp_path))
    mgr = _FakeManager(0, 2, "rep0")  # rank 1 never writes its shard
    cp = tdur.DurableCheckpointer(str(tmp_path), mgr, _RepState(0),
                                  store=store, every=1, commit_timeout_s=0.3,
                                  device="cpu")
    mgr._step = 1
    assert cp.maybe_save()
    assert cp.flush(30)
    cp.close()
    assert cp.snapshots[0]["aborted"] and not cp.snapshots[0]["committed"]
    assert cp.committed_steps() == []
    _, cp2 = _cold(store, tmp_path, seed=3)
    assert cp2.restore_latest() is None
    cp2.close()


def test_manifest_truncate_sweep_never_yields_torn_commit(tmp_path):
    store, mgrs, _, cps = _fleet(tmp_path, 1, every=1, keep=5)
    for step in (1, 2):
        _fleet_step(mgrs, cps, step)
        assert cps[0].flush(30)
    cps[0].close()
    raw = store.get(tdur.MANIFEST_NAME)
    records, _ = tdur.ManifestLog(store).replay()
    assert [r["step"] for r in tdur.live_commits(records)] == [1, 2]
    first_len = struct.unpack_from("<I", raw, 0)[0] + 8
    for cut in range(len(raw)):
        store.put(tdur.MANIFEST_NAME, raw[:cut])
        recs, dropped = tdur.ManifestLog(store).replay()
        steps = [r["step"] for r in tdur.live_commits(recs)]
        assert steps == ([] if cut < first_len else [1])
        assert dropped == cut - (0 if cut < first_len else first_len)


def test_corrupt_shard_falls_back_to_older_set(tmp_path):
    store, mgrs, _, cps = _fleet(tmp_path, 1, every=1, keep=3)
    for step in (1, 2):
        _fleet_step(mgrs, cps, step)
        assert cps[0].flush(30)
    cps[0].close()
    newest = tdur.snapshot_dir(2, 1, 1)
    name = f"{newest}/shard_0000.bin"
    data = bytearray(store.get(name))
    data[5] ^= 0xFF
    store.put(name, bytes(data))
    _, cp = _cold(store, tmp_path)
    assert cp.restore_latest() == 1
    cp.close()


def test_rebuild_error_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """A set that validates but whose rebuild fails (a device's
    out-of-memory or launch error at the upload) is not a bad set: the
    restore raises rather than loading an older set or returning None."""
    store, mgrs, _, cps = _fleet(tmp_path, 1, every=1, keep=3)
    for step in (1, 2):
        _fleet_step(mgrs, cps, step)
        assert cps[0].flush(30)
    cps[0].close()
    tried = []

    def failing_rebuild(meta, buf, device=None):
        tried.append(int(meta["total"]))
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(tdur, "rebuild_from_packed", failing_rebuild)
    _, cp = _cold(store, tmp_path)
    with pytest.raises(RuntimeError, match="out of memory"):
        cp.restore_latest()
    assert len(tried) == 1  # the newest set only, no older one tried
    assert cp.last_restore_stats is None
    monkeypatch.undo()
    assert cp.restore_latest() == 2
    cp.close()


def test_staging_cap_skips_capture(tmp_path):
    store = _GatedStore(str(tmp_path))
    _, mgrs, _, cps = _fleet(tmp_path, 1, store=store, every=1,
                             max_staging_mb=0.0001)
    _fleet_step(mgrs, cps, 1)  # in flight, gated
    _fleet_step(mgrs, cps, 2)  # past the cap: skipped, never blocking
    store.gate.set()
    assert all(c.flush(30) for c in cps)
    for c in cps:
        c.close()
    rows = cps[0].snapshots
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[0]["committed"] and rows[1]["skipped"]
    assert cps[0].committed_steps() == [1]


def test_sync_mode_commits_inline(tmp_path):
    _, mgrs, _, cps = _fleet(tmp_path, 2, every=1, mode="sync")
    for m in mgrs:
        m._step = 1
    # rank 0 last: its inline committer polls for rank 1's marker
    assert cps[1].maybe_save()
    assert cps[0].maybe_save()
    for c in cps:
        c.close()
    assert cps[0].committed_steps() == [1]
    assert cps[0].snapshots[0]["committed"]
    assert cps[0].snapshots[0]["stall_s"] >= cps[0].snapshots[0]["write_s"]


def test_retention_and_no_tmp_litter(tmp_path):
    store, mgrs, _, cps = _fleet(tmp_path, 1, every=1, keep=2)
    for step in range(1, 6):
        _fleet_step(mgrs, cps, step)
        assert cps[0].flush(30)
    cps[0].close()
    assert cps[0].committed_steps() == [4, 5]
    assert cps[0].latest_path() == tdur.snapshot_dir(5, 1, 1)
    dirs = {n.split("/")[1] for n in store.list("snap/")}
    assert dirs == {tdur.snapshot_dir(s, 1, 1).split("/")[1] for s in (4, 5)}
    for dirpath, _, files in os.walk(tmp_path):
        assert not [f for f in files if ".tmp" in f]


def test_marker_consistency_rejected(tmp_path):
    store = tdur.LocalDirStore(str(tmp_path))
    mgr = _FakeManager(0, 2, "rep0")
    cp = tdur.DurableCheckpointer(str(tmp_path), mgr, _RepState(0),
                                  store=store, every=1, commit_timeout_s=2.0,
                                  device="cpu")
    mgr._step = 1
    d = tdur.snapshot_dir(1, 1, 2)
    store.put(f"{d}/shard_0001.json", json.dumps({
        "v": 1, "step": 1, "quorum_id": 1, "rank": 1, "world": 2,
        "begin": 0, "end": 1, "nbytes": 1, "crc": "00000000",
        "wire": "bf16", "total": 999999, "name": f"{d}/shard_0001.bin",
    }).encode())
    assert cp.maybe_save() == d
    assert cp.flush(30)
    cp.close()
    assert cp.snapshots[0]["aborted"]
    assert cp.committed_steps() == []


def test_store_from_env_and_api(tmp_path, monkeypatch):
    monkeypatch.delenv("TORCHFT_DURABLE_STORE", raising=False)
    s = tdur.store_from_env(str(tmp_path / "d"))
    assert isinstance(s, tdur.LocalDirStore) and s.root == str(tmp_path / "d")
    monkeypatch.setenv("TORCHFT_DURABLE_STORE", f"file:{tmp_path}/e")
    assert tdur.store_from_env("x").root == str(tmp_path / "e")
    monkeypatch.setenv("TORCHFT_DURABLE_STORE", "s3://bucket/prefix")
    with pytest.raises(ValueError):
        tdur.store_from_env("x")
    st = tdur.LocalDirStore(str(tmp_path / "api"))
    st.put("a/b/c.bin", b"hello")
    assert st.exists("a/b/c.bin") and st.get("a/b/c.bin") == b"hello"
    assert st.read_range("a/b/c.bin", 1, 3) == b"ell"
    st.append("log", b"x")
    st.append("log", b"y")
    assert st.get("log") == b"xy"
    assert st.list("a/") == ["a/b/c.bin"]
    st.delete("a/b/c.bin")
    assert not st.exists("a/b/c.bin")
    assert not os.path.exists(tmp_path / "api" / "a")  # empty parents pruned
    with pytest.raises(ValueError):
        st.put("../escape", b"")
    assert tdur.shard_bounds(10, 3) == jdur.shard_bounds(10, 3) == [0, 3, 6, 10]


def test_ctor_registers_durable_restore(tmp_path):
    class _Registering(_FakeManager):
        def __init__(self):
            super().__init__(0, 1, "rep0")
            self.registered = None

        def set_durable_restore(self, fn):
            self.registered = fn

    mgr = _Registering()
    cp = tdur.DurableCheckpointer(str(tmp_path), mgr, _RepState(0),
                                  device="cpu")
    assert mgr.registered == cp.restore_latest
    cp.close()
    cp2 = tdur.DurableCheckpointer(str(tmp_path), _FakeManager(0, 1, "r"),
                                   _RepState(0), device="cpu")
    cp2.close()


# ---------------------------------------------------------------------------
# with a real manager: the commit hook and the cold-fleet consult


@pytest.fixture
def rig():
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=200,
                            quorum_tick_ms=50, heartbeat_timeout_ms=1000)
    store = Store()
    made = []

    def make_manager(state, replica_id="durable_test"):
        m = tft.Manager(
            collectives=tft.DummyCollectives(world_size=1),
            load_state_dict=state.load_state_dict,
            state_dict=state.state_dict, min_replica_size=1, rank=0,
            world_size=1, use_async_quorum=False, timeout=_T,
            quorum_timeout=_T, connect_timeout=_T,
            store_addr=store.address(), lighthouse_addr=lighthouse.address(),
            replica_id=replica_id, device="cpu",
        )
        made.append(m)
        return m

    yield make_manager
    for m in made:
        m.shutdown()
    store.shutdown()
    lighthouse.shutdown()


def _state(fill=1.0):
    return tft.FTTrainState({"w": torch.full((4,), fill)}, tft.AdamW(0.1))


def _train(manager, state, steps, ckpt=None):
    for _ in range(steps):
        manager.start_quorum()
        avg = manager.allreduce({"w": torch.full((4,), 0.1)}).wait()
        assert manager.should_commit()
        state.apply_gradients(avg)
        if ckpt is not None:
            ckpt.maybe_save()


def test_save_restore_roundtrip_with_loader(rig, tmp_path):
    state = _state()
    manager = rig(state)
    sampler = tft.DistributedSampler(dataset_len=64, replica_group=0,
                                     num_replica_groups=1)
    loader = tft.StatefulDataLoader(sampler, batch_size=4)
    for _ in range(3):
        next(loader)
    ckpt = tdur.DurableCheckpointer(str(tmp_path), manager, state,
                                    loader=loader, every=2, keep=2,
                                    device="cpu")
    try:
        # maybe_save follows the update: a capture at committed step N
        # holds the params after that step's update
        saved = {}
        for _ in range(5):
            manager.start_quorum()
            avg = manager.allreduce({"w": torch.full((4,), 0.1)}).wait()
            assert manager.should_commit()
            state.apply_gradients(avg)
            if ckpt.maybe_save():
                saved[manager.current_step()] = _bits(state.params["w"])
        assert ckpt.flush(30)
        assert manager.current_step() == 5
        assert ckpt.committed_steps() == [2, 4]
    finally:
        ckpt.close()

    state2 = _state(0.0)
    manager2 = rig(state2, "durable_test")
    loader2 = tft.StatefulDataLoader(sampler, batch_size=4)
    ckpt2 = tdur.DurableCheckpointer(str(tmp_path), manager2, state2,
                                     loader=loader2, every=2, device="cpu")
    try:
        assert ckpt2.restore_latest() == 4
        assert manager2.current_step() == 4
        assert _bits(state2.params["w"]) == saved[4]
        assert loader2.state_dict() == loader.state_dict()
        assert ckpt2.maybe_save() is None  # the restored step's guard
    finally:
        ckpt2.close()


def test_commit_hook_drives_captures(rig, tmp_path):
    state = _state()
    manager = rig(state)
    ckpt = tdur.DurableCheckpointer(str(tmp_path), manager, state, every=2,
                                    register_hook=True, device="cpu")
    try:
        _train(manager, state, 4)
        assert ckpt.flush(30)
        assert ckpt.committed_steps() == [2, 4]
        assert [r["step"] for r in ckpt.snapshots] == [2, 4]
        assert all(r["stall_s"] >= 0 for r in ckpt.snapshots)
    finally:
        ckpt.close()


def test_cold_fleet_consult_fires_once_and_only_cold(rig, tmp_path):
    state = _state()
    manager = rig(state, "warm")
    ckpt = tdur.DurableCheckpointer(str(tmp_path), manager, state, every=2,
                                    register_hook=True, device="cpu")
    try:
        _train(manager, state, 1)
        # the hook captures inside should_commit, before the step's
        # update: the set of step 2 holds the params after step 1's
        want = _bits(state.params["w"])
        _train(manager, state, 1)
        assert ckpt.flush(30)
        assert ckpt.committed_steps() == [2]
        # a member already past step 0 never consults the tier
        assert manager.metrics().snapshot()["counters"].get(
            "durable_cold_restores", 0) == 0
    finally:
        ckpt.close()
    manager.shutdown()

    calls = []
    state2 = _state(0.0)
    manager2 = rig(state2, "cold")
    ckpt2 = tdur.DurableCheckpointer(str(tmp_path), manager2, state2, every=2,
                                     device="cpu")
    real = ckpt2.restore_latest

    restored = []

    def counted():
        calls.append(manager2.current_step())
        out = real()
        restored.append(_bits(state2.params["w"]))
        return out

    manager2.set_durable_restore(counted)
    try:
        _train(manager2, state2, 2)  # the first quorum restores step 2
        assert calls == [0]
        assert manager2.metrics().snapshot()["counters"][
            "durable_cold_restores"] == 1
        assert manager2.current_step() == 4
        assert restored == [want]
    finally:
        ckpt2.close()
    manager2.shutdown()

    # a fleet whose member already committed (a live donor) skips it
    calls.clear()
    state3 = _state(0.0)
    manager3 = rig(state3, "late")
    manager3.set_durable_restore(counted)
    manager3.load_state_dict({"step": 3, "batches_committed": 3})
    _train(manager3, state3, 1)
    assert calls == []
