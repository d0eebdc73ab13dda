"""The port's ``IsolatedXLACollectives`` (a torch process group in a
disposable child) against the JAX package's (``jax.distributed`` in one).

- Segments and layout: the port binds the native ``ShmSegment`` (creator
  unlinks, attachments do not, the live-handle leak oracle) and its
  layout equals the JAX package's ``_sig_layout`` and the plan groups.
- The monitored channel: a dead child beats the op timeout, a stopped
  one gets the stall verdict (``ChildStalledError``), child errors
  re-raise with the child's traceback; the child's environment contract.
- The store path, both packages on the same seeded inputs at world 2 and
  3: SUM, AVG, a divisor, MAX, allgather and broadcast over f32, int32
  and bf16 leaves, bit for bit (rank-ordered sums on both sides).
- The psum path (the child's gloo group) against the in-process
  ``XLACollectives``, bit for bit; the reference's cases: slot
  recycling, kill-and-respawn reconfigure, a mid-op kill that fails fast
  then recovers, elastic joins, a superseded configure, the outer
  timeout's sizing, segment regrowth, shutdown reaping, the solo world
  and op-stats keys equal to the JAX backend's. A child holds no JAX
  module and never initialises CUDA.
- Managers: ``iso_allreduce`` through two of them, and a child's death
  latching ``None``, the vote discarding and the next step committing.
- ``PipelinedDDP(transport="iso")`` against the JAX engine over three
  steps (one discarded): with ``compress=None`` the averaged gradients
  each member applies are bit-exact, q8's within the F6 tolerance (rtol
  1e-5, atol 1e-6: the JAX quantize is jitted), and the params after
  the jitted JAX SGD update within it too (F6: XLA contracts the update
  into an FMA); the port's members end bit for bit equal.
- ``AdaptiveDDP``'s ``xla_iso`` joins only with an iso plane and an
  unspawnable child never wins; a ``PolicyEngine`` iso spec trains.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import ml_dtypes
import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax.numpy as jnp
import optax

import torchft_tpu as jft
from torchft_tpu import _native as jnative
from torchft_tpu import isolated_xla as jiso
from torchft_tpu.collectives import ReduceOp as JReduceOp
import torchft_tpu_torch as tft
from torchft_tpu_torch import _native
from torchft_tpu_torch import isolated_xla as iso
from torchft_tpu_torch.collectives import _NATIVE_DTYPES, ReduceOp, _plan_groups
from torchft_tpu_torch.isolated_xla import (
    ChildDiedError,
    ChildStalledError,
    IsolatedXLACollectives,
    _MonitoredChannel,
)
from torchft_tpu_torch.xla_collectives import XLACollectives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_T = timedelta(seconds=20)


@pytest.fixture
def store():
    s = _native.Store()
    yield s
    s.shutdown()


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


def _iso_ring(store, prefix, world, timeout_s=20, pkg=iso, path=None):
    cols = [pkg.IsolatedXLACollectives(timeout=timedelta(seconds=timeout_s),
                                       connect_timeout=timedelta(seconds=30))
            for _ in range(world)]
    if path is not None:
        for c in cols:  # the hint rank 0 publishes as the cohort's decision
            c._path = path
    addr = f"{store.address()}/{prefix}"
    _run_all(cols, lambda r, c: c.configure(addr, r, world))
    return cols


def _shutdown(cols):
    for c in cols:
        c.shutdown()


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def _wait_dead(pids, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(_pid_alive(p) for p in pids):
        time.sleep(0.05)
    return not any(_pid_alive(p) for p in pids)


# -- segments and layout ------------------------------------------------------


def _seg(name):
    """A segment name of this process's own (test runs may overlap)."""
    return f"tft_ttest_{name}_{os.getpid()}"


class TestShmSegments:
    def test_create_attach_visibility_and_leak_oracle(self):
        base = _native.shm_live_count()
        seg = _native.ShmSegment.create(_seg("seg_a"), 8192)
        view = torch.frombuffer(seg.buffer(), dtype=torch.float32)
        view[:3] = torch.tensor([1.5, 2.5, 3.5])
        att = _native.ShmSegment.attach(_seg("seg_a"), 8192)
        got = torch.frombuffer(att.buffer(), dtype=torch.float32)
        assert got[:3].tolist() == [1.5, 2.5, 3.5]
        got[3] = 9.0  # the same pages, both ways
        assert float(view[3]) == 9.0
        assert seg.size() == att.size() == 8192
        assert _native.shm_live_count() == base + 2
        del view, got
        att.close()
        seg.close()
        assert _native.shm_live_count() == base

    def test_attach_missing_and_short_segment_fail(self):
        with pytest.raises(RuntimeError, match="shm_open"):
            _native.ShmSegment.attach(_seg("never_created"), 4096)
        seg = _native.ShmSegment.create(_seg("seg_small"), 4096)
        try:
            with pytest.raises(RuntimeError, match="smaller"):
                _native.ShmSegment.attach(_seg("seg_small"), 8192)
        finally:
            seg.close()

    def test_creator_unlinks_attacher_does_not(self):
        seg = _native.ShmSegment.create(_seg("seg_own"), 4096)
        _native.ShmSegment.attach(_seg("seg_own"), 4096).close()
        _native.ShmSegment.attach(_seg("seg_own"), 4096).close()
        seg.close()
        with pytest.raises(RuntimeError, match="shm_open"):
            _native.ShmSegment.attach(_seg("seg_own"), 4096)

    def test_unlink_is_idempotent(self):
        _native.shm_unlink(_seg("seg_gone"))
        seg = _native.ShmSegment.create(_seg("seg_unl"), 4096)
        _native.shm_unlink(_seg("seg_unl"))
        _native.shm_unlink(_seg("seg_unl"))
        seg.close()


_TORCH_TO_NP = {torch.float32: np.dtype(np.float32),
                torch.float64: np.dtype(np.float64),
                torch.int32: np.dtype(np.int32),
                torch.int64: np.dtype(np.int64),
                torch.bfloat16: np.dtype(ml_dtypes.bfloat16),
                torch.float16: np.dtype(np.float16),
                torch.int8: np.dtype(np.int8)}

_SIGS = [
    [((7, 3), torch.float32), ((5,), torch.bfloat16), ((2, 2), torch.float32)],
    [((3,), torch.int32), ((), torch.float32), ((4, 1), torch.int64),
     ((9,), torch.int32)],
    [((6,), torch.float16), ((2, 3), torch.int8), ((5,), torch.float64)],
    [((1000,), torch.float32)] * 3 + [((17,), torch.bfloat16)],
]


class TestShmLayout:
    @pytest.mark.parametrize("sig", _SIGS)
    def test_layout_equals_the_jax_sig_layout(self, sig):
        port = iso._sig_layout(tuple(sig))
        ref = jiso._sig_layout(tuple((s, _TORCH_TO_NP[dt]) for s, dt in sig))
        assert port == ref

    @pytest.mark.parametrize("wire_name,wire_code", [
        (None, 0), ("bf16", 1), ("q8", 2), ("q8ef", 3)])
    def test_native_layout_matches_the_plan_groups(self, wire_name,
                                                   wire_code):
        sig = [((7, 3), torch.float32),
               ((5,), torch.bfloat16 if wire_name in (None, "bf16")
                else torch.float32),
               ((2, 2), torch.float32)]
        counts = [int(torch.Size(s).numel()) for s, _ in sig]
        codes = [_NATIVE_DTYPES[dt] for _, dt in sig]
        native = _native.shm_layout(counts, codes, wire_code)
        assert native == jnative.shm_layout(counts, codes, wire_code)
        groups = _plan_groups(sig, wire_name)
        assert len(native["groups"]) == len(groups)
        for ng, (gdt, idxs) in zip(native["groups"], groups):
            assert ng["dtype"] == _NATIVE_DTYPES[gdt]
            assert ng["count"] == sum(counts[i] for i in idxs)
        for i, nl in enumerate(native["leaves"]):
            _, idxs = groups[nl["group"]]
            assert nl["off"] == sum(counts[j] for j in idxs[:idxs.index(i)])

    def test_group_bases_are_64_aligned_and_total_covers(self):
        lay = _native.shm_layout([3, 5, 7], [2, 0, 2], 0)
        assert all(g["offset"] % 64 == 0 for g in lay["groups"])
        last = lay["groups"][-1]
        size = {0: 4, 1: 8, 2: 4, 3: 8, 4: 2}[last["dtype"]]
        assert lay["total_bytes"] >= last["offset"] + last["count"] * size

    def test_bad_inputs_raise(self):
        with pytest.raises(RuntimeError, match="q8"):
            _native.shm_layout([4], [2], 2)
        with pytest.raises(RuntimeError, match="empty"):
            _native.shm_layout([], [], 0)
        with pytest.raises(RuntimeError, match="wire"):
            _native.shm_layout([4], [0], 9)


# -- the monitored channel ----------------------------------------------------


class _FakeChild:
    def __init__(self):
        self.parent_sock, self.child_sock = socket.socketpair()
        self.rc = None

    def alive(self):
        return self.rc

    def die(self, rc=-9):
        self.rc = rc
        self.child_sock.close()


class TestMonitoredChannel:
    def test_roundtrip_and_child_error_reraise(self):
        fake = _FakeChild()
        ch = _MonitoredChannel(fake.parent_sock, fake.alive)
        ch.send({"cmd": "x"})
        fake.child_sock.sendall(b'{"ok": true}\n')
        assert ch.recv(5.0) == {"ok": True}
        fake.child_sock.sendall(
            b'{"error": "ValueError: boom", "tb": "Traceback...child"}\n')
        with pytest.raises(RuntimeError, match="boom") as ei:
            ch.recv(5.0)
        assert "child traceback" in str(ei.value)
        ch.close()
        fake.child_sock.close()

    def test_child_death_beats_the_op_timeout(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_ISO_LIVENESS_MS", "20")
        fake = _FakeChild()
        ch = _MonitoredChannel(fake.parent_sock, fake.alive)
        threading.Timer(0.1, fake.die).start()
        t0 = time.perf_counter()
        with pytest.raises(ChildDiedError):
            ch.recv(60.0)
        assert time.perf_counter() - t0 < 30.0  # 5x+ the expected ~0.1 s
        ch.close()

    def test_timeout_without_death(self):
        fake = _FakeChild()
        ch = _MonitoredChannel(fake.parent_sock, fake.alive)
        with pytest.raises(TimeoutError):
            ch.recv(0.3)
        ch.close()
        fake.child_sock.close()

    def test_stall_verdict_on_a_stopped_child(self, monkeypatch):
        """A real process stopped with SIGSTOP: the channel's /proc poll
        sees 'T' and issues ChildStalledError after the stall grace, well
        before the op deadline."""
        monkeypatch.setenv("TORCHFT_ISO_LIVENESS_MS", "20")
        monkeypatch.setenv("TORCHFT_ISO_STALL_MS", "200")
        proc = subprocess.Popen([sys.executable, "-c",
                                 "import time; time.sleep(120)"])
        fake = _FakeChild()
        try:
            os.kill(proc.pid, signal.SIGSTOP)
            deadline = time.monotonic() + 10
            while iso._proc_state(proc.pid) not in ("T", "t"):
                assert time.monotonic() < deadline, iso._proc_state(proc.pid)
                time.sleep(0.01)
            ch = _MonitoredChannel(fake.parent_sock, proc.poll, pid=proc.pid)
            t0 = time.perf_counter()
            with pytest.raises(ChildStalledError, match="STALLED"):
                ch.recv(60.0)
            assert time.perf_counter() - t0 < 30.0  # expected ~0.2 s
            assert issubclass(ChildStalledError, ChildDiedError)
            ch.close()
        finally:
            proc.kill()
            proc.wait()
            fake.child_sock.close()


class TestChildEnvContract:
    def test_child_env_is_parent_env_plus_repo_pythonpath(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_ENV_PROBE", "x1")
        env = iso._child_env()
        assert env["TORCHFT_ENV_PROBE"] == "x1"
        assert REPO in env["PYTHONPATH"].split(os.pathsep)

    def test_apply_child_env_replaces_not_merges(self):
        snap = dict(os.environ)
        try:
            os.environ["TORCHFT_STALE_VAR"] = "zombie"
            desired = dict(snap)
            desired["TORCHFT_FRESH_VAR"] = "new"
            iso._apply_child_env(desired)
            assert "TORCHFT_STALE_VAR" not in os.environ
            assert os.environ.get("TORCHFT_FRESH_VAR") == "new"
        finally:
            os.environ.clear()
            os.environ.update(snap)


# -- the store path against the JAX package ------------------------------------


def _inputs(rank):
    rng = np.random.default_rng(2000 + rank)
    return {"w": (rng.standard_normal((7, 13)) * 3).astype(np.float32),
            "b": rng.standard_normal(1001).astype(np.float32),
            "i": rng.integers(-1000, 1000, 17).astype(np.int32),
            "h": rng.standard_normal(33).astype(np.float32).astype(
                ml_dtypes.bfloat16)}


def _as_port(tree):
    out = {}
    for k, v in tree.items():
        if v.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(v.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.copy())
    return out


def _bytes(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _ops(world, port):
    """The op sequence of both packages' cohorts: {name: tree}."""
    R = ReduceOp if port else JReduceOp

    def run(r, c):
        tree = _inputs(r)
        if port:
            tree = _as_port(tree)
        res = {"sum": c.allreduce(tree, R.SUM).wait(),
               "avg": c.allreduce(tree, R.AVG).wait(),
               "div": c.allreduce(tree, R.SUM, divisor=3.0).wait(),
               "max": c.allreduce(tree, R.MAX).wait(),
               "bc": c.broadcast(tree, root=world - 1).wait()}
        for m, member in enumerate(c.allgather(tree).wait()):
            res[f"ag{m}"] = member
        c.barrier().wait()
        return {name: {k: _bytes(v) for k, v in t.items()}
                for name, t in res.items()}

    return run


@pytest.fixture(scope="module")
def jax_store_runs():
    """The JAX package's cohorts on the store path at world 2 and 3, and
    the keys of its op stats."""
    s = _native.Store()
    out = {}
    try:
        for world in (2, 3):
            cols = _iso_ring(s, f"jstore{world}", world, pkg=jiso,
                             path="store")
            try:
                assert all(c.reduction_path() == "store" for c in cols)
                out[world] = _run_all(cols, _ops(world, port=False))
                keys = {}
                for st in cols[0].pop_op_stats():
                    keys.setdefault(st["op"], sorted(st))
                out[f"keys{world}"] = keys
            finally:
                _shutdown(cols)
    finally:
        s.shutdown()
    return out


class TestStorePathAgainstJax:
    @pytest.mark.parametrize("world", [2, 3])
    def test_ops_bit_identical_to_jax(self, store, jax_store_runs, world):
        cols = _iso_ring(store, f"tstore{world}", world, path="store")
        try:
            assert all(c.reduction_path() == "store" for c in cols)
            port = _run_all(cols, _ops(world, port=True))
        finally:
            _shutdown(cols)
        ref = jax_store_runs[world]
        for r in range(world):
            assert port[r].keys() == ref[r].keys()
            for name in port[r]:
                assert port[r][name] == ref[r][name], (r, name)


# -- the backend end to end ---------------------------------------------------


class TestIsolatedBackend:
    @pytest.mark.parametrize("world", [2, 3])
    def test_psum_path_equals_the_inprocess_plane(self, store, world):
        """The child runs XLACollectives(backend="gloo") on the segment's
        views: the same bits as the in-process plane on the same
        inputs."""
        cols = _iso_ring(store, f"psum{world}", world)
        xcs = [XLACollectives(timeout=_T, connect_timeout=_T)
               for _ in range(world)]
        try:
            assert all(c.reduction_path() == "psum" for c in cols)
            addr = f"{store.address()}/xla{world}"
            _run_all(xcs, lambda r, c: c.configure(addr, r, world))

            def ops(r, c):
                tree = _as_port(_inputs(r))
                return {k: _bytes(v) for k, v in
                        c.allreduce(tree, ReduceOp.AVG).wait().items()}

            got = _run_all(cols, ops)
            want = _run_all(xcs, ops)
            assert got == want
            assert all(g == got[0] for g in got)
        finally:
            _shutdown(cols)
            _shutdown(xcs)

    def test_slot_recycling_never_serves_stale_payloads(self, store):
        cols = _iso_ring(store, "qstale", 2, path="store")
        try:
            nops = 3 * iso._STORE_SLOTS

            def run(r, c):
                outs = []
                for op in range(nops):
                    if r == 1:
                        time.sleep(0.02)  # the laggy member
                    outs.append(c.allreduce(
                        torch.full((64,), float((op + 1) * (r + 1))),
                        ReduceOp.SUM).wait())
                return outs

            results = _run_all(cols, run)
            for op in range(nops):
                for r in range(2):
                    assert torch.equal(results[r][op],
                                       torch.full((64,), float((op + 1) * 3)))
        finally:
            _shutdown(cols)

    @pytest.mark.parametrize("path", ["psum", "store"])
    def test_allgather_broadcast_barrier(self, store, path):
        cols = _iso_ring(store, f"agb{path}", 2,
                         path=None if path == "psum" else path)
        try:
            assert [c.reduction_path() for c in cols] == [path, path]

            def ops(r, c):
                g = c.allgather({"x": torch.full((4,), float(r * 10 + 1)),
                                 "i": torch.arange(3, dtype=torch.int32) * r}
                                ).wait()
                b = c.broadcast(torch.full((2,), float(r)), root=1).wait()
                c.barrier().wait()
                return g, b

            for g, b in _run_all(cols, ops):
                assert torch.equal(g[0]["x"], torch.full((4,), 1.0))
                assert torch.equal(g[1]["x"], torch.full((4,), 11.0))
                assert torch.equal(g[1]["i"], torch.arange(3,
                                                           dtype=torch.int32))
                assert torch.equal(b, torch.full((2,), 1.0))
        finally:
            _shutdown(cols)

    def test_reconfigure_is_kill_and_respawn(self, store):
        cols = _iso_ring(store, "q2", 2)
        try:
            pids = [c.child_pid() for c in cols]
            assert all(p is not None for p in pids)
            keep = torch.arange(16, dtype=torch.float32) * 1.25
            keep_ptr, keep_bytes = keep.data_ptr(), _bytes(keep)
            addr = f"{store.address()}/q2b"
            _run_all(cols, lambda r, c: c.configure(addr, r, 2))
            new_pids = [c.child_pid() for c in cols]
            assert all(n is not None and n != p
                       for n, p in zip(new_pids, pids)), (pids, new_pids)
            assert _wait_dead(pids), pids
            assert keep.data_ptr() == keep_ptr and _bytes(keep) == keep_bytes
            outs = _run_all(cols, lambda r, c: c.allreduce(
                torch.full((8,), 2.0), ReduceOp.SUM).wait())
            assert torch.equal(outs[0], torch.full((8,), 4.0))
            stats = [s for s in cols[0].pop_op_stats()
                     if s["op"] == "configure"]
            assert stats[-1]["respawn"] is True
            assert stats[-1]["spawn_mode"] in ("spare", "zygote", "classic")
        finally:
            _shutdown(cols)

    def test_mid_op_child_kill_fails_fast_then_respawn_recovers(self, store):
        cols = _iso_ring(store, "q4", 2, timeout_s=6)
        try:
            os.kill(cols[1].child_pid(), signal.SIGKILL)
            t0 = time.perf_counter()
            errors = [None, None]

            def op(r, c):
                try:
                    c.allreduce(torch.ones(4), ReduceOp.SUM).wait()
                except Exception as e:  # noqa: BLE001
                    errors[r] = e

            _run_all(cols, op)
            assert isinstance(errors[1], ChildDiedError), errors
            assert errors[0] is not None, "the survivor must not hang"
            assert time.perf_counter() - t0 < 30.0  # one op deadline, 6 s
            addr = f"{store.address()}/q4b"
            _run_all(cols, lambda r, c: c.configure(addr, r, 2))
            outs = _run_all(cols, lambda r, c: c.allreduce(
                torch.full((4,), 1.0), ReduceOp.SUM).wait())
            assert torch.equal(outs[0], torch.full((4,), 2.0))
        finally:
            _shutdown(cols)

    @pytest.mark.parametrize("fresh_rank", [0, 1])
    def test_elastic_join_fresh_member_configures_uniformly(self, store,
                                                             fresh_rank):
        """A restarted member's fresh backend sends no path hint while the
        incumbent hints its verdict: rank 0's one decision makes both
        land on the same path."""
        cols = _iso_ring(store, f"qjoin{fresh_rank}", 2, timeout_s=8)
        old = cols[fresh_rank]
        try:
            cols[fresh_rank] = IsolatedXLACollectives(
                timeout=timedelta(seconds=8),
                connect_timeout=timedelta(seconds=20))
            addr = f"{store.address()}/qjoin{fresh_rank}b"
            _run_all(cols, lambda r, c: c.configure(addr, r, 2))
            assert cols[0].reduction_path() == cols[1].reduction_path()
            outs = _run_all(cols, lambda r, c: c.allreduce(
                torch.full((4,), float(r + 1)), ReduceOp.SUM).wait())
            assert all(torch.equal(o, torch.full((4,), 3.0)) for o in outs)
        finally:
            old.shutdown()
            _shutdown(cols)

    def test_superseded_configure_never_installs_its_child(self):
        c = IsolatedXLACollectives(timeout=timedelta(seconds=10),
                                   connect_timeout=timedelta(seconds=20))
        real_spawn = c._spawn_and_connect_detached
        try:
            gate, release = threading.Event(), threading.Event()
            spawned = []

            def slow_spawn():
                gate.set()
                assert release.wait(timeout=30)
                out = real_spawn()
                spawned.append(out[0].pid)
                return out

            c._spawn_and_connect_detached = slow_spawn
            with c._child_lock:
                c._cfg_gen += 1
                gen = c._cfg_gen
            errors = []

            def stale_configure():
                try:
                    c._take_or_spawn_child(gen)
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

            t = threading.Thread(target=stale_configure)
            t.start()
            assert gate.wait(timeout=10)
            with c._child_lock:
                c._cfg_gen += 1  # the newer configure's entry kill ran
            release.set()
            t.join(timeout=60)
            assert not t.is_alive()
            assert errors and "superseded" in str(errors[0]), errors
            assert c.child_pid() is None
            assert spawned and _wait_dead(spawned), spawned
        finally:
            c._spawn_and_connect_detached = real_spawn
            c.shutdown()

    def test_outer_configure_timeout_covers_inner_deadlines(self):
        c = IsolatedXLACollectives(timeout=timedelta(seconds=7),
                                   connect_timeout=timedelta(seconds=11))
        try:
            assert c._outer_configure_timeout_s() >= 3 * 11 + 7
        finally:
            c.shutdown()

    def test_segment_regrow_evicts_all_staging_views(self):
        c = IsolatedXLACollectives()
        try:
            c._staging_for((((8,), torch.float32),), 1)
            c._staging_for((((4,), torch.int32),), 1)
            assert len(c._staging) == 2
            c._staging_for((((1 << 15,), torch.float32),), 1)
            assert len(c._staging) == 1
            assert all(g == c._seg_gen for g, _ in c._staging.values())
            c.shutdown()
            assert c._staging == {}
        finally:
            c.shutdown()

    def test_shutdown_reaps_children_and_segments(self, store):
        base = _native.shm_live_count()
        cols = _iso_ring(store, "q5", 2)
        _run_all(cols, lambda r, c: c.allreduce(torch.ones(4)).wait())
        assert _native.shm_live_count() == base + 4  # in + out, each
        pids = [c.child_pid() for c in cols]
        _shutdown(cols)
        assert _native.shm_live_count() == base
        assert _wait_dead(pids), pids

    def test_solo_world_short_circuits_without_child(self, store):
        c = IsolatedXLACollectives(timeout=timedelta(seconds=10))
        try:
            c.configure(f"{store.address()}/solo", 0, 1)
            assert c.reduction_path() == "solo" and c.child_pid() is None
            out = c.allreduce(torch.full((3,), 4.0), ReduceOp.AVG).wait()
            assert torch.equal(out, torch.full((3,), 4.0))
            assert c.allgather({"x": torch.ones(2)}).wait()[0]["x"].shape == (2,)
            c.barrier().wait()
        finally:
            c.shutdown()

    def test_op_stats_keys_equal_the_jax_backends(self, store, jax_store_runs):
        cols = _iso_ring(store, "q6", 2, path="store")
        try:
            _run_all(cols, _ops(2, port=True))
            keys = {}
            for st in cols[0].pop_op_stats():
                keys.setdefault(st["op"], sorted(st))
            assert keys == jax_store_runs["keys2"]
            assert cols[0].pop_op_stats() == []
        finally:
            _shutdown(cols)
        cols = _iso_ring(store, "q6b", 2)
        try:
            _run_all(cols, lambda r, c: c.allreduce(
                {"w": torch.ones(100)}, ReduceOp.SUM).wait())
            st = [s for s in cols[0].pop_op_stats() if s["op"] == "allreduce"]
            assert st[-1]["backend"] == "iso" and st[-1]["path"] == "psum"
            assert st[-1]["bytes"] >= 400 and st[-1]["d2h_bytes"] == 0
        finally:
            _shutdown(cols)

    def test_child_holds_no_jax_and_no_cuda(self, store):
        cols = _iso_ring(store, "status", 2)
        try:
            for c in cols:
                st = c.child_status().wait()
                assert st["pid"] == c.child_pid()
                assert st["foreign_modules"] == []
                assert st["cuda_initialized"] is False
        finally:
            _shutdown(cols)


# -- managers -----------------------------------------------------------------


def _managers(n, lighthouse, iso_plane=True):
    stores = [_native.Store() for _ in range(n)]
    managers = [tft.Manager(
        collectives=tft.HostCollectives(timeout=_T),
        iso_collectives=IsolatedXLACollectives(
            timeout=timedelta(seconds=10), connect_timeout=_T)
        if iso_plane else None,
        load_state_dict=lambda s: None, state_dict=lambda: {},
        min_replica_size=n, rank=0, world_size=1, use_async_quorum=False,
        timeout=_T, quorum_timeout=timedelta(seconds=30),
        store_addr=stores[i].address(), lighthouse_addr=lighthouse.address(),
        replica_id=f"iso_integ_{i}", device="cpu") for i in range(n)]
    return managers, stores


def _close(managers, stores, lighthouse):
    for m in managers:
        m.shutdown()
    for s in stores:
        s.shutdown()
    lighthouse.shutdown()


def _lighthouse(n):
    return tft.Lighthouse(min_replicas=n, join_timeout_ms=2000,
                          quorum_tick_ms=50, heartbeat_timeout_ms=5000)


class TestManagerIso:
    def test_iso_allreduce_through_managers(self):
        lighthouse = _lighthouse(2)
        managers, stores = _managers(2, lighthouse)
        try:
            def step(i, m):
                m.start_quorum()
                out = m.iso_allreduce({"g": torch.full((6,), float(i + 1))}
                                      ).wait()
                return out, m.should_commit()

            with ThreadPoolExecutor(max_workers=2) as ex:
                results = list(ex.map(lambda im: step(*im),
                                      enumerate(managers)))
            for out, committed in results:
                assert committed
                assert torch.equal(out["g"], torch.full((6,), 1.5))
            assert all(m.has_iso_plane() for m in managers)
            assert managers[0].iso_collectives().reduction_path() == "psum"
            assert managers[0].metrics().snapshot()["timers_s"].get(
                "reconfigure_iso") is not None
        finally:
            _close(managers, stores, lighthouse)

    def test_child_death_latches_none_and_next_step_recovers(self):
        lighthouse = _lighthouse(2)
        managers, stores = _managers(2, lighthouse)
        try:
            barrier = threading.Barrier(2)

            def run(i, m):
                outcomes = []
                for step in range(3):
                    m.start_quorum()
                    if step == 1 and i == 0:
                        os.kill(m.iso_collectives().child_pid(),
                                signal.SIGKILL)
                    out = m.iso_allreduce(
                        {"g": torch.full((4,), float(i + 1))}).wait()
                    outcomes.append((out is None, m.should_commit()))
                    barrier.wait(timeout=60)
                return outcomes

            with ThreadPoolExecutor(max_workers=2) as ex:
                futs = [ex.submit(run, i, m) for i, m in enumerate(managers)]
                res = [f.result(timeout=120) for f in futs]
            assert res[0][0] == (False, True) and res[1][0] == (False, True)
            assert res[0][1][0] is True, "a dead child defaults to None"
            assert res[0][1][1] is False and res[1][1][1] is False
            assert res[0][2] == (False, True) and res[1][2] == (False, True)
        finally:
            _close(managers, stores, lighthouse)

    def test_no_plane_raises_and_a_failed_configure_latches(self, monkeypatch):
        lighthouse = _lighthouse(1)
        managers, stores = _managers(1, lighthouse, iso_plane=False)
        try:
            m = managers[0]
            assert not m.has_iso_plane() and m.iso_collectives() is None
            with pytest.raises(ValueError, match="iso_collectives"):
                m.iso_allreduce({"g": torch.ones(2)})
        finally:
            _close(managers, stores, lighthouse)
        lighthouse = _lighthouse(1)
        managers, stores = _managers(1, lighthouse)
        try:
            m = managers[0]

            def broken(*a, **k):
                raise RuntimeError("injected: child unspawnable")

            monkeypatch.setattr(m.iso_collectives(), "configure", broken)
            m.start_quorum()
            assert m.iso_allreduce({"g": torch.ones(2)}).wait() is None
            assert not m.should_commit()
            assert m.metrics().snapshot()["counters"][
                "iso_configure_failures"] == 1
            # the primary plane is unaffected
            m.start_quorum()
            assert torch.equal(m.allreduce({"g": torch.ones(2)}).wait()["g"],
                               torch.ones(2))
        finally:
            _close(managers, stores, lighthouse)


# -- PipelinedDDP(transport="iso") against the JAX engine ------------------------


class _IsoRingManager:
    """A deterministic manager over a real isolated cohort, for either
    package: everyone participates and commits unless ``commit`` is
    False."""

    def __init__(self, col, avg):
        self._col = col
        self._avg = avg
        self.commit = True

    def start_quorum(self, **kw):
        pass

    def has_iso_plane(self):
        return True

    def iso_allreduce(self, tree, op=None, wire=None):
        return self._col.allreduce(tree, self._avg, wire=wire)

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


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.array(tree.detach().numpy() if isinstance(tree, torch.Tensor)
                     else tree)]


def _jax_tree(t):
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_jax_tree(v) for v in t]
    return jnp.asarray(t)


def _port_tree(t):
    if isinstance(t, dict):
        return {k: _port_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_port_tree(v) for v in t]
    return torch.from_numpy(np.array(t))


def _ddp_member(pkg, col, compress, rec):
    calls = [0]
    if pkg == "jax":
        st = jft.FTTrainState(_jax_tree(_params()), optax.sgd(0.1))
        m = _IsoRingManager(col, JReduceOp.AVG)
        conv, engine = _jax_tree, jft.PipelinedDDP
    else:
        st = tft.FTTrainState(_port_tree(_params()), tft.SGD(0.1))
        m = _IsoRingManager(col, ReduceOp.AVG)
        conv, engine = _port_tree, tft.PipelinedDDP
    inner = st.apply_gradients

    def apply(g):
        rec.append(_leaves(g))
        inner(g)

    st.apply_gradients = apply

    def grad_fn(params, member):
        calls[0] += 1
        return 0.0, conv(_ddp_grads(member, calls[0] - 1))

    return engine(m, st, grad_fn, compress=compress, transport="iso"), m, st


def _ddp_cohort(pkg, compress):
    """Two members of ``pkg`` on an isolated cohort: three pipelined
    steps, the second settle discarded by the vote, and a flush. Returns
    each member's applied gradients and final params."""
    s = _native.Store()
    cols = _iso_ring(s, f"ddp_{pkg}_{compress}", 2,
                     pkg=jiso if pkg == "jax" else iso)
    recs = [[], []]
    members = [_ddp_member(pkg, cols[r], compress, recs[r]) for r in range(2)]

    def run(r, c):
        ddp, m, st = members[r]
        for step in range(3):
            m.commit = step != 2
            ddp.step(r)
        m.commit = True
        assert ddp.flush()
        return _leaves(st.params)

    try:
        params = _run_all(cols, run)
    finally:
        _shutdown(cols)
        s.shutdown()
    return recs, params


class TestPipelinedIsoAgainstJax:
    def test_compress_none_is_bit_exact(self):
        port_recs, port_params = _ddp_cohort("port", None)
        jax_recs, jax_params = _ddp_cohort("jax", None)
        assert [len(r) for r in port_recs] == [2, 2]  # steps 0 and 2
        for pr, jr in zip(port_recs, jax_recs):
            for pa, ja in zip(pr, jr):
                assert [a.tobytes() for a in pa] == [a.tobytes() for a in ja]
        for pp, jp in zip(port_params, jax_params):
            for a, b in zip(pp, jp):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert ([a.tobytes() for a in port_params[0]]
                == [a.tobytes() for a in port_params[1]])

    def test_q8_within_the_f6_tolerance(self):
        port_recs, port_params = _ddp_cohort("port", "q8")
        jax_recs, jax_params = _ddp_cohort("jax", "q8")
        for pr, jr in zip(port_recs, jax_recs):
            assert len(pr) == len(jr) == 2
            for pa, ja in zip(pr, jr):
                for a, b in zip(pa, ja):
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        for pp, jp in zip(port_params, jax_params):
            for a, b in zip(pp, jp):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert ([a.tobytes() for a in port_params[0]]
                == [a.tobytes() for a in port_params[1]])

    def test_iso_transport_needs_the_plane_and_no_int8(self):
        class NoPlane:
            pass

        st = tft.FTTrainState(_port_tree(_params()), tft.SGD(0.1))
        with pytest.raises(ValueError, match="iso_collectives"):
            tft.PipelinedDDP(NoPlane(), st, None, transport="iso")
        with pytest.raises(ValueError, match="int8"):
            tft.PipelinedDDP(_IsoRingManager(None, ReduceOp.AVG), st, None,
                             compress="int8", transport="iso")


# -- AdaptiveDDP and the policy engine -------------------------------------------


def _solo_manager(iso_plane):
    lighthouse = tft.Lighthouse(min_replicas=1, join_timeout_ms=200,
                                quorum_tick_ms=50, heartbeat_timeout_ms=2000)
    s = _native.Store()
    manager = tft.Manager(
        collectives=tft.HostCollectives(timeout=timedelta(seconds=10)),
        iso_collectives=iso_plane, load_state_dict=lambda sd: None,
        state_dict=lambda: {}, min_replica_size=1, rank=0, world_size=1,
        use_async_quorum=False, timeout=timedelta(seconds=10),
        store_addr=s.address(), lighthouse_addr=lighthouse.address(),
        replica_id="adaptive_iso", device="cpu")
    return manager, [s], lighthouse


def _adaptive_grad_fn(params, x):
    w = params["w"].detach().requires_grad_(True)
    loss = ((x @ w) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [w])
    return loss.detach(), {"w": g}


def _adaptive_state():
    return tft.FTTrainState({"w": torch.ones((8, 8))}, tft.SGD(0.1))


class TestAdaptiveIsoCandidate:
    def test_candidate_joins_only_with_an_iso_plane(self):
        manager, stores, lighthouse = _solo_manager(
            IsolatedXLACollectives(timeout=timedelta(seconds=10)))
        try:
            ddp = tft.AdaptiveDDP(manager, _adaptive_state(),
                                  _adaptive_grad_fn, device_pack="off")
            assert "xla_iso" in ddp._candidates
            ddp8 = tft.AdaptiveDDP(manager, _adaptive_state(),
                                   _adaptive_grad_fn, compress="int8",
                                   device_pack="off")
            assert "xla_iso" not in ddp8._candidates
        finally:
            _close([manager], stores, lighthouse)
        manager, stores, lighthouse = _solo_manager(None)
        try:
            ddp = tft.AdaptiveDDP(manager, _adaptive_state(),
                                  _adaptive_grad_fn, device_pack="off")
            assert "xla_iso" not in ddp._candidates
            with pytest.raises(ValueError, match="iso_collectives"):
                tft.AdaptiveDDP(manager, _adaptive_state(),
                                _adaptive_grad_fn, mode="xla_iso")
        finally:
            _close([manager], stores, lighthouse)

    def test_probe_with_iso_locks_and_trains(self):
        manager, stores, lighthouse = _solo_manager(
            IsolatedXLACollectives(timeout=timedelta(seconds=10)))
        try:
            ddp = tft.AdaptiveDDP(manager, _adaptive_state(),
                                  _adaptive_grad_fn, probe_steps=2,
                                  device_pack="off")
            x = torch.ones((4, 8))
            for _ in range(10):
                ddp.step(x)
            ddp.flush()
            assert ddp.mode is not None
            assert ddp.decision["probe_s"]["xla_iso"] < 1e8
            assert manager.current_step() == 10
        finally:
            _close([manager], stores, lighthouse)

    def test_unspawnable_child_never_wins(self, monkeypatch):
        plane = IsolatedXLACollectives(timeout=timedelta(seconds=5),
                                       connect_timeout=timedelta(seconds=5))

        def broken(store_addr, rank, world_size):
            raise RuntimeError("injected: child unspawnable")

        monkeypatch.setattr(plane, "configure", broken)
        manager, stores, lighthouse = _solo_manager(plane)
        try:
            ddp = tft.AdaptiveDDP(manager, _adaptive_state(),
                                  _adaptive_grad_fn, probe_steps=2,
                                  device_pack="off")
            x = torch.ones((4, 8))
            for _ in range(14):
                ddp.step(x)
            ddp.flush()
            assert ddp.mode is not None and ddp.mode != "xla_iso"
            assert ddp.decision["probe_s"]["xla_iso"] >= 1e8
            assert manager.current_step() >= 8  # the primary plane trained
        finally:
            _close([manager], stores, lighthouse)


def test_policy_engine_iso_spec_trains():
    """Two port groups under a PolicyEngine whose one candidate is the
    iso transport with q8: every step commits and the groups end bit
    for bit equal."""
    lighthouse = _lighthouse(2)
    managers, stores = _managers(2, lighthouse)
    try:
        def run(g, m):
            st = tft.FTTrainState(_port_tree(_params()), tft.SGD(0.1))
            spec = tft.StrategySpec("ddp_iso", "ddp", transport="iso",
                                    wire="q8")
            calls = [0]

            def grad_fn(params, member):
                calls[0] += 1
                return torch.zeros(()), _port_tree(_ddp_grads(member,
                                                              calls[0]))

            pol = tft.PolicyEngine(m, st, grad_fn, candidates=[spec],
                                   decide_every=4)
            for _ in range(5):
                pol.step(g)
            pol.flush()
            return m.current_step(), _leaves(st.params), pol.strategy.name

        with ThreadPoolExecutor(max_workers=2) as ex:
            a, b = list(ex.map(lambda gm: run(*gm), enumerate(managers)))
        assert a[0] == b[0] >= 5
        assert a[2] == b[2] == "ddp_iso"
        assert [x.tobytes() for x in a[1]] == [x.tobytes() for x in b[1]]
        assert managers[0].iso_collectives().reduction_path() == "psum"
    finally:
        _close(managers, stores, lighthouse)
