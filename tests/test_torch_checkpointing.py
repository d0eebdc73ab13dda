"""The port's streamed zero-copy heal (``torchft_tpu_torch.checkpointing``)
on the CPU, against the JAX package's.

- Parity: the JAX and the port ``CheckpointServer`` publish the same numpy
  tree (f32 params, an int32 leaf, an empty leaf, a 0-d leaf, an odd-sized
  int8 leaf that puts the next leaves off every alignment, scalars, and
  the f32 NaN words of ``ops/wire_bits.py`` inside ``opt_state``). Every
  ``/stream/`` range body and its ``X-TFT-Crc32c`` header are
  byte-identical, for wire none and bf16, streams 1, 3 and 4, and the
  decoded slots (shape, dtype, wire dtype, offset, bytes) are equal.
- The JAX package's stream tests (tests/test_checkpointing.py), ported:
  params bit-identical for each wire and stream count, the donor never
  pickles the bulk, a wrong step is a 400, the env knobs, a stale publish
  is refused, disallow regates (and a fetch whose meta came before it
  finishes from the staging's copy), a corrupted range and torn
  ranges fall back (within one budget, the surviving readers cancelled),
  a timeout raises without a fallback, the striped path, a server
  without the stream and part endpoints falls back to the single stream.
- A Manager kill-and-heal on the bf16 heal wire: the heal takes the
  stream path; the healed params are bit-identical to what the donor
  published, its moments those moments rounded to bf16.
"""

import io
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import ml_dtypes
from torchft_tpu import checkpointing as jck
from torchft_tpu.chaos import HealFaultProxy

import torchft_tpu_torch as tft
from torchft_tpu_torch import checkpointing as ck
from torchft_tpu_torch._tree import (
    flatten, flatten_with_path, is_opt_state_path, tree_map,
)
from torchft_tpu_torch.models import transformer as tt
from torchft_tpu_torch.ops.quantize_kernels import plain
from torchft_tpu_torch.ops.wire_bits import CAST_BF16_WORDS

_T = timedelta(seconds=10)


@pytest.fixture
def server():
    s = ck.CheckpointServer(timeout=_T, device="cpu")
    yield s
    s.shutdown()


def _fetch(address, **kw):
    return ck.CheckpointServer._fetch(address, _T, device="cpu", **kw)


def _bits(t):
    return np.asarray(t).tobytes() if not isinstance(t, torch.Tensor) else \
        t.detach().contiguous().view(torch.uint8).numpy().tobytes()


def _bf16_round(x):
    """f32 bits through the bf16 wire and back (ml_dtypes' rounding)."""
    x = np.asarray(x, np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


# -- parity with the JAX package ---------------------------------------------


def _numpy_tree():
    rng = np.random.default_rng(5)
    nan_words = np.array(list(CAST_BF16_WORDS), np.uint32).view(np.float32)
    mu = rng.standard_normal(67).astype(np.float32)
    mu[:len(nan_words)] = nan_words
    return {
        "params": {
            "w": rng.standard_normal((37, 5)).astype(np.float32),
            "ids": np.arange(7, dtype=np.int32),
            "empty": np.zeros((0, 3), np.float32),
            "gain": np.array(1.25, np.float32),
        },
        "opt_state": {
            "count": np.array(4, np.int32),
            "flags": np.arange(13, dtype=np.int8),  # odd bytes: later
            "mu": mu,                               # leaves off-grid
            "nu": rng.random((9, 3)).astype(np.float32),
            "empty": np.zeros(0, np.float32),
        },
        "ema": rng.standard_normal(11).astype(np.float32),
        "lr": 0.125,
        "step": 9,
    }


class _Recorder:
    """A write-only file object that keeps each piece it is handed."""

    def __init__(self) -> None:
        self.pieces = []

    def write(self, data) -> int:
        self.pieces.append(bytes(data))
        return len(self.pieces[-1])


def test_dump_state_dict_stream_reads_back_through_the_loader():
    """The streamed writer: ``dump_state_dict_stream`` hands the pickle to
    its file object in pieces (never the whole payload at once), the
    bytes equal ``serialize_state_dict``'s, and ``load_state_dict_stream``
    (the port's, and the JAX package's, which reads the same wire) gives
    back the input with every tensor leaf as numpy."""
    rng = np.random.default_rng(5)
    state = {
        "params": {"w": torch.from_numpy(
            rng.standard_normal((512, 512)).astype(np.float32)),
            "b": torch.arange(7)},
        "opt": [torch.zeros(4, dtype=torch.float64), {"lr": 1e-3}],
        "step": 3,
    }
    out = _Recorder()
    ck.dump_state_dict_stream(state, out)
    raw = b"".join(out.pieces)
    assert raw == ck.serialize_state_dict(state)
    assert len(out.pieces) > 1 and max(map(len, out.pieces)) < len(raw)
    for load in (ck.load_state_dict_stream, jck.load_state_dict_stream):
        got = load(io.BytesIO(raw))
        assert got["step"] == 3 and got["opt"][1] == {"lr": 1e-3}
        for name in ("w", "b"):
            want = state["params"][name].numpy()
            assert got["params"][name].dtype == want.dtype
            np.testing.assert_array_equal(got["params"][name], want)
        np.testing.assert_array_equal(got["opt"][0], np.zeros(4))


def _ranges(address, step, wire_tok, streams, unpickle):
    with urllib.request.urlopen(
        f"{address}{step}/streammeta/{wire_tok}", timeout=10
    ) as f:
        meta = unpickle(f)
    bodies = []
    for i in range(streams):
        with urllib.request.urlopen(
            f"{address}{step}/stream/{i}/{streams}/{wire_tok}/{meta['seq']}",
            timeout=10,
        ) as f:
            bodies.append((f.headers.get("X-TFT-Crc32c"), f.read()))
    return meta, bodies


def _slots(leaves):
    return [(tuple(s.shape), s.dtype, s.wire_dtype, s.offset, s.nbytes)
            if type(s).__name__ == "_ArraySlot" else ("leaf", s)
            for s in leaves]


@pytest.mark.parametrize("streams", [1, 3, 4])
@pytest.mark.parametrize("wire", [None, "bf16"])
def test_stream_ranges_and_crcs_match_the_jax_package(wire, streams):
    import jax

    tree = _numpy_tree()
    jserver = jck.CheckpointServer(timeout=_T)
    tserver = ck.CheckpointServer(timeout=_T, device="cpu")
    try:
        jserver.send_checkpoint([1], 3, tree, _T)
        tserver.send_checkpoint([1], 3, tree, _T)
        tok = wire or "none"
        jmeta, jbodies = _ranges(jserver.address(), 3, tok, streams,
                                 lambda f: jck._SafeUnpickler(f).load())
        tmeta, tbodies = _ranges(tserver.address(), 3, tok, streams,
                                 ck.load_state_dict_stream)
    finally:
        jserver.shutdown()
        tserver.shutdown()
    assert tmeta["total"] == jmeta["total"] and tmeta["wire"] == jmeta["wire"]
    for (tcrc, tbody), (jcrc, jbody) in zip(tbodies, jbodies):
        assert tcrc == jcrc
        assert tbody == jbody
    jslots = _slots(jax.tree_util.tree_leaves(jmeta["skeleton"]))
    tslots = _slots(flatten(tmeta["skeleton"])[0])
    assert tslots == jslots
    if wire == "bf16":  # the NaN words crossed as K3's words
        mu = next(s for s in flatten(tmeta["skeleton"])[0]
                  if getattr(s, "shape", None) == (67,))
        body = b"".join(b for _, b in tbodies)
        words = np.frombuffer(body, np.uint16, count=len(CAST_BF16_WORDS),
                              offset=mu.offset)
        assert list(words) == list(CAST_BF16_WORDS.values())


def test_bf16_staging_is_k3_plain_over_tensor_leaves():
    """Torch leaves (the port's own state) give the numpy tree's bytes:
    the narrowed leaves through K3's plain version."""
    tree = _numpy_tree()
    ttree = tree_map(lambda l: torch.from_numpy(l.copy())
                     if isinstance(l, np.ndarray) else l, tree)
    a = ck._StreamStaging(tree, "bf16")
    b = ck._StreamStaging(ttree, "bf16")
    assert a.meta == b.meta
    assert a.buffer.numpy().tobytes() == b.buffer.numpy().tobytes()
    mu = torch.from_numpy(tree["opt_state"]["mu"])
    skeleton = ck.load_state_dict_stream(io.BytesIO(b.meta))["skeleton"]
    slot = [s for s in flatten(skeleton)[0]
            if getattr(s, "shape", None) == (67,)][0]
    got = b.buffer[slot.offset:slot.offset + slot.nbytes]
    assert torch.equal(got, plain["cast_bf16"](mu).view(torch.uint8))


def test_path_flatten_matches_flatten_and_guards_opt_state():
    tree = _numpy_tree()
    with_path, tdef = flatten_with_path(tree)
    leaves, tdef2 = flatten(tree)
    assert tdef == tdef2
    assert [l is m for (_, l), m in zip(with_path, leaves)] == [True] * len(leaves)
    narrowed = [p for p, _ in with_path if is_opt_state_path(p)]
    assert all(p[0] == "opt_state" for p in narrowed) and len(narrowed) == 5
    # a key only named like it, or an index, is not opt_state
    assert not is_opt_state_path(("params", "opt_state_like", 0))
    assert is_opt_state_path(("user", "opt_state", "mu", 3))


# -- the JAX package's stream tests, ported -----------------------------------


def _donor_state():
    """A heal payload: f32 params, AdamW state (f32 moments, int count), an
    f32 leaf outside params and opt_state, manager counters."""
    g = torch.Generator().manual_seed(0)
    params = {"dense": torch.randn(257, 31, generator=g),
              "bias": torch.randn(31, generator=g)}
    opt_state = tft.AdamW(1e-3).init(params)
    opt_state = {
        "count": 3,
        "mu": tree_map(lambda t: t + 0.1234567, opt_state["mu"]),
        "nu": tree_map(lambda t: t + 0.7654321, opt_state["nu"]),
    }
    return {
        "user": {"params": params, "opt_state": opt_state,
                 "ema_weights": torch.randn(19, generator=g)},
        "torchft": {"step": 17, "batches_committed": 51},
    }


@pytest.mark.parametrize("streams", [1, 2, 4])
@pytest.mark.parametrize("wire", [None, "bf16"])
def test_stream_heal_params_bit_identical(server, wire, streams):
    state = _donor_state()
    server.send_checkpoint([1], 7, state, _T)
    out, stats = _fetch(f"{server.address()}7", wire=wire, streams=streams)
    assert stats["path"] == "stream"
    assert stats["streams"] == streams and stats["wire"] == wire
    assert stats["bytes"] > 0 and stats["h2d_s"] == 0.0  # no upload on the CPU
    for key in ("dense", "bias"):
        donor, healed = state["user"]["params"][key], out["user"]["params"][key]
        assert healed.dtype == donor.dtype and _bits(healed) == _bits(donor)
    for m in ("mu", "nu"):
        for d, h in zip(flatten(state["user"]["opt_state"][m])[0],
                        flatten(out["user"]["opt_state"][m])[0]):
            assert h.dtype == d.dtype
            if wire == "bf16":
                np.testing.assert_array_equal(h.numpy(), _bf16_round(d))
            else:
                assert _bits(h) == _bits(d)
    assert out["user"]["opt_state"]["count"] == 3
    # protect by default: a leaf outside params and opt_state ships raw
    assert _bits(out["user"]["ema_weights"]) == _bits(state["user"]["ema_weights"])
    assert out["torchft"] == {"step": 17, "batches_committed": 51}


def test_stream_heal_donor_never_pickles_bulk(server, monkeypatch):
    def boom(_):
        raise AssertionError("serialize_state_dict on the streamed heal path")

    monkeypatch.setattr(ck, "serialize_state_dict", boom)
    monkeypatch.setattr(ck, "_to_host", boom)
    state = _donor_state()
    server.send_checkpoint([1], 4, state, _T)
    out = server.recv_checkpoint(0, server.metadata(), 4, _T)
    assert server.last_fetch_stats["path"] == "stream"
    assert server.last_fetch_stats["bytes"] > 0
    assert _bits(out["user"]["params"]["dense"]) == \
        _bits(state["user"]["params"]["dense"])


def test_stream_heal_wrong_step_is_an_error(server):
    server.send_checkpoint([1], 3, _donor_state(), _T)
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _fetch(f"{server.address()}5")
    assert exc_info.value.code == 400


def test_stream_heal_env_knobs(server, monkeypatch):
    monkeypatch.setenv("TORCHFT_HEAL_WIRE", "bf16")
    monkeypatch.setenv("TORCHFT_HEAL_STREAMS", "3")
    state = _donor_state()
    server.send_checkpoint([1], 11, state, _T)
    out = server.recv_checkpoint(0, server.metadata(), 11, _T)
    stats = server.last_fetch_stats
    assert stats["path"] == "stream"
    assert stats["wire"] == "bf16" and stats["streams"] == 3
    assert _bits(out["user"]["params"]["bias"]) == \
        _bits(state["user"]["params"]["bias"])
    monkeypatch.setenv("TORCHFT_HEAL_WIRE", "fp8")
    with pytest.raises(ValueError, match="TORCHFT_HEAL_WIRE"):
        server.recv_checkpoint(0, server.metadata(), 11, _T)
    monkeypatch.delenv("TORCHFT_HEAL_WIRE")
    monkeypatch.delenv("TORCHFT_HEAL_STREAMS")
    monkeypatch.setenv("TORCHFT_CKPT_STRIPES", "2")
    server.recv_checkpoint(0, server.metadata(), 11, _T)
    assert server.last_fetch_stats["streams"] == 2  # streams follow stripes
    assert server.last_fetch_stats["wire"] is None


def test_stream_stale_publish_rejected(server):
    server.send_checkpoint([1], 6, {"w": torch.ones(256)}, _T)
    with urllib.request.urlopen(
        f"{server.address()}6/streammeta/none", timeout=10
    ) as f:
        seq = ck.load_state_dict_stream(f)["seq"]
    with urllib.request.urlopen(
        f"{server.address()}6/stream/0/2/none/{seq}", timeout=10
    ) as f:
        assert len(f.read()) == 512  # half of 256 f32
    server.disallow_checkpoint()  # republish at the SAME step
    server.send_checkpoint([1], 6, {"w": torch.zeros(256)}, _T)
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(
            f"{server.address()}6/stream/0/2/none/{seq}", timeout=10)
    assert exc_info.value.code == 400
    out = ck.CheckpointServer.load_from_address(
        f"{server.address()}6", _T, device="cpu")
    assert torch.equal(out["w"], torch.zeros(256))


def test_stream_disallow_regates(server):
    """disallow_checkpoint closes the gate to new fetches (their meta times
    out, and so do the pickled fallbacks); the staging of the publish
    stays until the next one."""
    server.send_checkpoint([1], 1, _donor_state(), _T)
    ck.CheckpointServer.load_from_address(f"{server.address()}1", _T,
                                          device="cpu")
    assert server._stagings
    server.disallow_checkpoint()
    assert server._stagings
    server.send_checkpoint([1], 2, _donor_state(), _T)
    assert not server._stagings
    fast = ck.CheckpointServer(timeout=timedelta(milliseconds=200),
                               device="cpu")
    try:
        fast.send_checkpoint([1], 1, {"x": torch.ones(4)}, _T)
        fast.disallow_checkpoint()
        with pytest.raises(Exception):
            fast.recv_checkpoint(0, fast.metadata(), 1, _T)
    finally:
        fast.shutdown()


def test_stream_ranges_finish_after_disallow(server, monkeypatch):
    """A healer that read the meta before the donor's disallow (the donor's
    step failed fast and it voted) still gets its ranges: they come from
    the staging's host copy, not from the state the optimizer now
    writes."""
    state = _donor_state()
    want = _bits(state["user"]["params"]["dense"])
    server.send_checkpoint([1], 2, state, _T)
    real = ck.CheckpointServer._load_stream.__func__
    meta_seen = threading.Event()
    go = threading.Event()
    real_urlopen = urllib.request.urlopen

    def gated_urlopen(url, timeout=None):
        if "/stream/" in str(url):
            meta_seen.set()
            assert go.wait(10)
        return real_urlopen(url, timeout=timeout)

    monkeypatch.setattr(urllib.request, "urlopen", gated_urlopen)
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(real, ck.CheckpointServer, f"{server.address()}2", _T,
                        None, 2, torch.device("cpu"))
        assert meta_seen.wait(10)
        server.disallow_checkpoint()  # returns at once: nothing to drain
        with torch.no_grad():
            state["user"]["params"]["dense"].add_(1.0)  # the next update
        go.set()
        out, stats = fut.result(timeout=20)
    assert stats["path"] == "stream"
    assert _bits(out["user"]["params"]["dense"]) == want
    assert server._stream_inflight == 0


def _proxy_for(server):
    parts = urllib.parse.urlparse(server.address())
    proxy = HealFaultProxy(f"{parts.scheme}://{parts.netloc}")
    return proxy, proxy.address() + parts.path


def test_stream_corrupted_range_falls_back(server):
    """A flipped bit under an intact CRC header: the receiver's check
    catches it, installs nothing from the stream and refetches pickled."""
    state = {"params": {"w": torch.arange(65536, dtype=torch.float32)}}
    server.send_checkpoint([1], 2, state, _T)
    proxy, addr = _proxy_for(server)
    try:
        proxy.mode = "bit_flip"
        proxy.only_paths = ("/stream/",)
        proxy.max_faults = 1
        out, stats = _fetch(addr + "2", streams=4)
        assert proxy.faults_fired == 1
        assert stats["path"] == "striped"
        np.testing.assert_array_equal(out["params"]["w"],
                                      state["params"]["w"].numpy())
    finally:
        proxy.shutdown()


@pytest.mark.parametrize("mode", ["truncate_body", "reset_mid_range"])
def test_stream_fault_falls_back_within_budget(server, mode):
    state = {"params": {"w": torch.arange(65536, dtype=torch.float32)}}
    server.send_checkpoint([1], 2, state, _T)
    proxy, addr = _proxy_for(server)
    try:
        proxy.mode = mode
        proxy.only_paths = ("/stream/",)
        proxy.max_faults = 1
        t0 = time.monotonic()
        out, stats = _fetch(addr + "2", streams=4)
        wall = time.monotonic() - t0
        assert proxy.faults_fired == 1
        assert stats["path"] != "stream"
        np.testing.assert_array_equal(out["params"]["w"],
                                      state["params"]["w"].numpy())
        assert wall < _T.total_seconds(), wall
    finally:
        proxy.shutdown()


def test_stream_fault_cancels_surviving_readers(server):
    state = {"params": {"w": torch.arange(1 << 18, dtype=torch.float32)}}
    server.send_checkpoint([1], 3, state, _T)
    proxy, addr = _proxy_for(server)
    try:
        proxy.mode = "reset_mid_range"
        proxy.only_paths = ("/stream/",)
        proxy.max_faults = 1
        out, _stats = _fetch(addr + "3", streams=4)
        np.testing.assert_array_equal(out["params"]["w"],
                                      state["params"]["w"].numpy())
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with server._stream_lock:
                if server._stream_inflight == 0:
                    break
            time.sleep(0.05)
        assert server._stream_inflight == 0
    finally:
        proxy.shutdown()


def test_stream_timeout_raises_without_fallback(server):
    """A donor that never answers a range spends the budget: the fetch
    raises TimeoutError and no pickled path is tried."""
    server.send_checkpoint([1], 5, {"w": torch.ones(1024)}, _T)
    proxy, addr = _proxy_for(server)
    try:
        proxy.mode = "blackhole"
        proxy.only_paths = ("/stream/",)
        with pytest.raises(TimeoutError):
            ck.CheckpointServer._fetch(addr + "5", timedelta(seconds=1),
                                       streams=2, device="cpu")
        assert not any("/part/" in p or p.endswith("/5")
                       for p in proxy.requests)
    finally:
        proxy.shutdown()


def test_striped_parallel_fetch_roundtrip(server):
    big = {f"w{i}": torch.from_numpy(
        np.random.default_rng(i).standard_normal(1 << 18)) for i in range(4)}
    server.send_checkpoint([1], 9, big, _T)
    out = ck.CheckpointServer._load_striped(f"{server.address()}9", _T, 4)
    for k, v in big.items():
        assert out[k].tobytes() == v.numpy().tobytes()
    with urllib.request.urlopen(f"{server.address()}9/part/0/4",
                                timeout=10) as f:
        assert f.headers.get("Content-Length") is not None
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(f"{server.address()}8/part/0/4", timeout=10)
    assert exc_info.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(f"{server.address()}9/part/4/4", timeout=10)
    assert exc_info.value.code == 404


@pytest.mark.parametrize("missing,path", [
    (("/stream",), "striped"), (("/part/", "/stream"), "single")])
def test_fetch_falls_back_on_older_servers(server, monkeypatch, missing, path):
    """Against a peer without the stream (and part) endpoints, a 404, the
    heal goes on over the pickled paths."""
    state = {"w": torch.arange(32, dtype=torch.float32)}
    server.send_checkpoint([1], 2, state, _T)
    real = urllib.request.urlopen

    def older(url, timeout=None):
        if any(m in str(url) for m in missing):
            raise urllib.error.HTTPError(str(url), 404, "no such path", {}, None)
        return real(url, timeout=timeout)

    monkeypatch.setattr(urllib.request, "urlopen", older)
    out, stats = _fetch(f"{server.address()}2", stripes=4)
    assert stats["path"] == path
    np.testing.assert_array_equal(out["w"], state["w"].numpy())


def test_register_safe_modules_extends_the_skeleton_safelist(server):
    """A class from a registered module may ride the skeleton."""
    from fractions import Fraction

    state = {"w": torch.ones(3), "ratio": Fraction(1, 3)}
    server.send_checkpoint([1], 1, state, _T)
    with pytest.raises(Exception, match="disallowed global"):
        _fetch(f"{server.address()}1")
    roots = set(ck._SAFE_MODULE_ROOTS)
    try:
        ck.register_safe_modules("fractions")
        out, stats = _fetch(f"{server.address()}1")
        assert stats["path"] == "stream" and out["ratio"] == Fraction(1, 3)
    finally:
        ck._SAFE_MODULE_ROOTS.clear()
        ck._SAFE_MODULE_ROOTS.update(roots)


# -- a Manager kill-and-heal on the bf16 heal wire ----------------------------

_KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=1, d_ff=64,
           max_seq_len=32)


class _Killed(Exception):
    pass


def _snapshot(tree):
    return tree_map(lambda l: l.detach().clone() if isinstance(l, torch.Tensor)
                    else (np.array(l) if isinstance(l, np.ndarray) else l), tree)


def _replica(g, lighthouse, steps, kill_at, published, received, fetches):
    cfg = tt.TransformerConfig(**_KW, dtype=torch.float32)
    for attempt in range(3):
        model = tt.TransformerLM(cfg, device="cpu")
        state = tft.FTTrainState(model.params(), tft.AdamW(1e-3))
        collectives = tft.HostCollectives(timeout=_T, stripes=2)
        box = {}

        def state_dict(state=state, box=box):
            published.append((box["m"].current_step(), _snapshot(state.state_dict())))
            return state.state_dict()

        def load_state_dict(sd, state=state, box=box):
            received.append((box["m"].current_step(), _snapshot(sd)))
            state.load_state_dict(sd)

        manager = tft.Manager(
            collectives=collectives, load_state_dict=load_state_dict,
            state_dict=state_dict, min_replica_size=1, timeout=_T,
            quorum_timeout=_T, connect_timeout=_T, rank=0, world_size=1,
            lighthouse_addr=lighthouse, replica_id=f"g{g}", device="cpu",
        )
        box["m"] = manager
        optimizer = tft.OptimizerWrapper(manager, state)
        ddp = tft.DistributedDataParallel(manager)
        grad_fn = tt.make_grad_fn(cfg)
        try:
            i = 0
            deadline = time.monotonic() + 120
            while manager.current_step() < steps:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"group {g} stuck at step "
                                       f"{manager.current_step()}")
                if attempt == 0 and manager.current_step() == kill_at:
                    raise _Killed()
                optimizer.zero_grad()
                tokens = torch.from_numpy(np.random.default_rng(100 * g + i)
                                          .integers(0, 64, (2, 9))).long()
                _, grads = grad_fn(state.params, tokens)
                optimizer.step(ddp.allreduce_grads(grads).wait())
                i += 1
                if g == 0:
                    time.sleep(0.05)  # leave the victim time to rejoin
            fetches[g] = (manager.checkpoint_transport().last_fetch_stats,
                          manager.signals()["heal"])
            return manager.current_step()
        except _Killed:
            continue
        finally:
            manager.shutdown()
            collectives.shutdown()
    raise RuntimeError(f"group {g} exhausted its restarts")


def test_manager_kill_and_heal_bf16_wire(monkeypatch):
    monkeypatch.setenv("TORCHFT_HEAL_WIRE", "bf16")
    lighthouse = tft.Lighthouse(min_replicas=1, join_timeout_ms=200,
                                quorum_tick_ms=50, heartbeat_timeout_ms=2000)
    published, received, fetches = [], [], {}
    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(_replica, 0, lighthouse.address(), 8, None,
                              published, [], fetches),
                    ex.submit(_replica, 1, lighthouse.address(), 8, 2,
                              [], received, fetches)]
            steps = [f.result(timeout=180) for f in futs]
    finally:
        lighthouse.shutdown()
    assert min(steps) >= 8
    stats, heal = fetches[1]
    assert stats["path"] == "stream" and stats["wire"] == "bf16"
    assert heal["last_fetch"] == stats
    assert received, "the restarted group never healed"
    by_step = dict(published)
    healed_any = False
    for step, got in received:
        if step not in by_step:
            continue
        sent = by_step[step]
        healed_any = True
        for d, h in zip(flatten(sent["params"])[0], flatten(got["params"])[0]):
            assert _bits(h) == _bits(d)  # params: bit-identical
        for m in ("mu", "nu"):
            for d, h in zip(flatten(sent["opt_state"][m])[0],
                            flatten(got["opt_state"][m])[0]):
                np.testing.assert_array_equal(h.numpy(), _bf16_round(d))
        assert int(got["opt_state"]["count"]) == int(sent["opt_state"]["count"])
    assert healed_any
