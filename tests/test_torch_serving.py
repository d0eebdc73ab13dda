"""The port's weight-serving plane against the JAX package's.

- ``encode_tree`` / ``decode_tree`` / ``tree_digest`` on the same tree
  give bit-identical q8 codes and scales, bf16 words and digests. The
  non-finite cases are pinned: a q8 leaf holding NaN or Inf encodes to
  codes 0 and scale ``0x7FC00000`` in the port (numpy's cast of a NaN to
  int8 is undefined; ROADMAP Queue 3, D4), and a bf16 NaN to
  ``sign | 0x7FC0``; subnormal leaves follow numpy.
- The same 10-version publish sequence (``snapshot_every=4``) gives
  manifests with equal kind, base, total, crc and digest, and equal
  data-range bytes (the meta pickles differ by the slot class's module,
  so neither package's subscriber reads the other's versions).
- A publisher -> relay -> subscribers chain installs every version with
  matching digests and no torn install; late joiners catch up from a
  snapshot; the integrity ladder's detections leave the installed
  version untouched.

Every HTTP wait has its own timeout (``timeout_s`` of the relay and the
subscribers, the poll's long-poll bound).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import torchft_tpu.serving as js
from torchft_tpu_torch import serving as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRES = ["q8", "bf16", "f32"]
_TIMEOUT = 20.0


def _tree(seed=3):
    """Uneven leaves, a nested list, a 0-d leaf, an empty leaf, wide
    magnitudes, signed zeros and subnormals."""
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((33, 17)).astype(np.float32),
        "blocks": [
            {"w": (rng.standard_normal(1001) * 1e3).astype(np.float32)},
            {"w": (rng.standard_normal(1001) * 1e-3).astype(np.float32)},
        ],
        "scale": np.asarray(rng.standard_normal(), np.float32),
        "empty": np.zeros(0, np.float32),
        "zeros": np.array([0.0, -0.0, 0.0, -0.0], np.float32),
        "tiny": np.array([1e-40, -3e-39, 2e-45, 0.0], np.float32),
        "f64": rng.standard_normal(7),
    }


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _raw(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _leaf_bytes(tree):
    import jax

    return [_raw(l) for l in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]


class TestCodec:
    @pytest.mark.parametrize("wire", WIRES)
    def test_encode_decode_digest_match_the_jax_package(self, wire):
        tree = _tree()
        je, te = js.encode_tree(tree, wire), ts.encode_tree(_torch(tree), wire)
        assert _leaf_bytes(te) == _leaf_bytes(je)
        jd, td = js.decode_tree(je, wire), ts.decode_tree(te, wire)
        assert _leaf_bytes(td) == _leaf_bytes(jd)
        assert ts.tree_digest(td) == js.tree_digest(jd)
        assert ts.tree_digest(_torch(tree)) == js.tree_digest(tree)

    def test_group_encode_is_one_kernel_pair_per_tree(self):
        """On the CPU the wrappers run the plain versions; the encode
        still goes through the group wrappers (one call per tree)."""
        from torchft_tpu_torch.ops import quantize_kernels as qk

        calls = []
        real = qk.quantize_q8_ef_group

        def spy(*a, **k):
            calls.append(len(a[0]))
            return real(*a, **k)

        carry = {}
        qk.quantize_q8_ef_group = spy
        try:
            ts.encode_tree(_torch(_tree()), "q8", carry)
            ts.encode_tree(_torch(_tree(4)), "q8", carry)
        finally:
            qk.quantize_q8_ef_group = real
        assert calls == [8, 8]
        (zeros, _), = carry.values()
        assert not zeros.any()  # the zero carry is never written

    def test_nonfinite_q8_leaf_is_pinned(self):
        tree = {"a": np.array([1.0, np.nan, -2.0], np.float32),
                "b": np.array([3.0, np.inf, 0.5], np.float32),
                "c": np.array([0.25, -1.5, 4.0], np.float32)}
        te = ts.encode_tree(_torch(tree), "q8")
        je = js.encode_tree(tree, "q8")
        for k in ("a", "b"):
            assert te[k]["q"].tolist() == [0, 0, 0]
            assert te[k]["s"].view(torch.int32).item() == 0x7FC00000
            # the reference's scale is NaN or Inf, its codes undefined
            assert not np.isfinite(je[k]["s"])
            dec = ts.decode_tree(te, "q8")[k]
            assert (dec.view(torch.int32) == 0x7FC00000).all()
            assert not np.isfinite(js.decode_tree(je, "q8")[k]).any()
        assert _raw(te["c"]["q"]) == _raw(je["c"]["q"])
        assert _raw(te["c"]["s"]) == _raw(je["c"]["s"])

    def test_bf16_nan_is_pinned(self):
        bits = np.array([0x7FC00000, 0x7FFFFFFF, 0xFFC00001, 0x3F818000,
                         0x7F800000], np.uint32)
        x = {"x": bits.view(np.float32)}
        tw = ts.encode_tree(_torch(x), "bf16")["x"].view(torch.int16)
        jw = js.encode_tree(x, "bf16")["x"]
        assert [w & 0xFFFF for w in tw.tolist()] == [
            0x7FC0, 0x7FC0, 0xFFC0, 0x3F82, 0x7F80]
        assert np.isnan(np.asarray(jw[:3], np.float32)).all()
        assert _raw(tw[3:]) == np.asarray(jw[3:]).tobytes()

    def test_refuses_integer_and_mixed_device_trees(self):
        with pytest.raises(ValueError, match="float"):
            ts.encode_tree({"i": torch.arange(3)}, "q8")
        with pytest.raises(ValueError):
            ts.encode_tree({"a": torch.ones(2)}, "int4")


def _range_bytes(base, m):
    return ts._http_bytes(f"{base}/ps/range/{m['version']}/0/1/{m['nonce']}",
                          _TIMEOUT, verify_crc=True)


@pytest.mark.parametrize("wire", WIRES)
def test_publish_sequence_matches_the_jax_package(wire):
    jpub = js.WeightPublisher(wire=wire, snapshot_every=4, keep=16)
    tpub = ts.WeightPublisher(wire=wire, snapshot_every=4, keep=16)
    try:
        for v in range(10):
            params = js.demo_params(5, 3, 700, v)
            jm = jpub.publish(params, step=v)
            tm = tpub.publish(ts.demo_params(5, 3, 700, v, device="cpu"),
                              step=v)
            for key in ("version", "kind", "base", "wire", "step", "total",
                        "f32_nbytes", "crc", "digest"):
                assert tm[key] == jm[key], (v, key)
            assert _range_bytes(tpub.server.local_address(), tm) == \
                _range_bytes(jpub.server.local_address(), jm)
            stats = tpub.last_publish
            assert stats["version"] == v and stats["wire_bytes"] == tm["total"]
            assert all(stats[k] >= 0 for k in ("encode_s", "staging_s",
                                               "crc_s", "digest_s"))
        assert [m["kind"] for m in tpub.node.store.manifests()] == \
            [m["kind"] for m in jpub.node.store.manifests()]
    finally:
        jpub.shutdown()
        tpub.shutdown()


@pytest.mark.parametrize("wire", WIRES)
def test_relay_chain_installs_every_version(wire):
    pub = ts.WeightPublisher(wire=wire, snapshot_every=4, keep=16)
    relay = ts.WeightRelay(pub.server.local_address(), timeout_s=_TIMEOUT)
    base = relay.server.local_address()
    subs = [ts.WeightSubscriber(base, device="cpu", timeout_s=_TIMEOUT),
            ts.WeightSubscriber(base, device="cpu", timeout_s=_TIMEOUT),
            ts.WeightSubscriber(pub.server.local_address(), device="cpu",
                                timeout_s=_TIMEOUT)]
    try:
        for v in range(6):
            m = pub.publish(ts.demo_params(1, 4, 513, v, device="cpu"), step=v)
            relay.sync_once()
            for s in subs:
                assert s.poll(), (v, s.stats)
                version, tree, age = s.current()
                assert version == v and age >= 0
                assert ts.tree_digest(tree) == m["digest"]
                assert _leaf_bytes(tree) == _leaf_bytes(pub.served())
                assert s.last_install["bytes"] >= m["total"]
        for s in subs:
            assert s.stats["installs"] == 6 and s.stats["torn_installs"] == 0
            assert s.stats["snapshot_installs"] == 2
            assert s.stats["delta_installs"] == 4
        # one upstream fetch per version, whatever the relay's fan-out
        assert relay.node.counters["syncs"] == 6
        status = pub.status()
        assert status["latest"] == 5 and status["counters"]["publishes"] == 6
    finally:
        for s in subs:
            s.close()
        relay.shutdown()
        pub.shutdown()


def test_late_joiner_catches_up_from_a_snapshot():
    pub = ts.WeightPublisher(wire="q8", snapshot_every=4, keep=16)
    try:
        for v in range(7):
            m = pub.publish(ts.demo_params(2, 2, 300, v, device="cpu"))
        sub = ts.WeightSubscriber(pub.server.local_address(), device="cpu",
                                  timeout_s=_TIMEOUT)
        assert sub.poll()
        assert sub.version() == 6
        assert sub.stats["snapshot_installs"] == 1
        assert sub.stats["catch_up_deltas"] == 2  # snapshot 4, deltas 5 and 6
        assert ts.tree_digest(sub.current()[1]) == m["digest"]
        assert not sub.poll()  # current: no news
        sub.close()
    finally:
        pub.shutdown()


def test_detections_leave_the_installed_version():
    pub = ts.WeightPublisher(wire="bf16", snapshot_every=4)
    sub = ts.WeightSubscriber(pub.server.local_address(), device="cpu",
                              timeout_s=_TIMEOUT, max_age_ms=60_000)
    try:
        m0 = pub.publish(ts.demo_params(0, 2, 64, 0, device="cpu"))
        assert sub.poll()
        with pytest.raises(ts.WireDetection) as e:
            ts._fetch_version(pub.server.local_address(),
                              {**m0, "nonce": "0" * 16}, 1, _TIMEOUT)
        assert e.value.kind == "nonce"
        with pytest.raises(ts.WireDetection) as e:
            ts._fetch_version(pub.server.local_address(),
                              {**m0, "crc": "00000000"}, 2, _TIMEOUT)
        assert e.value.kind == "crc"
        # a manifest whose digest does not match what decodes: averted
        digest = pub.publish(ts.demo_params(0, 2, 64, 1, device="cpu"))["digest"]
        pub.node.store.get(1).manifest["digest"] = "deadbeef"
        assert not sub.poll()
        assert sub.stats["detect_digest"] == 1 and sub.version() == 0
        pub.node.store.get(1).manifest["digest"] = digest
        assert sub.poll() and sub.version() == 1
        assert sub.current(max_age_ms=60_000)[0] == 1
        with pytest.raises(ts.StaleWeightsError):
            ts.WeightSubscriber(pub.server.local_address(),
                                device="cpu").current()
        assert ts._catch_up_plan(-1, {}) == []
        with pytest.raises(ts.WireDetection):
            ts._catch_up_plan(-1, {3: {"kind": "delta"}})
    finally:
        sub.close()
        pub.shutdown()


def test_partitioned_relay_serves_with_a_growing_age():
    pub = ts.WeightPublisher(wire="f32")
    relay = ts.WeightRelay(pub.server.local_address(), timeout_s=_TIMEOUT)
    try:
        pub.publish(ts.demo_params(0, 1, 32, 0, device="cpu"))
        relay.sync_once()
        relay.set_partitioned(True)
        pub.publish(ts.demo_params(0, 1, 32, 1, device="cpu"))
        with pytest.raises(ts.WireDetection):
            relay.sync_once()
        age0 = relay.node.status()["age_ms"]
        import time

        time.sleep(0.05)
        assert relay.node.status()["age_ms"] > age0
        assert relay.node.store.latest() == 0
        relay.set_partitioned(False)
        assert relay.sync_once() and relay.node.store.latest() == 1
    finally:
        relay.shutdown()
        pub.shutdown()


def test_publish_on_commit_rides_the_commit_hook():
    class _Mgr:
        def __init__(self):
            self.hooks = []

        def add_commit_hook(self, hook):
            self.hooks.append(hook)

    mgr, pub = _Mgr(), ts.WeightPublisher(wire="q8")
    try:
        ts.publish_on_commit(mgr, pub, lambda: ts.demo_params(
            0, 2, 16, 0, device="cpu"), every=2)
        (hook,) = mgr.hooks
        for step, committed in ((1, True), (2, False), (2, True), (4, True)):
            hook(step, 1, committed)
        assert [m["step"] for m in pub.node.store.manifests()] == [2, 4]
    finally:
        pub.shutdown()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.WeightSubscriber("http://[::1]:1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.demo_params(0, 1, 4, 0)


def test_wire_from_env(monkeypatch):
    monkeypatch.delenv("TORCHFT_PS_WIRE", raising=False)
    assert ts.wire_from_env() == js.wire_from_env() == "q8"
    monkeypatch.setenv("TORCHFT_PS_WIRE", "raw")
    assert ts.wire_from_env() == "f32"
    monkeypatch.setenv("TORCHFT_PS_WIRE", "int4")
    with pytest.raises(ValueError):
        ts.wire_from_env()


def test_module_main_serves_versions():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.serving", "--device", "cpu",
         "--versions", "2", "--leaves", "2", "--elems", "64",
         "--publish-every-ms", "20"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving "), line
        port = int(line.rsplit("port=", 1)[1])
        sub = ts.WeightSubscriber(f"http://[::1]:{port}", device="cpu",
                                  timeout_s=_TIMEOUT)
        assert sub.wait_version(1, timeout_s=30)
        want = ts.demo_params(0, 2, 64, 1, device="cpu")
        got = sub.current()[1]
        for k in want:  # q8: within one code step of the weights
            err = (got[k] - want[k]).abs().max().item()
            assert err <= want[k].abs().max().item() / 127
        sub.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
