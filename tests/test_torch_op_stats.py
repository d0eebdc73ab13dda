"""The port's op stats and policy signals against the JAX package's.

- ``pop_op_stats`` entries carry the JAX package's keys on every plan
  path (the flat host pack, the CPU device pack, the two-tier plan) and
  on the plain allreduce, with equal byte fields and bucket counts and
  positive times: a JAX and a port member share one ring and each drains
  its own entry of the same op.
- ``Manager.observe_op_stats`` folds them into ``signals()``
  (``wire_eff_MBps``, ``tier_eff_MBps``, ``heal``), and ``push_status``
  shows up in the lighthouse's ``/status.json``.
"""

import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401
from torchft_tpu import collectives as jcol
from torchft_tpu._native import Store
from torchft_tpu_torch import _native as tnative
from torchft_tpu_torch import collectives as tcol

_T = timedelta(seconds=20)
_BYTE_KEYS = ("bytes", "wire_bytes", "d2h_bytes", "py_staging_allocs")


@pytest.fixture
def store():
    s = Store()
    yield s
    s.shutdown()


def _mixed(store, prefix, regions=None, hosts=None):
    cols = [jcol.HostCollectives(timeout=_T, stripes=2),
            tcol.HostCollectives(timeout=_T, stripes=2)]
    addr = f"{store.address()}/{prefix}"
    with ThreadPoolExecutor(max_workers=2) as ex:
        for f in [ex.submit(c.configure, addr, r, 2, regions, hosts)
                  for r, c in enumerate(cols)]:
            f.result(timeout=60)
    return cols


def _both(cols, jax_op, port_op):
    """Runs one op on the JAX member (rank 0) and the port member (rank
    1) at once; returns each member's drained stats entry."""
    errors = []

    def run(r):
        try:
            (jax_op if r == 0 else port_op)(cols[r]).wait()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return [c.pop_op_stats()[-1] for c in cols]


def _data():
    rng = np.random.default_rng(7)
    return {"a": rng.standard_normal(3000).astype(np.float32),
            "b": rng.standard_normal((7, 13)).astype(np.float32)}


def _port(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jnp(tree):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_same_shape(j, t, byte_keys=_BYTE_KEYS):
    assert set(t) == set(j), sorted(set(t) ^ set(j))
    for k in byte_keys:
        if k in j:
            assert t[k] == j[k], k
    assert len(t["buckets"]) == len(j["buckets"])
    assert t["ring"] > 0 and t["d2h"] >= 0
    for b in t["buckets"]:
        assert b["ring_s"] >= 0 and b["bytes"] > 0


class TestPlanStatsKeys:
    @pytest.mark.parametrize("wire", [None, "bf16", "q8ef"])
    def test_host_pack(self, store, wire):
        cols = _mixed(store, f"hp_{wire}")
        try:
            d = _data()
            j, t = _both(
                cols,
                lambda c: c.plan_allreduce(d, wire=wire, device_pack=False),
                lambda c: c.plan_allreduce(_port(d), wire=wire,
                                           device_pack=False))
            assert t["device_pack"] is False and t["op"] == "plan_allreduce"
            _assert_same_shape(j, t)
        finally:
            for c in cols:
                c.shutdown()

    @pytest.mark.parametrize("wire", [None, "bf16", "q8ef"])
    def test_device_pack(self, store, wire):
        cols = _mixed(store, f"dp_{wire}")
        try:
            d = _data()
            j, t = _both(
                cols,
                lambda c: c.plan_allreduce(_jnp(d), wire=wire,
                                           device_pack=True),
                lambda c: c.plan_allreduce(_port(d), wire=wire,
                                           device_pack=True))
            assert t["device_pack"] is True and t["pack"] > 0
            _assert_same_shape(j, t)
        finally:
            for c in cols:
                c.shutdown()

    @pytest.mark.parametrize("wire", [None, "q8ef"])
    def test_hier_plan(self, store, wire):
        cols = _mixed(store, f"hi_{wire}", hosts=["h0", "h0"])
        try:
            d = _data()
            j, t = _both(
                cols,
                lambda c: c.plan_allreduce(d, wire=wire, hier=True),
                lambda c: c.plan_allreduce(_port(d), wire=wire, hier=True))
            assert t["hier"] is True
            _assert_same_shape(j, t, ("bytes", "d2h_bytes",
                                      "py_staging_allocs"))
            assert set(t["tiers"]) == set(j["tiers"]) == {
                "host", "intra", "inter"}
            for name in t["tiers"]:
                assert set(t["tiers"][name]) == set(j["tiers"][name])
            assert t["tiers"]["host"]["transport"] == "shm"
            assert t["tiers"]["host"]["shm_bytes"] > 0
        finally:
            for c in cols:
                c.shutdown()

    def test_plain_allreduce_records_stripes(self, store):
        """The plain allreduce records the JAX package's device-packed
        allreduce keys plus ``stripe_s`` (the per-stripe ring seconds,
        summed over its dtype groups). ``d2h_bytes`` counts what crossed
        the card link: nothing, for CPU tensors."""
        cols = _mixed(store, "plain")
        try:
            d = _data()
            j, t = _both(cols, lambda c: c.allreduce(_jnp(d)),
                         lambda c: c.allreduce(_port(d)))
            assert set(t) == set(j) | {"stripe_s"}
            assert t["bytes"] == j["bytes"] and t["chunks"] == j["chunks"]
            assert t["d2h_bytes"] == 0
            assert set(t["buckets"]) == set(j["buckets"]) == {"float32"}
            tb, jb = t["buckets"]["float32"], j["buckets"]["float32"]
            assert set(tb) == set(jb) and tb["bytes"] == jb["bytes"]
            assert len(t["stripe_s"]) >= 1 and all(s > 0 for s in t["stripe_s"])
        finally:
            for c in cols:
                c.shutdown()

    def test_stats_are_bounded_and_drained(self, store):
        cols = _mixed(store, "bound")
        try:
            port = cols[1]
            for _ in range(300):
                port._record_op_stats({"op": "x"})
            assert len(port.pop_op_stats()) == 256
            assert port.pop_op_stats() == []
        finally:
            for c in cols:
                c.shutdown()


# ---- the Manager: observe_op_stats -> signals -> push_status ----


def _status_entry(lighthouse_addr, replica_id):
    url = lighthouse_addr.rstrip("/") + "/status.json"
    with urllib.request.urlopen(url, timeout=5) as r:
        members = json.load(r)["members"]
    return next((m for m in members if m["replica_id"] == replica_id), None)


def test_signals_and_status_through_manager(monkeypatch):
    import torchft_tpu_torch as tft

    monkeypatch.setenv("TORCHFT_HOST", "sighost")
    lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=100)
    results, errors = {}, []
    barrier = threading.Barrier(2)

    def replica(idx):
        store = tnative.Store()
        hc = tcol.HostCollectives(timeout=_T)
        box = {"params": 0}
        manager = None
        try:
            manager = tft.Manager(
                collectives=hc, load_state_dict=lambda s: box.update(s),
                state_dict=lambda: dict(box), min_replica_size=2, rank=0,
                world_size=1, store_addr=store.address(),
                lighthouse_addr=lighthouse.address(), replica_id=f"sig{idx}",
                timeout=_T, quorum_timeout=_T, connect_timeout=_T,
                device="cpu",
            )
            barrier.wait(timeout=20)
            assert manager.signals()["wire_eff_MBps"] is None
            for hier in (False, True):
                manager.start_quorum()
                manager.plan_allreduce(
                    {"g": torch.full((50_000,), float(idx))}, hier=hier).wait()
                assert manager.should_commit()
            entries = manager.observe_op_stats()
            sig = manager.signals()
            manager.report_opt_state_bytes(1234)
            manager.push_status({"strategy": "plan_hier"})
            entry = None
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                entry = _status_entry(lighthouse.address(),
                                      manager._replica_id)
                if entry is not None and "status" in entry:
                    break
                time.sleep(0.05)
            results[idx] = {"entries": entries, "signals": sig,
                            "entry": entry}
        except Exception as e:  # noqa: BLE001
            errors.append((idx, e))
        finally:
            if manager is not None:
                manager.shutdown()
            hc.shutdown()
            store.shutdown()

    threads = [threading.Thread(target=replica, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    lighthouse.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for idx, r in results.items():
        assert [st.get("hier", False) for st in r["entries"]] == [False, True]
        sig = r["signals"]
        assert sig["wire_eff_MBps"] > 0
        assert sig["tier_eff_MBps"]["host"] > 0
        assert sig["churn_per_min"] == 0
        # group 1's first quorum healed it from group 0 (the init sync)
        assert (sig["heal"] is None) == (idx == 0)
        if idx == 1:
            assert sig["heal"]["fetch_s"]["n"] == 1
        status = r["entry"]["status"]
        assert status["step"] == 2 and status["commits"] == 2
        assert status["strategy"] == "plan_hier"
        assert status["opt_state_bytes"] == 1234
        # (the lighthouse keeps a digest's floats to three decimals)
        assert status["wire_eff_MBps"] == pytest.approx(
            sig["wire_eff_MBps"], abs=1e-3)
