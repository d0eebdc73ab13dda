"""The port's durable control plane against the JAX package's.

- The pure entry points (lease, depart, quorum tick, quorum compute,
  digests, quorum results, backoff and jitter) return the same JSON from
  both bindings on one scripted history.
- A WAL written through one package's ``WalLog`` recovers to the same
  state and watermark through the other's ``wal_recover``.
- A port root with a WAL replays its ``quorum_id`` after a restart; a
  port standby root takes over with the watermark and the leases.
- A region tier of one JAX and one port ``RegionLighthouse`` under a port
  root carries a JAX group and a port group that commit bit-identical
  averages.
- A region's death demotes a port manager to the root
  (``using_root_fallback()``), and ``region_probe_max`` gives up.

Every wait has its own deadline.
"""

import dataclasses
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import torchft_tpu as jft
from torchft_tpu import _native as jn
import torchft_tpu_torch as tft
from torchft_tpu_torch import _native as tn

_T = timedelta(seconds=20)

EMPTY = {"participants": {}, "heartbeats": {}, "lease_ttls": {},
         "prev_quorum": None, "quorum_id": 0}
OPT = {"min_replicas": 1, "join_timeout_ms": 0, "quorum_tick_ms": 10,
       "heartbeat_timeout_ms": 200}


def member(rid, step=1):
    return {"replica_id": rid, "address": f"addr_{rid}",
            "store_address": f"store_{rid}", "step": step, "world_size": 1,
            "shrink_only": False, "force_reconfigure": False}


def entry(rid, ttl_ms=1000, participating=True, step=1):
    return {"replica_id": rid, "ttl_ms": ttl_ms,
            "participating": participating, "member": member(rid, step)}


def wal_entry(rid, age_ms=0):
    return {"replica_id": rid, "age_ms": age_ms, "ttl_ms": 60000,
            "participating": True, "joined_age_ms": 0, "member": member(rid)}


def wait_until(pred, deadline_s=10.0, msg="condition"):
    deadline = time.monotonic() + deadline_s
    while True:
        v = pred()
        if v:
            return v
        assert time.monotonic() < deadline, f"timed out waiting for {msg}"
        time.sleep(0.05)


def _history(n):
    """One scripted history through a binding's pure entry points: every
    intermediate result, in order."""
    out = []
    s = n.lease_apply(EMPTY, [entry("a"), entry("b"), entry("c", 500, False)], 0)
    out.append(s)
    r = n.quorum_step(10, 10, s, OPT)
    out.append(r)
    out.append(dataclasses.asdict(n.compute_quorum_results("b", 0, r["quorum"])))
    s = n.lease_apply(r["state"], [entry("a", step=2)], 600)
    out.append(n.quorum_compute(1100, s, OPT))
    r2 = n.quorum_step(1100, 1100, s, OPT)
    out.append(r2)
    out.append(n.depart_apply(r2["state"], "a"))
    digest = n.digest_make(r["state"], 400, OPT)
    out.append(digest)
    out.append(n.digest_apply(EMPTY, digest, 450))
    out.append(n.quorum_step(460, 460, n.digest_apply(EMPTY, digest, 450), OPT))
    out.append([n.backoff_ms(f, 100, 5000, seed)
                for f in range(10) for seed in (0, 1, 7, 2**63 + 5)])
    out.append([n.jittered_interval_ms(100, seed, t)
                for seed in (0, 7) for t in range(8)])
    return out


def test_pure_entry_points_match_jax():
    port, ref = _history(tn), _history(jn)
    assert len(port) == len(ref)
    for i, (p, j) in enumerate(zip(port, ref)):
        assert p == j, f"result {i} differs"
    # the history formed quorums (it exercised more than the empty path)
    assert port[1]["quorum"]["quorum_id"] == 1
    assert port[4]["changed"]


def _write_wal(n, d):
    w = n.WalLog(d)
    w.log_epoch(1)
    w.log_lease([wal_entry("g0"), wal_entry("g1")], unix_ms=5000)
    w.log_quorum({"quorum_id": 1, "created_ms": 5000,
                  "participants": [member("g0"), member("g1")]},
                 quorum_gen=1, root_epoch=1)
    w.log_lease([wal_entry("g0")], unix_ms=5100)
    w.log_depart("g1")
    w.log_quorum({"quorum_id": 2, "created_ms": 5100,
                  "participants": [member("g0")]}, quorum_gen=2, root_epoch=1)
    w.snapshot(
        {"quorum_id": 2, "participants": {"g0": {"joined_ms": 4900,
                                                 "member": member("g0")}},
         "heartbeats": {"g0": 5100}, "lease_ttls": {"g0": 60000},
         "prev_quorum": {"quorum_id": 2, "created_ms": 5100,
                         "participants": [member("g0")]}},
        quorum_gen=2, root_epoch=1, mono_now=5150, unix_now=5150)
    w.log_lease([wal_entry("g0"), wal_entry("g2")], unix_ms=5200)
    w.log_quorum({"quorum_id": 3, "created_ms": 5200,
                  "participants": [member("g0"), member("g2")]},
                 quorum_gen=3, root_epoch=1)
    w.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wal_written_by_one_package_recovers_in_the_other(tmp_path, writer):
    w_mod, r_mod = (tn, jn) if writer == "port" else (jn, tn)
    d = str(tmp_path / "wal")
    _write_wal(w_mod, d)
    rec = r_mod.wal_recover(d, 6000, 6000)
    assert rec == w_mod.wal_recover(d, 6000, 6000)
    assert rec["replayed"] and rec["dropped_tail_bytes"] == 0
    assert rec["state"]["quorum_id"] == 3 and rec["quorum_gen"] == 3
    assert rec["root_epoch"] == 1
    assert sorted(rec["state"]["heartbeats"]) == ["g0", "g2"]


def test_port_root_replays_quorum_id_after_restart(tmp_path):
    d = str(tmp_path / "wal")
    lh = tn.Lighthouse(min_replicas=1, join_timeout_ms=100, wal_dir=d)
    c = tn.LeaseClient(lh.address())
    c.renew([entry("gA", 60000), entry("gB", 60000)])
    wait_until(lambda: lh.status_json()["quorum_id"] >= 1, msg="quorum")
    c.depart("gB")
    wait_until(lambda: all(m["replica_id"] != "gB"
                           for m in lh.status_json()["members"]),
               msg="depart applied")
    qid, epoch = lh.status_json()["quorum_id"], lh.root_epoch()
    assert lh.active() and epoch == 1
    lh.shutdown()
    del lh, c

    lh2 = tn.Lighthouse(min_replicas=1, join_timeout_ms=100, wal_dir=d)
    try:
        st = lh2.status_json()
        assert st["wal_replayed"] is True
        assert st["root_epoch"] == epoch + 1 == lh2.root_epoch()
        assert st["quorum_id"] == qid
        members = {m["replica_id"]: m for m in st["members"]}
        assert members["gA"]["lease_remaining_ms"] > 0 and "gB" not in members
        c2 = tn.LeaseClient(lh2.address())
        c2.renew([entry("gA", 60000), entry("gD", 60000)])
        wait_until(lambda: lh2.status_json()["quorum_id"] > qid,
                   msg="post-replay quorum")
    finally:
        lh2.shutdown()


def test_port_standby_root_takes_over(tmp_path):
    primary = tn.Lighthouse(min_replicas=1, join_timeout_ms=100,
                            wal_dir=str(tmp_path / "p"))
    standby = tn.Lighthouse(min_replicas=1, join_timeout_ms=100,
                            wal_dir=str(tmp_path / "s"),
                            peers=primary.address(), standby=True,
                            takeover_ms=800)
    try:
        assert primary.active() and not standby.active()
        assert standby.status_json()["role"] == "standby"
        c = tn.LeaseClient(primary.address())
        c.renew([entry("gA", 60000), entry("gB", 60000)])
        wait_until(lambda: primary.status_json()["quorum_id"] >= 1,
                   msg="primary quorum")
        qid = primary.status_json()["quorum_id"]
        wait_until(lambda: standby.status_json()["quorum_id"] >= qid,
                   deadline_s=3, msg="standby mirror")
        primary.shutdown()
        wait_until(standby.active, msg="takeover")
        st = standby.status_json()
        assert st["quorum_id"] >= qid and st["root_epoch"] == 2
        members = {m["replica_id"]: m for m in st["members"]}
        assert members["gA"]["lease_remaining_ms"] > 0
        c2 = tn.LeaseClient(standby.address())
        c2.renew([entry("gA", 60000), entry("gB", 60000), entry("gC", 60000)])
        wait_until(lambda: standby.status_json()["quorum_id"] > qid,
                   msg="post-takeover quorum")
    finally:
        standby.shutdown()
        primary.shutdown()


_STEPS = 3


def _values(g, step):
    rng = np.random.default_rng(100 * g + step)
    return rng.standard_normal(257).astype(np.float32)


def _member(pkg, g, lighthouse, root_lh, out, errors, **kw):
    """One single-rank group of ``pkg`` averaging ``_values`` for
    ``_STEPS`` committed steps; records each average's bytes. The first
    quorum waits until the root holds both members' leases (a quorum
    asked for earlier forms without the other member)."""
    try:
        m = jft if pkg == "jax" else tft
        extra = {} if pkg == "jax" else {"device": "cpu"}
        col = m.HostCollectives(timeout=_T)
        manager = m.Manager(
            collectives=col, load_state_dict=lambda sd: None,
            state_dict=lambda: {}, min_replica_size=2, timeout=_T,
            quorum_timeout=_T, connect_timeout=_T, rank=0, world_size=1,
            use_async_quorum=False, lighthouse_addr=lighthouse, lighthouse_root_addr=root_lh.address(),
            replica_id=f"{pkg}{g}",
            heartbeat_interval=timedelta(milliseconds=50), **extra, **kw)
        try:
            wait_until(lambda: len(root_lh.status_json()["members"]) >= 2, 20,
                       "both leases at the root")
            res = []
            while manager.current_step() < _STEPS:
                manager.start_quorum()
                x = _values(g, manager.current_step())
                tree = {"w": x if pkg == "jax" else torch.from_numpy(x)}
                avg = manager.allreduce(tree).wait()
                if manager.should_commit():
                    res.append((manager.quorum_id(),
                                np.asarray(avg["w"]).tobytes()))
            out[g] = res
        finally:
            manager.shutdown()
            col.shutdown()
    except Exception as e:  # noqa: BLE001 - surfaced by the caller
        errors.append(e)


def test_region_tier_carries_a_mixed_cohort_bit_identical():
    root = tn.Lighthouse(min_replicas=1, join_timeout_ms=200)
    r_jax = jn.RegionLighthouse(root.address(), "ra", digest_interval_ms=50)
    r_port = tn.RegionLighthouse(root.address(), "rb", digest_interval_ms=50)
    out, errors = {}, []
    try:
        threads = [
            threading.Thread(target=_member, args=(
                "jax", 0, r_jax.address(), root, out, errors)),
            threading.Thread(target=_member, args=(
                "port", 1, r_port.address(), root, out, errors)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors, errors
        assert len(out[0]) == len(out[1]) == _STEPS
        for (q0, a), (q1, b) in zip(out[0], out[1]):
            assert q0 == q1 and a == b
        assert [q for q, _ in out[0]] == sorted(q for q, _ in out[0])
        # the average is of both members' values
        want = (_values(0, 0) + _values(1, 0)) / np.float32(2)
        np.testing.assert_allclose(np.frombuffer(out[0][0][1], np.float32),
                                   want, rtol=1e-6)
        st = root.status_json()
        assert {r["region_id"] for r in st["regions"]} >= {"ra", "rb"}
    finally:
        r_jax.shutdown()
        r_port.shutdown()
        root.shutdown()


def test_region_death_demotes_a_port_manager(monkeypatch):
    """The port Manager's options reach the native manager: a dead region
    demotes it to the root (quorums keep forming there)."""
    root = tn.Lighthouse(min_replicas=1, join_timeout_ms=200,
                         quorum_tick_ms=50)
    region = tn.RegionLighthouse(root.address(), "ra", digest_interval_ms=50)
    monkeypatch.setenv("TORCHFT_LIGHTHOUSE_ROOT", root.address())
    monkeypatch.setenv("TORCHFT_LEASE_TTL_MS", "300")
    monkeypatch.setenv("TORCHFT_REGION_PROBE_MAX", "3")
    col = tft.HostCollectives(timeout=_T)
    manager = tft.Manager(
        collectives=col, load_state_dict=lambda sd: None,
        state_dict=lambda: {}, min_replica_size=1, timeout=_T,
        quorum_timeout=_T, connect_timeout=_T, rank=0, world_size=1,
        lighthouse_addr=region.address(), replica_id="demoted",
        heartbeat_interval=timedelta(milliseconds=50), device="cpu")
    try:
        native = manager._manager
        manager.start_quorum()
        manager.wait_quorum()
        assert manager.should_commit()
        assert not native.using_root_fallback()
        region.shutdown()
        wait_until(native.using_root_fallback, 10, "demotion")
        wait_until(native.region_probe_given_up, 15, "probe give-up")
        qid = manager.quorum_id()
        manager.start_quorum()
        manager.wait_quorum()
        assert manager.should_commit() and manager.quorum_id() >= qid
    finally:
        manager.shutdown()
        col.shutdown()
        root.shutdown()


def test_region_probe_max_zero_probes_forever():
    root = tn.Lighthouse(min_replicas=1, join_timeout_ms=200)
    ra = tn.RegionLighthouse(root.address(), "ra", digest_interval_ms=50)
    ra_port = int(ra.address().rsplit(":", 1)[1])
    store = tn.Store()
    m = tn.Manager(
        "repF", ra.address(), "localhost", "[::]:0", store.address(), 1,
        heartbeat_interval=timedelta(milliseconds=50),
        root_addr=root.address(), lease_ttl=timedelta(milliseconds=300),
        region_probe_max=0)
    try:
        ra.shutdown()
        wait_until(m.using_root_fallback, 10, "demotion")
        time.sleep(1.5)  # more failed probes than any small bound
        assert not m.region_probe_given_up()
        ra2 = tn.RegionLighthouse(root.address(), "ra",
                                  bind=f"[::]:{ra_port}",
                                  digest_interval_ms=50)
        try:
            wait_until(lambda: not m.using_root_fallback(), 10, "drift back")
        finally:
            ra2.shutdown()
    finally:
        m.shutdown()
        root.shutdown()
        store.shutdown()


def test_manager_rotates_past_a_standby_root():
    primary = tn.Lighthouse(min_replicas=1, join_timeout_ms=200)
    standby = tn.Lighthouse(min_replicas=1, join_timeout_ms=200,
                            peers=primary.address(), standby=True,
                            takeover_ms=60000)
    store = tn.Store()
    m = tn.Manager("repL", f"{standby.address()},{primary.address()}",
                   "localhost", "[::]:0", store.address(), 1,
                   heartbeat_interval=timedelta(milliseconds=50))
    client = tn.ManagerClient(m.address())
    try:
        res = client.quorum(0, 1, "ck", timeout=_T)
        assert res.replica_world_size == 1 and res.quorum_id >= 1
    finally:
        m.shutdown()
        standby.shutdown()
        primary.shutdown()
        store.shutdown()
