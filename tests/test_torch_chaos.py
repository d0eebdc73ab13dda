"""The port's chaos plane against the JAX package's, and F7's remainder.

- ``FaultPlan.random`` JSON, ``fingerprint`` and ``native_rules`` are byte
  for byte the JAX package's over several seeds and configurations;
  ``splitmix64`` is the native backoff mixer; ``FaultyStoreClient`` makes
  the JAX package's seeded decisions; ``bench_fault_stamp`` stamps alike.
- The port's fault engine arms, disarms, and with ``permille`` 0 never
  fires; ``ChaosInjector`` arms it per step and dispatches Python seams.
- F7: with ``TORCHFT_WIRE_CRC=1`` a ``ring_send`` ``bit_flip`` armed
  through the port's ``fault_arm`` raises ``WireCorruption`` on a port
  ring, and on a mixed ring when the port member sends the frame; with
  CRC off the flip commits silently.
- Stall verdicts: a ``ProcessStall``-ed root is alive but answers
  nothing until SIGCONT; a killed one is dead.
- ``HealFaultProxy`` in front of the port's ``CheckpointServer``: every
  fault mode falls back off the stream path with the bytes exact.
"""

import threading
import time
import urllib.parse
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import torchft_tpu.chaos as jchaos
from torchft_tpu import _native as jn
from torchft_tpu import collectives as jcol
import torchft_tpu_torch.chaos as chaos
from torchft_tpu_torch import _native as tn
from torchft_tpu_torch import checkpointing as ck
from torchft_tpu_torch import collectives as tcol

_T = timedelta(seconds=10)


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    tn.fault_disarm()
    jn.fault_disarm()


@pytest.fixture
def store():
    s = tn.Store()
    yield s
    s.shutdown()


_PLANS = [
    dict(seed=0, steps=4, members=2),
    dict(seed=7, steps=10, members=3, seams=("ring_send", "net_send")),
    dict(seed=1234, steps=12, members=4,
         seams=("ring_send", "ring_hdr", "store", "heal", "child"),
         events_target=9, max_delay_ms=50),
    dict(seed=2**40 + 3, steps=6, members=2,
         seams=("root", "serving", "lighthouse", "wal_write", "shm_ring"),
         events_target=5),
    dict(seed=99, steps=2, members=0, events_target=1),
]


@pytest.mark.parametrize("kw", _PLANS)
def test_fault_plan_is_the_jax_plan_byte_for_byte(kw):
    port, ref = chaos.FaultPlan.random(**kw), jchaos.FaultPlan.random(**kw)
    assert port.to_json() == ref.to_json()
    assert port.fingerprint() == ref.fingerprint()
    for step in range(kw["steps"]):
        assert port.native_rules(step) == ref.native_rules(step)
        assert port.events_at(step, 1) == [
            chaos.FaultEvent(**vars(e)) for e in ref.events_at(step, 1)]
    assert chaos.FaultPlan.from_json(ref.to_json()) == port


def test_fault_plan_needs_two_steps():
    with pytest.raises(ValueError, match=">= 2 steps"):
        chaos.FaultPlan.random(1, steps=1, members=2)


def test_splitmix64_is_the_native_mixer():
    assert chaos.splitmix64(0) == 0xE220A8397B1DCDAF
    xs = [0, 1, 2**63, 2**64 - 1] + list(range(3, 300, 7))
    assert [chaos.splitmix64(x) for x in xs] == [jchaos.splitmix64(x)
                                                 for x in xs]


def test_faulty_store_client_makes_the_jax_decisions(store):
    def drive(mod, client_cls):
        fs = mod.FaultyStoreClient(client_cls(store.address()), seed=5,
                                   drop_permille=200, delay_permille=100,
                                   stale_permille=200, delay_ms=1)
        for i in range(40):
            try:
                fs.set(f"k{i % 3}", f"v{i}".encode())
                fs.get(f"k{i % 3}")
            except TimeoutError:
                pass
        return fs.fired

    assert drive(chaos, tn.StoreClient) == drive(jchaos, jn.StoreClient)


def test_bench_fault_stamp_matches(monkeypatch):
    plan = chaos.FaultPlan.random(3, steps=4, members=2)
    jplan = jchaos.FaultPlan.random(3, steps=4, members=2)
    assert (chaos.bench_fault_stamp(plan=plan, kill_every=9)
            == jchaos.bench_fault_stamp(plan=jplan, kill_every=9))
    monkeypatch.setenv("TORCHFT_CHAOS_SEED", "77")
    monkeypatch.delenv("TORCHFT_CHAOS_PLAN", raising=False)
    assert chaos.bench_fault_stamp()["seed"] == 77
    monkeypatch.setenv("TORCHFT_CHAOS_SEED", "x7")
    assert chaos.bench_fault_stamp()["seed_parse_error"] is True


def _ring(store, prefix, crc, kinds=("port", "port")):
    mods = {"port": tcol, "jax": jcol}
    cols = [mods[k].HostCollectives(timeout=_T, stripes=1, wire_crc=crc)
            for k in kinds]
    threads = [threading.Thread(target=c.configure,
                                args=(f"{store.address()}/{prefix}", r,
                                      len(cols)))
               for r, c in enumerate(cols)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return cols


def _allreduce_all(cols, n=2048):
    out, errs = [None] * len(cols), [None] * len(cols)

    def run(r, c):
        x = np.ones(n, np.float32)
        try:
            tree = {"w": torch.from_numpy(x) if isinstance(
                c, tcol.HostCollectives) else x}
            out[r] = np.asarray(c.allreduce(tree).wait()["w"])
        except Exception as e:  # noqa: BLE001 - the errors are the data
            errs[r] = e

    threads = [threading.Thread(target=run, args=rc) for rc in enumerate(cols)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return out, errs


def test_fault_engine_arm_disarm_states():
    assert not tn.fault_armed()
    tn.fault_arm({"seed": 1, "rules": [{"seam": "ring_send", "kind": "drop"}]})
    assert tn.fault_armed() and not jn.fault_armed()  # one engine per library
    tn.fault_arm({"seed": 1, "rules": []})
    assert not tn.fault_armed()  # empty rules = disarmed
    tn.fault_disarm()
    assert tn.fault_stats()["fired_total"] == 0
    with pytest.raises(RuntimeError, match="unknown seam"):
        tn.fault_arm({"seed": 1, "rules": [{"seam": "nope", "kind": "drop"}]})


def test_permille_zero_never_fires(store):
    cols = _ring(store, "pz", crc=True)
    try:
        tn.fault_arm({"seed": 3, "rules": [
            {"seam": "ring_send", "kind": "bit_flip", "permille": 0}]})
        out, errs = _allreduce_all(cols)
        assert errs == [None, None]
        assert tn.fault_stats()["fired_total"] == 0
        assert out[0].tobytes() == out[1].tobytes()
    finally:
        for c in cols:
            c.shutdown()


_FLIP = {"seed": 42, "rules": [{"seam": "ring_send", "kind": "bit_flip",
                                "member": 1, "max_fires": 1}]}


@pytest.mark.parametrize("kinds", [("port", "port"), ("jax", "port")])
def test_bit_flip_raises_wire_corruption_with_crc(store, kinds):
    """F7: the flip is armed in the port's engine on the sending port
    member (rank 1); the CRC trailer catches it as the typed error."""
    cols = _ring(store, f"bf_{kinds[0]}", crc=True, kinds=kinds)
    try:
        tn.fault_arm(_FLIP)
        out, errs = _allreduce_all(cols)
        assert tn.fault_stats()["fired"].get("ring_send:bit_flip") == 1
        assert jn.fault_stats()["fired_total"] == 0
        typed = (tn.WireCorruption, jn.WireCorruption)
        assert any(isinstance(e, typed) for e in errs if e), errs
    finally:
        for c in cols:
            c.shutdown()


def test_bit_flip_silent_without_crc(store):
    cols = _ring(store, "bfoff", crc=False)
    try:
        tn.fault_arm(_FLIP)
        out, errs = _allreduce_all(cols)
        assert errs == [None, None]
        assert tn.fault_stats()["fired"].get("ring_send:bit_flip") == 1
        assert (out[0].tobytes() != out[1].tobytes()
                or not np.all(out[0] == 2.0))
    finally:
        for c in cols:
            c.shutdown()


def test_injector_arms_per_step_and_dispatches_python_seams(store):
    plan = chaos.FaultPlan(seed=9, events=(
        chaos.FaultEvent(1, "ring_send", "bit_flip", 0),
        chaos.FaultEvent(1, "store", "drop", 1),
        chaos.FaultEvent(2, "store", "delay", 0, 5),
    ))
    seen = []
    inj = chaos.ChaosInjector(plan).on("store", seen.append)
    with pytest.raises(ValueError):
        inj.on("ring_send", seen.append)
    inj.begin_step(0)
    assert not tn.fault_armed()
    inj.begin_step(1, member=1)
    assert tn.fault_armed() and [e.kind for e in seen] == ["drop"]
    inj.begin_step(2, member=1)
    assert not tn.fault_armed()
    stats = inj.finish()
    assert not tn.fault_armed()
    assert [e["kind"] for e in stats["python_fired"]] == ["drop"]
    assert stats["fired_total"] == 0


def test_stall_and_kill_verdicts(tmp_path):
    root = chaos.RootProcess(chaos.free_port(), wal_dir=str(tmp_path / "w"),
                             join_timeout_ms=100)
    try:
        assert root.wait_serving()["active"] is True
        stall = root.partition(1.5)
        time.sleep(0.2)
        # stalled, not dead: the process lives and answers nothing
        assert root.proc.poll() is None and root.status(timeout=0.5) is None
        stall.join(10)
        assert root.wait_serving(10)["root_epoch"] == 1
        root.restart()
        st = root.wait_serving()
        assert st["wal_replayed"] is True and st["root_epoch"] == 2
        root.kill()
        assert root.proc.poll() is not None and root.status(0.5) is None
    finally:
        root.stop()


@pytest.fixture
def server():
    s = ck.CheckpointServer(timeout=_T, device="cpu")
    yield s
    s.shutdown()


@pytest.mark.parametrize("mode", ["truncate_body", "reset_mid_range",
                                  "bit_flip", "error_500"])
def test_heal_proxy_before_the_port_server_falls_back(server, mode):
    state = {"params": {"w": torch.arange(65536, dtype=torch.float32)}}
    server.send_checkpoint([1], 3, state, _T)
    parts = urllib.parse.urlparse(server.address())
    proxy = chaos.HealFaultProxy(f"{parts.scheme}://{parts.netloc}",
                                 mode=mode, only_paths=("/stream/",),
                                 max_faults=1)
    try:
        out, stats = ck.CheckpointServer._fetch(
            proxy.address() + parts.path + "3", _T, device="cpu", streams=2)
        assert proxy.faults_fired == 1
        assert stats["path"] != "stream"
        assert torch.equal(torch.as_tensor(out["params"]["w"]),
                           state["params"]["w"])
        proxy.mode = None  # transparent: the stream path again
        out, stats = ck.CheckpointServer._fetch(
            proxy.address() + parts.path + "3", _T, device="cpu", streams=2)
        assert stats["path"] == "stream"
    finally:
        proxy.shutdown()


def test_tear_shm_is_idempotent():
    chaos.tear_shm("/tft_chaos_no_such_segment")
    chaos.tear_shm("/tft_chaos_no_such_segment")
