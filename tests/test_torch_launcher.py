"""The port's launcher, standby gate and lighthouse command line.

- ``replica_group_spec`` is the JAX package's spec without its JAX
  compilation-cache entry and the isolated data plane's knobs;
  ``_can_lift_priority`` gives the JAX package's
  verdicts on the same inputs.
- ``launch`` restarts a failed group, promotes a hot spare parked at the
  port's ``standby_gate`` (at the supervisor's own priority when it
  cannot lift a niced child), and with ``regions=2`` hands each group a
  region lighthouse of its own, the root set and a region label.
- ``python -m torchft_tpu_torch.lighthouse`` serves the flat, durable
  root, standby and region roles.
- The standby warm-up: ``FTTrainState.warm`` leaves the live state
  untouched; ``HostCollectives.prewarm`` builds the q8ef device packer
  the first ``plan_allreduce`` reuses, bit-identical to a cold ring.
"""

import os
import subprocess
import sys
import time

import pytest

import torchft_tpu.launcher as jlauncher
import torchft_tpu_torch.launcher as launcher
from torchft_tpu_torch import _native
from torchft_tpu_torch.chaos import free_port
from torchft_tpu_torch.lighthouse import fetch_quorum, fetch_status

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("iso_env", [False, True])
def test_spec_is_the_jax_spec_without_its_cache_key(monkeypatch, iso_env):
    # the JAX spec also forwards the isolated data plane's knobs; the port
    # has no such plane yet, so its spec leaves them out
    iso_knobs = ("TORCHFT_ISO_ZYGOTE", "TORCHFT_ISO_LIVENESS_MS")
    if iso_env:
        monkeypatch.setenv("TORCHFT_ISO_ZYGOTE", "1")
        monkeypatch.setenv("TORCHFT_ISO_LIVENESS_MS", "500")
    args = (["python", "x.py"], 1, 4, "http://lh:1")
    kw = {"env": {"EXTRA": "1"}, "max_restarts": 3}
    port = launcher.replica_group_spec(*args, **kw)
    ref = jlauncher.replica_group_spec(*args, **kw)
    ref["env"].pop("TORCHFT_COMPILE_CACHE")
    for knob in iso_knobs:
        assert (knob in ref["env"]) is iso_env
        ref["env"].pop(knob, None)
    assert port == ref
    assert port["env"]["REPLICA_GROUP_ID"] == "1"


@pytest.mark.parametrize("status,rlimit", [
    ("Name:\tx\nCapEff:\t0000000000800000\n", 0),
    ("Name:\tx\nCapEff:\t0000000000000000\n", 0),
    ("Name:\tx\nCapEff:\t0000000000000000\n", 20),
    ("Name:\tx\nCapEff:\t0000000000000000\n", 19),
    ("Name:\tx\nCapEff:\t0000000000000000\n", -1),
    ("Name:\tx\n", 0),
])
def test_can_lift_priority_matches_the_jax_probe(status, rlimit):
    assert (launcher._can_lift_priority(status_text=status, rlimit_nice=rlimit)
            == jlauncher._can_lift_priority(status_text=status,
                                            rlimit_nice=rlimit))


def test_supervised_standby_warm_marker(tmp_path):
    s = launcher._Supervised(spec={"name": "g0"})
    assert s.standby_warm() is False
    s.standby_file = str(tmp_path / "gate")
    assert s.standby_warm() is False
    (tmp_path / "gate.warm").write_text("")
    assert s.standby_warm() is True


def _script(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(f"import os, sys\nsys.path.insert(0, {REPO!r})\n"
                    "d = os.path.dirname(os.path.abspath(__file__))\n" + body)
    return [sys.executable, str(path)]


def test_launch_restarts_a_failed_group(tmp_path):
    cmd = _script(tmp_path, "flaky.py",
                  "marker = os.path.join(d, 'marker_' + "
                  "os.environ['REPLICA_GROUP_ID'])\n"
                  "if not os.path.exists(marker):\n"
                  "    open(marker, 'w').close()\n"
                  "    sys.exit(1)\n")
    assert launcher.launch(cmd, num_replica_groups=2,
                           lighthouse_addr="http://unused:1",
                           max_restarts=2) == 0
    assert (tmp_path / "marker_0").exists() and (tmp_path / "marker_1").exists()


def test_launch_gives_up_after_max_restarts(tmp_path):
    cmd = _script(tmp_path, "fail.py", "sys.exit(3)\n")
    assert launcher.launch(cmd, num_replica_groups=1,
                           lighthouse_addr="http://unused:1",
                           max_restarts=1) == 1


_SPARE = (
    "from torchft_tpu_torch.platform import standby_gate\n"
    "if os.environ.get('TORCHFT_STANDBY_FILE'):\n"
    "    nice = os.nice(0)\n"
    "    standby_gate()\n"
    "    with open(os.path.join(d, 'promoted'), 'w') as f:\n"
    "        f.write(str(nice))\n"
    "    sys.exit(0)\n"
    "if not os.path.exists(os.path.join(d, 'died')):\n"
    "    open(os.path.join(d, 'died'), 'w').close()\n"
    "    sys.exit(1)\n"
)


@pytest.mark.parametrize("lift_ok", [True, False])
def test_launch_promotes_the_hot_spare(tmp_path, monkeypatch, lift_ok):
    """The dead primary is replaced by promoting the standby parked at the
    port's gate (only a standby writes ``promoted``); a supervisor that
    cannot lift a niced child lets the standby warm at its own priority."""
    if not lift_ok:
        monkeypatch.setattr(launcher, "_can_lift_priority", lambda: False)
    cmd = _script(tmp_path, "spare.py", _SPARE)
    assert launcher.launch(cmd, num_replica_groups=1,
                           lighthouse_addr="http://unused:1",
                           max_restarts=2, hot_spare=True) == 0
    assert (tmp_path / "died").exists()
    nice = int((tmp_path / "promoted").read_text())
    if not lift_ok:
        assert nice == os.nice(0)


def test_launch_with_two_regions(tmp_path):
    """Each group gets a region lighthouse of the launcher's tier (round
    robin), the root failover set and its region label; the regions are
    live and aggregate into the root."""
    root = _native.Lighthouse(min_replicas=1, join_timeout_ms=100)
    standby = _native.Lighthouse(min_replicas=1, join_timeout_ms=100,
                                 peers=root.address(), standby=True,
                                 takeover_ms=60000)
    roots = f"{root.address()},{standby.address()}"
    cmd = _script(
        tmp_path, "region.py",
        "from torchft_tpu_torch.lighthouse import fetch_status\n"
        "st = fetch_status(os.environ['TORCHFT_LIGHTHOUSE'])\n"
        "g = os.environ['REPLICA_GROUP_ID']\n"
        "with open(os.path.join(d, 'env_' + g), 'w') as f:\n"
        "    f.write('\\n'.join([os.environ['TORCHFT_LIGHTHOUSE'],\n"
        "        os.environ['TORCHFT_LIGHTHOUSE_ROOT'],\n"
        "        os.environ['TORCHFT_REGION'], st['role']]))\n")
    try:
        assert launcher.launch(cmd, num_replica_groups=4,
                               lighthouse_addr=root.address(),
                               max_restarts=0, regions=2,
                               root_addrs=roots) == 0
    finally:
        standby.shutdown()
        root.shutdown()
    rows = [(tmp_path / f"env_{g}").read_text().split("\n") for g in range(4)]
    assert {r[1] for r in rows} == {roots}
    assert [r[2] for r in rows] == ["region_0", "region_1"] * 2
    assert rows[0][0] == rows[2][0] != rows[1][0] == rows[3][0]
    assert all(r[0] != root.address() for r in rows)


def _serve(args):
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.lighthouse",
         "--bind", f"[::]:{port}", "--min_replicas", "1", *args],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    addr = f"http://localhost:{port}"
    deadline = time.monotonic() + 30
    while True:
        try:
            return proc, addr, fetch_status(addr, timeout=1.0)
        except OSError:
            assert proc.poll() is None, f"{args} exited {proc.returncode}"
            assert time.monotonic() < deadline, f"{args} never served"
            time.sleep(0.1)


def test_lighthouse_command_line_roles(tmp_path):
    procs = []
    try:
        p, flat, st = _serve([])
        procs.append(p)
        assert st["role"] == "flat" and st["wal_enabled"] is False
        p, root, st = _serve(["--role", "root", "--wal-dir",
                              str(tmp_path / "wal")])
        procs.append(p)
        assert st["wal_enabled"] is True and st["active"] is True
        assert st["root_epoch"] == 1
        p, standby, st = _serve(["--role", "root", "--standby", "--peers",
                                 root, "--takeover-ms", "60000"])
        procs.append(p)
        assert st["role"] == "standby" and st["active"] is False
        p, region, st = _serve(["--role", "region", "--root", root,
                                "--region-id", "ra",
                                "--digest-interval-ms", "50"])
        procs.append(p)
        assert st["role"] == "region"
        assert "age_ms" in fetch_quorum(region)
        c = _native.LeaseClient(region)
        c.renew([{"replica_id": "g0", "ttl_ms": 60000, "participating": True,
                  "member": {"replica_id": "g0", "address": "a",
                             "store_address": "s", "step": 1,
                             "world_size": 1, "shrink_only": False,
                             "force_reconfigure": False}}])
        deadline = time.monotonic() + 20
        while fetch_status(root)["quorum_id"] < 1:
            assert time.monotonic() < deadline, fetch_status(root)
            time.sleep(0.1)
        assert [r["region_id"] for r in fetch_status(root)["regions"]] == ["ra"]
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=10)


def test_region_role_needs_a_root():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "TORCHFT_LIGHTHOUSE_ROOT")}
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.lighthouse", "--role",
         "region"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 2 and "requires --root" in proc.stderr


# -- the standby warm-up ---------------------------------------------------------


def test_train_state_warm_leaves_the_live_state_untouched():
    import torch

    import torchft_tpu_torch as tft

    params = {"w": torch.randn(8, 4), "b": torch.randn(4)}
    state = tft.FTTrainState(params, tft.AdamW(1e-2, weight_decay=0.1))
    before = {k: v.clone() for k, v in params.items()}
    count = state.opt_state.get("count")
    state.warm({k: torch.empty_like(v) for k, v in params.items()})
    for k in params:
        assert torch.equal(params[k], before[k])
        assert not torch.any(state.opt_state["mu"][k])
    assert state.opt_state.get("count") == count


def test_prewarm_builds_the_packer_the_first_step_reuses():
    """A standby's prewarm runs the q8ef device pack once on zeros (no
    ring: it is not configured yet); the promoted member's first
    plan_allreduce reuses that packer and is bit-identical to a ring whose
    members never prewarmed."""
    import threading
    from datetime import timedelta

    import numpy as np
    import torch

    from torchft_tpu_torch import collectives as tcol

    grads = [{"a": torch.from_numpy(np.random.default_rng(r).standard_normal(
        (64, 3)).astype(np.float32)), "b": torch.full((5,), 0.5 + r)}
        for r in range(2)]
    store = _native.Store()
    outs = {}
    try:
        for warm in (False, True):
            cols = [tcol.HostCollectives(timeout=timedelta(seconds=10))
                    for _ in range(2)]
            if warm:
                cols[1].prewarm({k: torch.zeros_like(v)
                                 for k, v in grads[1].items()})
                assert len(cols[1]._dev_packers) == 1
                (packer,) = cols[1]._dev_packers.values()
                assert not torch.any(packer._carry)
            ts = [threading.Thread(target=c.configure,
                                   args=(f"{store.address()}/pw{warm}", r, 2))
                  for r, c in enumerate(cols)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            res = [None, None]

            def run(r):
                res[r] = cols[r].plan_allreduce(
                    grads[r], tcol.ReduceOp.AVG, wire="q8ef",
                    device_pack=True).wait()

            ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            if warm:
                assert list(cols[1]._dev_packers.values()) == [packer]
            outs[warm] = [{k: v.numpy().tobytes() for k, v in r.items()}
                          for r in res]
            for c in cols:
                c.shutdown()
    finally:
        store.shutdown()
    assert outs[True] == outs[False]
    assert outs[True][0] == outs[True][1]
