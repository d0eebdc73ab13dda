"""The port's ``profiling.py`` against the reference's, on the CPU.

- The capture window: both ``Profiler`` classes pass through the same
  states on the same ``on_step`` sequence (late starts included).
- The spans: one solo replica group of each package runs the same steps
  (quorum, reconfigure, plan allreduce, commit vote). The ``torchft::``
  span names the port's windowed ``torch.profiler`` capture wrote into
  its chrome trace equal the names the JAX Manager opened, and the two
  Managers' metric summaries (timer and counter keys) are the same.
"""

import json
import os
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401
import torchft_tpu as jft
import torchft_tpu_torch as tft
from torchft_tpu import manager as jmanager
from torchft_tpu import profiling as jprof
from torchft_tpu_torch import profiling as tprof

_T = timedelta(seconds=20)
STEPS = 2


@pytest.mark.parametrize("start,num,calls", [
    (2, 2, [0, 1, 2, 3, 4, 5]),
    (10, 5, [100, 101, 104, 105, 106]),  # a late start still gets its window
])
def test_window_states_match_reference(tmp_path, start, num, calls):
    states = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        prof = mod.Profiler(str(tmp_path / name), start_step=start,
                            num_steps=num)
        seen = [prof.state]
        for step in calls:
            prof.on_step(step)
            seen.append(prof.state)
        prof.shutdown()
        states[name] = seen + [prof.state]
    assert states["port"] == states["jax"]


def _steps(manager, tree):
    for _ in range(STEPS):
        manager.start_quorum()
        manager.plan_allreduce(tree).wait()
        assert manager.should_commit()


def test_span_names_and_summary_match_reference(tmp_path, monkeypatch):
    opened = []
    real_span = jmanager.span

    def recording_span(name):
        opened.append(name)
        return real_span(name)

    monkeypatch.setattr(jmanager, "span", recording_span)
    tree = {"g": np.ones(64, np.float32)}
    summaries = {}

    lighthouse = jft.Lighthouse(min_replicas=1, join_timeout_ms=50)
    hc = jft.HostCollectives(timeout=_T)
    manager = jft.Manager(
        collectives=hc, load_state_dict=None, state_dict=None,
        min_replica_size=1, rank=0, world_size=1,
        lighthouse_addr=lighthouse.address(), replica_id="jprof", timeout=_T,
    )
    try:
        _steps(manager, tree)
        summaries["jax"] = manager.metrics().snapshot()
    finally:
        manager.shutdown()
        hc.shutdown()
        lighthouse.shutdown()

    logdir = str(tmp_path / "port_trace")
    monkeypatch.setenv("TORCHFT_PROFILE_DIR", logdir)
    monkeypatch.setenv("TORCHFT_PROFILE_START", "0")
    monkeypatch.setenv("TORCHFT_PROFILE_STEPS", str(STEPS + 1))
    lighthouse = tft.Lighthouse(min_replicas=1, join_timeout_ms=50)
    hc = tft.HostCollectives(timeout=_T)
    manager = tft.Manager(
        collectives=hc, load_state_dict=None, state_dict=None,
        min_replica_size=1, rank=0, world_size=1,
        lighthouse_addr=lighthouse.address(), replica_id="tprof", timeout=_T,
        device="cpu",
    )
    try:
        _steps(manager, {"g": torch.ones(64)})
        summaries["port"] = manager.metrics().snapshot()
    finally:
        manager.shutdown()  # flushes the capture
        hc.shutdown()
        lighthouse.shutdown()

    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    traced = {e["name"] for e in events
              if str(e.get("name", "")).startswith("torchft::")}
    assert traced == set(opened) == {
        "torchft::quorum", "torchft::reconfigure",
        "torchft::plan_allreduce_dispatch", "torchft::commit_vote"}
    for part in ("counters", "timers_s"):
        assert set(summaries["port"][part]) == set(summaries["jax"][part]), part
    for name, t in summaries["port"]["timers_s"].items():
        assert set(t) == set(summaries["jax"]["timers_s"][name])
        assert t["n"] == summaries["jax"]["timers_s"][name]["n"]


def test_step_span_lands_in_the_windowed_trace(tmp_path):
    """``step_span`` inside the port's windowed capture: the trace the
    Profiler writes holds one ``torchft_step`` span per annotated step,
    the JAX package's step annotation name; outside a capture both
    packages' ``step_span`` are plain context managers."""
    with jprof.step_span(3), tprof.step_span(3):
        torch.ones(4).sum()
    logdir = str(tmp_path / "steps")
    prof = tprof.Profiler(logdir, start_step=1, num_steps=2)
    for step in range(4):
        prof.on_step(step)
        with tprof.step_span(step):
            torch.ones(64).sum()
    prof.shutdown()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name") == "torchft_step"]
    assert len(steps) == 2  # steps 1 and 2: the window
