"""The port Manager's caller-supplied options against the JAX package's.

- ``should_commit(count_batches=False)``: a solo group of each package
  runs the same commit pattern; step, ``batches_committed``, the commit
  hooks' calls and a caller's ``profiler`` (its ``on_step`` steps and its
  shutdown) are the same in both.
- ``checkpoint_transport=``: group A trains alone, group B joins with a
  fresh state under the sync quorum; in both packages the caller's
  transport carries the heal (A sends once, B receives once, at the same
  step) and B starts its first step from A's state.

Every wait has its own timeout (the quorum's, the threads' joins).
"""

import threading
from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import torch

import torch_one_thread  # noqa: F401

import torchft_tpu as jft
from torchft_tpu import checkpointing as jck
from torchft_tpu import collectives as jcol
import torchft_tpu_torch as tft
from torchft_tpu_torch import checkpointing as tck
from torchft_tpu_torch import collectives as tcol

_T = timedelta(seconds=20)
COMMIT_PATTERN = [True, False, True, False, False, True]


class _RecordingProfiler:
    """Duck-typed profiler: the steps ``on_step`` saw, and its shutdown."""

    def __init__(self):
        self.steps, self.shut = [], 0

    def on_step(self, step):
        self.steps.append(step)

    def shutdown(self):
        self.shut += 1


def _recording(base):
    """``base`` (a package's CheckpointServer) recording every send and
    receive it is asked for, with its step."""

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []

        def send_checkpoint(self, dst_ranks, step, state_dict, timeout, **kw):
            self.calls.append(("send", step))
            return super().send_checkpoint(dst_ranks, step, state_dict,
                                           timeout, **kw)

        def recv_checkpoint(self, src_rank, metadata, step, timeout):
            self.calls.append(("recv", step))
            return super().recv_checkpoint(src_rank, metadata, step, timeout)

    return Recording


def _pkg(pkg):
    if pkg == "jax":
        return jft, jcol, {}
    return tft, tcol, {"device": "cpu"}


def _commit_pattern(pkg):
    m, col_mod, kw = _pkg(pkg)
    lighthouse = m.Lighthouse(min_replicas=1, join_timeout_ms=50)
    col = col_mod.HostCollectives(timeout=_T)
    prof = _RecordingProfiler()
    manager = m.Manager(
        collectives=col, load_state_dict=None, state_dict=None,
        min_replica_size=1, rank=0, world_size=1, timeout=_T,
        quorum_timeout=_T, lighthouse_addr=lighthouse.address(),
        replica_id=f"opts_{pkg}", profiler=prof, **kw)
    hooks, seen = [], []
    manager.add_commit_hook(lambda *a: hooks.append(a))
    try:
        for count in COMMIT_PATTERN:
            manager.start_quorum()
            ok = manager.should_commit(count_batches=count)
            seen.append((ok, manager.current_step(),
                         manager.batches_committed()))
    finally:
        manager.shutdown()
        col.shutdown()
        lighthouse.shutdown()
    return {"seen": seen, "hooks": hooks, "profiled": prof.steps,
            "profiler_shutdowns": prof.shut}


def test_count_batches_hooks_and_profiler_match_the_jax_package():
    port, ref = _commit_pattern("port"), _commit_pattern("jax")
    assert port == ref
    # a control transaction advances the step, not the batch count
    assert port["seen"][-1] == (True, 6, 3)
    assert [h[0] for h in port["hooks"]] == [1, 2, 3, 4, 5, 6]
    assert port["profiled"] == [0, 1, 2, 3, 4, 5]
    assert port["profiler_shutdowns"] == 1


def _heal_scenario(pkg):
    """A trains alone, B joins with a fresh state; both Managers take a
    caller's recording transport. Returns each group's transport calls,
    B's state at the start of its first step and A's at that step."""
    m, col_mod, kw = _pkg(pkg)
    ck = jck if pkg == "jax" else tck
    lighthouse = m.Lighthouse(min_replicas=1, join_timeout_ms=300,
                              quorum_tick_ms=50, heartbeat_timeout_ms=2000)
    joined = threading.Event()
    out, errors = {}, []

    def group(name, late):
        store = m.Store()
        col = col_mod.HostCollectives(timeout=_T)
        transport = _recording(ck.CheckpointServer)(timeout=_T, **kw)
        state = {"w": np.zeros(4, np.float32)}

        def load(sd):
            state["w"] = np.array(np.asarray(sd["w"]), np.float32)

        manager = m.Manager(
            collectives=col, load_state_dict=load,
            state_dict=lambda: {"w": state["w"].copy()}, min_replica_size=1,
            rank=0, world_size=1, use_async_quorum=False, timeout=_T,
            quorum_timeout=_T, store_addr=store.address(),
            lighthouse_addr=lighthouse.address(), replica_id=name,
            checkpoint_transport=transport, **kw)
        starts = {}
        try:
            assert manager.checkpoint_transport() is transport
            joint = 0
            for step in range(40):
                manager.start_quorum()
                starts.setdefault(manager.current_step(), float(state["w"][0]))
                n = manager.num_participants()
                # the step's allreduce holds the donor until the healer,
                # its fetch done, joins the ring
                ones = np.ones(4, np.float32)
                manager.allreduce({"x": jnp.asarray(ones) if pkg == "jax"
                                   else torch.from_numpy(ones)}).wait()
                if manager.should_commit():
                    state["w"] = state["w"] + 1.0
                if not late and step == 2:
                    joined.set()
                joint += n == 2
                if joint >= 2:
                    break
            out[name] = {"calls": list(transport.calls), "starts": starts,
                         "first": min(starts) if late else None}
        finally:
            manager.shutdown()
            col.shutdown()
            store.shutdown()

    def run(name, late):
        try:
            if late:
                assert joined.wait(60)
            group(name, late)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=run, args=a)
          for a in (("a", False), ("b", True))]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]
    return out


def _heal_summary(got):
    (kind_a, step_a), = got["a"]["calls"]
    (kind_b, step_b), = got["b"]["calls"]
    # B's first step starts at the healed step, from A's state there
    first = got["b"]["first"]
    return {"a": kind_a, "b": kind_b, "same_step": step_a == step_b == first,
            "b_start_is_a_state": got["b"]["starts"][first]
            == got["a"]["starts"][first] == float(first)}


def test_caller_transport_carries_the_heal_as_in_the_jax_package():
    port = _heal_summary(_heal_scenario("port"))
    assert port == _heal_summary(_heal_scenario("jax"))
    assert port == {"a": "send", "b": "recv", "same_step": True,
                    "b_start_is_a_state": True}
