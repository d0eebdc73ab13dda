"""``bench_churn_torch.py``, the port's throughput-under-kills harness,
held against ``bench_churn.py`` (imported, not edited) on the CPU.

- The pure helpers (``_read_log``, ``_committed``, ``_steps_per_sec``,
  ``compute_heal_stats``, ``HEAL_PHASES``) give the JAX tool's results on
  the record sets of ``tests/test_bench_helpers.py`` (a cold restart, a
  promoted standby, a repeat kill inside one window, a boot record from
  before the backend/model split), written to a log with a torn line.
- One worker step at the tool's config: the same parameters on both
  sides (``params_from_jax`` of the JAX ``init_params``) and group 1's
  tokens from ``default_rng(1)``. Loss and gradients within F6 (rtol
  1e-5 / atol 1e-6) of jitted JAX with the matmuls in f32 on both sides
  (XLA's and torch's bf16 matmuls round differently on the CPU, which is
  the transformer tests' business); at the tool's own bf16 the loss
  within 2^-7 relative. One AdamW update of the same gradients within
  F6 of ``optax.adamw(1e-3)``.
- ``run_durable_phase(device="cpu")`` at 65,536 elements and 2
  checkpoints against the JAX tool's at the same size: equal byte
  counts, committed and restored steps, the bit-identity and scaling
  verdicts and the record's keys; the restored ``w`` within F6 of the
  JAX fleet's. The K3 launches ``chip_smoke.py`` requires of that run on
  the card are the durable captures' ``cast_bf16_group`` calls.
- ``chip_smoke.py``'s churn phase rehearsed on the CPU.
- The script as a user runs it (one torch thread a group, the runs
  started together): ``--durable --dryrun --device cpu`` and ``--dryrun
  --device cpu`` exit 0 with their metric at 1; without a card and
  without ``--device cpu`` it exits 2 naming the missing card.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch_one_thread  # noqa: E402,F401

import bench_churn  # noqa: E402
import bench_churn_torch as bct  # noqa: E402
from torchft_tpu.models import transformer as jt  # noqa: E402
from torchft_tpu_torch._tree import flatten  # noqa: E402
from torchft_tpu_torch.models import params_from_jax  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # F6: the port against jitted JAX
DRYRUN_TIMEOUT_S = 240
DURABLE_ELEMS = 65_536


# ---- the script as a user runs it -------------------------------------------

RUNS = {
    "churn dryrun": ["bench_churn_torch.py", "--dryrun", "--device", "cpu"],
    "durable dryrun": ["bench_churn_torch.py", "--durable", "--dryrun",
                       "--device", "cpu"],
    "refusal churn": ["bench_churn_torch.py", "--dryrun"],
    "refusal durable": ["bench_churn_torch.py", "--durable", "--dryrun"],
}


@pytest.fixture(scope="module")
def launched():
    """The file's script runs, started together: ``{name: proc}``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    runs = {name: subprocess.Popen(
        [sys.executable, *argv], cwd=REPO,
        env={**env, "OMP_NUM_THREADS": "1"}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, argv in RUNS.items()}
    yield runs
    for proc in runs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _finish(launched, name, timeout=DRYRUN_TIMEOUT_S):
    proc = launched[name]
    stdout, stderr = proc.communicate(timeout=timeout)
    return proc.returncode, stdout, stderr


def _metric(stdout: str) -> dict:
    lines = [l for l in stdout.splitlines() if l.startswith('{"metric"')]
    assert lines, stdout
    return json.loads(lines[-1])


def test_churn_dryrun_on_the_cpu(launched):
    rc, out, err = _finish(launched, "churn dryrun")
    assert rc == 0, err[-3000:]
    m = _metric(out)
    assert m["metric"] == "churn_dryrun_ok" and m["value"] == 1, m
    assert m["stream_heals"] >= 1
    assert m["heal_p50_s"] is not None and m["heal_p50_hot_s"] is not None


def test_durable_dryrun_on_the_cpu(launched):
    rc, out, err = _finish(launched, "durable dryrun")
    assert rc == 0, err[-3000:]
    m = _metric(out)
    assert m["metric"] == "durable_dryrun_ok" and m["value"] == 1, m
    assert m["restored_step"] == 2


@pytest.mark.parametrize("name", ["refusal churn", "refusal durable"])
def test_refuses_without_a_card(launched, name):
    rc, out, err = _finish(launched, name)
    assert rc == bct.EXIT_NO_CARD == 2
    assert "no CUDA device" in err and "--device cpu" in err
    assert '"metric"' not in out


# ---- the pure helpers -------------------------------------------------------


def _boot(kill_t, cold=True):
    """tests/test_bench_helpers.py's synthetic boot record."""
    if cold:
        spawn = kill_t + 0.25
        return {"spawn_t": spawn, "enter_t": spawn + 1.0,
                "setup_t": spawn + 2.0, "backend_t": spawn + 2.5,
                "model_t": spawn + 2.8, "compiled_t": spawn + 3.3,
                "activated_t": spawn + 3.3, "manager_t": spawn + 3.5}
    spawn = kill_t - 60.0
    return {"spawn_t": spawn, "enter_t": spawn + 1.0, "setup_t": spawn + 2.0,
            "backend_t": spawn + 2.5, "model_t": spawn + 2.8,
            "compiled_t": spawn + 3.3, "activated_t": kill_t + 0.3,
            "manager_t": kill_t + 0.5}


def _steps(t0, n, dt, step0=0):
    return [{"t": t0 + i * dt, "step": step0 + i + 1, "committed": True,
             "participants": 2, "ms": {"grad": 1.0}} for i in range(n)]


def _old_boot(kill_t):
    b = _boot(kill_t)
    del b["backend_t"], b["model_t"]
    return b


# (kills, {gid: records}) of each case of tests/test_bench_helpers.py,
# with steps around them
CASES = {
    "cold restart": (
        [{"t": 100.0, "gid": 1, "at_step": 10}],
        {0: _steps(90.0, 30, 0.5),
         1: _steps(90.0, 8, 0.5) + [
             {"boot": _boot(100.0)},
             {"heal": {"t": 104.0, "path": "stream", "fetch_s": 0.4,
                       "h2d_s": 0.05, "wire": None, "streams": 4}},
             {"t": 104.5, "step": 30, "committed": True},
             {"t": 104.9, "step": 31, "committed": False}]
         + _steps(105.0, 6, 0.5, 31)}),
    "promoted standby": (
        [{"t": 200.0, "gid": 2, "at_step": 20}],
        {0: _steps(195.0, 20, 0.25),
         2: [{"boot": _boot(200.0, cold=False)},
             {"t": 201.2, "step": 21, "committed": True}]}),
    "repeat kill": (
        [{"t": 100.0, "gid": 1, "at_step": 10},
         {"t": 102.0, "gid": 1, "at_step": 10}],
        {1: [{"boot": _boot(102.0)},
             {"t": 106.1, "step": 12, "committed": True}]}),
    "old boot records": (
        [{"t": 50.0, "gid": 3, "at_step": 5}],
        {3: [{"boot": _old_boot(50.0)},
             {"t": 55.0, "step": 6, "committed": True}]}),
}


def _write_log(path, records) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
        f.write('{"t": 1e9, "step": 99, "comm')  # a torn last write


@pytest.mark.parametrize("case", sorted(CASES))
def test_helpers_match_bench_churn(case, tmp_path):
    kills, logs = CASES[case]
    assert bct.HEAL_PHASES == bench_churn.HEAL_PHASES
    read = {}
    for gid, records in logs.items():
        path = str(tmp_path / f"g{gid}.jsonl")
        _write_log(path, records)
        read[gid] = bct._read_log(path)
        assert read[gid] == bench_churn._read_log(path) == records
        assert bct._committed(read[gid]) == bench_churn._committed(records)
        for skip in (0, 5):
            assert bct._steps_per_sec(read[gid], skip) == \
                bench_churn._steps_per_sec(records, skip)
    missing = str(tmp_path / "absent.jsonl")
    assert bct._read_log(missing) == bench_churn._read_log(missing) == []
    got = bct.compute_heal_stats(kills, read)
    want = bench_churn.compute_heal_stats(kills, logs)
    assert got == want
    assert got[0], "every case has a heal"


# ---- one worker step --------------------------------------------------------


def _jax_cfg(dtype=None):
    cfg = jt.TransformerConfig(vocab_size=2048, d_model=128, n_heads=4,
                               n_layers=2, d_ff=256, max_seq_len=64)
    if dtype is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg


def _close(a, b, rtol=RTOL, atol=ATOL) -> None:
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("group", [0, 1])
def test_worker_step_matches_jitted_jax(group):
    """The worker's config and tokens are the JAX tool's; from the same
    params its f32 loss and gradients are within F6 of jitted JAX, and
    one AdamW update of the same gradients within F6 of optax's."""
    jcfg = _jax_cfg(jnp.float32)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    cfg, batch, state, grad_fn = bct._model(
        group, "cpu", params=params_from_jax(jax.device_get(jparams), "cpu"),
        dtype=torch.float32)
    for field in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
                  "max_seq_len"):
        assert getattr(cfg, field) == getattr(jcfg, field)
    rng = np.random.default_rng(group)
    jbatch = jnp.asarray(rng.integers(0, jcfg.vocab_size, size=(4, 64),
                                      dtype=np.int32))
    assert batch.dtype == torch.int64
    assert np.array_equal(batch.numpy(), np.asarray(jbatch))

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(jcfg, p, b)))(jparams, jbatch)
    loss, grads = grad_fn(state.params, batch)
    _close(float(jloss), float(loss))
    jleaves, jdef = jax.tree_util.tree_flatten(jgrads)
    leaves, _ = flatten(grads)
    assert len(leaves) == len(jleaves)
    for want, got in zip(jleaves, leaves):
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(want, got.numpy())

    # one update of the same gradients (the JAX ones) on both sides
    tx = optax.adamw(1e-3)
    updates, _ = tx.update(jgrads, tx.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)
    state.apply_gradients(jax.tree_util.tree_unflatten(
        jdef, [torch.from_numpy(np.asarray(g).copy()) for g in jleaves]))
    for want, got in zip(jax.tree_util.tree_leaves(jnew),
                         flatten(state.params)[0]):
        _close(want, got.detach().numpy())


def test_worker_loss_at_the_tools_bf16():
    """At the tool's own bf16 matmuls the loss is within 2^-7 relative
    of jitted JAX's (the packages' bf16 products round apart)."""
    jcfg = _jax_cfg()
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    cfg, batch, state, grad_fn = bct._model(
        1, "cpu", params=params_from_jax(jax.device_get(jparams), "cpu"))
    assert cfg.dtype == torch.bfloat16
    jloss = jax.jit(lambda p, b: jt.loss_fn(jcfg, p, b))(
        jparams, jnp.asarray(batch.numpy().astype(np.int32)))
    loss, _ = grad_fn(state.params, batch)
    _close(float(jloss), float(loss), rtol=2.0 ** -7, atol=0)


# ---- the durable phase ------------------------------------------------------


def test_durable_phase_matches_bench_churn(monkeypatch):
    """The same sizes through both tools' durable phase: the record's
    keys, its byte counts, steps and verdicts agree; the restored ``w``
    of every member within F6 of the JAX fleet's."""
    import torchft_tpu.durable as jdur

    jax_restored = []

    class _Recording(jdur.DurableCheckpointer):
        def restore_latest(self, *args, **kw):
            step = super().restore_latest(*args, **kw)
            jax_restored.append(np.asarray(self._state.params["w"]))
            return step

    monkeypatch.setattr(jdur, "DurableCheckpointer", _Recording)
    want = bench_churn.run_durable_phase(n_elems=DURABLE_ELEMS, checkpoints=2)
    states = {}
    got = bct.run_durable_phase(n_elems=DURABLE_ELEMS, checkpoints=2,
                                device="cpu", states=states)

    assert set(got) == set(want)
    for key in ("config", "sync_baseline", "async_sharded",
                "durable_restore"):
        assert set(got[key]) == set(want[key]), key
    assert got["config"] == want["config"]
    assert got["config"]["total_bytes"] == 8 * DURABLE_ELEMS
    assert got["sync_baseline"]["durable_bytes_per_member"] == \
        want["sync_baseline"]["durable_bytes_per_member"]
    for key in ("shard_bytes", "committed_steps", "flushed", "world",
                "zero_copy"):
        assert got["async_sharded"][key] == want["async_sharded"][key], key
    for key in ("restored_step", "bytes", "members_bit_identical",
                "world_old", "world_new"):
        assert got["durable_restore"][key] == want["durable_restore"][key], \
            key
    assert got["durable_restore"]["members_bit_identical"] is True
    assert got["shard_scaling_ok"] is want["shard_scaling_ok"] is True
    assert got["durable_restore"]["restored_step"] == 2
    for key in ("manifest_read_s", "shard_fetch_s", "reshard_s", "h2d_s",
                "compile_s"):
        assert got["durable_restore"][key] is not None

    assert len(jax_restored) == len(states["restored"]) == 2
    for jw, st in zip(jax_restored, states["restored"]):
        _close(jw, st["params"]["w"].numpy())
    # the saved moments came back through the bf16 wire
    saved = states["saved"]["opt_state"]["m"]
    back = states["restored"][0]["opt_state"]["m"]
    assert torch.equal(back, saved.to(torch.bfloat16).to(torch.float32))


@pytest.mark.parametrize("checkpoints,world_old", [(2, 3), (4, 3), (2, 4)])
def test_durable_k3_count_is_the_smokes(monkeypatch, checkpoints, world_old):
    """The K3 launches ``chip_smoke.py`` requires of the in-process durable
    run on the card (``durable_k3_launches``) are the ``cast_bf16_group``
    calls the durable captures make: one call is one launch there (at
    most 64 leaves), here the plain version runs."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from torchft_tpu_torch import checkpointing as ck

    calls = []
    real = ck.cast_bf16_group

    def counting(leaves, out):
        calls.append(sum(l.numel() for l in leaves))
        return real(leaves, out)

    monkeypatch.setattr(ck, "cast_bf16_group", counting)
    bct.run_durable_phase(n_elems=DURABLE_ELEMS, checkpoints=checkpoints,
                          world_old=world_old, device="cpu")
    assert all(calls)
    assert len(calls) == cs.durable_k3_launches(DURABLE_ELEMS, checkpoints,
                                                world_old)


def test_smoke_churn_phase_on_the_cpu(launched):
    """chip_smoke.py's churn phase on the CPU: the dryrun on the bf16 heal
    wire, the in-process durable run held against its saved state and
    ``--durable --dryrun``. It runs after the file's own dryrun, whose
    logs share the directory."""
    _finish(launched, "churn dryrun")
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    res = cs.phase_churn(device="cpu", durable_elems=DURABLE_ELEMS)
    summ = cs.check_churn(res, on_card=False)
    for phase in ("churn", "churn_hot"):
        assert summ["heals"][phase]["stream_bf16"] >= 1
    assert summ["durable_k3_expected"] == 3 * cs.CHURN_DURABLE_CHECKPOINTS
    assert summ["launches"] == summ["durable_launches"] == {}
