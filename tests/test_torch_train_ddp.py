"""The quickstart trainer of the port (``examples/train_ddp_torch.py``)
held against the JAX package's (``examples/train_ddp.py``), both loaded
as modules in one process on the CPU.

- Data: both trainers' datasets are bit-identical (the synthetic blobs,
  the token streams, the CNN's images, CIFAR-10 from pickle batches this
  test writes, scikit-learn's digits where it is installed).
- Losses: each ``MODEL``'s loss on one batch, from the JAX trainer's
  initial params carried across. The MLP computes in f32 and agrees to
  rtol 1e-6 (summation order only); lm, moe and cnn run their matmuls in
  bf16, whose 8-bit mantissa and a different rounding order part them by
  up to ~1.2e-4 relative here, held to rtol 1e-3. A wrong configuration
  that keeps every leaf's shape can stay inside that (n_heads 2 in place
  of the moe's 4 moves its loss by 1.8e-4), so each leaf's gradient is
  held too, as ``|g_port - g_jax| / |g_jax|`` (Frobenius norms): mlp
  1e-5 (observed 1.0e-7), lm 0.05 (observed 0.012 at the worst leaf),
  moe 0.2 (0.091: its router's top-2 choice flips for a few tokens under
  bf16), cnn 0.05 (0.0057). n_heads 2 or 8 in place of 4, or the moe's
  router_k 1 in place of 2, puts the worst leaf at 0.89-1.14.
- The slice as a whole: a one-group, 20-step run of each trainer's
  ``main()`` from the same carried MLP params, each against its own
  in-process lighthouse. The JAX trainer's gradient step is jitted, so
  XLA contracts products into FMAs (ROADMAP Queue 3, F6): the per-step
  losses agree to rtol 1e-5 and the final params to atol 1e-6 (observed:
  1.5e-7 relative and 6e-8; a step's AdamW update moves a param by up to
  lr = 1e-3, so a sign flip in one step's direction would show).
- Kill and heal: two port trainers as processes, group 1 SIGKILLed
  mid-run and restarted cold; both end at ``NUM_STEPS`` with equal
  ``batches_committed``, the restart healed from its peer on the stream
  path, and the final params are bit-identical on the f32 heal wire.
- Without a card and without ``DEVICE=cpu`` the trainer raises.
"""

import importlib.util
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torchft_tpu._native as jax_native  # noqa: E402
import torchft_tpu_torch._native as port_native  # noqa: E402
from torchft_tpu_torch.models import cnn as tcnn  # noqa: E402
from torchft_tpu_torch.models import params_from_jax as lm_params_from_jax  # noqa: E402

JAX_TRAINER = os.path.join(REPO, "examples", "train_ddp.py")
PORT_TRAINER = os.path.join(REPO, "examples", "train_ddp_torch.py")
RECORDER = os.path.join(REPO, "scripts", "train_record_torch.py")
MODELS = ("mlp", "lm", "moe", "cnn")
LOSS_RTOL = {"mlp": 1e-6, "lm": 1e-3, "moe": 1e-3, "cnn": 1e-3}
GRAD_RTOL = {"mlp": 1e-5, "lm": 0.05, "moe": 0.2, "cnn": 0.05}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trainers():
    return _load("train_ddp_jax", JAX_TRAINER), _load("train_ddp_port", PORT_TRAINER)


@pytest.fixture(scope="module")
def built(trainers):
    """Each MODEL's (JAX, port) ``build_model()`` results on synthetic
    data, built once for the module's tests."""
    jt, pt = trainers
    cache = {}

    def get(model):
        if model not in cache:
            with pytest.MonkeyPatch.context() as m:
                m.setenv("MODEL", model)
                m.setenv("DATA", "synthetic")
                cache[model] = (jt.build_model(), pt.build_model("cpu"))
        return cache[model]

    return get


def _carry(port, model, jax_params):
    """The JAX trainer's params as the port's, on the CPU."""
    np_params = jax.tree_util.tree_map(np.asarray, jax_params)
    if model == "mlp":
        return port.params_from_jax(np_params, "cpu")
    if model == "cnn":
        return tcnn.params_from_jax(np_params, "cpu")
    return lm_params_from_jax(np_params, "cpu")  # lm, moe


class TestData:
    def test_synthetic_dataset_bit_identical(self, trainers):
        jt, pt = trainers
        jx, jy = jt.make_synthetic_dataset()
        px, py = pt.make_synthetic_dataset()
        assert jx.dtype == px.dtype and jy.dtype == py.dtype
        assert jx.tobytes() == px.tobytes() and jy.tobytes() == py.tobytes()

    @pytest.mark.parametrize("model", MODELS)
    def test_model_data_bit_identical(self, built, model):
        (_, _, jx, jy), (_, _, px, py) = built(model)
        assert (jx.dtype, jx.shape) == (px.dtype, px.shape)
        assert jx.tobytes() == px.tobytes() and jy.tobytes() == py.tobytes()

    def test_synthetic_image_data_is_none(self, trainers, monkeypatch):
        jt, pt = trainers
        monkeypatch.setenv("DATA", "synthetic")
        assert jt.make_image_dataset() is None and pt.make_image_dataset() is None

    def test_cifar10_pickles_bit_identical(self, trainers, tmp_path, monkeypatch):
        jt, pt = trainers
        rng = np.random.default_rng(3)
        for i in range(1, 6):
            batch = {b"data": rng.integers(0, 256, (7, 3072), dtype=np.uint8),
                     b"labels": [int(v) for v in rng.integers(0, 10, 7)]}
            with open(tmp_path / f"data_batch_{i}", "wb") as f:
                pickle.dump(batch, f)
        monkeypatch.setenv("DATA", "cifar10")
        monkeypatch.setenv("CIFAR_DIR", str(tmp_path))
        jx, jy, jmeta = jt.make_image_dataset()
        px, py, pmeta = pt.make_image_dataset()
        assert jmeta == pmeta == (32, 3, 10)
        assert px.shape == (35, 32, 32, 3) and px.dtype == np.float32
        assert jx.tobytes() == px.tobytes() and jy.tobytes() == py.tobytes()
        # MODEL=cnn builds the CIFAR config from them in both trainers
        monkeypatch.setenv("MODEL", "cnn")
        jparams, jloss, bx, by = jt.build_model()
        _, ploss, _, _ = pt.build_model("cpu")
        got = float(ploss(_carry(pt, "cnn", jparams), torch.as_tensor(bx[:8]),
                          torch.as_tensor(by[:8])))
        want = float(jloss(jparams, jnp.asarray(bx[:8]), jnp.asarray(by[:8])))
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL["cnn"])

    def test_cifar10_missing_raises_the_same(self, trainers, tmp_path, monkeypatch):
        jt, pt = trainers
        monkeypatch.setenv("DATA", "cifar10")
        monkeypatch.setenv("CIFAR_DIR", str(tmp_path))
        with pytest.raises(FileNotFoundError) as je:
            jt.make_image_dataset()
        with pytest.raises(FileNotFoundError) as pe:
            pt.make_image_dataset()
        assert str(je.value) == str(pe.value)

    def test_digits_bit_identical(self, trainers, monkeypatch):
        pytest.importorskip("sklearn")
        jt, pt = trainers
        monkeypatch.setenv("DATA", "digits")
        jx, jy, jmeta = jt.make_image_dataset()
        px, py, pmeta = pt.make_image_dataset()
        assert jmeta == pmeta == (8, 1, 10)
        assert jx.tobytes() == px.tobytes() and jy.tobytes() == py.tobytes()


class TestLosses:
    @pytest.mark.parametrize("model", MODELS)
    def test_loss_from_carried_params(self, trainers, built, model):
        _, pt = trainers
        (jparams, jloss, x, y), (pparams, ploss, _, _) = built(model)
        carried = _carry(pt, model, jparams)
        # same tree, same leaf shapes
        from torchft_tpu_torch._tree import flatten

        assert [tuple(l.shape) for l in flatten(carried)[0]] == [
            tuple(l.shape) for l in flatten(pparams)[0]]
        xb, yb = x[:64], y[:64]
        want = float(jloss(jparams, jnp.asarray(xb), jnp.asarray(yb)))
        got = float(ploss(carried, torch.as_tensor(xb), torch.as_tensor(yb)))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL[model])

    @pytest.mark.parametrize("model", MODELS)
    def test_grads_from_carried_params(self, trainers, built, model):
        _, pt = trainers
        (jparams, jloss, x, y), (_, ploss, _, _) = built(model)
        carried = _carry(pt, model, jparams)
        xb, yb = x[:64], y[:64]
        want = jax.tree_util.tree_leaves(
            jax.grad(jloss)(jparams, jnp.asarray(xb), jnp.asarray(yb)))
        _, grads = pt.value_and_grad(ploss)(carried, torch.as_tensor(xb),
                                            torch.as_tensor(yb))
        from torchft_tpu_torch._tree import flatten

        got = flatten(grads)[0]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
            assert rel <= GRAD_RTOL[model], (model, g.shape, rel)

    def test_mlp_init_is_seeded_with_jax_scales(self, trainers):
        _, pt = trainers
        a, b = pt.init_params(device="cpu"), pt.init_params(device="cpu")
        for k in a:
            assert torch.equal(a[k], b[k])
        assert abs(float(a["w1"].std()) - 32 ** -0.5) < 0.02
        assert abs(float(a["w2"].std()) - 0.1) < 0.01
        assert float(a["b1"].abs().sum()) == 0.0


def _run_main(module, monkeypatch, env, build_model):
    """Runs ``module.main()`` with ``build_model`` patched and the
    FTTrainState it builds recorded."""
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    states = []

    class Recording(module.FTTrainState):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            states.append(self)

    monkeypatch.setattr(module, "FTTrainState", Recording)
    monkeypatch.setattr(module, "build_model", build_model)
    module.main()
    return states[-1]


class TestTrajectory:
    def test_twenty_steps_match_the_jax_trainer(self, trainers, built,
                                                monkeypatch):
        jt, pt = trainers
        (jparams, jloss, x, y), _ = built("mlp")
        # host copies first: the JAX trainer's state donates its buffers
        np_params = jax.tree_util.tree_map(np.array, jparams)
        env = {"REPLICA_GROUP_ID": 0, "NUM_REPLICA_GROUPS": 1, "NUM_STEPS": 20,
               "DEVICE": "cpu"}
        jlosses, plosses = [], []

        def jax_build():
            def loss(params, xb, yb):
                value = jloss(params, xb, yb)
                jax.debug.callback(lambda v: jlosses.append(float(v)), value)
                return value

            return jax.tree_util.tree_map(jnp.asarray, np_params), loss, x, y

        def port_build(device=None):
            def loss(params, xb, yb):
                value = pt.loss_fn(params, xb, yb)
                plosses.append(float(value.detach()))
                return value

            return _carry(pt, "mlp", np_params), loss, x, y

        jlh = jax_native.Lighthouse(bind="[::]:0", min_replicas=1)
        try:
            jstate = _run_main(jt, monkeypatch, {
                **env, "TORCHFT_LIGHTHOUSE": jlh.address()}, jax_build)
        finally:
            jlh.shutdown()
        plh = port_native.Lighthouse(bind="[::]:0", min_replicas=1)
        try:
            pstate = _run_main(pt, monkeypatch, {
                **env, "TORCHFT_LIGHTHOUSE": plh.address()}, port_build)
        finally:
            plh.shutdown()
        # the warm-up's forward/backward, then one per step
        assert len(jlosses) == len(plosses) == 21
        np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
        assert plosses[-1] < plosses[1]  # it trains
        got = {k: v.numpy() for k, v in pstate.params.items()}
        for k, want in jstate.params.items():
            np.testing.assert_allclose(got[k], np.asarray(want), rtol=0,
                                       atol=1e-6)


def _wait_log(path, pattern, proc, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with open(path) as f:
            if re.search(pattern, f.read()):
                return
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    with open(path) as f:
        raise AssertionError(f"never saw {pattern!r}:\n{f.read()[-3000:]}")


class TestKillAndHeal:
    def test_sigkill_cold_restart_heals_bit_identical(self, tmp_path):
        """Two trainers on a lighthouse of ``min_replicas=2``, so the
        survivor waits for the restart (the kill lands mid-run whatever
        the host's speed) and the restart must heal from it."""
        steps = 120
        lh = port_native.Lighthouse(bind="[::]:0", min_replicas=2,
                                    join_timeout_ms=500, quorum_tick_ms=20,
                                    heartbeat_timeout_ms=1000)
        env = {**os.environ, "TORCHFT_LIGHTHOUSE": lh.address(),
               "DEVICE": "cpu", "OMP_NUM_THREADS": "1", "MODEL": "mlp",
               "NUM_STEPS": str(steps), "NUM_REPLICA_GROUPS": "2",
               "TORCHFT_HEAL_WIRE": "f32"}
        env.pop("PYTHONPATH", None)
        procs = []

        def start(g, name):
            out = tmp_path / name
            out.mkdir()
            log = tmp_path / f"{name}.log"
            p = subprocess.Popen(
                [sys.executable, RECORDER, str(out), PORT_TRAINER], cwd=REPO,
                env={**env, "REPLICA_GROUP_ID": str(g)},
                stdout=open(log, "w"), stderr=subprocess.STDOUT)
            procs.append(p)
            return p, out, log

        try:
            g0, out0, log0 = start(0, "g0")
            g1, _, log1 = start(1, "g1")
            _wait_log(log1, r"\[group 1\] step=30 ", g1, 60)
            g1.send_signal(signal.SIGKILL)
            g1.wait(timeout=10)
            g1b, out1b, log1b = start(1, "g1b")
            for p, log in ((g0, log0), (g1b, log1b)):
                p.wait(timeout=90)
                assert p.returncode == 0, open(log).read()[-3000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            lh.shutdown()
        recs = []
        for out in (out0, out1b):
            (name,) = [n for n in os.listdir(out) if n.startswith("end_")]
            with open(out / name) as f:
                recs.append(json.load(f))
        r0, r1 = recs
        assert r0["step"] == r1["step"] == steps
        assert r0["batches_committed"] == r1["batches_committed"]
        assert r1["counters"].get("heals", 0) >= 1
        assert r1["heal"]["path"] == "stream" and r1["heal"]["wire"] is None
        assert r1["commits"][0][0] > 30  # it healed to the survivor's step
        assert r0["digest"] == r1["digest"]
        for p in (open(log0).read(), open(log1b).read()):
            assert f"done: step={steps} batches_committed=" in p


def test_trainer_without_a_card_raises(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DEVICE", "PYTHONPATH")}
    env.update(CUDA_VISIBLE_DEVICES="", NUM_STEPS="1",
               TORCHFT_LIGHTHOUSE="http://localhost:1")
    proc = subprocess.run([sys.executable, PORT_TRAINER], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
