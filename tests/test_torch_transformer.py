"""The port's transformer LM against the JAX package's, on the same
weights (carried across with ``params_from_jax``) and the same tokens.

f32 compute: logits, loss and every gradient agree to rtol 1e-5 /
atol 1e-5 — the two sides differ only in summation order.

bf16 compute (the default ``cfg.dtype``): the port must round where the
JAX model rounds, so its bf16 result must sit closer to the JAX bf16
result than the f32 result does. XLA's CPU backend by default keeps
excess precision inside fused elementwise chains (it skips bf16
roundings torch performs), so the JAX bf16 reference runs in a
subprocess with ``--xla_allow_excess_precision=false``. Per logit and
gradient tensor:

- RMS: ``rms(port - ref_bf16) <= 0.9 * rms(ref_bf16 - ref_f32)``. The
  port reads 0.55-0.78 at the tested seeds (0.47-0.84 over seeds 3-6);
  a port computing in f32 reads 1.00 and fails (the planted control
  below);
- max norm: ``max|port - ref_bf16| <= 1.5 * max|ref_bf16 - ref_f32|``
  (the port reads at most 1.04), against a few outlying elements the RMS
  would dilute;
- the loss within 1e-3 relative (a quarter bf16 step).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models import transformer as jt
from torchft_tpu_torch._tree import flatten, tree_map
from torchft_tpu_torch.models import transformer as tt


def _configs(dtype_name):
    kw = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_seq_len=128)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    return jt.TransformerConfig(**kw, dtype=jdt), tt.TransformerConfig(**kw, dtype=tdt)


def _setup(dtype_name, seed=0):
    jcfg, tcfg = _configs(dtype_name)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = tt.params_from_jax(np_params, device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, size=(3, 33), dtype=np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def _jax_value_and_grad(jcfg, jparams, tokens):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jt.loss_fn(jcfg, p, t)
    ))(jparams, jnp.asarray(tokens))
    return np.asarray(loss), jax.tree_util.tree_leaves(grads)


def _jax_forward(jcfg, jparams, tokens):
    fwd = jax.jit(lambda p, t: jt.forward(jcfg, p, t))
    return np.asarray(fwd(jparams, jnp.asarray(tokens)))


def _torch_value_and_grad(tcfg, tparams, tokens):
    params = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    loss, grads = tt.make_grad_fn(tcfg)(params, torch.from_numpy(tokens))
    leaves, _ = flatten(grads)
    return loss.numpy(), [g.numpy() for g in leaves]


class TestTransformerF32:
    def test_logits_match(self):
        jcfg, tcfg, jparams, tparams, tokens = _setup("f32")
        want = _jax_forward(jcfg, jparams, tokens)
        got = tt.forward(tcfg, tparams, torch.from_numpy(tokens)).numpy()
        assert got.shape == want.shape == (3, 33, 256)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_loss_and_every_gradient_match(self):
        jcfg, tcfg, jparams, tparams, tokens = _setup("f32", seed=1)
        jloss, jgrads = _jax_value_and_grad(jcfg, jparams, tokens)
        tloss, tgrads = _torch_value_and_grad(tcfg, tparams, tokens)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
        assert len(tgrads) == len(jgrads) == 15  # 3 + 6 per layer
        for t, j in zip(tgrads, jgrads):
            assert t.shape == j.shape
            np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5)

    def test_module_params_are_the_jax_tree(self):
        jcfg, tcfg, jparams, tparams, tokens = _setup("f32", seed=2)
        model = tt.TransformerLM(tcfg, device="cpu")
        model.load_params(tparams)
        jleaves, jdef = jax.tree_util.tree_flatten(
            jax.tree_util.tree_map(np.asarray, jparams)
        )
        tleaves, _ = flatten(model.params())
        assert [tuple(l.shape) for l in tleaves] == [l.shape for l in jleaves]
        for t, j in zip(tleaves, jleaves):
            assert t.detach().numpy().tobytes() == j.tobytes()
        names = [n for n, _ in model.named_parameters()]
        assert len(names) == len(tleaves)
        want = np.asarray(jt.loss_fn(jcfg, jparams, jnp.asarray(tokens)))
        np.testing.assert_allclose(
            model.loss(torch.from_numpy(tokens)).detach().numpy(), want,
            rtol=1e-5, atol=1e-5,
        )


BF16_SEEDS = (3, 4)


def _dump_references(path, seeds):
    """Writes the JAX logits, loss and gradients at bf16 and f32 for each
    seed to ``path`` (npz). Run in a process whose XLA rounds every bf16
    op (see the module docstring)."""
    out = {}
    for seed in seeds:
        for name in ("bf16", "f32"):
            jcfg, _, jparams, _, tokens = _setup(name, seed=seed)
            out[f"{seed}/{name}/logits"] = _jax_forward(jcfg, jparams, tokens)
            loss, grads = _jax_value_and_grad(jcfg, jparams, tokens)
            out[f"{seed}/{name}/loss"] = loss
            for i, g in enumerate(grads):
                out[f"{seed}/{name}/grad{i}"] = np.asarray(g, np.float32)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def strict_references(tmp_path_factory):
    path = tmp_path_factory.mktemp("bf16_ref") / "ref.npz"
    here = os.path.dirname(os.path.abspath(__file__))
    # one compute thread: the suite runs beside other test processes
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
        " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    ).strip())
    subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path[:0] = sys.argv[1:3]; "
         "import test_torch_transformer as m; "
         "m._dump_references(sys.argv[3], m.BF16_SEEDS)",
         here, os.path.dirname(here), str(path)],
        env=env, check=True, timeout=300,
    )
    with np.load(path) as f:
        return dict(f)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _within_bf16_bound(port, ref_bf16, ref_f32):
    port, ref_bf16, ref_f32 = (np.asarray(a, np.float32)
                               for a in (port, ref_bf16, ref_f32))
    return (
        _rms(port - ref_bf16) <= 0.9 * _rms(ref_bf16 - ref_f32)
        and np.max(np.abs(port - ref_bf16))
        <= 1.5 * np.max(np.abs(ref_bf16 - ref_f32))
    )


def _port_outputs(seed, dtype_name):
    _, tcfg, _, tparams, tokens = _setup(dtype_name, seed=seed)
    logits = tt.forward(tcfg, tparams, torch.from_numpy(tokens)).numpy()
    loss, grads = _torch_value_and_grad(tcfg, tparams, tokens)
    return logits, loss, grads


def _bound_holds(ref, seed, logits, grads):
    """Per tensor (logits, then every gradient): within the bf16 bound?"""
    r = lambda name, kind: ref[f"{seed}/{name}/{kind}"]
    return [_within_bf16_bound(logits, r("bf16", "logits"), r("f32", "logits"))] + [
        _within_bf16_bound(g, r("bf16", f"grad{i}"), r("f32", f"grad{i}"))
        for i, g in enumerate(grads)
    ]


class TestTransformerBf16:
    @pytest.mark.parametrize("seed", BF16_SEEDS)
    def test_logits_loss_and_gradients_within_bf16_bound(
        self, strict_references, seed
    ):
        logits, loss, grads = _port_outputs(seed, "bf16")
        np.testing.assert_allclose(
            loss, strict_references[f"{seed}/bf16/loss"], rtol=1e-3
        )
        held = _bound_holds(strict_references, seed, logits, grads)
        assert len(held) == 16 and all(held), held

    @pytest.mark.parametrize("seed", BF16_SEEDS)
    def test_f32_compute_fails_the_bf16_bound(self, strict_references, seed):
        """Planted control: the same model computing in f32 (the precision
        the config states, lost) must fail the bound on every tensor."""
        logits, _, grads = _port_outputs(seed, "f32")
        held = _bound_holds(strict_references, seed, logits, grads)
        assert len(held) == 16 and not any(held), held


def test_flash_path_is_the_next_slice():
    """The flash path, once refused as the next slice, now builds; its
    numerics are held in tests/test_torch_transformer_flash.py."""
    cfg = tt.TransformerConfig(use_flash=True)
    assert cfg.use_flash and cfg.attn_window is None
    with pytest.raises(ValueError, match="use_flash"):
        tt.TransformerConfig(attn_window=8)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_params(tt.tiny_config())


def test_bench_default_config_param_count():
    """The full-width config the slice trains at (bench.py's default LM):
    39 f32 leaves, 23,337,472 parameters, counted without materializing."""
    cfg = tt.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                               n_layers=6, d_ff=2048, max_seq_len=512)
    params = tt.init_params(cfg, device="meta")
    leaves, _ = flatten(params)
    assert len(leaves) == 39
    assert tt.param_count(params) == 23_337_472
    jcfg = jt.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                                n_layers=6, d_ff=2048, max_seq_len=512)
    shapes = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)))
    assert [tuple(l.shape) for l in leaves] == [
        tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)
    ]
