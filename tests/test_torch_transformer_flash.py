"""The port's transformer LM on its flash path (``use_flash=True``, the
plain flash versions on the CPU) against the JAX package's LM on its
flash path (the Pallas kernels in interpret mode), on the same weights
and tokens.

- f32 compute, full causal attention and ``attn_window=16``: the loss
  and every gradient agree to rtol 1e-5 / atol 1e-5 (summation order).
- bf16 compute: the bound of tests/test_torch_transformer.py against a
  JAX bf16 reference computed with every bf16 rounding kept
  (``--xla_allow_excess_precision=false``, in a subprocess), per logit
  and gradient tensor: ``rms(port - ref_bf16) <= 0.9 * rms(ref_bf16 -
  ref_f32)`` and ``max|port - ref_bf16| <= 1.5 * max|ref_bf16 - ref_f32|``,
  and the loss within 1e-3 relative.
- The port's flash path against its own dense path on the same weights,
  and the config rule that ``attn_window`` requires ``use_flash``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from conftest import HAS_SHARD_MAP, SHARD_MAP_SKIP

if not HAS_SHARD_MAP:
    # the JAX flash kernel's module imports jax.shard_map at load
    pytest.skip(SHARD_MAP_SKIP, allow_module_level=True)

import test_torch_transformer as base
from torchft_tpu.models import transformer as jt
from torchft_tpu_torch._tree import flatten
from torchft_tpu_torch.models import transformer as tt

FLASH = {"flash": dict(use_flash=True),
         "window16": dict(use_flash=True, attn_window=16)}
BF16_SEED = 3


def _setup(dtype_name, variant, seed):
    jcfg, tcfg, jparams, tparams, tokens = base._setup(dtype_name, seed=seed)
    extra = FLASH[variant]
    return (dataclasses.replace(jcfg, **extra),
            dataclasses.replace(tcfg, **extra), jparams, tparams, tokens)


@pytest.mark.parametrize("variant", sorted(FLASH))
def test_loss_and_every_gradient_match_f32(variant):
    jcfg, tcfg, jparams, tparams, tokens = _setup("f32", variant, seed=1)
    jloss, jgrads = base._jax_value_and_grad(jcfg, jparams, tokens)
    tloss, tgrads = base._torch_value_and_grad(tcfg, tparams, tokens)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
    assert len(tgrads) == len(jgrads) == 15
    for t, j in zip(tgrads, jgrads):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5)


def _dump_references(path, seed):
    """The JAX flash LM's logits, loss and gradients at bf16 and f32,
    written to ``path`` (npz); run in a process whose XLA rounds every
    bf16 op."""
    out = {}
    for name in ("bf16", "f32"):
        jcfg, _, jparams, _, tokens = _setup(name, "flash", seed)
        out[f"{name}/logits"] = base._jax_forward(jcfg, jparams, tokens)
        loss, grads = base._jax_value_and_grad(jcfg, jparams, tokens)
        out[f"{name}/loss"] = loss
        for i, g in enumerate(grads):
            out[f"{name}/grad{i}"] = np.asarray(g, np.float32)
    np.savez(path, **out)


def test_bf16_within_the_bf16_bound(tmp_path):
    path = tmp_path / "ref.npz"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
        " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    ).strip())
    subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path[:0] = sys.argv[1:3]; "
         "import test_torch_transformer_flash as m; "
         "m._dump_references(sys.argv[3], int(sys.argv[4]))",
         here, os.path.dirname(here), str(path), str(BF16_SEED)],
        env=env, check=True, timeout=300,
    )
    with np.load(path) as f:
        ref = dict(f)
    _, tcfg, _, tparams, tokens = _setup("bf16", "flash", BF16_SEED)
    logits = tt.forward(tcfg, tparams, torch.from_numpy(tokens)).numpy()
    loss, grads = base._torch_value_and_grad(tcfg, tparams, tokens)
    np.testing.assert_allclose(loss, ref["bf16/loss"], rtol=1e-3)
    held = [base._within_bf16_bound(logits, ref["bf16/logits"],
                                    ref["f32/logits"])]
    held += [base._within_bf16_bound(g, ref[f"bf16/grad{i}"],
                                     ref[f"f32/grad{i}"])
             for i, g in enumerate(grads)]
    assert len(held) == 16 and all(held), held


def test_flash_path_matches_the_dense_path():
    _, tcfg, _, tparams, tokens = _setup("f32", "flash", seed=2)
    dense = dataclasses.replace(tcfg, use_flash=False)
    lf, gf = base._torch_value_and_grad(tcfg, tparams, tokens)
    ld, gd = base._torch_value_and_grad(dense, tparams, tokens)
    np.testing.assert_allclose(lf, ld, rtol=1e-5, atol=1e-5)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_window_bites_and_requires_flash():
    _, tcfg, _, tparams, tokens = _setup("f32", "window16", seed=0)
    full = dataclasses.replace(tcfg, attn_window=None)
    l_win = float(tt.loss_fn(tcfg, tparams, torch.from_numpy(tokens)))
    l_full = float(tt.loss_fn(full, tparams, torch.from_numpy(tokens)))
    assert np.isfinite(l_win) and abs(l_win - l_full) > 1e-6
    with pytest.raises(ValueError, match="use_flash"):
        tt.TransformerConfig(attn_window=16)


def test_bench_big_config_param_count():
    """The config the flash train phase runs at (bench.py's "big" LM):
    51 f32 leaves, 111,166,464 parameters, the JAX package's shapes."""
    kw = dict(vocab_size=8192, d_model=1024, n_heads=16, n_layers=8,
              d_ff=4096, max_seq_len=2048)
    cfg = tt.TransformerConfig(**kw, use_flash=True)
    assert cfg.head_dim == 64
    leaves, _ = flatten(tt.init_params(cfg, device="meta"))
    assert len(leaves) == 51
    assert sum(l.numel() for l in leaves) == 111_166_464
    shapes = jax.eval_shape(lambda: jt.init_params(
        jt.TransformerConfig(**kw, use_flash=True), jax.random.PRNGKey(0)))
    assert [tuple(l.shape) for l in leaves] == [
        tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)
    ]
