"""K5's pieces on the CPU against the JAX package: ``delta`` and the
backward entry point.

- ``flash_delta_plain`` (the torch ``delta = rowsum(do * out)`` the CPU
  path runs, and the reference the card's folded ``delta`` is held to)
  against ``jnp.sum(do.astype(f32) * o.astype(f32), -1)``
  (torchft_tpu/ops/flash_attention.py:374-376). The elementwise products
  are bit-exact (f32 products; from bf16 inputs exact in f32); the sums
  are taken in different orders, so they agree within the bound on two
  summation orders of D terms: ``2 D 2**-24`` of the row's sum of
  ``|do * out|``.
- ``flash_bwd`` called directly with K4's ``out`` and ``lse`` against the
  JAX backward (``jax.vjp`` of the Pallas kernels in interpret mode) at
  ``sm_scale=1``, so dq needs no chain rule: f32 within rtol = atol =
  2e-5 (the JAX package's flash tolerance), bf16 within two bf16 steps of
  each tensor's largest magnitude (see tests/test_torch_flash_attention.py).

The card's kernels are held against these plain versions by
tests/test_torch_cuda_kernels.py.
"""

import importlib

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from conftest import HAS_SHARD_MAP, SHARD_MAP_SKIP

if not HAS_SHARD_MAP:
    # the JAX kernel's module imports jax.shard_map at load
    pytest.skip(SHARD_MAP_SKIP, allow_module_level=True)

from torchft_tpu.ops import flash_attention as jax_flash

tfa = importlib.import_module("torchft_tpu_torch.ops.flash_attention")

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(shape, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 33, 3, 16), (1, 70, 2, 64),
                                   (1, 20, 2, 128)])
def test_plain_delta_matches_the_jax_delta(dtype_name, shape):
    jdt, tdt = _DTYPES[dtype_name]
    o, do = _arrays(shape, seed=sum(shape), n=2)
    to, tdo = (torch.from_numpy(a).to(tdt) for a in (o, do))
    jo, jdo = (jnp.asarray(a, jdt) for a in (o, do))
    got = tfa.flash_delta_plain(to, tdo).numpy()
    prod = jdo.astype(jnp.float32) * jo.astype(jnp.float32)
    want = np.asarray(jnp.sum(prod, axis=-1)).transpose(0, 2, 1)
    assert got.dtype == np.float32 and got.shape == want.shape
    # the products: bit for bit
    np.testing.assert_array_equal((tdo.float() * to.float()).numpy(),
                                  np.asarray(prod))
    # the sums: within two summation orders of D terms
    mag = np.abs(np.asarray(prod)).sum(-1).transpose(0, 2, 1)
    bound = 2 * shape[-1] * 2.0 ** -24 * mag
    assert (np.abs(got - want) <= bound).all(), float(
        np.max(np.abs(got - want) - bound))


def _jax_grads(arrays, jdt, **kw):
    def f(q, k, v, do):
        _, vjp = jax.vjp(
            lambda q, k, v: jax_flash(q, k, v, sm_scale=1.0, **kw), q, k, v)
        return vjp(do)

    res = jax.jit(f)(*(jnp.asarray(a, jdt) for a in arrays))
    return [np.asarray(r.astype(jnp.float32)) for r in res]


def _port_grads(arrays, tdt, causal, window, block_q, block_k):
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
    cfg = tfa.FlashConfig(causal, window, *tfa.resolve_blocks(
        q.shape[1], torch.device("cpu"), block_q, block_k))
    out, lse = tfa.flash_fwd(q, k, v, cfg)
    return [g.float().numpy() for g in tfa.flash_bwd(q, k, v, out, lse, do,
                                                     cfg)]


@pytest.mark.parametrize("dtype_name,causal,window,S,blocks", [
    ("f32", True, None, 96, (32, 32)),
    ("f32", False, None, 65, (32, 32)),
    ("f32", True, 7, 80, (16, 16)),
    ("bf16", True, None, 128, (32, 32)),
    ("bf16", False, None, 33, (32, 32)),
], ids=["f32_causal", "f32_full", "f32_window7", "bf16_causal", "bf16_full"])
def test_flash_bwd_matches_the_jax_backward(dtype_name, causal, window, S,
                                            blocks):
    jdt, tdt = _DTYPES[dtype_name]
    arrays = _arrays((2, S, 2, 16), seed=30 + S, n=4)
    kw = dict(causal=causal, block_q=blocks[0], block_k=blocks[1])
    if window is not None:
        kw["window"] = window
    want = _jax_grads(arrays, jdt, **kw)
    got = _port_grads(arrays, tdt, causal, window, *blocks)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        if dtype_name == "f32":
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5,
                                       err_msg=name)
        else:
            bound = 2.0 ** -6 * float(np.max(np.abs(w)))
            err = float(np.max(np.abs(g - w)))
            assert err <= bound, (name, err, bound)
