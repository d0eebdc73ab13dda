"""The port's flash attention (its plain path, on the CPU) against the JAX
package's Pallas kernels (interpret mode), on the same numpy-seeded
inputs and the same ``block_q``/``block_k``: the output and the q, k, v
gradients for one cotangent.

Tolerances:
- f32: rtol = atol = 2e-5, the JAX package's own flash tolerance
  (tests/test_flash_attention.py). The two sides differ only in f32
  summation order (dense sums here, tiled online sums there).
- bf16: per tensor, ``max|port - jax| <= 2**-6 * max|jax|``: two bf16
  steps at the tensor's largest magnitude. The JAX kernel rounds p to
  bf16 against each tile's running max, the dense plain version against
  the row's final max, so single elements of p, ds and the outputs may
  land one bf16 step apart (the runs here read at most half of one).

The CUDA kernels are held against the same plain versions on the card
by tests/test_torch_cuda_kernels.py.
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

# the module (the package's name `flash_attention` is its entry point)
tfa = importlib.import_module("torchft_tpu_torch.ops.flash_attention")

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax_out_and_grads(arrays, dtype, **kw):
    def f(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, **kw), q, k, v)
        return (out, *vjp(do))

    res = jax.jit(f)(*(jnp.asarray(a, dtype) for a in arrays))
    return [np.asarray(r.astype(jnp.float32)) for r in res]


def _port_out_and_grads(arrays, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_(True)
               for a in arrays[:3])
    out = tfa.flash_attention(q, k, v, **kw)
    out.backward(torch.from_numpy(arrays[3]).to(dtype))
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad, v.grad)]


def _compare(arrays, dtype_name, **kw):
    jdt, tdt = _DTYPES[dtype_name]
    want = _jax_out_and_grads(arrays, jdt, **kw)
    got = _port_out_and_grads(arrays, tdt, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        if dtype_name == "f32":
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5,
                                       err_msg=name)
        else:
            bound = 2.0 ** -6 * float(np.max(np.abs(w)))
            err = float(np.max(np.abs(g - w)))
            assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,blocks", [(128, (64, 64)), (96, (32, 32)),
                                      (33, (16, 16))])
def test_matches_jax_kernel_f32(causal, S, blocks):
    _compare(_inputs((2, S, 2, 16), seed=S), "f32", causal=causal,
             block_q=blocks[0], block_k=blocks[1])


@pytest.mark.parametrize("window", [1, 16, 40, 200])
def test_sliding_window_matches_jax_kernel(window):
    _compare(_inputs((1, 128, 2, 16), seed=window), "f32", window=window,
             block_q=32, block_k=32)


def test_unequal_blocks_take_the_general_path():
    cfg = tfa.FlashConfig(True, None, *tfa.resolve_blocks(
        96, torch.device("cpu"), 32, 16))
    assert (cfg.block_q, cfg.block_k) == (32, 16) and not cfg.fast
    _compare(_inputs((1, 96, 2, 16), seed=5), "f32", block_q=32, block_k=16)


@pytest.mark.parametrize("causal,S", [(True, 128), (False, 96), (True, 33)])
def test_matches_jax_kernel_bf16(causal, S):
    _compare(_inputs((2, S, 2, 16), seed=10 + S), "bf16", causal=causal,
             block_q=32, block_k=32)


def test_window_validation():
    q = torch.zeros(1, 8, 1, 8)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        tfa.flash_attention(q, q, q, window=0)


def test_cpu_blocks_resolve_as_the_jax_package_does():
    cpu = torch.device("cpu")
    assert tfa.resolve_blocks(2047, cpu, None, None) == (512, 512)
    assert tfa.resolve_blocks(100, cpu, None, None) == (104, 104)
    assert tfa.resolve_blocks(33, cpu, 64, 16) == (40, 16)
    assert tfa.FlashConfig(True, None, 512, 512).fast
    assert not tfa.FlashConfig(True, 8, 64, 64).fast
    assert not tfa.FlashConfig(False, None, 64, 64).fast
