"""The port's wire-compression kernels against the JAX package's.

The contract is BIT identity: the port's q8 EF quantize and bf16 cast
must reproduce the JAX Pallas kernels (run here in interpret mode, as the
JAX package's own tests run them on the CPU) and the FMA-free numpy EF
oracle of tests/test_comm_plan.py, or a device-packing member of a mixed
ring would drift from the rest. On the CPU the port's wrappers run their
plain PyTorch versions; tests/test_torch_cuda_kernels.py holds the CUDA
kernels against those plain versions on the card.
"""

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax.numpy as jnp

from test_comm_plan import _np_quantize_ef
from torchft_tpu.ops import quantize_kernels as jq
from torchft_tpu_torch.ops import quantize_kernels as tq

# f32 NaN/Inf bit patterns and the bf16 words the JAX cast gives them.
NAN_BITS = {
    0x7FC00000: 0x7FC0,
    0x7FFFFFFF: 0x7FC0,  # the card's canonical f32 NaN
    0x7F800001: 0x7FC0,
    0xFFC00000: 0xFFC0,
    0xFFFFFFFF: 0xFFC0,
    0x7F800000: 0x7F80,  # +Inf stays
    0x3F818000: 0x3F82,  # a tie: rounds to even
}


def _bits(a) -> bytes:
    return np.asarray(a).tobytes()


def _jax_q8ef(x, res):
    q, s, r = jq.quantize_q8_ef(jnp.asarray(x), jnp.asarray(res), interpret=True)
    return np.asarray(q), np.asarray(s), np.asarray(r)


def _port_q8ef(x, res):
    q, s, r = tq.quantize_q8_ef(torch.from_numpy(x), torch.from_numpy(res))
    return q.numpy(), s.numpy(), r.numpy()


def _cases():
    rng = np.random.default_rng(11)
    big = rng.standard_normal(70001).astype(np.float32) * 3.0
    return {
        "random": (rng.standard_normal(4096).astype(np.float32),
                   (rng.standard_normal(4096) * 1e-2).astype(np.float32)),
        "ragged_1": (np.array([0.7], np.float32), np.zeros(1, np.float32)),
        "ragged_129": (rng.standard_normal(129).astype(np.float32),
                       np.zeros(129, np.float32)),
        "ragged_70001": (big, (rng.standard_normal(70001) * 1e-3)
                         .astype(np.float32)),
        "matrix_13x9": (rng.standard_normal((13, 9)).astype(np.float32),
                        rng.standard_normal((13, 9)).astype(np.float32)),
        "all_zero": (np.zeros(300, np.float32), np.zeros(300, np.float32)),
        "inf_leaf": (np.array([1.0, np.inf, 2.0], np.float32),
                     np.zeros(3, np.float32)),
        "nan_leaf": (np.array([1.0, 2.0, np.nan, -4.0], np.float32),
                     np.zeros(4, np.float32)),
        "nan_in_residual": (np.ones(5, np.float32),
                            np.array([0, 0, np.nan, 0, 0], np.float32)),
        "nan_bit_patterns": (
            np.array(list(NAN_BITS), np.uint32).view(np.float32),
            np.zeros(len(NAN_BITS), np.float32),
        ),
    }


class TestQuantizeQ8EF:
    @pytest.mark.parametrize("case", sorted(_cases()))
    def test_bit_identical_to_jax_kernel(self, case):
        x, res = _cases()[case]
        jqv, jsv, jrv = _jax_q8ef(x, res)
        pq, ps, pr = _port_q8ef(x, res)
        assert pq.shape == jqv.shape and pq.dtype == np.int8
        assert _bits(pq) == _bits(jqv), "codes differ"
        assert _bits(ps) == _bits(jsv), "scale differs"
        assert _bits(pr) == _bits(jrv), "residual differs"

    def test_nonfinite_leaf_poisons_with_canonical_nan(self):
        q, s, r = _port_q8ef(np.array([1, np.inf, 2], np.float32),
                             np.zeros(3, np.float32))
        assert q.tolist() == [0, 0, 0]
        assert int(s.view(np.uint32)) == 0x7FC00000
        assert r.view(np.uint32).tolist() == [0x7FC00000] * 3

    def test_all_zero_leaf_floors_scale(self):
        _, s, r = _port_q8ef(np.zeros(8, np.float32), np.zeros(8, np.float32))
        assert s == np.float32(1e-12)
        assert not r.any()

    def test_subnormal_leaf_matches_numpy_oracle(self):
        """Subnormals are held against the numpy EF (the native
        plan_pack_ef's arithmetic), not the interpret-mode JAX kernel:
        XLA's CPU backend flushes subnormals to zero, the native EF and
        the card do not (ROADMAP F3)."""
        x = np.full(17, 1e-40, np.float32)
        x[3] = -3e-39
        res = np.zeros(17, np.float32)
        dq_want, res_want = _np_quantize_ef(x, res)
        q, s, r = _port_q8ef(x, res)
        dq = (q.astype(np.float32) * s + np.float32(0.0)).astype(np.float32)
        assert _bits(dq) == _bits((dq_want + np.float32(0.0)).astype(np.float32))
        assert _bits(r) == _bits(res_want)

    def test_size_zero(self):
        x = np.zeros(0, np.float32)
        jqv, jsv, jrv = _jax_q8ef(x, x)
        pq, ps, pr = _port_q8ef(x, x)
        assert pq.shape == jqv.shape == (0,) and pr.shape == (0,)
        assert _bits(ps) == _bits(jsv)

    def test_bf16_leaf_upcasts(self):
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal(257).astype(np.float32))
        xb = x.to(torch.bfloat16)
        res = torch.zeros(257)
        a = tq.quantize_q8_ef(xb, res)
        b = tq.quantize_q8_ef(xb.float(), res)
        for u, v in zip(a, b):
            assert _bits(u.numpy()) == _bits(v.numpy())

    @pytest.mark.parametrize("n", [1, 1000, 4097])
    def test_multi_step_carry_matches_numpy_oracle(self, n):
        """The EF carry over several steps: decode(q, scale) and the
        residual equal tests/test_comm_plan.py's numpy EF bit for bit."""
        rng = np.random.default_rng(n)
        res_np = np.zeros(n, np.float32)
        res_t = torch.zeros(n)
        for _ in range(4):
            g = rng.standard_normal(n).astype(np.float32)
            dq_want, res_np = _np_quantize_ef(g, res_np)
            q, s, res_t = tq.quantize_q8_ef(torch.from_numpy(g), res_t)
            # decode as the native prepacked plan does; + 0.0 normalizes
            # the oracle's -0.0, which an int8 code cannot carry
            dq = (q.numpy().astype(np.float32) * s.numpy()
                  + np.float32(0.0)).astype(np.float32)
            assert _bits(dq) == _bits((dq_want + np.float32(0.0))
                                      .astype(np.float32))
            assert _bits(res_t.numpy()) == _bits(res_np)

    def test_quantize_q8_is_zero_residual_ef(self):
        rng = np.random.default_rng(4)
        x = rng.standard_normal(999).astype(np.float32)
        q, s = tq.quantize_q8(torch.from_numpy(x))
        jqv, jsv = jq.quantize_q8(jnp.asarray(x), interpret=True)
        assert _bits(q.numpy()) == _bits(jqv)
        assert _bits(s.numpy()) == _bits(jsv)


class TestCastBf16:
    @pytest.mark.parametrize("case", ["random", "specials", "ragged_1", "matrix"])
    def test_bit_identical_to_jax_kernel(self, case):
        rng = np.random.default_rng(5)
        x = {
            "random": rng.standard_normal(70001).astype(np.float32),
            "specials": np.array(
                [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                 3.389531389251535e38, -3.4e38, 1.0000001], np.float32),
            "ragged_1": np.array([1.7], np.float32),
            "matrix": rng.standard_normal((13, 9)).astype(np.float32),
        }[case]
        want = np.asarray(jq.cast_bf16(jnp.asarray(x), interpret=True))
        got = tq.cast_bf16(torch.from_numpy(x))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
        assert _bits(got.view(torch.int16).numpy()) == want.view(np.int16).tobytes()

    def test_nan_bit_patterns(self):
        x = np.array(list(NAN_BITS), np.uint32).view(np.float32)
        got = tq.cast_bf16(torch.from_numpy(x)).view(torch.int16).numpy()
        assert got.view(np.uint16).tolist() == list(NAN_BITS.values())
        want = np.asarray(jq.cast_bf16(jnp.asarray(x), interpret=True))
        assert want.view(np.uint16).tolist() == list(NAN_BITS.values())

    def test_size_zero(self):
        out = tq.cast_bf16(torch.zeros(0))
        assert out.shape == (0,) and out.dtype == torch.bfloat16


class TestDequantizeQ8:
    """K2: ``q * scale`` in f32, bit for bit with the JAX kernel; a NaN
    scale (the poison K1b writes) gives 0x7FC00000 everywhere."""

    @pytest.mark.parametrize("scale_bits", [0x3C23D70A, 0x2B8CBCCC,
                                            0x00000000, 0x7FC00000])
    @pytest.mark.parametrize("shape", [(70001,), (13, 9), (1,)])
    def test_bit_identical_to_jax_kernel(self, scale_bits, shape):
        rng = np.random.default_rng(7)
        q = rng.integers(-127, 128, shape).astype(np.int8)
        scale = np.array(scale_bits, np.uint32).view(np.float32)
        want = np.asarray(jq.dequantize_q8(jnp.asarray(q), jnp.asarray(scale),
                                           interpret=True))
        got = tq.dequantize_q8(torch.from_numpy(q), torch.from_numpy(scale))
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert _bits(got.numpy()) == _bits(want)

    def test_subnormal_scale_matches_numpy_oracle(self):
        """ROADMAP F3 again: XLA's CPU backend treats a subnormal scale as
        zero in interpret mode (codes [1, -3, 127] times 0x0001A2B3 decode
        to [+0, -0, +0] there), while the port, numpy and the H100 kernel
        keep IEEE products. K1b never writes a scale below 1e-12, so the
        wire never carries one."""
        q = np.array([1, -3, 127], np.int8)
        scale = np.array(0x0001A2B3, np.uint32).view(np.float32)
        got = tq.dequantize_q8(torch.from_numpy(q), torch.from_numpy(scale))
        assert _bits(got.numpy()) == _bits(q.astype(np.float32) * scale)

    def test_nan_scale_poisons_the_leaf(self):
        q = torch.tensor([0, 1, -127, 127], dtype=torch.int8)
        got = tq.dequantize_q8(q, float("nan")).view(torch.int32)
        assert (got == 0x7FC00000).all()

    def test_round_trip_of_the_q8_pair(self):
        rng = np.random.default_rng(8)
        x = torch.from_numpy(rng.standard_normal(4099).astype(np.float32))
        q, s, r = tq.quantize_q8_ef(x, torch.zeros_like(x))
        # x = decode + residual, up to the residual's one rounding
        np.testing.assert_allclose((tq.dequantize_q8(q, s) + r).numpy(),
                                   x.numpy(), rtol=0, atol=1e-6)

    def test_size_zero(self):
        out = tq.dequantize_q8(torch.zeros(0, dtype=torch.int8), 1.0)
        assert out.shape == (0,) and out.dtype == torch.float32
        want = jq.dequantize_q8(jnp.zeros(0, jnp.int8), jnp.float32(1.0),
                                interpret=True)
        assert want.shape == (0,)

    def test_refuses_non_int8_codes(self):
        with pytest.raises(TypeError, match="int8"):
            tq.dequantize_q8(torch.zeros(3, dtype=torch.int32), 1.0)
