"""The q8 error-feedback pack over a whole plan group, against the JAX
package.

``quantize_q8_ef_group`` runs K1a and K1b once for every leaf of a plan
group: the codes land in the group's concatenated int8 buffer, the scales
in one f32 buffer, and the EF carry (one flat f32 buffer) advances in
place. Its contract is the per-leaf one, BIT for bit: the JAX Pallas
``quantize_q8_ef`` (interpret mode here, as the JAX package's own tests
run it on the CPU) leaf by leaf, concatenated, over several EF steps.
Subnormals are held against the numpy EF oracle instead (ROADMAP F3:
XLA's CPU backend flushes them). The port's ``_DeviceWirePacker`` on the
q8ef wire, which packs through the group entry point, is held against
the JAX package's ``_DeviceWirePacker`` the same way. On the CPU the
wrappers run their plain versions; tests/test_torch_cuda_kernels.py holds
the segmented CUDA kernels against those on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

from test_comm_plan import _np_quantize_ef
from torchft_tpu import collectives as jcol
from torchft_tpu.ops import quantize_kernels as jq
from torchft_tpu_torch import collectives as tcol
from torchft_tpu_torch.ops import quantize_kernels as tq

RAGGED = (1, 3, 127, 128, 512, 4099, 65537)


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _rand(rng, n, scale=1.0):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _group(case: str, step: int):
    """(numpy leaves, bf16 flags) of one step of a named group."""
    rng = np.random.default_rng(100 * step + len(case))
    if case == "ragged":
        return [_rand(rng, n, 10.0 ** (i % 3 - 1)) for i, n in enumerate(RAGGED)], None
    if case == "specials_in_the_middle":
        leaves = [_rand(rng, 4099), np.zeros(512, np.float32),
                  _rand(rng, 127), _rand(rng, 1000), _rand(rng, 65537)]
        leaves[2][5] = np.nan
        leaves[3][999] = np.inf if step != 1 else -np.inf
        return leaves, None
    if case == "bf16_leaf":
        return [_rand(rng, 300), _rand(rng, 4099), _rand(rng, 7)], [False, True, False]
    if case == "empty_leaf":
        return [_rand(rng, 128), np.zeros(0, np.float32), _rand(rng, 3),
                np.zeros(0, np.float32)], None
    if case == "matrices":
        return [_rand(rng, 13 * 9).reshape(13, 9), _rand(rng, 512),
                _rand(rng, 64 * 33).reshape(64, 33)], None
    raise KeyError(case)


CASES = ("ragged", "specials_in_the_middle", "bf16_leaf", "empty_leaf", "matrices")


def _torch_leaf(a: np.ndarray, bf16: bool) -> torch.Tensor:
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if bf16 else t


def _jax_leaf(a: np.ndarray, bf16: bool):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16).astype(jnp.float32) if bf16 else x


class TestGroupAgainstJax:
    @pytest.mark.parametrize("case", CASES)
    def test_three_ef_steps_bit_identical(self, case):
        """Codes, scales and carry of every step equal the JAX kernel run
        leaf by leaf with its own carry, concatenated."""
        leaves, bf16 = _group(case, 0)
        flags = bf16 or [False] * len(leaves)
        total = sum(a.size for a in leaves)
        res_flat = torch.zeros(total)
        codes = torch.empty(total, dtype=torch.int8)
        scales = torch.empty(len(leaves))
        jres = [jnp.zeros(a.shape, jnp.float32) for a in leaves]
        for step in range(3):
            leaves, _ = _group(case, step)
            before = dict(tq.launch_counts)
            tq.quantize_q8_ef_group(
                [_torch_leaf(a, f) for a, f in zip(leaves, flags)],
                res_flat, codes, scales)
            assert tq.launch_counts == before  # plain versions launch nothing
            want_q, want_s = [], []
            for k, (a, f) in enumerate(zip(leaves, flags)):
                q, s, jres[k] = jq.quantize_q8_ef(_jax_leaf(a, f), jres[k],
                                                  interpret=True)
                want_q.append(np.asarray(q).ravel())
                want_s.append(np.asarray(s).reshape(1))
            assert _bits(codes.numpy()) == _bits(np.concatenate(want_q)), step
            assert _bits(scales.numpy()) == _bits(np.concatenate(want_s)), step
            want_r = np.concatenate([np.asarray(r).ravel() for r in jres])
            assert _bits(res_flat.numpy()) == _bits(want_r), step

    def test_poison_stays_in_its_segment(self):
        leaves, _ = _group("specials_in_the_middle", 0)
        total = sum(a.size for a in leaves)
        res_flat, codes = torch.zeros(total), torch.empty(total, dtype=torch.int8)
        scales = torch.empty(len(leaves))
        tq.quantize_q8_ef_group([torch.from_numpy(a) for a in leaves],
                                res_flat, codes, scales)
        sbits = scales.view(torch.int32).tolist()
        assert [b == 0x7FC00000 for b in sbits] == [False, False, True, True, False]
        assert sbits[1] == np.array(1e-12, np.float32).view(np.int32)  # all zero
        off = np.cumsum([0] + [a.size for a in leaves])
        rbits = res_flat.view(torch.int32)
        for k in range(len(leaves)):
            seg = slice(int(off[k]), int(off[k + 1]))
            poisoned = k in (2, 3)
            assert bool((rbits[seg] == 0x7FC00000).all()) == poisoned, k
            assert bool((codes[seg] == 0).all()) == (poisoned or k == 1), k
            if not poisoned:
                assert bool(torch.isfinite(res_flat[seg]).all()), k

    def test_subnormal_leaf_matches_numpy_oracle(self):
        """A subnormal leaf between two normal ones, over two EF steps,
        against the numpy EF (the native plan_pack_ef's arithmetic): the
        decoded codes and the carry. ROADMAP F3 keeps JAX out of this one."""
        rng = np.random.default_rng(17)
        sub = np.full(33, 1e-40, np.float32)
        sub[7] = -3e-39
        leaves = [_rand(rng, 64), sub, _rand(rng, 5)]
        total = sum(a.size for a in leaves)
        res_flat, codes = torch.zeros(total), torch.empty(total, dtype=torch.int8)
        scales = torch.empty(3)
        res_np = [np.zeros(a.size, np.float32) for a in leaves]
        off = np.cumsum([0, 64, 33, 5])
        for _ in range(2):
            tq.quantize_q8_ef_group([torch.from_numpy(a) for a in leaves],
                                    res_flat, codes, scales)
            for k, a in enumerate(leaves):
                dq_want, res_np[k] = _np_quantize_ef(a, res_np[k])
                seg = slice(int(off[k]), int(off[k + 1]))
                dq = (codes[seg].numpy().astype(np.float32) * scales[k].numpy()
                      + np.float32(0.0)).astype(np.float32)
                assert _bits(dq) == _bits((dq_want + np.float32(0.0))
                                          .astype(np.float32)), k
                assert _bits(res_flat[seg].numpy()) == _bits(res_np[k]), k


class TestGroupEntryPoints:
    def test_split_passes_equal_the_fused_entry(self):
        leaves, _ = _group("ragged", 1)
        xs = [torch.from_numpy(a) for a in leaves]
        total = sum(a.size for a in leaves)
        rng = np.random.default_rng(3)
        res0 = torch.from_numpy(_rand(rng, total, 1e-3))
        outs = []
        for split in (False, True):
            res_flat = res0.clone()
            codes, scales = torch.empty(total, dtype=torch.int8), torch.empty(len(xs))
            if split:
                absmax = tq.q8_absmax_group(xs, res_flat)
                assert absmax.shape == (len(xs),)
                tq.q8_quantize_group(xs, res_flat, absmax, codes, scales)
            else:
                tq.quantize_q8_ef_group(xs, res_flat, codes, scales)
            outs.append([_bits(t.numpy()) for t in (codes, scales, res_flat)])
        assert outs[0] == outs[1]

    def test_matches_the_per_leaf_wrapper(self):
        leaves, _ = _group("matrices", 2)
        xs = [torch.from_numpy(a) for a in leaves]
        total = sum(a.size for a in leaves)
        res_flat, codes = torch.zeros(total), torch.empty(total, dtype=torch.int8)
        scales = torch.empty(len(xs))
        tq.quantize_q8_ef_group(xs, res_flat, codes, scales)
        per_leaf = [tq.quantize_q8_ef(x, torch.zeros(x.shape)) for x in xs]
        assert _bits(codes.numpy()) == b"".join(_bits(q.numpy()) for q, _, _ in per_leaf)
        assert _bits(scales.numpy()) == b"".join(_bits(s.numpy()) for _, s, _ in per_leaf)
        assert _bits(res_flat.numpy()) == b"".join(_bits(r.numpy()) for _, _, r in per_leaf)

    def test_empty_group(self):
        tq.quantize_q8_ef_group([], torch.zeros(0), torch.zeros(0, dtype=torch.int8),
                                torch.zeros(0))
        assert tq.q8_absmax_group([], torch.zeros(0)).shape == (0,)

    @pytest.mark.parametrize("bad, exc", [
        (dict(res_flat=torch.zeros(9)), ValueError),
        (dict(res_flat=torch.zeros(10, dtype=torch.float64)), TypeError),
        (dict(res_flat=torch.zeros(20)[::2]), TypeError),
        (dict(codes_out=torch.zeros(10, dtype=torch.int16)), TypeError),
        (dict(codes_out=torch.zeros(11, dtype=torch.int8)), ValueError),
        (dict(scales_out=torch.zeros(3)), ValueError),
        (dict(leaves=[torch.zeros(4), torch.zeros(6, dtype=torch.int32)]), TypeError),
    ], ids=["short_carry", "f64_carry", "strided_carry", "int16_codes",
            "long_codes", "scales_count", "int_leaf"])
    def test_refuses_mismatched_buffers(self, bad, exc):
        args = dict(leaves=[torch.ones(4), torch.ones(6)], res_flat=torch.zeros(10),
                    codes_out=torch.zeros(10, dtype=torch.int8),
                    scales_out=torch.zeros(2))
        args.update(bad)
        with pytest.raises(exc):
            tq.quantize_q8_ef_group(**args)


def _packer_leaves(step: int, poison: bool = False):
    """f32 and bf16 leaves of uneven sizes (the bf16 one is stored as its
    f32 values for the JAX side)."""
    rng = np.random.default_rng(40 + step)
    leaves = [_rand(rng, 127), _rand(rng, 4099).reshape(4099, 1),
              _rand(rng, 512), _rand(rng, 3 * 171).reshape(3, 171), _rand(rng, 1)]
    if poison:
        leaves[2][100] = np.nan
    return leaves, [False, False, True, False, False]


class TestDevicePackerAgainstJax:
    @pytest.mark.parametrize("poison_step", [None, 1], ids=["finite", "nan_at_step1"])
    def test_three_steps_bit_identical(self, poison_step):
        leaves, flags = _packer_leaves(0)
        tp = tcol._DeviceWirePacker(
            [_torch_leaf(a, f) for a, f in zip(leaves, flags)], "q8ef")
        jp = jcol._DeviceWirePacker(
            [jnp.asarray(a).astype(jnp.bfloat16) if f else jnp.asarray(a)
             for a, f in zip(leaves, flags)], "q8ef")
        for step in range(3):
            leaves, _ = _packer_leaves(step, poison=step == poison_step)
            (tpay,), (tsc,) = tp.pack_step(
                [_torch_leaf(a, f) for a, f in zip(leaves, flags)])
            (jpay,), (jsc,) = jp.pack_step(
                [jnp.asarray(a).astype(jnp.bfloat16) if f else jnp.asarray(a)
                 for a, f in zip(leaves, flags)])
            assert tpay.dtype == torch.int8 and tsc.dtype == torch.float32
            assert _bits(tpay.numpy()) == _bits(jpay), step
            assert _bits(tsc.numpy()) == _bits(jsc), step
            for k, (tr, jr) in enumerate(zip(tp.residuals, jp.residuals)):
                assert tuple(tr.shape) == tuple(jr.shape), (step, k)
                assert _bits(tr.numpy()) == _bits(jr), (step, k)
        if poison_step is not None:  # the poisoned leaf's carry stays NaN
            assert bool(torch.isnan(tp.residuals[2]).all())
            assert not bool(torch.isnan(tp.residuals[1]).any())

    def test_carry_is_one_buffer_and_resets_in_place(self):
        leaves, flags = _packer_leaves(0)
        tls = [_torch_leaf(a, f) for a, f in zip(leaves, flags)]
        tp = tcol._DeviceWirePacker(tls, "q8ef")
        base = tp._carry.data_ptr()
        ptrs = [r.data_ptr() for r in tp.residuals]
        offs = np.cumsum([0] + [a.size for a in leaves[:-1]])
        assert ptrs == [base + 4 * int(o) for o in offs]
        for r in tp.residuals:
            assert r.untyped_storage().data_ptr() == tp._carry.untyped_storage().data_ptr()
        tp.pack_step(tls)
        assert bool(tp._carry.abs().max() > 0)
        tp.reset_feedback()
        assert not bool(tp._carry.any())
        assert [r.data_ptr() for r in tp.residuals] == ptrs
        # after the reset the next step equals a fresh packer's first one
        fresh = tcol._DeviceWirePacker(tls, "q8ef")
        (a,), (sa,) = tp.pack_step(tls)
        a, sa = a.clone(), sa.clone()
        (b,), (sb,) = fresh.pack_step(tls)
        assert _bits(a.numpy()) == _bits(b.numpy())
        assert _bits(sa.numpy()) == _bits(sb.numpy())
        assert _bits(tp._carry.numpy()) == _bits(fresh._carry.numpy())

    def test_pack_goes_through_the_group_entry_point(self, monkeypatch):
        calls = []
        real = tq.quantize_q8_ef_group

        def spy(*args):
            calls.append(len(args[0]))
            return real(*args)

        monkeypatch.setattr(tq, "quantize_q8_ef_group", spy)
        monkeypatch.setattr(torch, "cat", None)  # no concat on the q8ef path
        leaves, flags = _packer_leaves(0)
        tls = [_torch_leaf(a, f) for a, f in zip(leaves, flags)]
        tp = tcol._DeviceWirePacker(tls, "q8ef")
        tp.pack_step(tls)
        tp.pack_step(tls)
        assert calls == [len(tls), len(tls)]
