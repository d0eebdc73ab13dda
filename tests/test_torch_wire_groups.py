"""The bf16 wire cast and the q8 decode over a whole plan group, against
the JAX package.

``cast_bf16_group`` casts every leaf of a plan group into the group's
bf16 wire buffer in one K3 launch; its contract is the JAX pack's, BIT for
bit: the JAX Pallas ``cast_bf16`` (interpret mode here, as the JAX
package's own tests run it on the CPU) of the leaves' f32 concatenation,
NaN words included (every NaN is ``sign | 0x7FC0``, ROADMAP F1). The
port's ``_DeviceWirePacker`` on the bf16 wire, which packs through it, is
held against the JAX package's ``_DeviceWirePacker``. ``dequantize_q8_group``
decodes a ``quantize_q8_ef_group`` pack in one K2 launch; its contract is
the JAX ``dequantize_q8`` leaf by leaf, and the numpy product where XLA's
CPU backend flushes a subnormal scale (ROADMAP F5). On the CPU the
wrappers run their plain versions; tests/test_torch_cuda_kernels.py holds
the segmented CUDA kernels against those on the card.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

from torchft_tpu import collectives as jcol
from torchft_tpu.ops import quantize_kernels as jq
from torchft_tpu_torch import collectives as tcol
from torchft_tpu_torch.models import transformer as tt
from torchft_tpu_torch._tree import flatten
from torchft_tpu_torch.ops import quantize_kernels as tq
from torchft_tpu_torch.ops.wire_bits import CAST_BF16_WORDS, Q8_DECODE_SPECIALS

TINY_LM = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32,
               max_seq_len=16)


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _rand(rng, n, scale=1.0):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _patterns() -> np.ndarray:
    return np.array(list(CAST_BF16_WORDS), np.uint32).view(np.float32)


def _cast_group(case: str):
    """(numpy leaves in f32, bf16 flags) of a named group."""
    rng = np.random.default_rng(len(case))
    if case == "all_f32":
        return [_rand(rng, n, 10.0 ** (i % 3 - 1))
                for i, n in enumerate((1, 3, 127, 128, 4099, 65537))], None
    if case == "mixed_f32_bf16":
        # the bf16 leaves' values are bf16-exact (the JAX side holds them
        # as bf16 too); one carries a NaN with a payload
        leaves = [_rand(rng, 300), _rand(rng, 4099), _rand(rng, 7), _rand(rng, 513)]
        for k in (1, 3):  # truncated to bf16-exact values
            leaves[k] = (leaves[k].view(np.uint32) & 0xFFFF0000).view(np.float32)
        leaves[3][5] = np.array(0x7FC10000, np.uint32).view(np.float32)
        return leaves, [False, True, False, True]
    if case == "patterns":
        return [_rand(rng, 5), _patterns(), _rand(rng, 2)], None
    if case == "empty_leaf":
        return [_rand(rng, 17), np.zeros(0, np.float32), _rand(rng, 3),
                np.zeros(0, np.float32)], None
    raise KeyError(case)


CAST_CASES = ("all_f32", "mixed_f32_bf16", "patterns", "empty_leaf")


def _bf16_words(a: np.ndarray) -> np.ndarray:
    """The bf16 words of bf16-exact f32 values, taken from the bits (no
    conversion, so a NaN keeps its payload)."""
    return (a.view(np.uint32) >> 16).astype(np.uint16)


def _torch_leaf(a: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(_bf16_words(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jax_leaf(a: np.ndarray, bf16: bool):
    if bf16:
        return jnp.asarray(_bf16_words(a).view(ml_dtypes.bfloat16))
    return jnp.asarray(a)


def _words(t: torch.Tensor) -> list:
    return t.view(torch.int16).numpy().view(np.uint16).tolist()


class TestCastGroupAgainstJax:
    @pytest.mark.parametrize("case", CAST_CASES)
    def test_bit_identical_to_jax_cast_of_the_concat(self, case):
        leaves, bf16 = _cast_group(case)
        flags = bf16 or [False] * len(leaves)
        n = sum(a.size for a in leaves)
        out = torch.full((n,), 7.0, dtype=torch.bfloat16)
        tq.cast_bf16_group([_torch_leaf(a, f) for a, f in zip(leaves, flags)], out)
        concat = jnp.concatenate([_jax_leaf(a, f).astype(jnp.float32).ravel()
                                  for a, f in zip(leaves, flags)])
        want = jq.cast_bf16(concat, interpret=True)
        assert out.shape == (n,) and out.dtype == torch.bfloat16
        assert _bits(out.view(torch.int16).numpy()) == _bits(want.view(jnp.int16))

    def test_nan_words_are_sign_and_0x7fc0(self):
        leaves = [torch.ones(3), torch.from_numpy(_patterns())]
        out = torch.empty(3 + len(CAST_BF16_WORDS), dtype=torch.bfloat16)
        tq.cast_bf16_group(leaves, out)
        assert _words(out)[3:] == list(CAST_BF16_WORDS.values())

    def test_payload_nan_of_a_bf16_leaf_becomes_0x7fc0(self):
        """A native bf16 leaf goes through f32 as in the JAX pack: its NaN
        payload 0x7FC1 comes out as 0x7FC0."""
        leaf = torch.tensor([0x7FC1, -0x7F, 0x3F80], dtype=torch.int16)  # 0xFF81
        out = torch.empty(4, dtype=torch.bfloat16)
        tq.cast_bf16_group([torch.ones(1), leaf.view(torch.bfloat16)], out)
        assert _words(out) == [0x3F80, 0x7FC0, 0xFFC0, 0x3F80]

    def test_one_leaf_equals_the_per_leaf_cast(self):
        x = torch.from_numpy(_rand(np.random.default_rng(2), 1000))
        out = torch.empty(1000, dtype=torch.bfloat16)
        tq.cast_bf16_group([x], out)
        assert _bits(out.view(torch.int16).numpy()) == \
            _bits(tq.cast_bf16(x).view(torch.int16).numpy())

    def test_empty_group(self):
        tq.cast_bf16_group([], torch.zeros(0, dtype=torch.bfloat16))

    @pytest.mark.parametrize("bad, exc", [
        (dict(out=torch.zeros(9, dtype=torch.bfloat16)), ValueError),
        (dict(out=torch.zeros(10)), TypeError),
        (dict(out=torch.zeros(20, dtype=torch.bfloat16)[::2]), TypeError),
        (dict(out=torch.zeros(2, 5, dtype=torch.bfloat16)), TypeError),
        (dict(leaves=[torch.zeros(4), torch.zeros(6, dtype=torch.int32)]), TypeError),
    ], ids=["short_out", "f32_out", "strided_out", "2d_out", "int_leaf"])
    def test_refuses_mismatched_buffers(self, bad, exc):
        args = dict(leaves=[torch.ones(4), torch.ones(6)],
                    out=torch.zeros(10, dtype=torch.bfloat16))
        args.update(bad)
        with pytest.raises(exc):
            tq.cast_bf16_group(**args)


def _tiny_lm_leaves(step: int):
    """f32 leaves at a tiny LM's shapes (random values; one NaN pattern
    leaf is poisoned at step 1)."""
    shapes = [tuple(p.shape) for p in
              flatten(tt.init_params(tt.TransformerConfig(**TINY_LM),
                                     device="meta"))[0]]
    rng = np.random.default_rng(60 + step)
    leaves = [_rand(rng, int(np.prod(s)), 1e-2).reshape(s) for s in shapes]
    if step == 1:
        leaves[2].reshape(-1)[:len(CAST_BF16_WORDS)] = _patterns()
    return leaves, [False] * len(leaves)


def _mixed_leaves(step: int):
    """A bf16 wire whose plan has a mixed group: f32 and bf16 leaves cast
    into one bf16 group; an int32 leaf forms its own group."""
    rng = np.random.default_rng(70 + step)
    leaves = [_rand(rng, 127), _rand(rng, 4099).reshape(4099, 1),
              _rand(rng, 512), _rand(rng, 3 * 171).reshape(3, 171)]
    leaves[1] = (leaves[1].view(np.uint32) & 0xFFFF0000).view(np.float32)
    if step == 1:
        leaves[2][100] = np.array(0xFFFFFFFF, np.uint32).view(np.float32)
    return leaves, [False, True, False, False]


PACKER_CASES = {"tiny_lm": _tiny_lm_leaves, "mixed_group": _mixed_leaves}


class TestBf16PackerAgainstJax:
    @pytest.mark.parametrize("case", sorted(PACKER_CASES))
    def test_payloads_bit_identical(self, case):
        make = PACKER_CASES[case]
        leaves, flags = make(0)
        ints = np.arange(6, dtype=np.int32) if case == "mixed_group" else None

        def port(ls):
            out = [_torch_leaf(a, f) for a, f in zip(ls, flags)]
            return out + ([torch.from_numpy(ints)] if ints is not None else [])

        def jax_(ls):
            out = [_jax_leaf(a, f) for a, f in zip(ls, flags)]
            return out + ([jnp.asarray(ints)] if ints is not None else [])

        tp = tcol._DeviceWirePacker(port(leaves), "bf16")
        jp = jcol._DeviceWirePacker(jax_(leaves), "bf16")
        assert len(tp.groups) == (2 if ints is not None else 1)
        for step in range(2):
            leaves, _ = make(step)
            tpays, tsc = tp.pack_step(port(leaves))
            jpays, jsc = jp.pack_step(jax_(leaves))
            assert tsc == [] and list(jsc) == []
            assert len(tpays) == len(jpays)
            for t, j in zip(tpays, jpays):
                assert t.dtype in (torch.bfloat16, torch.int32)
                tb = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                jb = j.view(jnp.int16) if j.dtype == jnp.bfloat16 else j
                assert _bits(tb.numpy()) == _bits(jb), step

    def test_pack_goes_through_the_group_entry_point(self, monkeypatch):
        """One cast_bf16_group call per bf16 group with f32 leaves, into
        the buffer the packer allocated once; no concatenation outside it
        (the int32 group still concatenates natively)."""
        calls, cats, inside = [], [], []
        real_group, real_cat = tq.cast_bf16_group, torch.cat

        def spy(leaves, out):
            calls.append((len(leaves), out.data_ptr()))
            inside.append(True)
            try:
                return real_group(leaves, out)
            finally:
                inside.pop()

        def cat(tensors, *args, **kwargs):
            if not inside:
                cats.append([t.dtype for t in tensors])
            return real_cat(tensors, *args, **kwargs)

        monkeypatch.setattr(tq, "cast_bf16_group", spy)
        monkeypatch.setattr(torch, "cat", cat)
        leaves, flags = _mixed_leaves(0)
        tls = [_torch_leaf(a, f) for a, f in zip(leaves, flags)]
        tls.append(torch.arange(6, dtype=torch.int32))
        tp = tcol._DeviceWirePacker(tls, "bf16")
        tp.pack_step(tls)
        tp.pack_step(tls)
        assert [c[0] for c in calls] == [4, 4]
        assert calls[0][1] == calls[1][1] == tp._casts[0].data_ptr()
        assert cats == [[torch.int32], [torch.int32]]

    def test_all_bf16_group_keeps_the_concat(self, monkeypatch):
        monkeypatch.setattr(tq, "cast_bf16_group", None)  # never called
        tls = [torch.ones(3, dtype=torch.bfloat16), torch.zeros(5, dtype=torch.bfloat16)]
        tp = tcol._DeviceWirePacker(tls, "bf16")
        (pay,), _ = tp.pack_step(tls)
        assert tp._casts == [None]
        assert _words(pay) == [0x3F80] * 3 + [0] * 5


def _q8_pack(leaves, steps: int = 2):
    """Codes and scales of the last of ``steps`` q8ef group packs."""
    ts = [torch.from_numpy(a) for a in leaves]
    n = sum(a.size for a in leaves)
    carry = torch.zeros(n)
    codes = torch.empty(n, dtype=torch.int8)
    scales = torch.empty(len(leaves))
    for _ in range(steps):
        tq.quantize_q8_ef_group(ts, carry, codes, scales)
    return codes, scales


def _decode_group(case: str):
    rng = np.random.default_rng(80 + len(case))
    if case == "ragged":
        return [_rand(rng, n, 10.0 ** (i % 3 - 1))
                for i, n in enumerate((1, 3, 127, 128, 4099, 65537))]
    if case == "poisoned_leaf":
        leaves = [_rand(rng, 4099), _rand(rng, 127), _rand(rng, 1000)]
        leaves[1][5] = np.nan
        return leaves
    if case == "empty_leaf":
        return [_rand(rng, 17), np.zeros(0, np.float32), _rand(rng, 3)]
    if case == "tiny_lm":
        return [a.reshape(-1) for a in _tiny_lm_leaves(0)[0]]
    raise KeyError(case)


class TestDequantizeGroupAgainstJax:
    @pytest.mark.parametrize("case", ["ragged", "poisoned_leaf", "empty_leaf",
                                      "tiny_lm"])
    def test_bit_identical_to_jax_decode_leaf_by_leaf(self, case):
        leaves = _decode_group(case)
        counts = [a.size for a in leaves]
        codes, scales = _q8_pack(leaves)
        out = torch.full((sum(counts),), 7.0)
        tq.dequantize_q8_group(codes, scales, counts, out)
        want, off = [], 0
        for k, n in enumerate(counts):
            want.append(np.asarray(jq.dequantize_q8(
                jnp.asarray(codes[off:off + n].numpy()),
                jnp.asarray(scales[k].numpy()), interpret=True)))
            off += n
        assert _bits(out.numpy()) == b"".join(_bits(w) for w in want)
        if case == "poisoned_leaf":
            part = out[4099:4099 + 127].view(torch.int32)
            assert bool((part == 0x7FC00000).all())

    def test_subnormal_scale_matches_numpy_oracle(self):
        """ROADMAP F5 over a group: XLA's CPU backend flushes the
        subnormal scale 0x0001A2B3 in interpret mode; numpy, the plain
        version and the card keep the IEEE products."""
        codes = torch.tensor([5, -2, 1, -3, 127], dtype=torch.int8)
        sub = np.array(0x0001A2B3, np.uint32).view(np.float32)
        scales = torch.from_numpy(np.array([0.25, sub], np.float32))
        out = torch.empty(5)
        tq.dequantize_q8_group(codes, scales, [2, 3], out)
        want = np.concatenate([codes[:2].numpy().astype(np.float32) * np.float32(0.25),
                               codes[2:].numpy().astype(np.float32) * sub])
        assert _bits(out.numpy()) == _bits(want)
        assert out[2:].view(torch.int32).numpy().view(np.uint32).tolist() == \
            [0x0001A2B3, 0x8004E819, 0x00CFB6CD]

    def test_nan_and_inf_scales(self):
        """A NaN scale poisons its leaf with 0x7FC00000, and so does an Inf
        scale on zero codes (0 * Inf); other leaves are untouched."""
        codes = torch.tensor([1, -2, 0, 0, 3, 4], dtype=torch.int8)
        scales = torch.tensor([float("nan"), float("inf"), 0.5])
        out = torch.empty(6)
        tq.dequantize_q8_group(codes, scales, [2, 2, 2], out)
        assert out[:4].view(torch.int32).tolist() == [0x7FC00000] * 4
        assert out[4:].tolist() == [1.5, 2.0]

    def test_special_scales_decode_as_tabled(self):
        """The shared table of K2's special scales (the card tests and
        chip_smoke.py hold the kernel to it) against the decode here."""
        scale_bits, leaf_codes, want = Q8_DECODE_SPECIALS
        codes = torch.tensor([c for cs in leaf_codes for c in cs], dtype=torch.int8)
        scales = torch.tensor(scale_bits, dtype=torch.int64).to(torch.int32)
        out = torch.empty(len(want))
        tq.dequantize_q8_group(codes, scales.view(torch.float32),
                               [len(cs) for cs in leaf_codes], out)
        assert out.view(torch.int32).numpy().view(np.uint32).tolist() == want

    def test_one_leaf_equals_the_per_leaf_decode(self):
        codes, scales = _q8_pack([_rand(np.random.default_rng(3), 999)], steps=1)
        out = torch.empty(999)
        tq.dequantize_q8_group(codes, scales, [999], out)
        assert _bits(out.numpy()) == _bits(tq.dequantize_q8(codes, scales[0]).numpy())

    def test_empty_group(self):
        tq.dequantize_q8_group(torch.zeros(0, dtype=torch.int8), torch.zeros(0), [],
                               torch.zeros(0))

    @pytest.mark.parametrize("bad, exc", [
        (dict(codes=torch.zeros(9, dtype=torch.int8)), ValueError),
        (dict(codes=torch.zeros(10, dtype=torch.int16)), TypeError),
        (dict(scales=torch.zeros(3)), ValueError),
        (dict(scales=torch.zeros(2, dtype=torch.float64)), TypeError),
        (dict(out=torch.zeros(11)), ValueError),
        (dict(out=torch.zeros(20)[::2]), TypeError),
        (dict(counts=[4, -1, 7]), ValueError),
    ], ids=["short_codes", "int16_codes", "scales_count", "f64_scales",
            "long_out", "strided_out", "negative_count"])
    def test_refuses_mismatched_buffers(self, bad, exc):
        args = dict(codes=torch.zeros(10, dtype=torch.int8), scales=torch.ones(2),
                    counts=[4, 6], out=torch.zeros(10))
        args.update(bad)
        with pytest.raises(exc):
            tq.dequantize_q8_group(**args)
