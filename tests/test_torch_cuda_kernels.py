"""The port's CUDA kernels against their plain PyTorch versions on the
card: the wire kernels bit for bit (per leaf through one-segment tables,
and over whole plan groups), the flash-attention kernels within the
tolerances stated at ``_flash_tol``, and K3 on the heal path: the bf16
heal staging's narrowed ``opt_state`` leaves, and a streamed heal from
card to card.

Needs a CUDA device (the hand-written kernels have no CPU interpreter);
without one every test skips with that reason, and the plain versions are
held against the JAX kernels by tests/test_torch_quantize_kernels.py and
tests/test_torch_flash_attention.py.
This file imports no JAX, so it also runs on a machine with only the
port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import importlib

import numpy as np
import pytest
import torch

from torchft_tpu_torch.ops import quantize_kernels as tq
from torchft_tpu_torch.ops.wire_bits import CAST_BF16_WORDS, Q8_DECODE_SPECIALS

# the module (the package's name `flash_attention` is its entry point)
tfa = importlib.import_module("torchft_tpu_torch.ops.flash_attention")

# f32 NaN/Inf bit patterns and the bf16 words they must cast to.
NAN_BITS = {
    0x7FC00000: 0x7FC0,
    0x7FFFFFFF: 0x7FC0,
    0x7F800001: 0x7FC0,
    0xFFC00000: 0xFFC0,
    0xFFFFFFFF: 0xFFC0,
    0x7F800000: 0x7F80,
    0x3F818000: 0x3F82,
}


def _cases():
    rng = np.random.default_rng(11)
    return {
        "random": (rng.standard_normal(4096).astype(np.float32),
                   (rng.standard_normal(4096) * 1e-2).astype(np.float32)),
        "ragged_1": (np.array([0.7], np.float32), np.zeros(1, np.float32)),
        "ragged_1000003": (rng.standard_normal(1000003).astype(np.float32),
                           (rng.standard_normal(1000003) * 1e-3)
                           .astype(np.float32)),
        "matrix_512x1536": (rng.standard_normal((512, 1536)).astype(np.float32),
                            np.zeros((512, 1536), np.float32)),
        "all_zero": (np.zeros(300, np.float32), np.zeros(300, np.float32)),
        "subnormal": (np.full(17, 1e-40, np.float32), np.zeros(17, np.float32)),
        "inf_leaf": (np.array([1.0, np.inf, 2.0], np.float32),
                     np.zeros(3, np.float32)),
        "nan_leaf": (np.array([1.0, 2.0, np.nan, -4.0], np.float32),
                     np.zeros(4, np.float32)),
        "nan_bit_patterns": (
            np.array(list(NAN_BITS), np.uint32).view(np.float32),
            np.zeros(len(NAN_BITS), np.float32),
        ),
    }


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs a CUDA device: the hand-written kernels have no CPU "
            "interpreter (their plain versions are tested against JAX in "
            "tests/test_torch_quantize_kernels.py)"
        )
    return torch.device("cuda")


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_cases()))
def test_q8ef_kernels_match_plain(cuda_device, case):
    x, res = (torch.from_numpy(a).to(cuda_device) for a in _cases()[case])
    before = dict(tq.launch_counts)
    absmax = tq.q8_absmax(x, res)
    want_absmax = tq.plain["q8_absmax"](x, res)
    got = tq.q8_quantize(x, res, absmax)
    want = tq.plain["q8_quantize"](x, res, want_absmax)
    torch.cuda.synchronize()
    if torch.isnan(want_absmax):  # which NaN is not part of the contract
        assert torch.isnan(absmax)
    else:
        assert _bytes(absmax) == _bytes(want_absmax)
    for g, w in zip(got, want):
        assert _bytes(g) == _bytes(w)
    assert tq.launch_counts["q8_absmax"] == before["q8_absmax"] + 1
    assert tq.launch_counts["q8_quantize"] == before["q8_quantize"] + 1


# -- K1a/K1b over a plan group (the segmented launches) -----------------------


def _lm_shapes(**cfg):
    from torchft_tpu_torch._tree import flatten
    from torchft_tpu_torch.models import transformer as tt

    params = tt.init_params(tt.TransformerConfig(**cfg), device="meta")
    return [tuple(p.shape) for p in flatten(params)[0]]


# the dense LM the repository benchmarks by default, and bench.py's "big"
# LM (chip_smoke.py trains both)
DENSE_LM = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=6,
                d_ff=2048, max_seq_len=512)
FLASH_LM = dict(vocab_size=8192, d_model=1024, n_heads=16, n_layers=8,
                d_ff=4096, max_seq_len=2048, use_flash=True)


def _seg_capacity() -> int:
    from torchft_tpu_torch.ops._lib import _kernels

    return _kernels.lib().tft_seg_capacity()


def _group_check(leaves, res0, at: int = 0):
    """The group entry point on the card against its plain version on the
    same inputs, bit for bit (codes, scales, carry; K1a's absmax too, up to
    which NaN), with one K1a and one K1b launch per table of up to the
    kernels' capacity. ``at`` shifts the carry and the code buffer that
    many elements off their allocations' start (off the 16-byte grid, and
    code offsets off the 4-byte grid). Returns the card's (codes, scales,
    carry)."""
    dev = res0.device
    n = sum(l.numel() for l in leaves)
    outs = []
    for body in ("kernel", "plain"):
        res = torch.empty(n + at, device=dev)[at:]
        res.copy_(res0)
        codes = torch.full((n + at,), 99, dtype=torch.int8, device=dev)[at:]
        scales = torch.full((len(leaves),), 7.0, device=dev)
        before = dict(tq.launch_counts)
        if body == "kernel":
            tq.quantize_q8_ef_group(leaves, res, codes, scales)
            tables = -(-len(leaves) // _seg_capacity())
            assert tq.launch_counts["q8_absmax"] == before["q8_absmax"] + tables
            assert tq.launch_counts["q8_quantize"] == before["q8_quantize"] + tables
        else:
            tq.plain_group["quantize_q8_ef"](leaves, res, codes, scales)
            assert tq.launch_counts == before
        outs.append((codes, scales, res))
    torch.cuda.synchronize()
    for part, got, want in zip(("codes", "scales", "carry"), *outs):
        assert _bytes(got) == _bytes(want), part
    got = tq.q8_absmax_group(leaves, res0)
    want = tq.plain_group["q8_absmax"](leaves, res0)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert _bytes(got[~nan]) == _bytes(want[~nan])
    return outs[0]


def _randn(shape, gen, dev, scale=1.0):
    return torch.randn(shape, generator=gen, device=dev) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("lm", ["dense", "flash"])
def test_q8_group_kernels_match_plain_at_the_lm_shapes(cuda_device, lm):
    shapes = _lm_shapes(**(DENSE_LM if lm == "dense" else FLASH_LM))
    assert len(shapes) == (39 if lm == "dense" else 51)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    leaves = [_randn(s, gen, cuda_device, 1e-2) for s in shapes]
    res0 = _randn(sum(l.numel() for l in leaves), gen, cuda_device, 1e-4)
    _group_check(leaves, res0)


def _specials(dev, gen):
    nan_bits = torch.tensor(list(NAN_BITS), dtype=torch.int64).to(torch.int32)
    return [
        _randn(1000003, gen, dev),
        torch.zeros(4099, device=dev),
        torch.tensor([1.0, float("nan"), -2.0], device=dev),
        _randn(2048 * 3, gen, dev),
        torch.tensor([1.0, float("inf"), 2.0], device=dev),
        nan_bits.view(torch.float32).to(dev),
        torch.zeros(0, device=dev),
        _randn((37, 129), gen, dev),
    ]


@pytest.mark.cuda
def test_q8_group_specials_poison_only_their_segment(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    leaves = _specials(cuda_device, gen)
    res0 = _randn(sum(l.numel() for l in leaves), gen, cuda_device, 1e-3)
    codes, scales, res = _group_check(leaves, res0)
    poisoned = [bool((s.view(torch.int32) == 0x7FC00000).item()) for s in scales]
    assert poisoned == [False, False, True, False, True, True, False, False]
    assert scales[6].item() == np.float32(1e-12)  # the empty leaf's floor


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
def test_q8_group_misaligned_views(cuda_device, offset):
    """Leaves, the carry and the codes at storage offsets off the 16-byte
    grid take the scalar path of the same kernels."""
    gen = torch.Generator(device=cuda_device).manual_seed(offset)
    sizes = [4099, 2048, 65537, 1, 512]
    base = _randn(sum(sizes) + offset + 8, gen, cuda_device)
    leaves, at = [], offset
    for n in sizes:
        leaves.append(base[at:at + n])
        at += n + 1
    _group_check(leaves, _randn(sum(sizes), gen, cuda_device, 1e-3), at=offset)


@pytest.mark.cuda
def test_q8_group_code_offsets_off_the_4_byte_grid(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    leaves = [_randn(n, gen, cuda_device) for n in (3, 5, 7, 4096, 2049, 6, 70001)]
    res0 = _randn(sum(l.numel() for l in leaves), gen, cuda_device, 1e-3)
    _group_check(leaves, res0)


@pytest.mark.cuda
def test_q8_group_bf16_and_strided_leaves_are_copied(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    leaves = [_randn(4099, gen, cuda_device).to(torch.bfloat16),
              _randn((64, 48), gen, cuda_device).t(),
              _randn(1024, gen, cuda_device)]
    res0 = _randn(sum(l.numel() for l in leaves), gen, cuda_device, 1e-3)
    _group_check(leaves, res0)


@pytest.mark.cuda
def test_q8_group_past_the_table_capacity(cuda_device):
    """More leaves than one launch's table holds: several launches, the
    same bits."""
    rng = np.random.default_rng(8)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    sizes = rng.integers(0, 3000, 2 * _seg_capacity() + 77).tolist()
    leaves = [_randn(int(n), gen, cuda_device) for n in sizes]
    res0 = _randn(sum(sizes), gen, cuda_device, 1e-3)
    _group_check(leaves, res0)


@pytest.mark.cuda
def test_q8_group_is_bit_identical_run_to_run(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    leaves = [_randn(s, gen, cuda_device, 1e-2) for s in _lm_shapes(**DENSE_LM)]
    leaves += _specials(cuda_device, gen)
    res0 = _randn(sum(l.numel() for l in leaves), gen, cuda_device, 1e-4)
    first = _group_check(leaves, res0)
    second = _group_check(leaves, res0)
    for a, b in zip(first, second):
        assert _bytes(a) == _bytes(b)


@pytest.mark.cuda
def test_packer_launches_one_k1_pair_per_step(cuda_device):
    """The q8ef device pack: one K1a and one K1b launch per plan group per
    step, the carry advanced in place in its one flat buffer, and the
    pack bit-identical to the plain pack of the same leaves on the CPU."""
    from torchft_tpu_torch.collectives import _DeviceWirePacker

    gen = torch.Generator(device=cuda_device).manual_seed(10)
    shapes = _lm_shapes(**DENSE_LM)
    card = _DeviceWirePacker([torch.empty(s, device=cuda_device) for s in shapes],
                             "q8ef")
    host = _DeviceWirePacker([torch.empty(s) for s in shapes], "q8ef")
    carry = card._carry.data_ptr()
    for step in range(3):
        leaves = [_randn(s, gen, cuda_device, 1e-2) for s in shapes]
        before = dict(tq.launch_counts)
        ready = torch.cuda.current_stream().record_event()
        (pay,), (sc,) = card.pack_step(leaves, ready)
        assert tq.launch_counts["q8_absmax"] == before["q8_absmax"] + 1
        assert tq.launch_counts["q8_quantize"] == before["q8_quantize"] + 1
        (hpay,), (hsc,) = host.pack_step([l.cpu() for l in leaves])
        assert _bytes(pay) == _bytes(hpay) and _bytes(sc) == _bytes(hsc), step
        torch.cuda.synchronize()
        assert _bytes(card._carry) == _bytes(host._carry), step
        assert card._carry.data_ptr() == carry
    card.reset_feedback()
    card.stream.synchronize()
    assert not bool(card._carry.any())


@pytest.mark.cuda
def test_nonfinite_leaf_poisons_with_canonical_nan(cuda_device):
    x = torch.tensor([1.0, float("inf"), 2.0], device=cuda_device)
    q, s, r = tq.quantize_q8_ef(x, torch.zeros(3, device=cuda_device))
    assert q.tolist() == [0, 0, 0]
    assert s.view(torch.int32).item() == 0x7FC00000
    assert (r.view(torch.int32) == 0x7FC00000).all()


@pytest.mark.cuda
def test_cast_matches_plain(cuda_device):
    """The per-leaf cast: one launch of the segmented K3, one segment."""
    rng = np.random.default_rng(9)
    x = np.concatenate([
        rng.standard_normal(100003).astype(np.float32),
        np.array([0.0, -0.0, 1e-40, -1e-40, 3.4e38, -3.4e38], np.float32),
        np.array(list(NAN_BITS), np.uint32).view(np.float32),
    ])
    xd = torch.from_numpy(x).to(cuda_device)
    before = tq.launch_counts["cast_bf16"]
    got = tq.cast_bf16(xd)
    want = tq.plain["cast_bf16"](xd)
    assert _bytes(got) == _bytes(want)
    words = got.view(torch.int16).cpu().numpy().view(np.uint16)
    assert words[-len(NAN_BITS):].tolist() == list(NAN_BITS.values())
    assert tq.launch_counts["cast_bf16"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("scale_bits", [0x3C23D70A, 0, 0x7FC00000])
def test_dequantize_matches_plain(cuda_device, scale_bits):
    """The per-leaf decode: one launch of the segmented K2, one segment."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-127, 128, 100003).astype(np.int8))
    scale = torch.tensor([scale_bits], dtype=torch.int32).view(torch.float32)[0]
    qd, sd = q.to(cuda_device), scale.to(cuda_device)
    before = tq.launch_counts["q8_dequantize"]
    got = tq.dequantize_q8(qd, sd)
    assert _bytes(got) == _bytes(tq.plain["q8_dequantize"](qd, sd))
    assert _bytes(got) == _bytes(tq.dequantize_q8(q, scale))  # the CPU body
    assert tq.launch_counts["q8_dequantize"] == before + 1


# -- K3 and K2 over a plan group (the segmented launches) ---------------------


def _tables(n_segments: int) -> int:
    return -(-n_segments // _seg_capacity())


def _cast_group_check(leaves, at: int = 0):
    """K3 over the group on the card against its plain version on the same
    inputs, bit for bit, with one launch per table. ``at`` puts the bf16
    buffer that many words off its allocation's start (offsets off the
    8-byte grid). Returns the card's words."""
    n = sum(l.numel() for l in leaves)
    outs = []
    for body in ("kernel", "plain"):
        out = torch.full((n + at,), 3.0, dtype=torch.bfloat16,
                         device=leaves[0].device)[at:]
        before = dict(tq.launch_counts)
        if body == "kernel":
            tq.cast_bf16_group(leaves, out)
            assert tq.launch_counts["cast_bf16"] == before["cast_bf16"] + _tables(len(leaves))
        else:
            tq.plain_group["cast_bf16"](leaves, out)
            assert tq.launch_counts == before
        outs.append(out)
    torch.cuda.synchronize()
    assert _bytes(outs[0]) == _bytes(outs[1])
    return outs[0]


def _dequant_group_check(codes, scales, counts, at: int = 0):
    """K2 over the group on the card against its plain version, bit for
    bit, with one launch per table; ``at`` shifts the f32 output off the
    16-byte grid. Returns the card's values."""
    n = sum(counts)
    outs = []
    for body in ("kernel", "plain"):
        out = torch.full((n + at,), 7.0, device=codes.device)[at:]
        before = dict(tq.launch_counts)
        if body == "kernel":
            tq.dequantize_q8_group(codes, scales, counts, out)
            assert tq.launch_counts["q8_dequantize"] == \
                before["q8_dequantize"] + _tables(len(counts))
        else:
            tq.plain_group["q8_dequantize"](codes, scales, counts, out)
            assert tq.launch_counts == before
        outs.append(out)
    torch.cuda.synchronize()
    assert _bytes(outs[0]) == _bytes(outs[1])
    return outs[0]


def _q8_wire(leaves, at: int = 0):
    """The codes and scales of a q8ef group pack of ``leaves`` (the codes
    ``at`` bytes off their allocation's start) and the leaves' counts."""
    dev = leaves[0].device
    n = sum(l.numel() for l in leaves)
    codes = torch.empty(n + at, dtype=torch.int8, device=dev)[at:]
    scales = torch.empty(len(leaves), device=dev)
    tq.quantize_q8_ef_group(leaves, torch.zeros(n, device=dev), codes, scales)
    return codes, scales, [l.numel() for l in leaves]


def _wire_group(case: str, dev):
    """(leaves, buffer offset) of a named group for K3 and K2."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    if case in ("dense", "flash"):
        shapes = _lm_shapes(**(DENSE_LM if case == "dense" else FLASH_LM))
        return [_randn(s, gen, dev, 1e-2) for s in shapes], 0
    if case == "specials":
        return _specials(dev, gen) + [
            torch.tensor(list(CAST_BF16_WORDS), dtype=torch.int64)
            .to(torch.int32).view(torch.float32).to(dev)], 0
    if case in ("views_at_offset_1", "views_at_offset_3"):
        offset = int(case[-1])
        sizes = [4099, 2048, 65537, 1, 512]
        base = _randn(sum(sizes) + offset + 8, gen, dev)
        leaves, at = [], offset
        for n in sizes:
            leaves.append(base[at:at + n])
            at += n + 1
        return leaves, offset
    if case == "offsets_off_the_vector_grid":
        return [_randn(n, gen, dev) for n in (3, 5, 7, 4096, 2049, 6, 70001)], 0
    if case == "past_the_table_capacity":
        sizes = np.random.default_rng(8).integers(0, 3000, 2 * _seg_capacity() + 77)
        return [_randn(int(n), gen, dev) for n in sizes], 0
    raise KeyError(case)


WIRE_GROUPS = ("dense", "flash", "specials", "views_at_offset_1",
               "views_at_offset_3", "offsets_off_the_vector_grid",
               "past_the_table_capacity")


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIRE_GROUPS)
def test_cast_group_matches_plain(cuda_device, case):
    leaves, at = _wire_group(case, cuda_device)
    words = _cast_group_check(leaves, at)
    if case == "specials":
        got = words[-len(CAST_BF16_WORDS):].view(torch.int16).cpu().numpy()
        assert got.view(np.uint16).tolist() == list(CAST_BF16_WORDS.values())


@pytest.mark.cuda
def test_cast_group_mixed_bf16_and_strided_leaves(cuda_device):
    """Native bf16 leaves (a NaN payload 0x7FC1 among them) and a strided
    view are copied to f32 first: the words are those of the f32 cast."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    nan_payload = torch.tensor([0x7FC1, -0x7F], dtype=torch.int16).view(torch.bfloat16)
    leaves = [_randn(4099, gen, cuda_device).to(torch.bfloat16),
              _randn((64, 48), gen, cuda_device).t(),
              nan_payload.to(cuda_device), _randn(1024, gen, cuda_device)]
    words = _cast_group_check(leaves)
    nan_words = words[4099 + 64 * 48:][:2].view(torch.int16).cpu().numpy()
    assert nan_words.view(np.uint16).tolist() == [0x7FC0, 0xFFC0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIRE_GROUPS)
def test_dequantize_group_matches_plain(cuda_device, case):
    """K2 on the codes and scales of a real q8ef group pack; the code
    buffer and the output shifted off their vector grids for the views
    cases."""
    leaves, at = _wire_group(case, cuda_device)
    codes, scales, counts = _q8_wire(leaves, at)
    _dequant_group_check(codes, scales, counts, at)


@pytest.mark.cuda
def test_dequantize_group_special_scales(cuda_device):
    """A NaN scale and an Inf scale on zero codes poison their leaf with
    0x7FC00000; the subnormal scale 0x0001A2B3 keeps IEEE products (F5)."""
    scale_bits, leaf_codes, want = Q8_DECODE_SPECIALS
    codes = torch.tensor([c for cs in leaf_codes for c in cs], dtype=torch.int8,
                         device=cuda_device)
    scales = torch.tensor(scale_bits, dtype=torch.int64).to(torch.int32)
    got = _dequant_group_check(codes, scales.view(torch.float32).to(cuda_device),
                               [len(cs) for cs in leaf_codes])
    assert got.view(torch.int32).cpu().numpy().view(np.uint32).tolist() == want


@pytest.mark.cuda
def test_wire_groups_are_bit_identical_run_to_run(cuda_device):
    leaves, _ = _wire_group("dense", cuda_device)
    leaves += _wire_group("specials", cuda_device)[0]
    assert _bytes(_cast_group_check(leaves)) == _bytes(_cast_group_check(leaves))
    codes, scales, counts = _q8_wire(leaves)
    assert _bytes(_dequant_group_check(codes, scales, counts)) == \
        _bytes(_dequant_group_check(codes, scales, counts))


@pytest.mark.cuda
def test_packer_launches_one_k3_per_bf16_group_per_step(cuda_device):
    """The bf16 device pack: one K3 launch per bf16 group with f32 leaves
    per step, into the wire buffer allocated once, no other kernel of the
    port, and the payloads bit-identical to the plain pack on the CPU."""
    from torchft_tpu_torch.collectives import _DeviceWirePacker

    gen = torch.Generator(device=cuda_device).manual_seed(13)
    shapes = _lm_shapes(**DENSE_LM)

    def leaves_of(dev):
        return [torch.empty(s, device=dev) for s in shapes] + [
            torch.empty(5, dtype=torch.bfloat16, device=dev),
            torch.empty(3, dtype=torch.int32, device=dev)]

    card = _DeviceWirePacker(leaves_of(cuda_device), "bf16")
    host = _DeviceWirePacker(leaves_of("cpu"), "bf16")
    assert len(card.groups) == 2
    wire = card._casts[0].data_ptr()
    for step in range(3):
        leaves = [_randn(s, gen, cuda_device, 1e-2) for s in shapes]
        leaves += [_randn(5, gen, cuda_device).to(torch.bfloat16),
                   torch.arange(3, dtype=torch.int32, device=cuda_device) + step]
        before = dict(tq.launch_counts)
        ready = torch.cuda.current_stream().record_event()
        pays, scales = card.pack_step(leaves, ready)
        want = dict(before, cast_bf16=before["cast_bf16"] + 1)
        assert tq.launch_counts == want
        hpays, _ = host.pack_step([l.cpu() for l in leaves])
        assert scales == []
        for a, b in zip(pays, hpays):
            assert _bytes(a) == _bytes(b), step
        assert card._casts[0].data_ptr() == wire


def _flash_inputs(device, shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=dtype) for _ in range(4)]


def _flash_tol(ref: torch.Tensor) -> float:
    """f32: 2e-5 (the JAX package's own flash tolerance; the kernel and
    the plain version differ only in f32 summation order). bf16: two bf16
    steps at the tensor's largest magnitude (2**-6 of it): the kernel
    rounds p to bf16 against each tile's running max, the plain version
    against the row's final max, so single elements of p, ds and the
    outputs may land one bf16 step apart."""
    if ref.dtype == torch.float32:
        return 2e-5 * max(1.0, float(ref.abs().max()))
    return 2.0 ** -6 * float(ref.float().abs().max())


def _flash_check(device, shape, dtype, causal=True, window=None, block_k=None):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 products
    q, k, v, do = _flash_inputs(device, shape, dtype)
    cfg = tfa.FlashConfig(causal, window, *tfa.resolve_blocks(
        shape[1], device, None, block_k))
    before = dict(tq.launch_counts)
    out, lse = tfa.flash_fwd(q, k, v, cfg)
    grads = tfa.flash_bwd(q, k, v, out, lse, do, cfg)
    assert tq.launch_counts["flash_fwd"] == before["flash_fwd"] + 1
    assert tq.launch_counts["flash_bwd"] == before["flash_bwd"] + 2
    want_out, want_lse = tfa.flash_fwd_plain(q, k, v, cfg)
    want = tfa.flash_bwd_plain(q, k, v, do, lse,
                               tfa.flash_delta_plain(out, do), cfg)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out, *grads),
                          (want_out, *want)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max())
        assert err <= _flash_tol(w), (name, err, _flash_tol(w))
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    return q, k, v, do, out, lse, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 130, 3, 64), (1, 257, 2, 128),
                                   (1, 64, 1, 64), (2, 33, 2, 64),
                                   # below one tile, and past tile multiples
                                   (1, 8, 2, 64), (1, 65, 2, 64),
                                   (1, 515, 2, 64), (1, 1100, 2, 64),
                                   (1, 2047, 2, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_match_plain(cuda_device, dtype, shape, causal):
    _flash_check(cuda_device, shape, dtype, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 16, 200, 1000])
@pytest.mark.parametrize("block_k", [64, 32])
def test_flash_kernels_window_and_blocks(cuda_device, window, block_k):
    _flash_check(cuda_device, (1, 1100, 2, 64), torch.bfloat16,
                 window=window, block_k=block_k)


@pytest.mark.cuda
def test_flash_kernels_at_the_path_sequence(cuda_device):
    """The LM's sequence (2047: the last token is dropped), bf16, causal,
    at a reduced batch and head count."""
    _flash_check(cuda_device, (1, 2047, 2, 64), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(shape=(2, 515, 2, 64)),
    dict(shape=(1, 515, 2, 64), causal=False),
    dict(shape=(1, 1100, 2, 64), window=1),
    dict(shape=(1, 1100, 2, 64), window=200, block_k=32),
    dict(shape=(2, 257, 2, 128), block_k=32),
], ids=["causal", "non_causal", "window1", "window200_bk32", "d128_bk32"])
def test_flash_backward_is_deterministic(cuda_device, case):
    """dq, dk and dv carry the same bits run to run (no float atomics)."""
    kw = dict(case)
    shape = kw.pop("shape")
    q, k, v, do, out, lse, cfg = _flash_check(cuda_device, shape,
                                              torch.bfloat16, **kw)
    first = tfa.flash_bwd(q, k, v, out, lse, do, cfg)
    second = tfa.flash_bwd(q, k, v, out, lse, do, cfg)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert _bytes(a) == _bytes(b), name


@pytest.mark.cuda
@pytest.mark.parametrize("block_k", [64, 32])
def test_flash_kernels_window1_not_causal(cuda_device, block_k):
    """window 1 without the causal mask: each query sees every key at or
    after its own position (q_pos - k_pos < 1)."""
    _flash_check(cuda_device, (1, 300, 2, 64), torch.bfloat16, causal=False,
                 window=1, block_k=block_k)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_head_dim128_block_k32(cuda_device, causal):
    _flash_check(cuda_device, (2, 257, 2, 128), torch.bfloat16,
                 causal=causal, block_k=32)


@pytest.mark.cuda
def test_flash_reads_the_strided_qkv_split(cuda_device):
    """q, k, v as views of one (B, S, 3D) tensor, as the model's qkv
    split yields them: the same result as contiguous copies."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 100, 3 * 128))
                           .astype(np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = (t.reshape(2, 100, 2, 64) for t in torch.split(qkv, 128, -1))
    assert not k.is_contiguous()
    got = tfa.flash_attention(q, k, v)
    want = tfa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert _bytes(got) == _bytes(want)


@pytest.mark.cuda
def test_flash_refuses_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 8, 1, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="CUDA kernels take"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 1, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 1, 64, device=cuda_device)
    with pytest.raises(ValueError, match="block_q"):
        tfa.flash_attention(q, q, q, block_q=128)
    # cp.async copies 16-byte rows: a bf16 view at an odd storage offset,
    # or with a row stride off the 8-element grid, raises (no copy)
    base = torch.zeros(2 * 100 * 2 * 64 + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    q = base[1:].view(2, 100, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q, q, q)
    qkv = torch.zeros(2, 100, 3 * 128 + 1, device=cuda_device,
                      dtype=torch.bfloat16)
    q, k, v = (t.reshape(2, 100, 2, 64) for t in
               torch.split(qkv[..., :3 * 128], 128, -1))
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("mn_major", [0, 1], ids=["q_kT", "p_v"])
def test_wgmma_tile_product_matches_matmul(cuda_device, mn_major):
    """One wgmma tile product through the forward's tensor maps,
    swizzled tiles and descriptors: both operands K-major from shared
    memory (as s = q . k^T), and A from registers with B MN-major (as
    o = p . v). A wrong descriptor or swizzle moves whole rows or
    16-byte chunks, far past the f32 summation-order tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(15)
    a, b = (torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    c = torch.empty(64, 64, device=cuda_device)
    lib = tfa._kernels.lib()
    rc = lib.tft_wgmma_tile_test(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                 mn_major, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, lib.tft_cuda_error_string(rc)
    want = a.float() @ (b.float() if mn_major else b.float().T)
    torch.testing.assert_close(c, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2047, 1100, 257])
@pytest.mark.parametrize("D,block_k", [(64, 64), (64, 32), (128, 64),
                                       (128, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_ragged_tails(cuda_device, S, D, block_k, causal):
    """K4 (TMA boxes of 64 query and block_k key rows) where the last box
    runs past S and reads zeros, for every (D, block_k) it takes."""
    shape = (1, S, 2, D)
    q, k, v, _ = _flash_inputs(cuda_device, shape, torch.bfloat16, seed=S)
    cfg = tfa.FlashConfig(causal, None, *tfa.resolve_blocks(
        S, cuda_device, None, block_k))
    out, lse = tfa.flash_fwd(q, k, v, cfg)
    want_out, want_lse = tfa.flash_fwd_plain(q, k, v, cfg)
    err = float((out.float() - want_out.float()).abs().max())
    assert err <= _flash_tol(want_out), (err, _flash_tol(want_out))
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_forward_is_deterministic_at_the_path_shape(cuda_device):
    """K4 at the flash LM's call (B16 H16 S2047 D64, bf16, causal) gives
    the same bits run to run, and one launch a call."""
    q, k, v, _ = _flash_inputs(cuda_device, (16, 2047, 16, 64),
                               torch.bfloat16, seed=4)
    cfg = tfa.FlashConfig(True, None, *tfa.resolve_blocks(
        2047, cuda_device, None, None))
    before = tq.launch_counts["flash_fwd"]
    first = tfa.flash_fwd(q, k, v, cfg)
    second = tfa.flash_fwd(q, k, v, cfg)
    assert tq.launch_counts["flash_fwd"] == before + 2
    for name, x, y in zip(("out", "lse"), first, second):
        assert _bytes(x) == _bytes(y), name
    assert torch.isfinite(first[0].float()).all()


@pytest.mark.cuda
def test_flash_forward_reads_permuted_views(cuda_device):
    """q, k, v as (B, S, H, D) views of (B, H, S, D) tensors (the head
    stride above the row stride): the tensor maps order the dimensions by
    stride, so the result equals that of contiguous copies."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 300, 64))
                                .astype(np.float32))
               .to(cuda_device, torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    assert q.stride(2) > q.stride(1)
    got = tfa.flash_attention(q, k, v)
    want = tfa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert _bytes(got) == _bytes(want)


def _flash_bwd_check(q, k, v, do, cfg):
    """K5 (through K4's out and lse) against its plain version within
    ``_flash_tol``; returns the kernels' (dq, dk, dv)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 products
    out, lse = tfa.flash_fwd(q, k, v, cfg)
    grads = tfa.flash_bwd(q, k, v, out, lse, do, cfg)
    want = tfa.flash_bwd_plain(q, k, v, do, lse,
                               tfa.flash_delta_plain(out, do), cfg)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max())
        assert err <= _flash_tol(w), (name, err, _flash_tol(w))
    return grads


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2047, 1100, 257])
@pytest.mark.parametrize("D,block_k", [(64, 64), (64, 32), (128, 64),
                                       (128, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_ragged_tails(cuda_device, S, D, block_k, causal):
    """K5 (TMA boxes of 64 query rows, of block_k key rows in dq and of 64
    in dk/dv, lse and delta rows by 4-byte copies) where the last box runs
    past S and reads zeros, for every (D, block_k) it takes."""
    q, k, v, do = _flash_inputs(cuda_device, (1, S, 2, D), torch.bfloat16,
                                seed=S + D)
    cfg = tfa.FlashConfig(causal, None, *tfa.resolve_blocks(
        S, cuda_device, None, block_k))
    _flash_bwd_check(q, k, v, do, cfg)


@pytest.mark.cuda
def test_flash_backward_reads_permuted_views(cuda_device):
    """q, k, v, do and out as (B, S, H, D) views of (B, H, S, D) tensors:
    the backward's tensor maps and the dq kernel's delta loads follow the
    strides, so the gradients equal those of contiguous copies bit for
    bit."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 3, 300, 64))
                                    .astype(np.float32))
                   .to(cuda_device, torch.bfloat16).transpose(1, 2)
                   for _ in range(4))
    assert q.stride(2) > q.stride(1)
    cfg = tfa.FlashConfig(True, None, *tfa.resolve_blocks(
        300, cuda_device, None, None))
    out, lse = tfa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                             cfg)
    out_view = out.transpose(1, 2).contiguous().transpose(1, 2)
    got = tfa.flash_bwd(q, k, v, out_view, lse, do, cfg)
    want = tfa.flash_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out,
                         lse, do.contiguous(), cfg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _bytes(a) == _bytes(b), name


@pytest.mark.cuda
def test_flash_backward_is_deterministic_at_the_path_shape(cuda_device):
    """K5 at the flash LM's call (B16 H16 S2047 D64, bf16, causal) gives
    the same bits run to run, and two launches a call (dq with delta,
    then dk/dv)."""
    q, k, v, do = _flash_inputs(cuda_device, (16, 2047, 16, 64),
                                torch.bfloat16, seed=6)
    cfg = tfa.FlashConfig(True, None, *tfa.resolve_blocks(
        2047, cuda_device, None, None))
    out, lse = tfa.flash_fwd(q, k, v, cfg)
    before = tq.launch_counts["flash_bwd"]
    first = tfa.flash_bwd(q, k, v, out, lse, do, cfg)
    assert tq.launch_counts["flash_bwd"] == before + 2
    second = tfa.flash_bwd(q, k, v, out, lse, do, cfg)
    assert tq.launch_counts["flash_bwd"] == before + 4
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert _bytes(x) == _bytes(y), name
        assert torch.isfinite(x.float()).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_folds_delta_as_torch_does(cuda_device, dtype):
    """The dq kernel's delta = rowsum(do * out) at the path's shape equals
    the torch delta (``flash_delta_plain``) within f32 rounding: rtol
    1e-6, plus the bound on two summation orders of D products (2 D 2**-24
    of the row's sum of |do * out|; the bf16 kernel sums in the plain
    version's d order, the f32 scalar kernel over 16 lanes). It carries
    the same bits run to run."""
    shape = (16, 2047, 16, 64) if dtype == torch.bfloat16 else (2, 2047, 4, 64)
    q, k, v, do = _flash_inputs(cuda_device, shape, dtype, seed=7)
    cfg = tfa.FlashConfig(True, None, *tfa.resolve_blocks(
        2047, cuda_device, None, None))
    out, lse = tfa.flash_fwd(q, k, v, cfg)
    delta = tfa.flash_bwd_kernels(q, k, v, out, lse, do, cfg)[3]
    again = tfa.flash_bwd_kernels(q, k, v, out, lse, do, cfg)[3]
    want = tfa.flash_delta_plain(out, do)
    assert delta.shape == want.shape == (shape[0], shape[2], shape[1])
    mag = (do.float() * out.float()).abs().sum(-1).transpose(1, 2)
    tol = 1e-6 * want.abs() + 2 * shape[3] * 2.0 ** -24 * mag
    assert bool(((delta - want).abs() <= tol).all())
    assert _bytes(delta) == _bytes(again)


@pytest.mark.cuda
def test_wrapper_refuses_mismatched_inputs(cuda_device):
    x = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError):
        tq.quantize_q8_ef(x, torch.zeros(8))  # carry on the CPU
    with pytest.raises(ValueError):
        tq.q8_quantize(x, torch.zeros(8, device=cuda_device), torch.ones(()))


def _plan_ring(prefix: str, store):
    from torchft_tpu_torch.collectives import HostCollectives

    c = HostCollectives(stripes=1)
    c.configure(f"{store.address()}/{prefix}", 0, 1)
    return c


@pytest.mark.cuda
def test_card_leaves_refuse_the_host_pack(cuda_device):
    """A device pack on a wire no kernel encodes raises (nothing falls
    back to the host pack); the host pack runs only where the caller
    asks for it (``device_pack=False``), through the plan's pinned
    inputs, bit-identical to the device pack."""
    from torchft_tpu_torch._native import Store

    store = Store()
    c = _plan_ring("refuse", store)
    try:
        g = {"w": torch.linspace(-3, 5, 4099, device=cuda_device),
             "b": torch.full((7, 3), 0.25, device=cuda_device)}
        with pytest.raises(ValueError, match="packed there"):
            c.plan_allreduce(g, wire="q8")  # no kernel encodes this wire
        for wire in ("q8ef", "bf16", None):
            host = c.plan_allreduce(g, wire=wire, device_pack=False).wait()
            dev = c.plan_allreduce(g, wire=wire, device_pack=True).wait()
            for k in g:
                assert host[k].is_cuda
                # equal values: a one-member q8ef ring keeps the host
                # pack's -0.0 codes (F4), the device pack's decode +0.0
                assert torch.equal(host[k], dev[k])
            c.plan_reset_feedback()
        # the plain q8 wire on the caller's host pack
        q8 = c.plan_allreduce(g, wire="q8", device_pack=False).wait()
        assert q8["w"].is_cuda
    finally:
        c.shutdown()
        store.shutdown()


@pytest.mark.cuda
def test_pack_waits_for_the_gradients_not_for_later_work(cuda_device):
    """The pack waits on an event recorded at dispatch, so work the caller
    queues afterwards (here a ~1 s spin standing in for the next step's
    forward/backward) is still running when the averaged tree is back;
    and the card's pack stays bit-identical to the plain pack on the CPU
    over steps that advance the error-feedback carry."""
    from torchft_tpu_torch._native import Store

    store = Store()
    card, host = _plan_ring("card", store), _plan_ring("host", store)
    try:
        rng = np.random.default_rng(5)
        for step in range(3):
            g = {"w": torch.from_numpy(rng.standard_normal(1 << 20)
                                       .astype(np.float32))}
            gd = {"w": g["w"].to(cuda_device)}
            work = card.plan_allreduce(gd, wire="q8ef")
            if step:  # step 0 builds the plan, the staging and the kernels
                torch.cuda._sleep(2_000_000_000)
            out = work.wait()
            if step:
                assert not torch.cuda.current_stream().query()
            want = host.plan_allreduce(g, wire="q8ef", device_pack=True).wait()
            torch.cuda.synchronize()
            assert _bytes(out["w"]) == _bytes(want["w"])
    finally:
        card.shutdown()
        host.shutdown()
        store.shutdown()


def _heal_state(device, n_moments: int = 70):
    """A heal payload whose opt_state holds more f32 leaves than one K3
    table (and the NaN words), beside f32 params and an int count."""
    rng = np.random.default_rng(8)
    mu = [torch.from_numpy(rng.standard_normal(1000 + 37 * i)
                           .astype(np.float32)) for i in range(n_moments)]
    mu[0][:len(CAST_BF16_WORDS)] = torch.from_numpy(
        np.array(list(CAST_BF16_WORDS), np.uint32).view(np.float32))
    state = {"user": {
        "params": {"w": torch.from_numpy(rng.standard_normal((513, 7))
                                         .astype(np.float32))},
        "opt_state": {"count": 5, "mu": mu,
                      "nu": [m.abs() * 1e-3 for m in mu]},
    }, "torchft": {"step": 3}}
    return _tree_to(state, device)


def _tree_to(tree, device):
    from torchft_tpu_torch._tree import tree_map

    return tree_map(lambda l: l.to(device) if isinstance(l, torch.Tensor)
                    else l, tree)


@pytest.mark.cuda
def test_heal_staging_narrows_opt_state_with_k3(cuda_device):
    """The donor's bf16 heal staging on the card: K3 over the opt_state
    leaves (one launch per 64), written into the stream's layout, bit for
    bit the staging its plain version builds on the CPU."""
    from torchft_tpu_torch import checkpointing as ck

    card = _heal_state(cuda_device)
    before = dict(tq.launch_counts)
    staged = ck._StreamStaging(card, "bf16")
    assert tq.launch_counts["cast_bf16"] == before["cast_bf16"] + _tables(140)
    assert staged.buffer.is_pinned()
    host = ck._StreamStaging(_tree_to(card, "cpu"), "bf16")
    assert staged.meta == host.meta
    assert staged.buffer.numpy().tobytes() == host.buffer.numpy().tobytes()
    raw = ck._StreamStaging(card, None)
    assert raw.total == host.total + 4 * sum(
        m.numel() for m in card["user"]["opt_state"]["mu"])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, "bf16"])
def test_stream_heal_uploads_onto_the_card(cuda_device, wire):
    """Donor and receiver on the card: the staging waits for the stream
    that wrote the state (here behind a ~1 s spin), the leaves land on
    the card, params bit-identical, moments through K3's plain cast."""
    from datetime import timedelta

    from torchft_tpu_torch import checkpointing as ck
    from torchft_tpu_torch._tree import flatten

    server = ck.CheckpointServer(timeout=timedelta(seconds=30),
                                 device=cuda_device)
    try:
        state = _heal_state(cuda_device)
        writer = torch.cuda.Stream(cuda_device)
        w = state["user"]["params"]["w"]
        with torch.cuda.stream(writer):
            torch.cuda._sleep(1_000_000_000)
            w.add_(1.0)  # the write the publish must wait for
        server.send_checkpoint([1], 3, state, timedelta(seconds=30),
                               stream=writer)
        out, stats = ck.CheckpointServer._fetch(
            f"{server.address()}3", timedelta(seconds=30), wire=wire,
            streams=4, device=cuda_device)
        torch.cuda.synchronize()
        assert stats["path"] == "stream" and stats["h2d_s"] >= 0
        got = out["user"]["params"]["w"]
        assert got.device.type == "cuda" and _bytes(got) == _bytes(w)
        for m in ("mu", "nu"):
            for d, h in zip(flatten(state["user"]["opt_state"][m])[0],
                            flatten(out["user"]["opt_state"][m])[0]):
                assert h.device.type == "cuda" and h.dtype == torch.float32
                want = d if wire is None else tq.plain["cast_bf16"](d).float()
                assert _bytes(h) == _bytes(want)
    finally:
        server.shutdown()


# -- the legacy transport's quantize module and ops on card leaves ------------


def _q8_tree(shapes, gen, device, poison: bool = False):
    """A gradient tree of the given leaf shapes (a list, flatten order),
    leaf 3 poisoned with NaN and leaf 5 with Inf when ``poison``."""
    leaves = [_randn(s, gen, device, 1e-2) for s in shapes]
    if poison:
        leaves[3].view(-1)[7] = float("nan")
        leaves[5].view(-1)[0] = float("inf")
    return leaves


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [False, True])
def test_quantize_with_feedback_matches_plain(cuda_device, poison):
    """quantize_with_feedback on the card (one K1a + K1b launch and one K2
    launch over the dense LM's 39 leaves) bit for bit against its plain
    version on the same leaves on the CPU, over three steps that flip two
    flat carries (each step reads one and writes the other, the read one
    left untouched); poisoned leaves included."""
    from torchft_tpu_torch import quantize as q

    gen = torch.Generator(device=cuda_device).manual_seed(12)
    shapes = _lm_shapes(**DENSE_LM)
    n = sum(int(np.prod(s)) for s in shapes)
    carries = [torch.zeros(n, device=cuda_device), torch.empty(n, device=cuda_device)]
    host = [torch.zeros(n), torch.empty(n)]
    cur = 0
    for step in range(3):
        leaves = _q8_tree(shapes, gen, cuda_device, poison and step == 1)
        before = dict(tq.launch_counts)
        read = carries[cur].clone()
        out = q.quantize_with_feedback(
            leaves, q._views(carries[cur], [l.shape for l in leaves]),
            res_out=carries[1 - cur])
        for k in ("q8_absmax", "q8_quantize", "q8_dequantize"):
            assert tq.launch_counts[k] == before[k] + 1, k
        want = q.quantize_with_feedback(
            [l.cpu() for l in leaves],
            q._views(host[cur], [l.shape for l in leaves]),
            res_out=host[1 - cur])
        torch.cuda.synchronize()
        for k in ("q", "scale", "dq", "res"):
            for a, b in zip(out[k], want[k]):
                assert _bytes(a) == _bytes(b), (step, k)
        assert _bytes(carries[cur]) == _bytes(read)
        if poison and step == 1:
            assert torch.isnan(out["scale"][3]) and torch.isnan(out["scale"][5])
            assert (out["dq"][3].view(torch.int32) == 0x7FC00000).all()
            # a poisoned carry is not carried on: the next step starts over
            carries[1 - cur].zero_()
            host[1 - cur].zero_()
        cur = 1 - cur


@pytest.mark.cuda
def test_dequant_average_matches_plain(cuda_device):
    """The member-wise decode (one K2 launch per member) and the
    member-order sum and divide, bit for bit against the CPU."""
    from torchft_tpu_torch import quantize as q

    gen = torch.Generator(device=cuda_device).manual_seed(13)
    shapes = _lm_shapes(**DENSE_LM)
    entries, host = [], []
    for m in range(3):
        leaves = _q8_tree(shapes, gen, cuda_device, poison=m == 2)
        z = [torch.zeros(l.shape, device=cuda_device) for l in leaves]
        out = q.quantize_with_feedback(leaves, z)
        entries.append({"q": out["q"], "scale": out["scale"]})
        host.append({"q": [t.cpu() for t in out["q"]],
                     "scale": [t.cpu() for t in out["scale"]]})
    comb = q.make_dequant_average()
    before = tq.launch_counts["q8_dequantize"]
    got = comb(entries, 3.0)
    assert tq.launch_counts["q8_dequantize"] == before + 3
    want = comb(host, 3.0)
    for a, b in zip(got, want):
        assert _bytes(a) == _bytes(b)


def _card_ring(store, prefix, world=2, **kw):
    from concurrent.futures import ThreadPoolExecutor

    from torchft_tpu_torch.collectives import HostCollectives

    cols = [HostCollectives(stripes=2, **kw) for _ in range(world)]
    addr = f"{store.address()}/{prefix}"
    with ThreadPoolExecutor(world) as ex:
        for f in [ex.submit(c.configure, addr, r, world)
                  for r, c in enumerate(cols)]:
            f.result()
    return cols


def _both(cols, fn):
    import threading

    out, errors = [None] * len(cols), []

    def run(r):
        try:
            out[r] = fn(r, cols[r])
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(len(cols))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return out


@pytest.mark.cuda
def test_legacy_ops_on_card_leaves_match_cpu_leaves(cuda_device):
    """A two-member ring in one process, once on card leaves and once on
    the same leaves on the CPU: the chunked allreduce (an f32 and an
    int32 group, each in 4 chunks), the q8 ring over a quantize pack's dq
    buffer, the allgather of an int8 payload, and both sharded-plan legs
    give the same bits, and card results come back on the card."""
    from torchft_tpu_torch import quantize as q
    from torchft_tpu_torch._native import Store
    from torchft_tpu_torch._tree import flatten

    store = Store()
    rng = np.random.default_rng(14)
    base = {"w": rng.standard_normal(300007).astype(np.float32),
            "b": rng.standard_normal((61, 7)).astype(np.float32),
            "n": rng.integers(-50, 50, 1001).astype(np.int32)}

    def trees(dev):
        return [{k: torch.from_numpy(v * (r + 1)).to(dev) for k, v in base.items()}
                for r in range(2)]

    def ops(r, c, tree):
        f32 = {"w": tree["w"], "b": tree["b"]}
        res = [torch.zeros(l.shape, device=l.device) for l in flatten(f32)[0]]
        qz = q.quantize_with_feedback(flatten(f32)[0], res)
        sh = c.plan_reduce_scatter(f32, wire="q8", ag_wire="bf16").wait()
        return {
            "ar": c.allreduce(tree, divisor=2.0).wait(),
            "q8": c.allreduce(qz["dq"], divisor=2.0, wire="q8").wait(),
            "ag": c.allgather({"q": qz["q"], "scale": qz["scale"]}).wait(),
            "rs": sh.values["float32"],
            "ranges": sh.ranges["float32"],
            "agi": c.plan_allgather_into(
                sh.replace_values({"float32": sh.values["float32"] * 0.5}),
                wire="bf16").wait(),
        }

    try:
        got = {}
        for dev in ("cpu", cuda_device):
            cols = _card_ring(store, f"legacy_{dev}", pipeline_min_bytes=0)
            try:
                ts = trees(dev)
                got[str(dev)] = _both(cols, lambda r, c: ops(r, c, ts[r]))
                if dev != "cpu":
                    st = [s for s in cols[0].pop_op_stats() if s["op"] == "allreduce"]
                    assert st[-1]["chunks"] == 2 * 4  # f32 and int32 groups
                    assert st[-1]["d2h_bytes"] == st[-1]["bytes"]
            finally:
                for c in cols:
                    c.shutdown()
        for a, b in zip(got["cpu"], got[str(cuda_device)]):
            assert a["ranges"] == b["ranges"]
            for k in ("ar", "q8", "ag", "rs", "agi"):
                la, lb = flatten(a[k])[0], flatten(b[k])[0]
                assert len(la) == len(lb) and all(l.is_cuda for l in lb), k
                for x, y in zip(la, lb):
                    assert x.dtype == y.dtype and _bytes(x) == _bytes(y), k
    finally:
        store.shutdown()


# -- the serving wire and the durable capture on the card ----------------------


@pytest.mark.cuda
def test_q8_group_encode_matches_plain(cuda_device):
    """The serving wire's EF-free group encode: one K1a and one K1b launch
    per 64 leaves over a zero carry that is never written, the codes and
    scales bit for bit the plain version's (the poisoned leaves too)."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    shapes = [(1000,), (0,), (33, 17), (), (2049,), (7,)] * 12  # 72 leaves
    leaves = [_randn(s, gen, cuda_device, 1e-2) for s in shapes]
    leaves[3].fill_(float("nan"))  # a 0-d leaf
    leaves[8].view(-1)[0] = float("inf")  # a (33, 17) leaf
    n = sum(l.numel() for l in leaves)
    zeros = torch.zeros(n, device=cuda_device)
    scratch = torch.empty(n, device=cuda_device)
    codes = torch.empty(n, dtype=torch.int8, device=cuda_device)
    scales = torch.empty(len(leaves), device=cuda_device)
    before = dict(tq.launch_counts)
    tq.quantize_q8_group(leaves, codes, scales, zeros, scratch)
    assert tq.launch_counts["q8_absmax"] == before["q8_absmax"] + _tables(72)
    assert tq.launch_counts["q8_quantize"] == before["q8_quantize"] + _tables(72)
    assert not zeros.any()
    pc = torch.empty(n, dtype=torch.int8)
    ps = torch.empty(len(leaves))
    tq.plain_group["quantize_q8"]([l.cpu() for l in leaves], pc, ps)
    assert _bytes(codes) == _bytes(pc) and _bytes(scales) == _bytes(ps)
    assert scales[3].view(torch.int32).item() == 0x7FC00000


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["q8", "bf16", "f32"])
def test_card_resident_served_tree_matches_the_cpu_publisher(cuda_device, wire):
    """The publisher's served tree on the card (encode K1a/K1b or K3, the
    delta's decode K2 and its add as two roundings) is bit for bit the one
    a publisher of the same weights on the CPU (the plain versions) keeps:
    equal manifests' CRC and digest, equal served bits; a subscriber on
    the card installs the same bits."""
    from torchft_tpu_torch import serving as ts

    pubs = {d: ts.WeightPublisher(wire=wire, snapshot_every=4)
            for d in ("cuda", "cpu")}
    sub = ts.WeightSubscriber(pubs["cuda"].server.local_address(),
                              device=cuda_device, timeout_s=30.0)
    try:
        before = dict(tq.launch_counts)
        for v in range(6):
            ms = {d: pubs[d].publish(ts.demo_params(4, 5, 3001, v, device=d),
                                     step=v)
                  for d in pubs}
            assert ms["cuda"]["crc"] == ms["cpu"]["crc"]
            assert ms["cuda"]["digest"] == ms["cpu"]["digest"]
            served = {d: pubs[d].served() for d in pubs}
            for k in served["cpu"]:
                assert served["cuda"][k].is_cuda
                assert _bytes(served["cuda"][k]) == _bytes(served["cpu"][k])
            assert sub.poll()
            got = sub.current()[1]
            for k in got:
                assert got[k].is_cuda
                assert _bytes(got[k]) == _bytes(served["cpu"][k])
        after = tq.launch_counts
        if wire == "q8":
            assert after["q8_quantize"] - before["q8_quantize"] == 6
            # the publisher's 6 decodes (snapshots and deltas) and the
            # subscriber's 6 installs
            assert after["q8_dequantize"] - before["q8_dequantize"] == 6 + 6
        if wire == "bf16":
            assert after["cast_bf16"] - before["cast_bf16"] == 6
    finally:
        sub.close()
        for p in pubs.values():
            p.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("zero_copy", [False, True])
def test_durable_capture_on_card_holds_the_captured_step(cuda_device,
                                                         zero_copy):
    """A shard-limited staging of card state: K3 narrows the moments, the
    bytes equal a CPU staging's, and an in-place update queued after the
    capture (behind a ~0.5 s spin) does not reach them, with the d2h
    deferred (zero_copy) or not."""
    from torchft_tpu_torch import checkpointing as ck

    card = _heal_state(cuda_device)
    want = ck._StreamStaging(_tree_to(card, "cpu"), "bf16", shard_of=(1, 3))
    w = card["user"]["params"]["w"]
    staged = ck._StreamStaging(card, "bf16", shard_of=(1, 3),
                               zero_copy=zero_copy)
    torch.cuda._sleep(500_000_000)
    w.add_(1.0)  # the next step's write, queued behind the capture
    for m in card["user"]["opt_state"]["mu"]:
        m.mul_(-1.0)
    assert staged.captured_bytes == want.captured_bytes
    b, e = staged._range
    assert staged.range_crc32c(b, e) == want.range_crc32c(b, e)
    assert bytes(staged._slice(b, e)) == bytes(want._slice(b, e))


@pytest.mark.cuda
def test_standby_warm_up_launches_on_the_card(cuda_device):
    """A hot spare's warm-up runs on the card: prewarm's q8ef pack is one
    K1a and one K1b launch over the gradient tree's shapes (no ring: the
    collectives are not configured), and FTTrainState.warm runs one
    AdamW update there on copies, the live state untouched."""
    import torchft_tpu_torch as tft

    params = {"w": torch.randn(512, 256, device=cuda_device),
              "b": torch.randn(256, device=cuda_device)}
    state = tft.FTTrainState(params, tft.AdamW(1e-3, weight_decay=1e-4))
    before = {k: v.clone() for k, v in params.items()}
    grads_like = {k: torch.empty_like(v) for k, v in params.items()}
    col = tft.HostCollectives()
    try:
        tq.reset_launch_counts()
        col.prewarm(grads_like, wire="q8ef")
        assert tq.launch_counts["q8_absmax"] == 1
        assert tq.launch_counts["q8_quantize"] == 1
        (packer,) = col._dev_packers.values()
        assert packer.staged and packer._carry.is_cuda
        assert not torch.any(packer._carry)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        state.warm(grads_like)
        assert torch.cuda.max_memory_allocated(cuda_device) > 0
        for k in params:
            assert torch.equal(params[k], before[k])
    finally:
        col.shutdown()
