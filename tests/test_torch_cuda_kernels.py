"""The port's CUDA kernels against their plain PyTorch versions on the
card: the wire kernels bit for bit, the flash-attention kernels within
the tolerances stated at ``_flash_tol``.

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


@pytest.mark.cuda
def test_nonfinite_leaf_poisons_with_canonical_nan(cuda_device):
    x = torch.tensor([1.0, float("inf"), 2.0], device=cuda_device)
    q, s, r = tq.quantize_q8_ef(x, torch.zeros(3, device=cuda_device))
    assert q.tolist() == [0, 0, 0]
    assert s.view(torch.int32).item() == 0x7FC00000
    assert (r.view(torch.int32) == 0x7FC00000).all()


@pytest.mark.cuda
def test_cast_matches_plain(cuda_device):
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
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-127, 128, 100003).astype(np.int8))
    scale = torch.tensor([scale_bits], dtype=torch.int32).view(torch.float32)[0]
    qd, sd = q.to(cuda_device), scale.to(cuda_device)
    before = tq.launch_counts["q8_dequantize"]
    got = tq.dequantize_q8(qd, sd)
    assert _bytes(got) == _bytes(tq.plain["q8_dequantize"](qd, sd))
    assert _bytes(got) == _bytes(tq.dequantize_q8(q, scale))  # the CPU body
    assert tq.launch_counts["q8_dequantize"] == before + 1


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
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    want = tfa.flash_bwd_plain(q, k, v, do, lse, delta, cfg)
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
    from torchft_tpu_torch.collectives import HostCollectives

    c = HostCollectives(stripes=1)
    try:
        g = {"w": torch.ones(8, device=cuda_device)}
        with pytest.raises(ValueError, match="packed there"):
            c.plan_allreduce(g, wire="q8ef", device_pack=False)
        with pytest.raises(ValueError, match="packed there"):
            c.plan_allreduce(g, wire="q8")  # no kernel encodes this wire
    finally:
        c.shutdown()


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
