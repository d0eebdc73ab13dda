"""The flash wrapper's choices made before any launch, on the CPU: which
kernels a dtype runs on the card (a dispatch by dtype, not a fallback),
and the 16-byte alignment the tensor-core kernels' ``cp.async`` row copies
need. Both are pure functions of the tensors' metadata; nothing launches.
Also ``interpret``: ``True`` takes the plain versions on any device,
``None`` keeps the route by device (checked with the launches recorded,
not run).
"""

import importlib

import pytest
import torch

import torch_one_thread  # noqa: F401

# the module (the package's name `flash_attention` is its entry point)
tfa = importlib.import_module("torchft_tpu_torch.ops.flash_attention")


def test_bf16_takes_the_tensor_core_kernels_and_f32_the_scalar_ones():
    assert tfa.kernel_route(torch.bfloat16) == "mma"
    assert tfa.kernel_route(torch.float32) == "scalar"
    # the C entry points' dtype codes
    assert tfa.KERNEL_ROUTES[torch.float32][0] == 0
    assert tfa.KERNEL_ROUTES[torch.bfloat16][0] == 1


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_other_dtypes_have_no_kernel(dtype):
    with pytest.raises(TypeError, match="CUDA kernels take"):
        tfa.kernel_route(dtype)


def test_the_qkv_split_is_aligned():
    """q, k, v as views of the (B, S, 3HD) projection, as the model's qkv
    split yields them: strides and offsets are multiples of the head dim."""
    qkv = torch.zeros(2, 10, 3 * 128, dtype=torch.bfloat16)
    q, k, v = (t.reshape(2, 10, 2, 64) for t in torch.split(qkv, 128, -1))
    assert not k.is_contiguous()
    tfa.check_kernel_layout(q, k, v)


def test_an_odd_storage_offset_raises():
    base = torch.zeros(1 + 2 * 10 * 2 * 64, dtype=torch.bfloat16)
    q = base[1:].view(2, 10, 2, 64)
    assert q.storage_offset() == 1 and q.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.check_kernel_layout(q)


def test_a_row_stride_off_the_16_byte_grid_raises():
    qkv = torch.zeros(2, 10, 3 * 128 + 1, dtype=torch.bfloat16)
    q = qkv[..., :128].reshape(2, 10, 2, 64)
    assert q.stride()[1] == 3 * 128 + 1
    with pytest.raises(ValueError, match="16-byte"):
        tfa.check_kernel_layout(q)


def test_the_scalar_route_takes_any_offset():
    """f32 goes to the scalar kernels, which read element by element: the
    alignment check applies to the tensor-core route only."""
    base = torch.zeros(1 + 2 * 10 * 2 * 64)
    q = base[1:].view(2, 10, 2, 64)
    tfa._check_kernel_inputs(q, q, q)  # f32: no raise
    qb = base.to(torch.bfloat16)[1:].view(2, 10, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_kernel_inputs(qb, qb, qb)


def _as_if_on_the_card(monkeypatch):
    """CPU tensors take the card's route: the wrapper sees a CUDA tensor
    and launches (each launch recorded by its entry point, none run)."""
    launches = []
    monkeypatch.setattr(tfa, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    monkeypatch.setattr(tfa._kernels, "launch",
                        lambda name, fn_name, *args: launches.append(fn_name))
    return launches


@pytest.mark.parametrize("interpret,want", [
    (None, ["tft_flash_fwd", "tft_flash_bwd_dq", "tft_flash_bwd_dkdv"]),
    (False, ["tft_flash_fwd", "tft_flash_bwd_dq", "tft_flash_bwd_dkdv"]),
    (True, []),
])
def test_interpret_asks_for_the_plain_version(monkeypatch, interpret, want):
    """``interpret=True`` runs the plain versions whatever the device;
    ``None`` (and ``False``) keep the dispatch, which on a card tensor
    launches K4 and K5 (dq, which writes delta, before dk/dv) and never
    falls back."""
    launches = _as_if_on_the_card(monkeypatch)
    q, k, v = (torch.randn(1, 8, 2, 64, requires_grad=True) for _ in range(3))
    out = tfa.flash_attention(q, k, v, interpret=interpret)
    out.float().sum().backward()
    assert launches == want
    if interpret:
        monkeypatch.undo()  # the CPU route: the plain versions
        ref = tfa.flash_attention(q.detach(), k.detach(), v.detach())
        assert torch.equal(out.detach(), ref)


def test_the_backward_kernels_refuse_host_tensors():
    """``flash_bwd_kernels`` is the card's path alone: CPU tensors raise
    before any launch (``flash_bwd`` takes the plain version for them)."""
    q = torch.zeros(1, 8, 1, 64)
    cfg = tfa.FlashConfig(True, None, 64, 64)
    with pytest.raises(ValueError, match="on the card"):
        tfa.flash_bwd_kernels(q, q, q, q, torch.zeros(1, 1, 8), q, cfg)
