"""The flash wrapper's choices made before any launch, on the CPU: which
kernels a dtype runs on the card (a dispatch by dtype, not a fallback),
and the 16-byte alignment the tensor-core kernels' ``cp.async`` row copies
need. Both are pure functions of the tensors' metadata; nothing launches.
"""

import importlib

import pytest
import torch

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
