"""The copy kernel (``dvo_table_copy``) on the card: bit-equal to
``clone()`` into a buffer of its own, at the L1 quad-table shape, at
ragged element counts (not a multiple of 4: the scalar tail) and from a
table that is not 16-byte aligned (the scalar loop)."""

import pytest
import torch

from dvo_slam_tpu_torch.ops import table_copy

pytestmark = pytest.mark.cuda


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape", [(32, 76800), (7, 1001), (1, 3), (32, 4800)])
def test_copy_bit_equal_to_clone(shape):
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = torch.randn(shape, device="cuda", generator=gen)
    before = table_copy.table_copy_cuda.launches
    out = table_copy.table_copy_cuda(x)
    torch.cuda.synchronize()
    assert table_copy.table_copy_cuda.launches == before + 1
    assert out.data_ptr() != x.data_ptr() and out.shape == x.shape
    assert torch.equal(_bits(out), _bits(table_copy.table_copy_plain(x)))


def test_copy_of_unaligned_table():
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(32 * 4800 + 1, device="cuda", generator=gen)[1:].view(32, 4800)
    assert x.data_ptr() % 16 != 0
    out = table_copy.table_copy_cuda(x)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(x))


def test_copy_of_a_slice_of_the_stack():
    """The probe's use: one stream's table out of a [B, 32, N] stack."""
    stack = torch.randn(3, 32, 1200, device="cuda")
    out = table_copy.table_copy(stack[1])
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(stack[1]))


def test_wrapper_rejects_bad_inputs():
    x = torch.randn(32, 100, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        table_copy.table_copy_cuda(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        table_copy.table_copy_cuda(x.t())
    with pytest.raises(ValueError, match=r"\[C, n\]"):
        table_copy.table_copy_cuda(x.reshape(-1))
    with pytest.raises(ValueError, match="CUDA"):
        table_copy.table_copy_cuda(x.cpu())
