"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked `cuda` and skips
without a card (a CUDA kernel has no CPU or interpret mode). The file
imports no JAX, so on a machine with the card it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(--noconftest: tests/conftest.py configures JAX, which that machine
need not have)."""

import pytest
import torch

from ape_x_dqn_tpu_torch.ops import frame_gather as tfg


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: every xdist worker
    must collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the frame-gather kernel has no "
                    "CPU or interpret mode")
    return torch.device("cuda")


# (rows in src, trailing shape, indices, byte offset of src's base
# pointer, top end: draw the indices from the last 1000 rows only)
CASES = {
    # the frame ring's 7168-byte rows: one chunk a row
    "frame_ring": (4096, (7168,), 1000, 0, False),
    # flat replay's 28,288-byte packed stacks: four chunks a row
    "flat": (2048, (28288,), 1000, 0, False),
    # a 16-byte multiple that is not a 128-byte multiple
    "rows_7056": (1024, (7056,), 1000, 0, False),
    # fewer indices than the card has SMs, and a single one
    "m_1": (4096, (7168,), 1, 0, False),
    "m_below_sms": (4096, (7168,), 100, 0, False),
    # a source of 4.3 GB: row offsets past 2^32 bytes
    "over_4gb": (600_000, (7168,), 1000, 0, True),
    # a base pointer 16-byte aligned but not 128-byte aligned
    "base_16": (2048, (28288,), 1000, 16, False),
    # the r2d2 preset's packed single-frame sequences (83 x 84 x 84,
    # padded to 585,728 B: 82 chunks a row), one K=4 x B=64 draw, and
    # the same draw from the top of a 4.8 GB source
    "sequence": (1024, (585728,), 256, 0, False),
    "sequence_top": (8192, (585728,), 256, 0, True),
    # the byte path: 36-byte rows, and a base pointer off 16 bytes
    "bytes_36": (8, (6, 6), 1000, 0, False),
    "base_1": (1024, (7168,), 1000, 1, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(cuda_device, case, idx_dtype):
    """Kernel vs plain version on the card, bitwise, with duplicate
    indices and both ends of the source; one launch per call."""
    n, shape, m, offset, top = CASES[case]
    row = 1
    for d in shape:
        row *= d
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    base = torch.randint(0, 256, (n * row + offset,), dtype=torch.uint8,
                         device=cuda_device, generator=g)
    src = base[offset:].view(n, *shape)
    assert src.is_contiguous() and src.data_ptr() % 16 == offset % 16
    low = n - 1000 if top else 0
    idx = torch.randint(low, n, (m,), dtype=idx_dtype, device=cuda_device,
                        generator=g)
    ends = torch.tensor([n - 1, 0, n - 1, low, n - 1, 0], dtype=idx_dtype,
                        device=cuda_device)[:m]
    idx[:ends.numel()] = ends
    if m > 8:
        idx[-2:] = idx[:2]            # duplicates, wherever the set lies
    before = tfg.gather_rows.launches
    out = tfg.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert tfg.gather_rows.launches == before + 1
    assert out.shape == (m, *shape)
    assert torch.equal(out, tfg.gather_rows_reference(src, idx))


@pytest.mark.cuda
def test_kernel_clamps_out_of_range_indices(cuda_device):
    """An index outside [0, N) reads the nearest end row, as JAX's
    gather clamps (the plain version raises on it instead)."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(1)
    src = torch.randint(0, 256, (64, 28288), dtype=torch.uint8,
                        device=cuda_device, generator=g)
    idx = torch.tensor([-5, 70, 3, 64, -1], device=cuda_device)
    out = tfg.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, tfg.gather_rows_reference(src,
                                                      idx.clamp(0, 63)))


@pytest.mark.cuda
def test_kernel_alternating_row_sizes(cuda_device):
    """Row sizes whose shared-memory rings differ, in turns: a launch
    with a smaller ring must not lower the limit a later, larger one
    needs."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(2)
    srcs = [torch.randint(0, 256, (256, row), dtype=torch.uint8,
                          device=cuda_device, generator=g)
            for row in (7168, 28288, 7056, 7168, 28288)]
    for src in srcs:
        idx = torch.randint(0, 256, (300,), device=cuda_device, generator=g)
        out = tfg.gather_rows(src, idx)
        torch.cuda.synchronize()
        assert torch.equal(out, tfg.gather_rows_reference(src, idx))
