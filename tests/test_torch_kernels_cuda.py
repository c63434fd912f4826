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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """Kernel vs plain version on the card, bitwise: the 16-byte path
    (the frame ring's 7168-byte rows and flat replay's 28,288-byte
    packed stacks) and the byte path (36-byte rows), int32 and int64
    indices, duplicates and both ends."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    for n, shape in [(4096, (7168,)), (2048, (28288,)), (8, (6, 6))]:
        src = torch.randint(0, 256, (n, *shape), dtype=torch.uint8,
                            device=cuda_device, generator=g)
        for idt in (torch.int32, torch.int64):
            idx = torch.randint(0, n, (1000,), dtype=idt,
                                device=cuda_device, generator=g)
            idx[:4] = torch.tensor([0, n - 1, n - 1, 0], dtype=idt)
            before = tfg.gather_rows.launches
            out = tfg.gather_rows(src, idx)
            torch.cuda.synchronize()
            assert tfg.gather_rows.launches == before + 1
            assert torch.equal(out, tfg.gather_rows_reference(src, idx))
