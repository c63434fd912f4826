"""The inference server's pinned staging on the card. Marked `cuda`:
the pinned buffers and the non-blocking copies exist only there (on the
CPU the server stages plain host tensors). The file imports no JAX, so
on a machine with the card it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_server_cuda.py
"""

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.parallel.inference_server import (
    BatchedInferenceServer)


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: every xdist worker
    must collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned staging runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_leaves_of_one_shape_stage_apart(cuda_device):
    """Two request leaves of one shape and dtype each keep their own
    pinned buffer: a shared one would be rewritten by the second leaf
    before the first leaf's copy lands."""
    def apply(params, x):
        return {"a": x["a"] * params["w"], "b": x["b"] * params["w"]}

    server = BatchedInferenceServer(
        apply, {"w": torch.ones((), device=cuda_device)}, max_batch=8,
        deadline_ms=1.0, device=cuda_device)
    try:
        rng = np.random.default_rng(0)
        for n in (1, 3, 8):
            x = {"a": rng.random((n, 256, 256), dtype=np.float32),
                 "b": rng.random((n, 256, 256), dtype=np.float32)}
            out = server.query_batch(x, n)
            np.testing.assert_array_equal(out["a"], x["a"])
            np.testing.assert_array_equal(out["b"], x["b"])
    finally:
        server.stop()
