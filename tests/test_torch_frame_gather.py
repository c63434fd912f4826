"""The PyTorch port's frame-row gather (ape_x_dqn_tpu_torch/ops/
frame_gather.py) against the JAX package's Pallas kernel in interpret
mode and its jnp reference. A gather copies bytes, so every comparison
is exact. The kernel itself runs only on a CUDA card: its test is in
test_torch_kernels_cuda.py, which imports no JAX so that it also runs
on a machine with the card and without JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.ops.frame_gather import (gather_rows_pallas,
                                            gather_rows_reference)
from ape_x_dqn_tpu_torch.ops import frame_gather as tfg


def _both(src: np.ndarray, idx: np.ndarray):
    port = tfg.gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
    return port.numpy()


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_gather_matches_pallas_and_reference(idx_dtype):
    rng = np.random.default_rng(0)
    src = rng.integers(0, 255, (500, 84, 84)).astype(np.uint8)
    idx = rng.integers(0, 500, 128).astype(idx_dtype)
    out = _both(src, idx)
    j_idx = jnp.asarray(idx, jnp.int32)
    np.testing.assert_array_equal(
        out, np.asarray(gather_rows_pallas(jnp.asarray(src), j_idx,
                                           interpret=True)))
    np.testing.assert_array_equal(
        out, np.asarray(gather_rows_reference(jnp.asarray(src), j_idx)))


def test_gather_duplicate_and_boundary_indices():
    rng = np.random.default_rng(1)
    src = rng.integers(0, 255, (8, 6, 6)).astype(np.uint8)
    idx = np.asarray([0, 7, 7, 3, 0, 7], np.int32)
    out = _both(src, idx)
    np.testing.assert_array_equal(
        out, np.asarray(gather_rows_pallas(jnp.asarray(src),
                                           jnp.asarray(idx),
                                           interpret=True)))
    np.testing.assert_array_equal(out, src[idx])


def test_gather_frame_ring_byte_rows():
    """The replay's own shape: [N, 7168] uint8 byte rows (pad128 of an
    84x84 frame), duplicates and both ends included."""
    rng = np.random.default_rng(2)
    n = 300
    src = rng.integers(0, 255, (n, 7168)).astype(np.uint8)
    idx = np.concatenate([[0, n - 1, n - 1, 0],
                          rng.integers(0, n, 60)]).astype(np.int32)
    out = _both(src, idx)
    ref = np.asarray(gather_rows_reference(jnp.asarray(src),
                                           jnp.asarray(idx)))
    np.testing.assert_array_equal(out, ref)
    assert out.shape == (64, 7168) and out.dtype == np.uint8


def test_cpu_path_counts_no_launch():
    before = tfg.gather_rows.launches
    tfg.gather_rows(torch.zeros(4, 8, dtype=torch.uint8),
                    torch.tensor([1, 2]))
    assert tfg.gather_rows.launches == before


def test_mixed_devices_raise():
    src = torch.zeros(4, 8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tfg.gather_rows(src, torch.zeros(2, dtype=torch.int32,
                                         device="meta"))
