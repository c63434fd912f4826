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


@pytest.mark.cuda
def test_coalesced_forward_on_the_card_matches_each_tenants_forward(
        cuda_device):
    """Eight tenants of one family (a dueling Nature CNN at 84x84x4,
    bfloat16, each from its own seed) behind the serving tier on the
    card: a batch that mixes them runs ONE gathered forward (grouped
    convolutions), and every row agrees with its own tenant's plain
    forward within the bf16 tolerance (1e-2: the card's error is ~1e-3,
    a row of another tenant differs by ~0.17)."""
    from ape_x_dqn_tpu_torch.configs import NetworkConfig
    from ape_x_dqn_tpu_torch.envs.base import EnvSpec
    from ape_x_dqn_tpu_torch.models import build_network, init_params
    from ape_x_dqn_tpu_torch.parallel.inference_server import (
        MultiPolicyInferenceServer, _make_gather_apply)
    from ape_x_dqn_tpu_torch.runtime.family import server_apply_fn
    from ape_x_dqn_tpu_torch.utils.rng import component_generator

    obs = (84, 84, 4)
    spec = EnvSpec(obs, np.dtype(np.uint8), True, 6)
    ncfg = NetworkConfig(kind="nature_cnn", dueling=True,
                         compute_dtype="bfloat16")
    params = []
    for seed in range(8):
        net = init_params(build_network(ncfg, spec),
                          component_generator(seed, "net_init"))
        params.append({k: v.detach().to(cuda_device)
                       for k, v in net.state_dict().items()})
    apply = server_apply_fn("dqn", build_network(ncfg, spec).to(cuda_device))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (64, *obs)).astype(np.uint8)
    rows = rng.integers(0, 8, 64)
    stacked = {k: torch.stack([p[k] for p in params]) for k in params[0]}
    with torch.inference_mode():
        got = _make_gather_apply(apply)(
            stacked, torch.from_numpy(rows).to(cuda_device),
            torch.from_numpy(x).to(cuda_device)).float().cpu().numpy()
        for t in range(8):
            mine = rows == t
            want = apply(params[t], torch.from_numpy(x[mine]).to(
                cuda_device)).float().cpu().numpy()
            np.testing.assert_allclose(got[mine], want, atol=1e-2,
                                       rtol=0)
        # the references first: `apply` is a functional_call of one
        # module, which swaps the module's parameters while it runs, so
        # it must not run on two threads at once (the tier's dispatch
        # thread is its one caller once traffic starts)
        wants = [apply(params[i], torch.from_numpy(x[8 * i:8 * i + 8]).to(
            cuda_device)).float().cpu().numpy() for i in range(8)]
    tier = MultiPolicyInferenceServer(max_batch=64, deadline_ms=2.0,
                                      device=cuda_device)
    try:
        clients = [tier.register_policy(f"t{i}", apply, params[i],
                                        family="dqn") for i in range(8)]
        clients[0].warmup(np.zeros(obs, np.uint8), extra_sizes=(8,))
        tickets = [clients[i].submit(x[8 * i:8 * i + 8], 8)
                   for i in range(8)]
        for want, t in zip(wants, tickets):
            np.testing.assert_allclose(t.wait(60.0), want, atol=1e-2,
                                       rtol=0)
        assert tier.stats["gather_batches"] >= 1
    finally:
        tier.stop()
