"""The port's batched inference server
(ape_x_dqn_tpu_torch/parallel/inference_server.py) against the JAX
package's: Q-values of the same params (flax converted by
models/convert.py) at float32 over 60x60x4 pixels (large enough that the
torso's flatten order matters: the last conv output is 4x4, not 1x1) to
1e-5, over single and batched requests; then the original's behaviours
(tests/test_runtime.py, tests/test_vector_actor.py): batching, param
update, error propagation, mixed single and multi-item requests, an
oversize request served alone, and _collect's item budget with its held
requests in arrival order."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.configs import NetworkConfig as JaxNetworkConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JaxEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu.parallel.inference_server import (
    BatchedInferenceServer as JaxServer, _Request as JaxRequest)
from ape_x_dqn_tpu_torch.configs import NetworkConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.parallel.inference_server import (
    BatchedInferenceServer, _pow2_bucket_sizes, _Request)
from ape_x_dqn_tpu_torch.runtime.family import server_apply_fn

OBS = (60, 60, 4)
NET = dict(kind="nature_cnn", cnn_channels=(8, 16, 16), torso_dense=32,
           compute_dtype="float32", dueling=True)


def _threads(fns):
    ts = [threading.Thread(target=f) for f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def test_q_values_match_the_jax_server():
    jnet = jax_build_network(JaxNetworkConfig(**NET),
                             JaxEnvSpec(OBS, np.dtype(np.uint8), True, 6))
    params = jnet.init(jax.random.key(1), jnp.zeros((1, *OBS), jnp.uint8))
    tnet = build_network(NetworkConfig(**NET),
                         EnvSpec(OBS, np.dtype(np.uint8), True, 6))
    sd = from_flax(jax.tree.map(np.asarray, params))
    tnet.load_state_dict(sd)
    jserver = JaxServer(lambda p, o: jnet.apply(p, o), params,
                        max_batch=8, deadline_ms=5.0)
    tserver = BatchedInferenceServer(server_apply_fn("dqn", tnet), sd,
                                     max_batch=8, deadline_ms=5.0,
                                     device="cpu")
    rng = np.random.default_rng(0)
    singles = [rng.integers(0, 256, OBS, dtype=np.uint8) for _ in range(5)]
    batches = [rng.integers(0, 256, (n, *OBS), dtype=np.uint8)
               for n in (3, 6, 11)]
    try:
        for server in (jserver, tserver):
            res = {}

            def single(i, server=server, res=res):
                res[("s", i)] = server.query(singles[i])

            def batch(i, server=server, res=res):
                res[("b", i)] = server.query_batch(batches[i],
                                                   len(batches[i]))

            _threads([lambda i=i: single(i) for i in range(5)]
                     + [lambda i=i: batch(i) for i in range(3)])
            server.result = res
        for key, want in jserver.result.items():
            got = tserver.result[key]
            assert got.shape == np.asarray(want).shape and \
                got.dtype == np.float32, key
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=1e-5, err_msg=str(key))
        assert tserver.stats["items"] == jserver.stats["items"] == 5 + 20
    finally:
        jserver.stop()
        tserver.stop()


def test_server_batches_and_serves():
    server = BatchedInferenceServer(lambda p, o: o @ p, torch.eye(4),
                                    max_batch=16, deadline_ms=5.0,
                                    device="cpu")
    try:
        results = {}

        def client(i):
            results[i] = server.query(np.full(4, float(i), np.float32))

        _threads([lambda i=i: client(i) for i in range(10)])
        for i in range(10):
            np.testing.assert_allclose(results[i], np.full(4, float(i)),
                                       rtol=1e-6)
        st = server.stats
        assert st["items"] == 10 and st["batches"] <= 10
    finally:
        server.stop()


def test_server_param_update():
    server = BatchedInferenceServer(lambda p, o: o * p, torch.tensor(1.0),
                                    device="cpu")
    try:
        np.testing.assert_allclose(server.query(np.ones(3, np.float32)), 1.0)
        server.update_params(torch.tensor(2.0), version=1)
        np.testing.assert_allclose(server.query(np.ones(3, np.float32)), 2.0)
        assert server.params_version == 1
    finally:
        server.stop()


def test_server_propagates_errors_and_keeps_serving():
    server = BatchedInferenceServer(lambda p, o: o @ p, torch.eye(4),
                                    device="cpu")
    try:
        with pytest.raises(RuntimeError):
            server.query(np.ones(7, np.float32))  # wrong obs dim
        assert server.query(np.ones(4, np.float32)).shape == (4,)
    finally:
        server.stop()


def test_query_batch_slices_match_items():
    server = BatchedInferenceServer(lambda p, o: o * p, torch.tensor(2.0),
                                    max_batch=16, deadline_ms=5.0,
                                    device="cpu")
    try:
        results = {}

        def single(i):
            results[("s", i)] = server.query(np.full(3, float(i),
                                                     np.float32))

        def batch(i, n):
            inp = np.stack([np.full(3, 100.0 * i + j, np.float32)
                            for j in range(n)])
            results[("b", i)] = server.query_batch(inp, n)

        _threads([lambda i=i: single(i) for i in range(4)]
                 + [lambda i=i: batch(i, 5) for i in range(3)])
        for i in range(4):
            np.testing.assert_allclose(results[("s", i)],
                                       np.full(3, 2.0 * i), rtol=1e-6)
        for i in range(3):
            want = np.stack([np.full(3, 2.0 * (100.0 * i + j), np.float32)
                             for j in range(5)])
            np.testing.assert_allclose(results[("b", i)], want, rtol=1e-6)
        assert server.stats["items"] == 4 + 3 * 5
    finally:
        server.stop()


def test_oversize_request_is_served_alone():
    """A vector request larger than max_batch serves alone, in its own
    (padded) bucket."""
    server = BatchedInferenceServer(lambda p, o: o + p, torch.tensor(1.0),
                                    max_batch=4, deadline_ms=1.0,
                                    device="cpu")
    try:
        inp = np.arange(10, dtype=np.float32).reshape(10, 1)
        np.testing.assert_allclose(server.query_batch(inp, 10), inp + 1.0)
        assert server.stats == {"batches": 1, "items": 10,
                                "avg_batch": 10.0}
    finally:
        server.stop()


def test_collect_holds_requests_in_arrival_order_like_the_original():
    """The same request sequence queued on a stopped server of each
    package: every _collect returns the same batches (item budget 4,
    overflowing requests held in arrival order, an oversize one alone,
    a held request not a barrier for smaller ones that fit)."""
    sizes = [3, 2, 1, 6, 1, 2, 0, 4, 3]   # 0: a single-item request
    groups = []
    for server, req in (
            (BatchedInferenceServer(lambda p, o: o, None, max_batch=4,
                                    deadline_ms=1.0, device="cpu"),
             _Request),
            (JaxServer(lambda p, o: o, None, max_batch=4, deadline_ms=1.0),
             JaxRequest)):
        server.stop()
        for i, n in enumerate(sizes):
            r = req(np.zeros((n, 1)) if n else np.zeros(1), n)
            r.result = i   # tag
            server._q.put(r)
        out = []
        while True:
            reqs = server._collect()
            if not reqs:
                break
            out.append([r.result for r in reqs])
        groups.append(out)
    assert groups[0] == groups[1]
    assert sorted(i for g in groups[0] for i in g) == list(range(len(sizes)))


def test_pow2_buckets_cover_every_request_size():
    from ape_x_dqn_tpu.parallel.inference_server import (
        _pow2_bucket_sizes as jax_buckets)
    from ape_x_dqn_tpu.utils.misc import next_pow2
    for max_batch, extra in ((64, (16,)), (4, (10,)), (1, ())):
        assert _pow2_bucket_sizes(next_pow2, max_batch, extra) == \
            jax_buckets(next_pow2, max_batch, extra)


def test_server_refuses_a_mesh_and_a_missing_card():
    with pytest.raises(NotImplementedError, match="item 14"):
        BatchedInferenceServer(lambda p, o: o, None, mesh=object(),
                               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchedInferenceServer(lambda p, o: o, None)
