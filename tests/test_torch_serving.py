"""The port's multi-tenant serving tier (parallel/inference_server.py:
MultiPolicyInferenceServer, TenantClient, build_serving_tier) under the
original's tests/test_serving.py, on the CPU: continuous-batching
admission, priority shedding, deadlines, backpressure hysteresis, the
coalesced forward, the tagged-request wire interop and the transport's
backpressure gate, plus BatchedInferenceServer's held-request collection
and per-bucket warm-up dedupe. Then the coalesced forward against the
JAX tier's on the same tenants' params (flax, converted by
models/convert.py) and the same rows: an MLP family in float32 (1e-5)
and a small Nature CNN in bfloat16 (3e-2, the bf16 tolerance of
tests/test_torch_models.py)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ape_x_dqn_tpu.configs import NetworkConfig as JaxNetworkConfig
from ape_x_dqn_tpu.envs.base import EnvSpec as JaxEnvSpec
from ape_x_dqn_tpu.models import build_network as jax_build_network
from ape_x_dqn_tpu.parallel.inference_server import (
    _make_gather_apply as jax_make_gather_apply)
from ape_x_dqn_tpu_torch.configs import NetworkConfig, ServingConfig
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.convert import from_flax
from ape_x_dqn_tpu_torch.parallel.inference_server import (
    BatchedInferenceServer, MultiPolicyInferenceServer,
    ServeDeadlineExceeded, ServeShed, _make_gather_apply, _Request,
    build_serving_tier)
from ape_x_dqn_tpu_torch.runtime.family import server_apply_fn


def _scale_apply(params, x):
    return x * params["w"]


def _w(v):
    return {"w": torch.tensor(v, dtype=torch.float32)}


def _tier(cls=MultiPolicyInferenceServer, **kw):
    return cls(device="cpu", **kw)


# -- BatchedInferenceServer: _collect's held requests -----------------------


class _NoServe(BatchedInferenceServer):
    """Server whose serve thread exits at once: the queue and the held
    deque are driven by calling _collect directly, so the collection is
    testable without racing a consumer."""

    def _serve_loop(self):
        return


def test_collect_oversize_does_not_starve_fitting_requests():
    """A held K-item vector request must not block smaller requests
    that still fit the current bucket: they keep admitting around it,
    and the vector serves in the NEXT batch, alone, in arrival order."""
    server = _NoServe(_scale_apply, _w(1.0), max_batch=8, deadline_ms=1.0,
                      device="cpu")
    try:
        singles_a = [_Request(np.zeros(2, np.float32)) for _ in range(4)]
        vector = _Request(np.zeros((6, 2), np.float32), n=6)
        singles_b = [_Request(np.zeros(2, np.float32)) for _ in range(4)]
        for r in [*singles_a, vector, *singles_b]:
            server._q.put(r)
        first = server._collect()
        assert first == [*singles_a, *singles_b]
        assert sum(r.items for r in first) == 8
        assert server._collect() == [vector]
    finally:
        server.stop()


def test_collect_oversize_request_serves_alone():
    """A single request larger than max_batch still serves (alone, in
    its own warmed bucket) instead of being parked forever."""
    server = _NoServe(_scale_apply, _w(1.0), max_batch=4, deadline_ms=1.0,
                      device="cpu")
    try:
        big = _Request(np.zeros((9, 2), np.float32), n=9)
        small = _Request(np.zeros(2, np.float32))
        server._q.put(big)
        server._q.put(small)
        assert server._collect() == [big]
        assert server._collect() == [small]
    finally:
        server.stop()


def test_collect_preserves_arrival_order_among_held():
    """Parked requests re-enter in arrival order ahead of new queue
    traffic once capacity frees."""
    server = _NoServe(_scale_apply, _w(1.0), max_batch=4, deadline_ms=1.0,
                      device="cpu")
    try:
        vs = [_Request(np.zeros((3, 2), np.float32), n=3) for _ in range(3)]
        for r in vs:
            server._q.put(r)
        assert server._collect() == [vs[0]]  # v2/v3 parked (3+3 > 4)
        assert server._collect() == [vs[1]]
        assert server._collect() == [vs[2]]
    finally:
        server.stop()


def test_warmup_dedupes_across_update_params_epochs():
    """A publication changes param VALUES, not shapes: warming again
    after update_params runs no forward; a NEW bucket size warms exactly
    that bucket (the port's count of warm-up forwards stands in for the
    original's compile count)."""
    calls = []

    def counting(params, x):
        calls.append(x.shape[0])
        return _scale_apply(params, x)

    server = BatchedInferenceServer(counting, _w(1.0), max_batch=8,
                                    deadline_ms=1.0, device="cpu")
    try:
        example = np.zeros(3, np.float32)
        server.warmup(example, extra_sizes=(5,))
        warm = len(calls)
        assert warm > 0
        server.update_params(_w(2.0), 1)
        server.warmup(example, extra_sizes=(5,))
        assert len(calls) == warm, "a publication re-paid the warm-up"
        server.warmup(example, extra_sizes=(3 * 8,))
        assert calls[warm:] == [32]
        out = server.query(np.full(3, 2.0, np.float32))
        np.testing.assert_allclose(np.asarray(out), 4.0)
    finally:
        server.stop()


# -- admission semantics ----------------------------------------------------


class _NoDispatch(MultiPolicyInferenceServer):
    """Tier whose dispatch thread exits at once: the REAL admission
    thread runs (offer/shed/backpressure accounting), while batches are
    taken synchronously through _take_batch."""

    def _dispatch_loop(self):
        return


def _wait_depth(tier, depth, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if tier._q.qsize() == 0 and tier.queue_depth == depth:
            return
        time.sleep(0.002)
    raise AssertionError(
        f"queue never reached depth {depth}: at {tier.queue_depth}")


def test_priority_ordering_under_saturation():
    """With more pending than one batch holds, class 0 is served first
    (FIFO within the class); lower classes fill the remainder oldest
    first."""
    tier = _tier(_NoDispatch, max_batch=4, deadline_ms=0.0,
                 priority_classes=3, queue_slo_items=100)
    try:
        c = [tier.register_policy(f"p{i}", _scale_apply, _w(i + 1),
                                  family="mlp", priority=i)
             for i in range(3)]
        x = np.zeros(2, np.float32)
        low = [c[2].submit(x) for _ in range(4)]
        mid = [c[1].submit(x) for _ in range(2)]
        top = [c[0].submit(x) for _ in range(2)]
        _wait_depth(tier, 8)
        fam, reqs, items = tier._take_batch()
        assert items == 4
        assert [r.policy for r in reqs] == ["p0", "p0", "p1", "p1"]
        fam, reqs, items = tier._take_batch()
        assert [r.policy for r in reqs] == ["p2"] * 4
        assert [id(r) for r in reqs] == [id(r) for r in low]  # FIFO
        del mid, top
    finally:
        tier.stop()


def test_shed_accounting_closure_and_class_protection():
    """Overload sheds newest-first from the LOWEST class only, class 0
    is never shed, and the books close: offered == admitted +
    sum(shed_by_class) once the queue is drained."""
    tier = _tier(_NoDispatch, max_batch=4, deadline_ms=0.0,
                 priority_classes=3, queue_slo_items=6)
    try:
        c = [tier.register_policy(f"p{i}", _scale_apply, _w(i + 1),
                                  family="mlp", priority=i)
             for i in range(3)]
        x = np.zeros(2, np.float32)
        tickets = [c[i].submit(x) for i in range(3) for _ in range(5)]
        deadline = time.monotonic() + 5.0
        while tier._q.qsize() and time.monotonic() < deadline:
            time.sleep(0.002)
        assert tier.queue_depth <= 6  # the controller held the SLO line
        shed_errs = [t.result for t in tickets
                     if t.event.is_set() and isinstance(t.result, ServeShed)]
        assert shed_errs, "2.5x-SLO offered load must shed"
        assert all(e.priority > 0 for e in shed_errs)  # class 0 immune
        while tier._take_batch() is not None:
            pass
        s = tier.stats
        assert s["offered"] == 15
        assert s["shed_by_class"][0] == 0
        assert s["offered"] == s["admitted"] + sum(s["shed_by_class"])
        assert shed_errs[0].policy_id in ("p1", "p2")
    finally:
        tier.stop()


def test_deadline_expiry_names_policy():
    """A request idling past serving.request_deadline_ms raises an
    attributed ServeDeadlineExceeded naming the policy and class."""
    tier = _tier(_NoDispatch, max_batch=4, deadline_ms=0.0,
                 priority_classes=2, queue_slo_items=100,
                 request_deadline_ms=20.0)
    try:
        client = tier.register_policy("breakout", _scale_apply, _w(1.0),
                                      priority=1)
        ticket = client.submit(np.zeros(2, np.float32))
        _wait_depth(tier, 1)
        time.sleep(0.05)
        assert tier._take_batch() is None  # the sweep, nothing to serve
        with pytest.raises(ServeDeadlineExceeded) as ei:
            ticket.wait(timeout=1.0)
        assert "breakout" in str(ei.value)
        assert "class 1" in str(ei.value)
        s = tier.stats
        assert s["expired"] == 1
        assert s["offered"] == s["admitted"] + sum(s["shed_by_class"])
    finally:
        tier.stop()


def test_unknown_policy_rejected_with_attribution():
    tier = _tier(max_batch=4, deadline_ms=1.0)
    try:
        tier.register_policy("known", _scale_apply, _w(1.0))
        ticket = tier.submit("ghost", 0, np.zeros(2, np.float32))
        with pytest.raises(KeyError, match="ghost"):
            ticket.wait(timeout=2.0)
    finally:
        tier.stop()


def test_backpressure_hysteresis_transitions():
    """Crossing the SLO line fires on_backpressure(True); it releases
    only once the queue drains to half the line; force_backpressure
    nudges the flag through the same callback."""
    tier = _tier(_NoDispatch, max_batch=2, deadline_ms=0.0,
                 priority_classes=2, queue_slo_items=6)
    events: list[bool] = []
    tier.on_backpressure = events.append
    try:
        client = tier.register_policy("p", _scale_apply, _w(1.0),
                                      priority=1)
        x = np.zeros(2, np.float32)
        for _ in range(7):
            client.submit(x)
        deadline = time.monotonic() + 5.0
        while not events and time.monotonic() < deadline:
            time.sleep(0.002)
        assert events == [True]
        # draining one batch leaves depth 4 > slo//2 = 3: still engaged
        assert tier._take_batch() is not None
        assert events == [True]
        while tier._take_batch() is not None:
            pass
        assert events == [True, False]
        assert tier.force_backpressure(True) is True
        assert tier.force_backpressure(True) is False  # a no-op
        assert events == [True, False, True]
        assert tier.backpressure_engaged
    finally:
        tier.stop()


# -- coalesced multi-tenant forwards ----------------------------------------


def test_coalesced_forward_per_tenant_params():
    """Same-family tenants coalesce into one gathered forward; each
    request still sees ITS tenant's params, for singles and vector
    requests, across an update_params epoch bump."""
    tier = _tier(max_batch=16, deadline_ms=2.0, priority_classes=2)
    try:
        clients = [tier.register_policy(f"pol{i}", _scale_apply,
                                        _w(i + 1), family="mlp")
                   for i in range(8)]
        for c in clients:
            c.warmup(np.zeros(3, np.float32))
        x = np.full(3, 2.0, np.float32)
        results = [None] * 8

        def ask(i):
            results[i] = np.asarray(clients[i].query(x))

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for i, out in enumerate(results):
            np.testing.assert_allclose(out, 2.0 * (i + 1), err_msg=str(i))
        vec = np.asarray(clients[3].query_batch(
            np.ones((5, 3), np.float32), 5))
        assert vec.shape == (5, 3)
        np.testing.assert_allclose(vec, 4.0)
        clients[3].update_params(_w(100.0), version=9)
        assert clients[3].params_version == 9
        np.testing.assert_allclose(
            np.asarray(clients[3].query(np.ones(3, np.float32))), 100.0)
        assert tier.stats["tenants"] == 8
    finally:
        tier.stop()


def test_mixed_batch_without_coalescing_keeps_each_tenants_params():
    """coalesce=False: a batch that mixes tenants runs one plain forward
    per tenant, each row with its own tenant's params (the original
    applied the first tenant's params to every row of such a batch)."""
    tier = _tier(_NoDispatch, max_batch=8, deadline_ms=0.0,
                 queue_slo_items=100, coalesce=False)
    try:
        a = tier.register_policy("a", _scale_apply, _w(2.0), family="mlp")
        b = tier.register_policy("b", _scale_apply, _w(3.0), family="mlp")
        x = np.ones(2, np.float32)
        tickets = [a.submit(x), b.submit(np.ones((2, 2), np.float32), 2),
                   a.submit(x)]
        _wait_depth(tier, 4)
        tier._forward(*tier._take_batch())
        np.testing.assert_allclose(tickets[0].wait(1.0), 2.0)
        np.testing.assert_allclose(tickets[1].wait(1.0), 3.0)
        np.testing.assert_allclose(tickets[2].wait(1.0), 2.0)
        assert tier.stats["gather_batches"] == 0
    finally:
        tier.stop()


def test_dispatch_error_reaches_the_batch_and_the_tier_keeps_serving():
    def fragile(params, x):
        if float(x.sum()) < 0:
            raise RuntimeError("poisoned batch")
        return _scale_apply(params, x)

    tier = _tier(max_batch=4, deadline_ms=1.0)
    try:
        c = tier.register_policy("p", fragile, _w(2.0))
        with pytest.raises(RuntimeError, match="poisoned"):
            c.query(np.full(2, -1.0, np.float32), timeout=5.0)
        np.testing.assert_allclose(c.query(np.ones(2, np.float32)), 2.0)
    finally:
        tier.stop()


def test_build_serving_tier_reads_config():
    scfg = ServingConfig(multi_tenant=True, priority_classes=5,
                         queue_slo_items=32, request_deadline_ms=250.0,
                         coalesce=False)
    tier = build_serving_tier(scfg, max_batch=8, deadline_ms=1.0,
                              device="cpu")
    try:
        assert tier._classes == 5
        assert tier._slo_items == 32
        assert tier._req_deadline_s == pytest.approx(0.25)
        assert not tier._coalesce
        # the mesh-sharded mode: buckets in multiples of the mesh size,
        # on the mesh's device
        from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
        meshed = build_serving_tier(
            scfg, max_batch=8, deadline_ms=1.0,
            mesh=make_mesh(dp=3, tp=1, devices=["cpu"] * 3), device="cuda")
        try:
            assert meshed.device.type == "cpu"
            assert [meshed._bucket(n) for n in (1, 4, 7)] == [3, 6, 9]
        finally:
            meshed.stop()
    finally:
        tier.stop()


def test_stop_fails_leftover_tickets():
    tier = _tier(_NoDispatch, max_batch=4, deadline_ms=0.0,
                 queue_slo_items=100)
    client = tier.register_policy("p", _scale_apply, _w(1.0))
    ticket = client.submit(np.zeros(2, np.float32))
    _wait_depth(tier, 1)
    tier.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        ticket.wait(timeout=1.0)


# -- the coalesced forward against the JAX tier's ---------------------------

NETS = {
    "mlp": (dict(kind="mlp", mlp_hidden=(32, 32), dueling=True,
                 compute_dtype="float32"), (6,), np.float32, 1e-5),
    "nature_cnn": (dict(kind="nature_cnn", cnn_channels=(4, 8, 8),
                        torso_dense=32, dueling=True,
                        compute_dtype="bfloat16"),
                   (52, 52, 4), np.uint8, 3e-2),
}


@pytest.mark.parametrize("family", sorted(NETS))
def test_coalesced_forward_matches_the_jax_tier(family):
    """Four tenants' flax params (four seeds), converted; one batch of
    rows that mixes them with padding rows pointing at row 0: the JAX
    tier's gathered forward and the port's agree per row, and the
    port's tier answers each tenant's query with its own params."""
    net_kw, obs_shape, obs_dtype, tol = NETS[family]
    jspec = JaxEnvSpec(obs_shape, np.dtype(obs_dtype), True, 5)
    jnet = jax_build_network(JaxNetworkConfig(**net_kw), jspec)
    tnet = build_network(NetworkConfig(**net_kw),
                         EnvSpec(obs_shape, np.dtype(obs_dtype), True, 5))
    jparams = [jax.tree.map(np.asarray, jnet.init(
        jax.random.key(s), jnp.zeros((1, *obs_shape), obs_dtype)))
               for s in range(4)]
    tparams = [{k: torch.from_numpy(np.array(v))
                for k, v in from_flax(p).items()} for p in jparams]
    rng = np.random.default_rng(3)
    if obs_dtype == np.uint8:
        x = rng.integers(0, 255, (16, *obs_shape)).astype(np.uint8)
    else:
        x = rng.standard_normal((16, *obs_shape)).astype(np.float32)
    rows = np.array([2, 0, 3, 1, 1, 2, 3, 0, 2, 2, 1, 3, 0, 0, 0, 0],
                    np.int32)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jparams)
    want = np.asarray(jax.jit(jax_make_gather_apply(jnet.apply))(
        jstack, jnp.asarray(rows), jnp.asarray(x)))
    apply = server_apply_fn("dqn", tnet)
    tstack = {k: torch.stack([p[k] for p in tparams]) for k in tparams[0]}
    with torch.inference_mode():
        got = _make_gather_apply(apply)(
            tstack, torch.from_numpy(rows.astype(np.int64)),
            torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (16, 5)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    # each row against its own tenant's plain forward in the port
    with torch.inference_mode():
        for i, r in enumerate(rows):
            one = apply(tparams[r], torch.from_numpy(x[i:i + 1])).numpy()
            np.testing.assert_allclose(got[i], one[0], atol=tol, rtol=tol)
    # through the tier: concurrent queries of all four tenants
    tier = _tier(max_batch=16, deadline_ms=5.0)
    try:
        clients = [tier.register_policy(f"t{i}", apply, tparams[i],
                                        family=family) for i in range(4)]
        clients[0].warmup(np.zeros(obs_shape, obs_dtype))
        res = {}

        def ask(i):
            res[i] = clients[i].query_batch(x[4 * i:4 * i + 4], 4)

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        jit_apply = jax.jit(jnet.apply)
        for i in range(4):
            ref = np.asarray(jit_apply(jparams[i],
                                       jnp.asarray(x[4 * i:4 * i + 4])))
            np.testing.assert_allclose(res[i], ref, atol=tol, rtol=tol)
    finally:
        tier.stop()


# -- tagged-request wire interop --------------------------------------------


def _mini_batch():
    return {"obs": np.zeros((2, 4), np.uint8),
            "priorities": np.ones(2, np.float32), "actor": 0}


def test_serve_tags_negotiated_new_client_new_server():
    from ape_x_dqn_tpu_torch.comm.socket_transport import (
        SocketIngestServer, SocketTransport)

    server = SocketIngestServer("127.0.0.1", 0)
    client = SocketTransport("127.0.0.1", server.port,
                             serve_policy="pong", serve_class=1)
    try:
        client.send_experience(_mini_batch())
        assert server.recv_experience(timeout=5.0) is not None
        assert client.serve_negotiated
        assert server.serve_peers == {"pong": 1}
    finally:
        client.close()
        server.stop()
        assert server.serve_peers == {}


def test_serve_tags_old_client_new_server():
    """A client that never offers a serve tag (tenancy off) negotiates
    exactly as before: no serve peers, experience flows."""
    from ape_x_dqn_tpu_torch.comm.socket_transport import (
        SocketIngestServer, SocketTransport)

    server = SocketIngestServer("127.0.0.1", 0)
    client = SocketTransport("127.0.0.1", server.port)
    try:
        client.send_experience(_mini_batch())
        assert server.recv_experience(timeout=5.0) is not None
        assert not client.serve_negotiated
        assert server.serve_peers == {}
    finally:
        client.close()
        server.stop()


def test_serve_tags_new_client_old_server():
    """An OLD server ignores MSG_HELLO entirely: the tagged client must
    degrade (serve_negotiated False, raw codec) and its experience must
    still arrive."""
    import socket as socket_mod

    from ape_x_dqn_tpu_torch.comm.socket_transport import (
        MSG_EXPERIENCE, SocketTransport, _recv_msg, decode_batch)

    listener = socket_mod.socket(socket_mod.AF_INET,
                                 socket_mod.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    got: list = []

    def old_server():
        conn, _ = listener.accept()
        while True:
            msg = _recv_msg(conn)
            if msg is None:
                return
            if msg[0] == MSG_EXPERIENCE:  # hellos silently ignored
                got.append(msg[1])
                return

    thread = threading.Thread(target=old_server, daemon=True)
    thread.start()
    client = SocketTransport("127.0.0.1", listener.getsockname()[1],
                             hello_timeout=0.3,
                             serve_policy="pong", serve_class=0)
    try:
        batch = _mini_batch()
        client.send_experience(batch)
        assert not client.serve_negotiated
        thread.join(timeout=5)
        assert got, "old server never received the raw experience"
        np.testing.assert_array_equal(decode_batch(got[0])["obs"],
                                      batch["obs"])
    finally:
        client.close()
        listener.close()


def test_transport_backpressure_gate_drops_and_releases():
    """set_backpressure(True), the serving tier's SLO signal, makes
    send_experience drop (attributed to the 'backpressure' bucket)
    without touching the socket; release resumes delivery."""
    from ape_x_dqn_tpu_torch.comm.socket_transport import (
        SocketIngestServer, SocketTransport)

    server = SocketIngestServer("127.0.0.1", 0)
    client = SocketTransport("127.0.0.1", server.port,
                             serve_policy="pong")
    try:
        client.send_experience(_mini_batch())
        assert server.recv_experience(timeout=5.0) is not None
        client.set_backpressure(True)
        before = client.dropped
        client.send_experience(_mini_batch())
        client.send_experience(_mini_batch())
        assert client.dropped == before + 2
        assert client.drop_reasons["backpressure"] == 2
        assert server.recv_experience(timeout=0.2) is None
        client.set_backpressure(False)
        client.send_experience(_mini_batch())
        assert server.recv_experience(timeout=5.0) is not None
    finally:
        client.close()
        server.stop()
