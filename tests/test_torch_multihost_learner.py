"""The multi-process dp-sharded learner (parallel/dist_learner.py with a
parallel/multihost.py `GradExchange`) over two gloo processes on the
CPU, against the port's one-process dist learners at the same global
dp on one recorded stream of adds. tests/test_torch_parallel.py holds
those one-process learners against the JAX package's dist learners.

Each of the two processes (torch.multiprocessing spawn, a free port)
holds 4 of the 8 shards, rows [4 * rank, 4 * rank + 4), and adds those
rows of every recorded block; the one-process learner adds all 8. Five
K=2 macro-steps: the params must equal the one-process learner's within
1e-5 (float32) and be IDENTICAL across the two ranks, and each rank's
sum-trees must equal the one-process learner's rows of them within
1e-5. The bound is the one-process parity bound of
tests/test_torch_parallel.py: the two-process gradient is the same sum
split in two halves (each half scaled by its IS max and back, summed in
rank order), so it differs from the one-process sum by float32
rounding only, well inside it after ten Adam steps."""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ape_x_dqn_tpu_torch.configs import (LearnerConfig, NetworkConfig,
                                         ReplayConfig)
from ape_x_dqn_tpu_torch.envs.base import EnvSpec
from ape_x_dqn_tpu_torch.models import build_network, init_params
from ape_x_dqn_tpu_torch.parallel.dist_learner import (DistDQNLearner,
                                                       DistSequenceLearner)
from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
from ape_x_dqn_tpu_torch.runtime.learner import transition_item_spec
from ape_x_dqn_tpu_torch.utils.rng import component_generator

DP = 8
NPROC = 2
MACRO = 5
K = 2
TIMEOUT_S = 60
TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dqn_case():
    """cartpole_smoke's width (an MLP of 256, 256 on CartPole's 4
    floats), batch 64 over dp=8."""
    spec = EnvSpec((4,), np.dtype(np.float32), True, 2)
    net = NetworkConfig(kind="mlp", mlp_hidden=(256, 256), dueling=False,
                        compute_dtype="float32")
    lcfg = LearnerConfig(batch_size=64, sample_chunk=K, lr=1e-3,
                         target_sync_every=3)
    rng = np.random.default_rng(7)
    blocks = []
    for n in (16, 16, 8):
        td = rng.uniform(0.1, 2.0, (DP, n)).astype(np.float32)
        td[3] *= 1e-2                    # a lighter shard
        blocks.append(({
            "obs": rng.normal(size=(DP, n, 4)).astype(np.float32),
            "action": rng.integers(0, 2, (DP, n)).astype(np.int32),
            "reward": rng.normal(size=(DP, n)).astype(np.float32),
            "next_obs": rng.normal(size=(DP, n, 4)).astype(np.float32),
            "discount": np.full((DP, n), 0.99, np.float32)}, td))
    return ("dqn", spec, net, lcfg, None,
            transition_item_spec((4,), np.float32), blocks)


def _r2d2_case():
    """The `_R2D2_SETS` width of tests/test_multihost.py: masked
    CartPole's 2 floats, an LSTM of 32 over a dense torso of 64, f32,
    sequences of 16 with burn-in 4, batch 16 over dp=8."""
    seq, lstm = 16, 32
    spec = EnvSpec((2,), np.dtype(np.float32), True, 2)
    net = NetworkConfig(kind="lstm_q", lstm_size=lstm, torso_dense=64,
                        compute_dtype="float32")
    lcfg = LearnerConfig(batch_size=16, n_step=3, lr=1e-3,
                         target_sync_every=3, sample_chunk=K)
    rcfg = ReplayConfig(kind="sequence", capacity=512, seq_length=seq,
                        seq_overlap=8, burn_in=4, storage="flat")
    rng = np.random.default_rng(11)
    blocks = []
    for n in (6, 6):
        mask = np.ones((DP, n, seq), np.float32)
        mask[:, ::3, seq - 3:] = 0.0
        blocks.append(({
            "obs": rng.normal(size=(DP, n, seq, 2)).astype(np.float32),
            "actions": rng.integers(0, 2, (DP, n, seq)).astype(np.int32),
            "rewards": rng.normal(size=(DP, n, seq)).astype(np.float32),
            "terminals": np.zeros((DP, n, seq), np.float32),
            "mask": mask,
            "init_c": (0.3 * rng.normal(size=(DP, n, lstm))
                       ).astype(np.float32),
            "init_h": (0.3 * rng.normal(size=(DP, n, lstm))
                       ).astype(np.float32)},
            rng.uniform(0.1, 2.0, (DP, n)).astype(np.float32)))
    return ("r2d2", spec, net, lcfg, rcfg,
            sequence_item_spec((2,), np.float32, seq, lstm,
                               frame_mode=False), blocks)


CASES = {"dqn": _dqn_case, "r2d2": _r2d2_case}


def _train(case: str, rows: slice, exchange=None,
           device: str | torch.device = "cpu") -> dict:
    """Build the case's dist learner over `rows` of the dp shards on
    `device`, add those rows of every recorded block, then MACRO K-batch
    macro-steps (the second block lands after the first two). -> params
    and trees (on the CPU), the last loss, the step graphs' classes."""
    family, spec, ncfg, lcfg, rcfg, item_spec, blocks = CASES[case]()
    dp_local = rows.stop - rows.start
    mesh = make_mesh(dp=dp_local, tp=1, devices=[device] * dp_local)
    net = build_network(ncfg, spec)
    init_params(net, component_generator(0, "net_init"))
    net.to(device)
    replay = PrioritizedReplay(capacity=64, alpha=0.6, beta=0.4,
                               device=device)
    learner = (DistSequenceLearner(replay, lcfg, rcfg, mesh,
                                   exchange=exchange)
               if family == "r2d2" else
               DistDQNLearner(replay, lcfg, mesh, exchange=exchange))
    state = learner.init(net, item_spec,
                         component_generator(0, "learner", device=device))

    def add(block):
        items, td = block
        learner.add(state, {k: torch.from_numpy(v[rows])
                            for k, v in items.items()},
                    torch.from_numpy(td[rows]))

    add(blocks[0])
    m = None
    for i in range(MACRO):
        if i == 2:
            for block in blocks[1:]:
                add(block)
        _, m = learner.train_step_k(state, K)
    return {"params": {k: v.cpu().clone() for k, v in
                       state.net.state_dict().items()},
            "tree": state.replay.tree.cpu().clone(),
            "loss": float(m["loss"]), "step": state.step,
            "graphs": {k: type(g).__name__
                       for k, g in learner.step_graphs().items()}}


def _worker(rank: int, case: str, port: int, out_dir: str) -> None:
    from ape_x_dqn_tpu_torch.parallel import multihost

    torch.set_num_threads(1)   # small; the suite's workers share the cores
    multihost.init_multihost(f"127.0.0.1:{port}", NPROC, rank)
    try:
        per = DP // NPROC
        out = _train(case, slice(rank * per, (rank + 1) * per),
                     multihost.GradExchange())
        out["rows"] = multihost.process_rows(DP)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_processes_match_the_one_process_learner(case, tmp_path):
    ref = _train(case, slice(0, DP))
    ctx = mp.start_processes(_worker, args=(case, _free_port(),
                                            str(tmp_path)),
                             nprocs=NPROC, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "a rank hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(NPROC)]
    per = DP // NPROC
    for rank, out in enumerate(outs):
        assert out["rows"] == (rank * per, (rank + 1) * per)
        assert out["step"] == ref["step"] == MACRO * K
        for name, want in ref["params"].items():
            np.testing.assert_allclose(out["params"][name].numpy(),
                                       want.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=name)
        np.testing.assert_allclose(
            out["tree"].numpy(), ref["tree"][rank * per:(rank + 1) * per]
            .numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=TOL)
    for name, p0 in outs[0]["params"].items():
        assert torch.equal(p0, outs[1]["params"][name]), name
    assert outs[0]["loss"] == outs[1]["loss"]
