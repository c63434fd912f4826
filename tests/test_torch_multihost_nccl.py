"""The multi-host learner's choice of gradient exchange
(parallel/multihost.py) on the CPU.

- The mode agreement: two spawned processes in a gloo group, each fed
  its own (on a card, processes on that card) for every case, must
  reach the same mode, and that mode is "nccl" only when every rank is
  on a card of its own (`agreed_exchange_mode`). The same processes
  count the processes on their device (both on this host's CPU: 2).
- On a CPU-only build `init_multihost` joins a gloo group, and the
  exchange it gives is gloo.
- No fallback: asking for the NCCL exchange where NCCL is unavailable
  raises, and so does the driver when the group agrees on NCCL.
- An exchange a CUDA graph can hold makes the dist learner's exchanged
  endpoints `ExchangedStep`s (one graph on the card); on the CPU both
  kinds run the same generator bodies eagerly, with the same numbers.
- The HBM budget counts NCCL's buffers with the NCCL exchange.

The card forms are tests/test_torch_multihost_cuda.py."""

import os
import socket
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ape_x_dqn_tpu_torch.configs import ParallelConfig
from ape_x_dqn_tpu_torch.parallel import multihost
from ape_x_dqn_tpu_torch.runtime.multihost_driver import MultihostApexDriver
from tests.test_torch_multihost import _tiny_cfg
from tests.test_torch_multihost_learner import DP, _train

NPROC = 2
TIMEOUT_S = 60
# name: (each rank's (on a card, processes on its card), the agreed mode)
MODES = {
    "alone_on_two_cards": (((True, 1), (True, 1)), "nccl"),
    "sharing_one_card": (((True, 2), (True, 2)), "gloo"),
    "one_rank_shares_its_card": (((True, 1), (True, 2)), "gloo"),
    "one_rank_on_the_cpu": (((True, 1), (False, 1)), "gloo"),
    "both_on_the_cpu": (((False, 1), (False, 1)), "gloo"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _agree_worker(rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    multihost.init_multihost(f"127.0.0.1:{port}", NPROC, rank,
                             device="cpu")
    try:
        out = {name: multihost.agreed_exchange_mode(*ranks[rank])
               for name, (ranks, _) in sorted(MODES.items())}
        out["processes_on_cpu"] = multihost.processes_on_device(
            torch.device("cpu"))
        multihost.barrier()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def agreed(tmp_path_factory):
    """Both ranks' agreed modes, by case (one pair of processes)."""
    out_dir = tmp_path_factory.mktemp("agree")
    ctx = mp.start_processes(_agree_worker, args=(_free_port(),
                                                  str(out_dir)),
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
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(NPROC)]


@pytest.mark.parametrize("case", sorted(MODES))
def test_every_rank_agrees_on_one_mode(agreed, case):
    want = MODES[case][1]
    assert [out[case] for out in agreed] == [want] * NPROC


def test_processes_on_device_counts_both_ranks(agreed):
    assert [out["processes_on_cpu"] for out in agreed] == [NPROC] * NPROC


@pytest.fixture
def group1():
    """A one-process group as the CLI joins it on this machine's
    default device (cuda: a CPU-only build has none)."""
    multihost.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_cpu_only_build_joins_a_gloo_group(group1):
    if torch.cuda.is_available():
        pytest.skip("this case is for a CPU-only torch build; the card "
                    "form is tests/test_torch_multihost_cuda.py")
    assert dist.get_backend() == "gloo"
    assert multihost.group_backend("cuda") == "gloo"
    assert multihost.group_backend("cpu") == "gloo"
    assert multihost.agreed_exchange_mode(False, 1) == "gloo"
    ex = multihost.GradExchange()
    assert not ex.capturable
    out = ex(torch.arange(6, dtype=torch.float32))
    assert torch.equal(out, torch.arange(6, dtype=torch.float32)[None])
    stats = ex.stats()
    assert stats["backend"] == "gloo" and stats["calls"] == 1
    assert stats["bytes_sent"] == stats["bytes_received"] == 24


def test_the_nccl_exchange_does_not_fall_back(group1):
    """Where NCCL is unavailable (this build, or a gloo group), asking
    for the device exchange raises, naming NCCL."""
    with pytest.raises(RuntimeError, match="NCCL"):
        multihost.GradExchange("nccl", device="cpu")
    with pytest.raises(ValueError, match="not one of"):
        multihost.GradExchange("mpi")


def test_the_driver_does_not_fall_back(group1, monkeypatch):
    """A group that agrees on NCCL (as when every rank is alone on its
    card) makes the driver raise where NCCL cannot run, not train over
    gloo."""
    monkeypatch.setattr(multihost, "agreed_exchange_mode",
                        lambda on_card, n: "nccl")
    with pytest.raises(RuntimeError, match="NCCL"):
        MultihostApexDriver(_tiny_cfg(parallel=ParallelConfig(dp=2, tp=1)),
                            device="cpu")


@pytest.mark.parametrize("case", ["dqn", "r2d2"])
def test_a_capturable_exchange_runs_one_exchanged_graph(group1, case):
    """With an exchange a graph can hold, the K-batch endpoint is an
    `ExchangedStep` (one graph on the card), else a `SegmentedStep`; on
    the CPU both drive the same generator bodies eagerly, bitwise
    alike, with one exchange per SGD step."""
    seg = multihost.GradExchange()
    capturable = multihost.GradExchange()
    capturable.capturable = True
    a = _train(case, slice(0, DP), seg)
    b = _train(case, slice(0, DP), capturable)
    assert set(a["graphs"].values()) == {"SegmentedStep"}
    assert set(b["graphs"].values()) == {"ExchangedStep"}
    assert seg.calls == capturable.calls == a["step"] == b["step"]
    for name, p in a["params"].items():
        assert torch.equal(p, b["params"][name]), name
    assert torch.equal(a["tree"], b["tree"]) and a["loss"] == b["loss"]


def test_the_budget_counts_nccls_buffers():
    """With the NCCL exchange the budget holds NCCL's buffers, which
    live outside PyTorch's allocator (utils/hbm.py), and a card that
    fits the run without them no longer does with them."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.utils import hbm

    cfg = get_config("r2d2")
    obs = (84, 84, 4)
    plain = hbm.check_hbm_fits(cfg, obs, shards_per_card=4)
    with_nccl = hbm.check_hbm_fits(cfg, obs, shards_per_card=4, nccl=True)
    assert plain.nccl == 0 and with_nccl.nccl == hbm.NCCL_DEVICE_BYTES
    assert with_nccl.total == plain.total + hbm.NCCL_DEVICE_BYTES
    assert "NCCL buffers" in with_nccl.table()
    hbm.check_hbm_fits(cfg, obs, shards_per_card=4, hbm_bytes=plain.total)
    with pytest.raises(ValueError, match="NCCL buffers"):
        hbm.check_hbm_fits(cfg, obs, shards_per_card=4,
                           hbm_bytes=plain.total, nccl=True)
