"""The system under test for a frame-ring DQN configuration over four
cards: the port's ``CardsLearner`` of ``DistDQNLearner`` card groups
(``parallel/cards.py``), on the configuration's dp x tp mesh laid over
the cards as ``[c0, c1, c2, c3] * 2``: rows (c0, c1), (c2, c3), (c0,
c1), (c2, c3), so c0 and c2 each own two replay shards and a replica of
the net whose ``torso_out`` is column-split with their tp partner (c1,
c3), and the groups exchange each SGD step's gradient over NCCL between
captured segments."""

from __future__ import annotations

import torch

from apex_bench import inputs
from apex_bench.adaptors.base import Learner, env_spec
from apex_bench.reference import dqn as ref

REFERENCE = "dqn"


class Program(Learner):
    def __init__(self, conf, traffic, seed, devices):
        from ape_x_dqn_tpu_torch.models import build_network
        from ape_x_dqn_tpu_torch.parallel.cards import (CardsLearner,
                                                        group_learner)
        from ape_x_dqn_tpu_torch.parallel.dist_learner import DistDQNLearner
        from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
        from ape_x_dqn_tpu_torch.runtime.build import \
            build_prioritized_replay
        from ape_x_dqn_tpu_torch.utils.rng import component_generator

        super().__init__(conf, traffic, seed, devices)
        self.cards = list(devices)
        cfg, spec = self.cfg, env_spec(conf)
        dp, tp = cfg.parallel.dp, cfg.parallel.tp
        mesh = make_mesh(dp=dp, tp=tp, devices=self.cards
                         * (dp * tp // len(self.cards)))
        shard_cap = conf["replay"]["capacity"] // dp
        self.learner = CardsLearner(
            group_learner(DistDQNLearner, cfg.learner),
            lambda dev: build_prioritized_replay(cfg, spec, shard_cap, dev,
                                                 frame_mode=True),
            cfg.learner, mesh)
        self.state = self.learner.init(
            build_network(cfg.network, spec), None,
            component_generator(cfg.seed, "learner", device=self.device))
        self.w0 = inputs.make_weights(
            ref.leaves(conf["network"], conf["env"]["obs_shape"],
                       conf["env"]["num_actions"]),
            seed, self.device, traffic["bias_std"])
        self._load(self.w0)

    def devices(self) -> list[torch.device]:
        return self.cards

    def _load(self, weights: dict) -> None:
        """The seed's weights into every group's replica and target (the
        pieces of a split layer into its cards), Adam's moments and
        count to zero and the step count to 0, in place."""
        zeros = [torch.zeros_like(v) for v in weights.values()]
        self.state.restore({
            "params": weights, "target_params": weights,
            "opt_state": {"count": torch.zeros((), dtype=torch.int32),
                          "mu": zeros, "nu": zeros},
            "rng": self.state.generator.get_state(), "step": 0})

    def fill(self) -> None:
        """Every shard to capacity, block by block, through the
        learner's add (each group's rows to its owner)."""
        geo = ref.ring_geometry(self.conf, self.traffic["block_segments"])
        for blk in range(geo["blocks"]):
            f = inputs.ring_fields(geo, self.traffic, self.seed, blk,
                                   self.device)
            td = f.pop("td")
            f["seg_frames"] = inputs.ring_frames(geo, self.seed, blk,
                                                 self.device)
            self.state = self.learner.add(self.state, f, td)
            del f, td
        self._filled()

    def _filled(self) -> None:
        # the adds ran on each card's own stream (`on_cards`): wait for
        # every card before reading a tree on its default stream
        for d in self.cards:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        self._tree0 = [st.replay.tree.clone() for st in self.state.groups]

    def _reset(self) -> None:
        self._load(self.w0)
        for st, tree in zip(self.state.groups, self._tree0):
            st.replay.tree.copy_(tree)
        for d in self.cards:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _moments_and_leaves(self) -> tuple[dict, torch.Tensor]:
        from ape_x_dqn_tpu_torch.parallel.tensor_parallel import \
            whole_tensors

        st0 = self.state.groups[0]
        cap = self.learner.replay.capacity
        leaves = torch.empty((self.state.dp, cap), dtype=torch.float32)
        for st, rows in zip(self.state.groups, self.state.rows):
            leaves[list(rows)] = st.replay.tree[:, cap:].cpu()
        return whole_tensors(st0.net, st0.opt_state.mu), leaves.reshape(-1)
