"""The system under test for an R2D2 configuration on one card: the
port's ``DistSequenceLearner`` over dp stacked ``PrioritizedReplay``
shards of frame-mode sequences, on the preset's dp x tp mesh with every
position on the one card, as ``ApexDriver`` builds it when the mesh
repeats one card (``runtime/driver.py``)."""

from __future__ import annotations

from apex_bench import inputs
from apex_bench.adaptors.base import Learner, env_spec
from apex_bench.reference import r2d2 as ref

REFERENCE = "r2d2"


class Program(Learner):
    def __init__(self, conf, traffic, seed, devices):
        from ape_x_dqn_tpu_torch.models import build_network
        from ape_x_dqn_tpu_torch.parallel.dist_learner import \
            DistSequenceLearner
        from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
        from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
        from ape_x_dqn_tpu_torch.runtime.build import \
            build_prioritized_replay
        from ape_x_dqn_tpu_torch.utils.misc import next_pow2
        from ape_x_dqn_tpu_torch.utils.rng import component_generator

        super().__init__(conf, traffic, seed, devices)
        cfg, spec = self.cfg, env_spec(conf)
        dp, tp = cfg.parallel.dp, cfg.parallel.tp
        mesh = make_mesh(dp=dp, tp=tp, devices=[self.device] * (dp * tp))
        net = build_network(cfg.network, spec).to(self.device)
        shard_cap = next_pow2(max(cfg.replay.capacity // dp, 2))
        replay = build_prioritized_replay(cfg, spec, shard_cap, self.device,
                                          frame_mode=False)
        self.learner = DistSequenceLearner(replay, cfg.learner, cfg.replay,
                                           mesh)
        item_spec = sequence_item_spec(
            spec.obs_shape, spec.obs_dtype, cfg.replay.seq_length,
            cfg.network.lstm_size, frame_mode=True)
        self.state = self.learner.init(
            net, item_spec,
            component_generator(cfg.seed, "learner", device=self.device))
        self.w0 = inputs.make_weights(ref.leaves(conf), seed, self.device,
                                      traffic["bias_std"])
        self._load(self.w0)

    def fill(self) -> None:
        """Every shard to capacity, block by block, through the
        learner's lockstep add."""
        geo = ref.seq_geometry(self.conf, self.traffic["block_sequences"])
        for blk in range(geo["blocks"]):
            f = inputs.seq_fields(geo, self.traffic, self.seed, blk,
                                  self.device)
            td = f.pop("td")
            f["seq_frames"] = inputs.seq_frames(geo, self.seed, blk,
                                                self.device)
            self.state = self.learner.add_many(
                self.state, {k: v[None] for k, v in f.items()}, td[None])
            del f
        self._filled()
