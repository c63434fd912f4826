"""The system under test for a frame-ring DQN configuration on one card:
the port's ``DQNLearner`` over ``FrameRingReplay``, built by the port's
own entry point (``runtime/build.py: build_learner``), as ``ApexDriver``
builds it for one card."""

from __future__ import annotations

from apex_bench import inputs
from apex_bench.adaptors.base import Learner, env_spec
from apex_bench.reference import dqn as ref

REFERENCE = "dqn"


class Program(Learner):
    def __init__(self, conf, traffic, seed, devices):
        from ape_x_dqn_tpu_torch.runtime.build import build_learner

        super().__init__(conf, traffic, seed, devices)
        self.learner, self.state = build_learner(
            self.cfg, env_spec(conf), device=self.device)
        spec = ref.leaves(conf["network"], conf["env"]["obs_shape"],
                          conf["env"]["num_actions"])
        self.w0 = inputs.make_weights(spec, seed, self.device,
                                      traffic["bias_std"])
        self._load(self.w0)

    def fill(self) -> None:
        """The whole ring, block by block, through the learner's add."""
        geo = ref.ring_geometry(self.conf, self.traffic["block_segments"])
        for blk in range(geo["blocks"]):
            f = inputs.ring_fields(geo, self.traffic, self.seed, blk,
                                   self.device)
            td = f.pop("td")
            f["seg_frames"] = inputs.ring_frames(geo, self.seed, blk,
                                                 self.device)
            self.state = self.learner.add_many(
                self.state, {k: v[None] for k, v in f.items()}, td[None])
        self._filled()
