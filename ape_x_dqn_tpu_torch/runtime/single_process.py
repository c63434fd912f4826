"""Single-process trainer: one env, one net, device replay and the
learner, all in one process with no transport.

Counterpart of ``ape_x_dqn_tpu/runtime/single_process.py``, the JAX
package's whole training loop in one process and its correctness
oracle: ε-greedy acting through the online network, n-step folding,
flat replay (prioritized or uniform) and the learner, with the K-batch
and the double-buffered (`sample_prefetch`) paths. It works for any
flat-transition discrete config (the CartPole MLP, the Nature-CNN on
84x84x4 pixels); pixel transitions are stored as packed byte rows and
sampled through the hand-written row-gather kernel.

    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.runtime.single_process import (
        train_single_process)
    out = train_single_process(get_config("cartpole_smoke"),
                               total_env_frames=9_000)  # on cuda

Differences from the original, by design:
- The device is explicit (`device`, default "cuda"; "cpu" runs the plain
  PyTorch paths). Asking for CUDA without it raises.
- The actor's numpy generator is seeded from the port's
  ``component_seed(cfg.seed, "actor_host")``: the original seeds it from
  JAX's ``RngStream.next_uint32``, whose threefry bits cannot be
  reproduced without JAX. Runs are reproducible, but not the same
  episode-for-episode as the JAX package's.
- Observability is the disabled facade (obs/core.py); the observed
  split dispatch (the original's ``traced_train``) and its publish-
  boundary instruments wait for the device observability port (ROADMAP
  Queue A item 17), and an obs-enabled config raises.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.models import build_network, init_params
from ape_x_dqn_tpu_torch.obs.core import build_obs
from ape_x_dqn_tpu_torch.ops.nstep import NStepBuilder
from ape_x_dqn_tpu_torch.replay.prioritized import (PrioritizedReplay,
                                                    UniformReplayDevice)
from ape_x_dqn_tpu_torch.runtime.learner import (DQNLearner,
                                                 transition_item_spec)
from ape_x_dqn_tpu_torch.utils.metrics import Metrics, log_run_header
from ape_x_dqn_tpu_torch.utils.misc import next_pow2, resolve_device
from ape_x_dqn_tpu_torch.utils.rng import (component_generator,
                                           component_seed)


def build_replay(rcfg, device: str | torch.device = "cuda"):
    """Flat replay at next_pow2(capacity): uniform or prioritized. The
    storage layout setting does not apply here: this trainer always
    stores flat transitions, as the original does."""
    cap = next_pow2(rcfg.capacity)
    if rcfg.kind == "uniform":
        return UniformReplayDevice(capacity=cap, device=device)
    return PrioritizedReplay(capacity=cap, alpha=rcfg.alpha, beta=rcfg.beta,
                             eps=rcfg.eps, device=device)


def train_single_process(cfg, total_env_frames: int | None = None,
                         metrics: Metrics | None = None,
                         solve_return: float | None = None,
                         train_every: int = 1,
                         flush_every: int = 32,
                         device: str | torch.device = "cuda") -> dict:
    """Run config-1-style training on `device`; returns summary stats
    with the original's keys."""
    dev = resolve_device(device)
    total = total_env_frames or cfg.total_env_frames
    metrics = metrics or Metrics()
    log_run_header(metrics, cfg)
    # `obs` is this loop's env observation; the observability facade
    # rides as `obs_` (NULL_OBS: see the module docstring)
    obs_ = build_obs(getattr(cfg, "obs", None), metrics)
    obs_.blackbox.install()
    obs_.register("actor-0")
    obs_.register("learner")
    env = make_env(cfg.env, seed=cfg.seed)
    net = build_network(cfg.network, env.spec)
    init_params(net, component_generator(cfg.seed, "net_init"))
    net.to(dev)

    obs = env.reset()
    replay = build_replay(cfg.replay, dev)
    item_spec = transition_item_spec(env.spec.obs_shape,
                                     env.spec.obs_dtype)
    learner = DQNLearner(replay, cfg.learner)
    state = learner.init(net, replay.init(item_spec),
                         component_generator(cfg.seed, "learner",
                                             device=dev))

    nstep = NStepBuilder(cfg.learner.n_step, cfg.learner.gamma)
    actor_rng = np.random.default_rng(component_seed(cfg.seed, "actor_host"))

    pending: list = []
    returns: deque[float] = deque(maxlen=100)
    losses: deque[float] = deque(maxlen=100)
    frames = 0
    grad_steps = 0
    # K-batch relaxation: bank K training opportunities, then one K-step
    # macro-dispatch — same grad-steps-per-frame as the exact path
    sample_chunk = max(getattr(cfg.learner, "sample_chunk", 1), 1)
    train_bank = 0
    # Double-buffered sampling (LearnerConfig.sample_prefetch): keep ONE
    # macro-step's sample in flight — each macro opportunity first draws
    # the next sample from the CURRENT tree, then learns on the sample
    # drawn at the PREVIOUS opportunity. The pending sample's priorities
    # (and, after interleaved adds, even its slots) may be one round
    # stale: the async-replay semantics of the reference's host sampler.
    sample_prefetch = (sample_chunk > 1
                       and getattr(cfg.learner, "sample_prefetch", False))
    pending_sample = None
    eps_final = 0.05
    eps_decay_frames = max(total // 10, 1_000)

    def flush():
        """Pending n-step transitions -> one host-to-device copy per leaf
        (stacked on the host) and one replay add."""
        nonlocal pending
        if not pending:
            return
        with obs_.span("replay.add", n=len(pending)):
            items = {
                "obs": torch.from_numpy(np.stack([t.obs for t in pending])),
                "action": torch.from_numpy(np.asarray(
                    [t.action for t in pending], np.int32)),
                "reward": torch.from_numpy(np.asarray(
                    [t.reward for t in pending], np.float32)),
                "next_obs": torch.from_numpy(
                    np.stack([t.next_obs for t in pending])),
                "discount": torch.from_numpy(np.asarray(
                    [t.discount for t in pending], np.float32)),
            }
            learner.add(state, items, torch.ones(len(pending)))
        obs_.count("replay_adds", len(pending))
        pending = []

    while frames < total:
        obs_.beat("actor-0", f"frame {frames}")
        eps = max(eps_final, 1.0 - (1.0 - eps_final) * frames
                  / eps_decay_frames)
        with obs_.span("actor.step"):
            if actor_rng.random() < eps:
                action = int(actor_rng.integers(env.spec.num_actions))
            else:
                # one host sync per greedy frame, as the original's
                # int(jnp.argmax(q[0]))
                with torch.no_grad():
                    q = state.net(torch.from_numpy(obs[None]).to(dev))
                action = int(q[0].argmax())
            next_obs, reward, done, info = env.step(action)
        frames += 1
        truncated = done and not info.get("terminal", done)
        pending.extend(nstep.append(obs, action, reward, next_obs,
                                    info.get("terminal", done), truncated))
        obs = env.reset() if done else next_obs
        if done and "episode_return" in info:
            returns.append(info["episode_return"])

        if len(pending) >= flush_every:
            flush()

        if (state.replay.size + len(pending) >= cfg.replay.min_fill
                and frames % train_every == 0):
            flush()
            prev_grad_steps = grad_steps
            m = None
            if sample_chunk > 1:
                # bank K training opportunities, then one K-batch
                # macro-dispatch (<= K-1 banked opportunities evaporate
                # at loop end — same grad/frame ratio, harmless)
                train_bank += 1
                if train_bank >= sample_chunk:
                    train_bank = 0
                    if sample_prefetch:
                        if pending_sample is None:  # pipeline prologue
                            pending_sample = learner.sample_k(state,
                                                              sample_chunk)
                        nxt = learner.sample_k(state, sample_chunk)
                        state, m = learner.learn_k(state, pending_sample,
                                                   sample_chunk)
                        pending_sample = nxt
                    else:
                        state, m = learner.train_step_k(state, sample_chunk)
                    grad_steps += sample_chunk
            else:
                state, m = learner.train_step(state)
                grad_steps += 1
            if m is not None:
                obs_.beat("learner", f"grad_step {grad_steps}")
                losses.append(float(m["loss"]))
                # boundary CROSSING, not equality: K-sized increments
                # would otherwise only hit exact multiples at lcm(K, 500)
                if prev_grad_steps // 500 != grad_steps // 500:
                    metrics.log(grad_steps, frames=frames,
                                loss=float(m["loss"]),
                                q_mean=float(m["q_mean"]),
                                avg_return=(float(np.mean(returns))
                                            if returns else 0.0),
                                eps=eps)
        obs_.check_stalled()
        if (solve_return is not None and len(returns) >= 20
                and np.mean(list(returns)[-20:]) >= solve_return):
            break

    obs_.gauge("replay_occupancy", state.replay.size)
    obs_.close(grad_steps)
    return {
        "frames": frames,
        "grad_steps": grad_steps,
        "avg_return": float(np.mean(returns)) if returns else 0.0,
        "last20_return": (float(np.mean(list(returns)[-20:]))
                          if len(returns) >= 1 else 0.0),
        "episodes": len(returns),
        "final_loss": float(np.mean(losses)) if losses else float("nan"),
    }
