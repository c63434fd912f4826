"""Plain PyTorch reference of the Ape-X DQN learner over a frame-ring
replay: the first macro-step of K grad-steps, from the benchmark's
inputs.

What it follows (Horgan et al. 2018; Mnih et al. 2015; Wang et al.
2016; van Hasselt et al. 2016):
- the replay: segments of B transitions over B + n + stack - 1 frames;
  transition j of segment k stacks frames j..j+stack-1 (channel c is
  frame j + c) and bootstraps from the stack next_off frames later;
  priorities (|TD| + eps)^alpha in a sum-tree;
- ONE stratified draw of K * b leaves from each of dp shards (b = batch
  / dp; one shard without a ``parallel`` part) for K SGD steps, step j
  taking each shard's strata j, j + K, j + 2K, ...; a draw's
  probability is its in-shard probability over dp, its IS weight (N
  P)^-beta over the global fill N, normalised by the step's largest
  over every shard; the step's batch is the shards' draws, shard-major;
- the dueling Nature CNN over frames / 255 (NCHW, flattened in CHW
  order), double-DQN n-step targets from the target net, the IS-weighted
  Huber mean, clipped Adam, the hard target sync every
  ``target_sync_every`` steps;
- after the K steps, ONE write-back per shard of (|TD| + eps)^alpha at
  every drawn leaf, 0 at dead slots (next_off 0). Leaf indices are
  global: shard d's leaf i at d * capacity + i.

Everything is float32 (TF32 off) unless `precision` asks for the fp8
control. Imports nothing of the port and nothing of JAX; it regenerates
the replay from the seed block by block (``apex_bench/inputs.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from apex_bench import inputs
# the learner cells' comparison, this reference's `compare`
from apex_bench.checks import NAMES, as_readings, compare  # noqa: F401
from apex_bench.reference.common import (ClippedAdam, build_tree,
                                         exact_float32, huber,
                                         importance_weights, quantizer,
                                         stratified_draw)


def conv_out(hw: int, kernels, strides) -> int:
    for k, s in zip(kernels, strides):
        hw = (hw - k) // s + 1
    return hw


def torso_leaves(net: dict, obs_shape) -> list[tuple[str, tuple, int]]:
    """(name, shape, fan_in; 0 for a bias) of the Nature-CNN torso."""
    h, w, stack = obs_shape
    out = []
    c_in = stack
    for i, (c, k) in enumerate(zip(net["cnn_channels"], net["cnn_kernels"])):
        out.append((f"torso.convs.{i}.weight", (c, c_in, k, k),
                    c_in * k * k))
        out.append((f"torso.convs.{i}.bias", (c,), 0))
        c_in = c
    side = conv_out(h, net["cnn_kernels"], net["cnn_strides"])
    flat = side * side * c_in
    d = net["torso_dense"]
    return out + [("torso.torso_out.weight", (d, flat), flat),
                  ("torso.torso_out.bias", (d,), 0)]


def head_leaves(width: int, num_actions: int) -> list:
    return [("head.value.weight", (1, width), width),
            ("head.value.bias", (1,), 0),
            ("head.advantage.weight", (num_actions, width), width),
            ("head.advantage.bias", (num_actions,), 0)]


def leaves(net: dict, obs_shape, num_actions: int
           ) -> list[tuple[str, tuple, int]]:
    """Every parameter of the dueling Nature CNN, in the state-dict
    naming both sides share."""
    return (torso_leaves(net, obs_shape)
            + head_leaves(net["torso_dense"], num_actions))


def torso(params: dict, x: torch.Tensor, net: dict, q) -> torch.Tensor:
    """Nature-CNN features [N, dense] of float frames x [N, S, H, W]
    (already / 255)."""
    for i, s in enumerate(net["cnn_strides"]):
        x = F.relu(F.conv2d(q(x), q(params[f"torso.convs.{i}.weight"]),
                            params[f"torso.convs.{i}.bias"], stride=s))
    x = x.reshape(x.shape[0], -1)
    return F.relu(F.linear(q(x), q(params["torso.torso_out.weight"]),
                           params["torso.torso_out.bias"]))


def dueling_head(params: dict, x: torch.Tensor, q) -> torch.Tensor:
    v = F.linear(q(x), q(params["head.value.weight"]),
                 params["head.value.bias"])
    a = F.linear(q(x), q(params["head.advantage.weight"]),
                 params["head.advantage.bias"])
    return v + a - a.mean(dim=-1, keepdim=True)


def q_values(params: dict, obs: torch.Tensor, net: dict,
             q=lambda x: x) -> torch.Tensor:
    """Dueling Q-values [N, A] of uint8 frame stacks obs [N, H, W, S]."""
    x = obs.permute(0, 3, 1, 2).float() / 255.0
    return dueling_head(params, torso(params, x, net, q), q)


def dqn_loss(params, target, batch, w, conf, q, half=False):
    """-> (IS-weighted Huber mean, |TD| [n]) of one SGD step. `half`:
    the fault of a step that leaves half of its batch out."""
    net, lc = conf["network"], conf["learner"]
    if half:
        m = batch["obs"].shape[0] // 2
        batch = {k: v[:m] for k, v in batch.items()}
        w = w[:m]
    q_s = q_values(params, batch["obs"], net, q)
    with torch.no_grad():
        a_star = q_values(params, batch["next_obs"], net, q).argmax(-1)
        boot = q_values(target, batch["next_obs"], net, q).gather(
            -1, a_star[:, None])[:, 0]
        y = batch["reward"] + batch["discount"] * boot
    td = q_s.gather(-1, batch["action"].long()[:, None])[:, 0] - y
    loss = (w * huber(td, lc["huber_delta"])).mean()
    return loss, td.detach().abs()


def ring_geometry(conf: dict, block_segments: int) -> dict:
    """The frame ring's shape from the configuration and the cell's
    fill block: dp shards (1 without a ``parallel`` part) of
    ``capacity / dp`` transitions each."""
    h, w, stack = conf["env"]["obs_shape"]
    r, lc = conf["replay"], conf["learner"]
    dp = conf.get("parallel", {}).get("dp", 1)
    b = r["seg_transitions"]
    cap = r["capacity"] // dp
    return {"dp": dp, "segments": block_segments, "seg_transitions": b,
            "frames": b + lc["n_step"] + stack - 1, "h": h, "w": w,
            "stack": stack, "n_step": lc["n_step"], "gamma": lc["gamma"],
            "num_actions": conf["env"]["num_actions"], "capacity": cap,
            "blocks": cap // (b * block_segments)}


def _block(geo, traffic, seed, blk, device, frames: bool) -> dict:
    """Block `blk`'s fields (and frames), each with a leading [dp]
    axis."""
    f = inputs.ring_fields(geo, traffic, seed, blk, device)
    if frames:
        f["seg_frames"] = inputs.ring_frames(geo, seed, blk, device)
    if geo["dp"] == 1:
        f = {k: v[None] for k, v in f.items()}
    return f


def _leaf_priorities(conf, traffic, seed, geo, device):
    """The initial leaves and next_off [dp, capacity] of every shard,
    from the fields' generators alone."""
    r = conf["replay"]
    pri, off = [], []
    for blk in range(geo["blocks"]):
        f = _block(geo, traffic, seed, blk, device, frames=False)
        live = f["next_off"] > 0
        p = torch.where(live, (f["td"] + r["eps"]) ** r["alpha"],
                        torch.zeros_like(f["td"]))
        pri.append(p.reshape(geo["dp"], -1))
        off.append(f["next_off"].reshape(geo["dp"], -1))
    return torch.cat(pri, dim=1), torch.cat(off, dim=1)


def _transitions(traffic, seed, geo, idx, device) -> dict:
    """The flat transitions at leaves idx [dp, n] (shard d's leaves of
    its own ring) as one shard-major batch [dp * n], rebuilt block by
    block from regenerated segments."""
    b, stack = geo["seg_transitions"], geo["stack"]
    dp, n = idx.shape
    per_block = b * geo["segments"]
    flat = idx.reshape(-1)
    shard = torch.arange(dp, device=device).repeat_interleave(n)
    h, w = geo["h"], geo["w"]
    out = {"obs": torch.empty((dp * n, h, w, stack), dtype=torch.uint8,
                              device=device),
           "next_obs": torch.empty((dp * n, h, w, stack), dtype=torch.uint8,
                                   device=device)}
    for key, dt in (("action", torch.int32), ("reward", torch.float32),
                    ("discount", torch.float32)):
        out[key] = torch.empty(dp * n, dtype=dt, device=device)
    blocks = flat // per_block
    offs = torch.arange(stack, device=device)
    for blk in torch.unique(blocks).tolist():
        rows = torch.nonzero(blocks == blk)[:, 0]
        d, local = shard[rows], flat[rows] - blk * per_block
        seg, slot = local // b, local % b
        f = _block(geo, traffic, seed, blk, device, frames=True)
        frames = f["seg_frames"]
        nxt = slot + f["next_off"].reshape(dp, -1)[d, local].long()
        # frames[d, seg, slot + c] -> channel c
        out["obs"][rows] = frames[d[:, None], seg[:, None],
                                  slot[:, None] + offs].permute(0, 2, 3, 1)
        out["next_obs"][rows] = frames[d[:, None], seg[:, None],
                                       nxt[:, None] + offs].permute(
                                           0, 2, 3, 1)
        for key in ("action", "reward", "discount"):
            out[key][rows] = f[key].reshape(dp, -1)[d, local]
        del f, frames
    return out


def follow(conf: dict, traffic: dict, seed: int, device: torch.device,
           precision: str = "float32", fault: str | None = None) -> dict:
    """The reference's first macro-step from the seed's inputs.
    `fault` plants one of the faults a benchmark check must catch:
    "half_batch" (each step's mean over half its rows), "altered" (the
    written-back |TD| 1.5 times what the step computed). -> {"loss":
    the last step's loss, "losses", "mu" {leaf: Adam's first moment},
    "params" {leaf: params after}, "params0", "grad0" {leaf: the first
    step's gradient norm}, "written" {leaf index: [(step, priority)] of
    each draw of it},
    "leaves0" the initial leaves}."""
    with exact_float32():
        return _follow(conf, traffic, seed, device, precision, fault)


def _follow(conf, traffic, seed, device, precision, fault):
    net, r, lc = conf["network"], conf["replay"], conf["learner"]
    geo = ring_geometry(conf, traffic["block_segments"])
    k, dp, cap = lc["sample_chunk"], geo["dp"], geo["capacity"]
    b = lc["batch_size"] // dp
    q = quantizer(precision)
    leaves0, next_off = _leaf_priorities(conf, traffic, seed, geo, device)
    tree = build_tree(leaves0)
    # one generator draw: [k * b] on one shard, [dp, k * b] over dp
    noise = inputs.draw_noise((k * b,) if dp == 1 else (dp, k * b), seed,
                              device).reshape(dp, k * b)
    idx, p = stratified_draw(tree, noise, cap)
    valid = next_off.gather(1, idx) > 0
    w_all = importance_weights(p / dp, float(dp * cap), r["beta"], valid)
    data = _transitions(traffic, seed, geo, idx, device)

    spec = leaves(net, conf["env"]["obs_shape"], conf["env"]["num_actions"])
    params0 = inputs.make_weights(spec, seed, device, traffic["bias_std"])
    params = {n: v.clone().requires_grad_(True) for n, v in params0.items()}
    target = {n: v.clone() for n, v in params0.items()}
    adam = ClippedAdam(params, lc["lr"], lc["adam_eps"],
                       lc["max_grad_norm"])
    shard0 = torch.arange(dp, device=device)[:, None] * (k * b)
    losses, tds, grad0 = [], [], None
    for j in range(k):
        cols = torch.arange(j, k * b, k, device=device)
        rows = (shard0 + cols[None, :]).reshape(-1)
        batch = {key: v[rows] for key, v in data.items()}
        w = w_all[:, cols].reshape(-1)
        w = w / torch.clamp(w.max(), min=1e-12)
        loss, td = dqn_loss(params, target, batch, w, conf, q,
                            half=fault == "half_batch")
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if grad0 is None:
            grad0 = {n: float(g.norm()) for n, g in grads.items()}
        adam.step(params, grads)
        params = {n: v.requires_grad_(True) for n, v in params.items()}
        if adam.t % lc["target_sync_every"] == 0:
            target = {n: v.detach().clone() for n, v in params.items()}
        losses.append(float(loss.detach()))
        if fault == "half_batch":
            td = torch.cat([td, td])[:dp * b]
        tds.append((td * (1.5 if fault == "altered" else 1.0)).reshape(dp, b))
    written: dict[int, list[tuple[int, float]]] = {}
    for j in range(k):
        cols = torch.arange(j, k * b, k, device=device)
        live = valid[:, cols]
        pri = torch.where(live, (tds[j] + r["eps"]) ** r["alpha"],
                          torch.zeros_like(tds[j]))
        glob = idx[:, cols] + torch.arange(dp, device=device)[:, None] * cap
        for leaf, v in zip(glob.reshape(-1).tolist(),
                           pri.reshape(-1).tolist()):
            written.setdefault(leaf, []).append((j, v))
    return {"loss": losses[-1], "losses": losses,
            "mu": {n: v.detach() for n, v in adam.mu.items()},
            "params": {n: v.detach() for n, v in params.items()},
            "params0": params0, "grad0": grad0, "written": written,
            "leaves0": leaves0.reshape(-1)}
