"""Plain PyTorch reference of the R2D2 learner over dp prioritized
sequence shards: the first macro-step of K grad-steps, from the
benchmark's inputs.

What it follows (Kapturowski et al. 2019; Horgan et al. 2018):
- dp shards of stored sequences (single frames; step t stacks frames
  t .. t + stack - 1, channel c frame t + c), each with its own sum-tree
  of (|TD| + eps)^alpha;
- ONE stratified draw of K * b sequences from EVERY shard (b = batch /
  dp), step j taking each shard's strata j, j + K, ...; a draw's
  probability is its in-shard probability over dp, its IS weight (N
  P)^-beta over the global fill N, normalised by the step's largest over
  all shards; the step's batch is the shards' draws, shard-major;
- the LSTM Q-net: the Nature-CNN torso per frame stack, an LSTM (gates
  i, f, g, o; no input bias), a dueling head; burn-in of the first
  ``burn_in`` steps from the stored state without gradient, online and
  target alike; double-DQN n-step targets inside the sequence under the
  value rescaling h; a per-sequence Huber mean over the valid steps,
  IS-weighted; clipped Adam; the hard target sync;
- after the K steps, ONE write-back per shard of eta max|TD| + (1 - eta)
  mean|TD| of each drawn sequence.

float32 throughout (TF32 off) unless `precision` asks for the fp8
control. Imports nothing of the port and nothing of JAX.
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
from apex_bench.reference.dqn import (dueling_head, head_leaves, torso,
                                      torso_leaves)

RESCALE_EPS = 1e-3


def h(x: torch.Tensor) -> torch.Tensor:
    """The value rescaling sign(x) (sqrt(|x| + 1) - 1) + eps x."""
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + RESCALE_EPS * x


def h_inv(x: torch.Tensor) -> torch.Tensor:
    e = RESCALE_EPS
    return torch.sign(x) * (((torch.sqrt(1.0 + 4.0 * e * (x.abs() + 1.0 + e))
                              - 1.0) / (2.0 * e)) ** 2 - 1.0)


def leaves(conf: dict) -> list[tuple[str, tuple, int]]:
    net = conf["network"]
    d, hid = net["torso_dense"], net["lstm_size"]
    return (torso_leaves(net, conf["env"]["obs_shape"])
            + [("lstm.weight_ih", (4 * hid, d), d),
               ("lstm.weight_hh", (4 * hid, hid), hid),
               ("lstm.bias_hh", (4 * hid,), 0)]
            + head_leaves(hid, conf["env"]["num_actions"]))


def unroll(params: dict, frames: torch.Tensor, state, net: dict, q):
    """frames [n, T + stack - 1, H, W] uint8 from state (c, h) [n, H]
    -> (q [n, T, A], final state)."""
    n = frames.shape[0]
    stack = net["stack"]
    steps = frames.shape[1] - stack + 1
    x = torch.stack([frames[:, c:c + steps] for c in range(stack)], dim=2)
    x = x.reshape(n * steps, stack, *frames.shape[2:]).float() / 255.0
    feats = torso(params, x, net, q)
    xp = F.linear(q(feats), q(params["lstm.weight_ih"])).reshape(
        n, steps, -1)
    c, hh = state
    outs = []
    for t in range(steps):
        gates = F.linear(q(hh), q(params["lstm.weight_hh"]),
                         params["lstm.bias_hh"]) + xp[:, t]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hh = torch.sigmoid(o) * torch.tanh(c)
        outs.append(hh)
    qv = dueling_head(params, torch.stack(outs, dim=1).reshape(
        n * steps, -1), q)
    return qv.reshape(n, steps, -1), (c, hh)


def nstep_targets(rewards, terminals, mask, boot, n: int, gamma: float):
    """n-step targets at each step t of [n_seq, T] from rescaled
    bootstrap values boot [n_seq, T]: h(sum_{k<n} gamma^k r_{t+k} +
    gamma^n h^-1(boot_{t+n})), the sum stopping at a terminal (after
    which nothing is bootstrapped) and at the sequence's end or padding.
    -> (targets, valid): a step trains if it is real data and its target
    is known (the bootstrap step is real data, or a terminal came
    first)."""
    b, length = rewards.shape
    pad = torch.zeros((b, n), device=rewards.device)
    r = torch.cat([rewards, pad], dim=1)
    term = torch.cat([terminals, pad], dim=1)
    m = torch.cat([mask, pad], dim=1)
    bv = torch.cat([h_inv(boot), pad], dim=1)
    ret = torch.zeros_like(rewards)
    alive = torch.ones_like(rewards)
    for k in range(n):
        mk = m[:, k:k + length]
        ret = ret + gamma ** k * alive * r[:, k:k + length] * mk
        alive = alive * (1.0 - term[:, k:k + length] * mk)
    target = h(ret + gamma ** n * alive * bv[:, n:n + length])
    boot_ok = m[:, n:n + length]
    valid = mask * torch.clamp(boot_ok + (1.0 - alive), 0.0, 1.0)
    return target, valid


def r2d2_loss(params, target, batch, w, conf, q, half=False):
    """-> (IS-weighted mean of per-sequence Huber means, eta-mixed |TD|
    priorities [n]) of one SGD step."""
    net = dict(conf["network"], stack=conf["env"]["obs_shape"][2])
    r, lc = conf["replay"], conf["learner"]
    if half:
        m = batch["actions"].shape[0] // 2
        batch = {k: v[:m] for k, v in batch.items()}
        w = w[:m]
    burn, stack = r["burn_in"], net["stack"]
    frames = batch["seq_frames"]
    head_frames = frames[:, :burn + stack - 1]
    tail_frames = frames[:, burn:]
    state0 = (batch["init_c"], batch["init_h"])
    with torch.no_grad():
        _, s_on = unroll(params, head_frames, state0, net, q)
        _, s_tg = unroll(target, head_frames, state0, net, q)
        q_tg, _ = unroll(target, tail_frames, s_tg, net, q)
    q_on, _ = unroll(params, tail_frames, s_on, net, q)
    actions = batch["actions"][:, burn:].long()
    q_sa = q_on.gather(-1, actions[..., None])[..., 0]
    with torch.no_grad():
        boot = q_tg.gather(-1, q_on.argmax(-1, keepdim=True))[..., 0]
        y, valid = nstep_targets(batch["rewards"][:, burn:],
                                 batch["terminals"][:, burn:],
                                 batch["mask"][:, burn:], boot,
                                 lc["n_step"], lc["gamma"])
    td = (q_sa - y) * valid
    denom = torch.clamp(valid.sum(dim=1), min=1.0)
    per_seq = huber(td, lc["huber_delta"]).sum(dim=1) / denom
    loss = (w * per_seq).mean()
    a = td.detach().abs()
    eta = r["priority_eta"]
    return loss, eta * a.amax(dim=1) + (1.0 - eta) * a.sum(dim=1) / denom


def seq_geometry(conf: dict, block_sequences: int) -> dict:
    h_, w_, stack = conf["env"]["obs_shape"]
    r, p = conf["replay"], conf["parallel"]
    cap = r["capacity"] // p["dp"]
    return {"dp": p["dp"], "segments": block_sequences,
            "seq_length": r["seq_length"],
            "frames": r["seq_length"] + stack - 1, "h": h_, "w": w_,
            "lstm_size": conf["network"]["lstm_size"],
            "num_actions": conf["env"]["num_actions"],
            "capacity": cap, "blocks": cap // block_sequences}


def _sequences(traffic, seed, geo, idx, device) -> dict:
    """The sequences at leaves idx [dp, n] as a flat shard-major batch
    [dp * n, ...], rebuilt from regenerated blocks."""
    dp, n = idx.shape
    g = geo["segments"]
    flat = idx.reshape(-1)
    shard = torch.arange(dp, device=device).repeat_interleave(n)
    blocks = flat // g
    out: dict = {}
    for blk in torch.unique(blocks).tolist():
        rows = torch.nonzero(blocks == blk)[:, 0]
        d, local = shard[rows], flat[rows] - blk * g
        f = inputs.seq_fields(geo, traffic, seed, blk, device)
        f["seq_frames"] = inputs.seq_frames(geo, seed, blk, device)
        for key, v in f.items():
            if key == "td":
                continue
            if key not in out:
                out[key] = torch.empty((dp * n, *v.shape[2:]),
                                       dtype=v.dtype, device=device)
            out[key][rows] = v[d, local]
        del f
    return out


def follow(conf: dict, traffic: dict, seed: int, device: torch.device,
           precision: str = "float32", fault: str | None = None) -> dict:
    """As ``reference/dqn.py: follow``, for R2D2 over dp shards; leaf
    indices are global, shard d's leaf i at d * capacity + i."""
    with exact_float32():
        return _follow(conf, traffic, seed, device, precision, fault)


def _follow(conf, traffic, seed, device, precision, fault):
    r, lc = conf["replay"], conf["learner"]
    k, dp = lc["sample_chunk"], conf["parallel"]["dp"]
    b = lc["batch_size"] // dp
    geo = seq_geometry(conf, traffic["block_sequences"])
    cap = geo["capacity"]
    q = quantizer(precision)
    tds = [inputs.seq_fields(geo, traffic, seed, blk, device)["td"]
           for blk in range(geo["blocks"])]
    leaves0 = (torch.cat(tds, dim=1) + r["eps"]) ** r["alpha"]   # [dp, cap]
    tree = build_tree(leaves0)
    noise = inputs.draw_noise((dp, k * b), seed, device)
    idx, p = stratified_draw(tree, noise, cap)
    w_all = importance_weights(p / dp, float(dp * cap), r["beta"],
                               torch.ones_like(p))
    data = _sequences(traffic, seed, geo, idx, device)    # [dp * k * b]

    params0 = inputs.make_weights(leaves(conf), seed, device,
                                  traffic["bias_std"])
    params = {n: v.clone().requires_grad_(True) for n, v in params0.items()}
    target = {n: v.clone() for n, v in params0.items()}
    adam = ClippedAdam(params, lc["lr"], lc["adam_eps"],
                       lc["max_grad_norm"])
    losses, tds, grad0 = [], [], None
    for j in range(k):
        cols = torch.arange(j, k * b, k, device=device)          # [b]
        rows = (torch.arange(dp, device=device)[:, None] * (k * b)
                + cols[None, :]).reshape(-1)                     # [dp*b]
        batch = {key: v[rows] for key, v in data.items()}
        w = w_all[:, cols].reshape(-1)
        w = w / torch.clamp(w.max(), min=1e-12)
        loss, td = r2d2_loss(params, target, batch, w, conf, q,
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
        pri = (tds[j] + r["eps"]) ** r["alpha"]
        glob = idx[:, cols] + torch.arange(dp, device=device)[:, None] * cap
        for leaf, v in zip(glob.reshape(-1).tolist(),
                           pri.reshape(-1).tolist()):
            written.setdefault(leaf, []).append((j, v))
    return {"loss": losses[-1], "losses": losses,
            "mu": {n: v.detach() for n, v in adam.mu.items()},
            "params": {n: v.detach() for n, v in params.items()},
            "params0": params0, "grad0": grad0, "written": written,
            "leaves0": leaves0.reshape(-1)}
