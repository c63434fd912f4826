"""The inputs a run makes from ``--seed``: the weights, the replay's
contents and the learner's draw noise.

Both sides get the same inputs: the port loads them through its own add
path and parameter tensors, and the reference regenerates whatever part
it needs from the same seed, block by block, so nothing that the port
derived from them (padded frame rows, its sum-tree) reaches the
reference.

Everything is drawn on the run's device by a ``torch.Generator`` of
that device, in a few large calls: the weights as one normal draw, the
replay one block of segments per call, its fields (and the initial
|TD|s) from a generator of their own so that the reference can rebuild
the sum-tree without the frames. The same seed gives the same inputs on
the same kind of device.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit generator seed for (seed, tags): any whole seed, also
    one beyond 64 bits, gives a valid ``manual_seed`` argument."""
    digest = hashlib.blake2b(repr((int(seed), *tags)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(device: torch.device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def make_weights(leaves: list[tuple[str, tuple, int]], seed: int,
                 device: torch.device, bias_std: float) -> dict:
    """{name: float32 tensor} for leaves (name, shape, fan_in): one
    normal draw over every element, a weight's slice scaled to variance
    1/fan_in (LeCun), a bias's (fan_in 0) to `bias_std`."""
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.randn(total, generator=generator(device, seed, "weights"),
                       device=device)
    out, off = {}, 0
    for name, shape, fan_in in leaves:
        n = math.prod(shape)
        scale = (1.0 / math.sqrt(fan_in)) if fan_in else bias_std
        out[name] = (flat[off:off + n] * scale).view(shape).clone()
        off += n
    return out


def draw_noise(shape: tuple, seed: int, device: torch.device
               ) -> torch.Tensor:
    """The first draw's stratification noise, as the learner draws it
    from a generator seeded with ``noise_seed(seed)``."""
    return torch.rand(shape, generator=generator(device, seed, "noise"),
                      device=device)


def noise_seed(seed: int) -> int:
    return sub_seed(seed, "noise")


def priorities(shape: tuple, g: torch.Generator, device: torch.device,
               dist: dict) -> torch.Tensor:
    """Initial |TD| errors: lognormal(mu, sigma), heavy-tailed like real
    TD errors (uniform ones would flatter the sum-tree's draw)."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown priority distribution {dist['dist']!r}")
    z = torch.randn(shape, generator=g, device=device)
    return torch.exp(dist["mu"] + dist["sigma"] * z)


def _lead(geo: dict) -> tuple:
    """The leading [dp] axis of a block over dp > 1 shards."""
    dp = geo.get("dp", 1)
    return (dp,) if dp > 1 else ()


def ring_fields(geo: dict, traffic: dict, seed: int, block: int,
                device: torch.device) -> dict:
    """The transition fields of segment block `block` of a frame ring
    (`geo`: dp shards, segments G per shard, seg_transitions B, n_step,
    gamma, num_actions). -> {"action", "reward", "discount",
    "next_off", "td"} [G, B], or [dp, G, B] over dp > 1 shards.
    Rewards are clipped ones in {-1, 0, 1}. A transition ends its
    episode with probability p_terminal: its bootstrap frame is then
    1..n steps ahead with discount 0; otherwise n steps ahead with
    discount gamma^n."""
    g = generator(device, seed, "fields", block)
    shape = _lead(geo) + (geo["segments"], geo["seg_transitions"])
    n = geo["n_step"]
    action = torch.randint(0, geo["num_actions"], shape, generator=g,
                           device=device, dtype=torch.int32)
    u = torch.rand(shape, generator=g, device=device)
    p = traffic["reward_p"]
    reward = torch.where(u < p, -1.0, torch.where(u >= 1.0 - p, 1.0, 0.0))
    terminal = torch.rand(shape, generator=g,
                          device=device) < traffic["p_terminal"]
    span = torch.randint(1, n + 1, shape, generator=g, device=device,
                         dtype=torch.int32)
    next_off = torch.where(terminal, span, n).to(torch.int32)
    discount = torch.where(terminal, 0.0, geo["gamma"] ** n).to(
        torch.float32)
    td = priorities(shape, g, device, traffic["priority"])
    return {"action": action, "reward": reward, "discount": discount,
            "next_off": next_off, "td": td}


def ring_frames(geo: dict, seed: int, block: int,
                device: torch.device) -> torch.Tensor:
    """The frames of segment block `block`: [G, F, h, w] ([dp, G, F, h,
    w] over dp > 1 shards) uniform bytes
    (the card's machine has no emulator; see the configuration's
    ``assumed``)."""
    return torch.randint(
        0, 256, _lead(geo) + (geo["segments"], geo["frames"], geo["h"],
                              geo["w"]),
        generator=generator(device, seed, "frames", block), device=device,
        dtype=torch.uint8)


def seq_fields(geo: dict, traffic: dict, seed: int, block: int,
               device: torch.device) -> dict:
    """The fields of sequence block `block` (`geo`: shards dp,
    sequences per shard G, length L, lstm size H, num_actions), each
    [dp, G, ...]: actions, clipped rewards, terminals and the valid
    mask over L steps, the stored recurrent state (init_c, init_h) from
    before the first step, and the initial |TD| ("td" [dp, G]). A
    sequence ends its episode with probability p_end, at a uniform step:
    a terminal there, and the steps after it are padding (mask 0,
    reward 0)."""
    g = generator(device, seed, "seq_fields", block)
    lead = (geo["dp"], geo["segments"])
    length, hid = geo["seq_length"], geo["lstm_size"]
    actions = torch.randint(0, geo["num_actions"], (*lead, length),
                            generator=g, device=device, dtype=torch.int32)
    u = torch.rand((*lead, length), generator=g, device=device)
    p = traffic["reward_p"]
    rewards = torch.where(u < p, -1.0, torch.where(u >= 1.0 - p, 1.0, 0.0))
    ends = torch.rand(lead, generator=g, device=device) < traffic["p_end"]
    at = torch.randint(0, length, lead, generator=g, device=device)
    t = torch.arange(length, device=device)
    terminals = (ends[..., None] & (t == at[..., None])).float()
    mask = (~(ends[..., None] & (t > at[..., None]))).float()
    init_c = traffic["state_std"] * torch.randn(
        (*lead, hid), generator=g, device=device)
    init_h = torch.tanh(traffic["state_std"] * torch.randn(
        (*lead, hid), generator=g, device=device))
    td = priorities(lead, g, device, traffic["priority"])
    return {"actions": actions, "rewards": rewards * mask,
            "terminals": terminals, "mask": mask, "init_c": init_c,
            "init_h": init_h, "td": td}


def seq_frames(geo: dict, seed: int, block: int,
               device: torch.device) -> torch.Tensor:
    """The single frames of sequence block `block`: [dp, G, L + stack -
    1, h, w] uniform bytes (step t stacks frames t .. t + stack - 1)."""
    return torch.randint(
        0, 256, (geo["dp"], geo["segments"], geo["frames"], geo["h"],
                 geo["w"]),
        generator=generator(device, seed, "seq_frames", block),
        device=device, dtype=torch.uint8)
