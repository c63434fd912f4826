"""Plain PyTorch pieces every learner reference shares: precision, the
prioritized replay's sum-tree and draw, importance weights, the Huber
loss and clipped Adam.

Written from the published algorithms (Schaul et al. 2016 for the
sum-tree and the IS weights, Horgan et al. 2018 for the stratified
draw, optax's ``clip_by_global_norm`` and ``adam`` formulas), not from
the port. Imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0   # largest float8_e4m3fn value


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls and convolutions without TF32 for the block, the
    process's settings restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def quantizer(precision: str):
    """The operand rounding of a matmul or convolution: "float32" none;
    "fp8" each operand scaled per tensor into float8 e4m3's range,
    rounded to it and scaled back (the control, one precision below the
    configurations' bfloat16). Gradients pass straight through."""
    if precision == "float32":
        return lambda x: x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")

    def q(x: torch.Tensor) -> torch.Tensor:
        scale = FP8_MAX / torch.clamp(x.detach().abs().amax(), min=1e-12)
        r = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (r - x.detach())

    return q


def build_tree(leaves: torch.Tensor) -> torch.Tensor:
    """A sum-tree over `leaves` [cap] (cap a power of two): tree[1] the
    root, node i = node 2i + node 2i+1, leaves at [cap, 2 cap)."""
    cap = leaves.shape[-1]
    tree = torch.zeros((*leaves.shape[:-1], 2 * cap), dtype=torch.float32,
                       device=leaves.device)
    tree[..., cap:] = leaves
    n = cap // 2
    while n >= 1:
        tree[..., n:2 * n] = (tree[..., 2 * n:4 * n:2]
                              + tree[..., 2 * n + 1:4 * n:2])
        n //= 2
    return tree


def stratified_draw(tree: torch.Tensor, noise: torch.Tensor,
                    size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Proportional draw of n = noise.shape[-1] leaves, one from each of
    n equal slices of the total mass (one tree per leading row).
    -> (leaf [.., n] int64, p_leaf / total [.., n])."""
    cap = tree.shape[-1] // 2
    n = noise.shape[-1]
    tot = tree[..., 1:2]
    u = (torch.arange(n, dtype=torch.float32, device=tree.device)
         + noise.float()) / n * tot
    node = torch.ones(noise.shape, dtype=torch.long, device=tree.device)
    while cap > 1:
        left = tree.gather(-1, 2 * node)
        right = u >= left
        u = torch.where(right, u - left, u)
        node = 2 * node + right.long()
        cap //= 2
    leaf = node - tree.shape[-1] // 2
    leaf = torch.clamp(leaf, max=max(size, 1) - 1)
    p = tree.gather(-1, tree.shape[-1] // 2 + leaf) / torch.clamp(tot,
                                                                 min=1e-12)
    return leaf, p


def huber(x: torch.Tensor, delta: float) -> torch.Tensor:
    a = x.abs()
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


class ClippedAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr, b1, b2,
    eps)) over a dict of float32 parameters."""

    def __init__(self, params: dict, lr: float, eps: float,
                 max_norm: float, b1: float = 0.9, b2: float = 0.999):
        self.lr, self.eps, self.max_norm = lr, eps, max_norm
        self.b1, self.b2 = b1, b2
        self.t = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> float:
        """Update `params` in place; -> the gradients' global norm
        before the clip."""
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values())).float()
        clip = torch.where(norm < self.max_norm, torch.ones_like(norm),
                           self.max_norm / norm)
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            g = g * clip
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            update = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                           + self.eps)
            params[k] = (params[k] - self.lr * update).detach()
        return float(norm)


def importance_weights(p: torch.Tensor, n_items: float, beta: float,
                       valid: torch.Tensor) -> torch.Tensor:
    """(N p)^-beta of each draw, 0 on dead slots (not max-normalised)."""
    w = (n_items * torch.clamp(p, min=1e-12)) ** (-beta)
    return w * valid.float()
