"""Device-side sum-tree (segment tree) for prioritized replay.

Counterpart of ``ape_x_dqn_tpu/ops/sum_tree.py``, in plain PyTorch
tensor code (a hand-written kernel for it is later work).

Layout: 1-indexed implicit binary tree in one ``(2*capacity,)`` float32
tensor. tree[1] is the root (total priority), leaves live at
tree[capacity + i] for i in [0, capacity). Capacity must be a power of
two so the descent depth is fixed.

- `update` writes IN PLACE (the JAX version returns a new array): set
  the leaves, then recompute the parents level by level. Recomputation
  (not delta accumulation) makes duplicate indices in one batch
  harmless for the parents.
- `sample` is a vectorized stratified prefix-sum descent of
  log2(capacity) batched gathers. It reads nothing from the host when
  `size` is a device tensor and `noise` is given, so a captured CUDA
  graph can replay it (runtime/step_graph.py).
"""

from __future__ import annotations

import torch


def init(capacity: int, device: str | torch.device = "cpu"
         ) -> torch.Tensor:
    if not (capacity > 0 and (capacity & (capacity - 1)) == 0):
        raise ValueError("capacity must be a power of two")
    return torch.zeros(2 * capacity, dtype=torch.float32, device=device)


def capacity_of(tree: torch.Tensor) -> int:
    return tree.shape[0] // 2


def update(tree: torch.Tensor, leaf_idx: torch.Tensor,
           priorities: torch.Tensor) -> torch.Tensor:
    """Set priorities at leaf_idx ([B] int) and repair ancestor sums,
    in place. Returns `tree`."""
    cap = capacity_of(tree)
    depth = cap.bit_length() - 1  # log2(cap)
    node = leaf_idx.long() + cap
    tree[node] = priorities.to(torch.float32)
    for _ in range(depth):
        node = node >> 1
        tree[node] = tree[2 * node] + tree[2 * node + 1]
    return tree


def sample(tree: torch.Tensor, batch: int,
           size: int | torch.Tensor | None = None,
           noise: torch.Tensor | None = None,
           generator: torch.Generator | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stratified proportional sampling.

    Returns (leaf_idx [batch] int64, probs [batch] f32) where probs are
    normalized leaf probabilities p_i / total. Sample i draws uniformly
    from the i-th of `batch` equal slices of the total mass.

    `noise` ([batch] uniform in [0, 1)) is the stratification noise; a
    test feeds the JAX package's ``jax.random.uniform(key, (batch,))``
    here. Without it the noise is drawn from `generator`.

    `size` (number of live leaves: a host int, or a 0-dim device
    tensor such as ``ReplayState.size_dev``) clamps the descent's
    landing spot into the filled region, and probs are re-gathered at
    the clamped leaf so IS weights always describe the leaf actually
    returned.
    """
    cap = capacity_of(tree)
    depth = cap.bit_length() - 1
    tot = tree[1]
    if noise is None:
        noise = torch.rand(batch, generator=generator, device=tree.device)
    u = (torch.arange(batch, dtype=torch.float32, device=tree.device)
         + noise.to(torch.float32)) / batch * tot
    idx = torch.ones(batch, dtype=torch.long, device=tree.device)
    for _ in range(depth):
        left = tree[2 * idx]
        go_right = u >= left
        u = torch.where(go_right, u - left, u)
        idx = 2 * idx + go_right.long()
    leaf = idx - cap
    if size is not None:
        size = torch.as_tensor(size, device=tree.device)
        leaf = torch.minimum(leaf, torch.clamp(size, min=1) - 1)
    probs = tree[cap + leaf] / torch.clamp(tot, min=1e-12)
    return leaf, probs
