"""Per-preset device-memory budgeting with an early, loud fits-check.

Counterpart of ``ape_x_dqn_tpu/utils/hbm.py``: `replay_budget` prices a
RunConfig's replay storage the way the card will hold it (byte-row
packed pixel leaves, replay/packing.py), `run_budget` adds the model
and optimizer state and the transient headroom, and `check_hbm_fits`
raises before any device allocation when the preset cannot fit its
card. The replay and model-state prices are the original's, byte for
byte (tests/test_torch_hbm.py); the headroom and the card's size are
the port's own:

- `device_hbm_bytes` is ``torch.cuda.get_device_properties(d)
  .total_memory`` on a card, and None on the CPU (no budget to
  enforce there).
- `TRANSIENT_HEADROOM` covers what the run allocates beyond the replay
  and the model state: gradients, the captured graphs' private pools
  (activations of a whole K-batch macro-step, the add graphs' static
  inputs), the inference server's param copy and buckets, and the
  pinned publication copies. The original's 2 GB was measured on a
  TPU v5e and does not carry over; this one was measured on an NVIDIA
  H100 80GB HBM3 at a 700 W limit by ``chip_smoke.py``, which prints
  each phase's measured peak (``torch.cuda.max_memory_allocated``)
  beside the budget (PERF.md §6).
- `serving_transient_bytes` prices the serving tier's coalesced forward
  (``serving.multi_tenant`` with ``serving.coalesce``) on its own: it
  gathers one tenant's float32 params per batch row, largest bucket x
  params for the one family registered, up to 1.66 GB for an LSTM
  Q-net of 6.5M params at bucket 64, which the headroom was not
  measured with.
- `card_budget` prices one card of the dp-sharded learner's mesh at the
  replay shards the mesh puts there: the original prices a device at
  one shard, while the port's one-card meshes hold all dp shards.
  `mesh_budgets` prices every card of a one-process mesh over several
  cards: the shards it owns, the parameter pieces it holds, NCCL's
  part on the owners, and with the cold tier each owner's swap buffers
  (`swap_bytes`: the evict graph's outputs and the add_at graph's
  static inputs, per shard it owns); `check_mesh_fits` raises naming
  the card that does not fit. A multi-host rank that holds several
  cards prices its cards the same way, with the processes that share
  each card and the cross-rank communicator's part on its first
  owner.
- `check_hbm_fits(processes_per_card=n)`: the multi-host learner's
  processes may share a card (two ranks on one card); each process's
  budget counts n times against it, or two processes that each fit
  could run out of memory together. The multi-host driver counts the
  processes on its card once, at construction
  (parallel/multihost.py: `processes_on_device`).
- `check_hbm_fits(nccl=True)`: the multi-host learner's NCCL exchange
  (every rank alone on its card) makes NCCL's communicator on the card,
  and NCCL allocates its buffers, and loads its kernels, outside
  PyTorch's caching allocator, so no measured peak
  (``torch.cuda.max_memory_allocated``) and no allocator headroom sees
  them. `NCCL_DEVICE_BYTES` counts them as a part of their own. Measured
  by ``chip_smoke.py`` on NVIDIA H100 80GB HBM3 cards at a 700 W limit
  (PERF.md §6): a world of one took 591,396,864 B of the
  card outside the allocator across the communicator's creation and the
  first full-size all-gather, about a quarter of the 2 GiB
  `TRANSIENT_HEADROOM`, while r2d2's rank peaked at 40.03 GB allocated
  (42.15 GB reserved) against a 40.95 GB budget that had not counted
  them: they would have eaten into the headroom. A group over several
  cards holds a set of buffers per peer and channel on top of that:
  with two ranks on two H100s over NVLink, rank 0's NCCL took
  922,746,880 B across the communicator, one eager and one captured
  15.15 MB all-gather (``nccl_probe``, which fails when a rank exceeds
  the part). More peers were not measured, so the
  part is a floor for groups of more than two (the table says so).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ape_x_dqn_tpu_torch.replay.frame_ring import frame_ring_mode
from ape_x_dqn_tpu_torch.replay.packing import (ItemSpec, packable, pad128,
                                                torch_dtype)
from ape_x_dqn_tpu_torch.replay.sequence import sequence_frame_mode
from ape_x_dqn_tpu_torch.utils.misc import next_pow2


def _leaf_stored_bytes(shape: tuple[int, ...], dtype) -> int:
    """Bytes one stored leaf actually occupies: pad128 byte rows when
    the leaf is packed (the SAME packing.packable predicate the replay
    storage uses — the budget must not drift from the layout), raw
    bytes otherwise."""
    n = math.prod(shape) * np.dtype(dtype).itemsize
    if packable(ItemSpec(tuple(shape), torch_dtype(dtype))):
        return pad128(n)
    return n


# bytes reserved for what the run allocates beyond the replay and the
# model state (module docstring): the largest transient chip_smoke.py
# measured on the card was r2d2's 1.32 GiB (NVIDIA H100 80GB HBM3,
# 700 W; pong's driver 0.98, pong-sp 0.80, apex_dpg 0.48), with a
# margin
TRANSIENT_HEADROOM = 2 << 30  # 2.0 GiB
# NCCL's communicator, buffers and kernels on the card, outside the
# caching allocator (module docstring): 591,396,864 B measured for a
# world of one, 922,746,880 B for a rank of two on two cards, with a
# margin; a floor for groups of more than two
NCCL_DEVICE_BYTES = 1 << 30  # 1.0 GiB


@dataclass(frozen=True)
class HbmBudget:
    """All sizes in bytes, PER DEVICE (dp-sharded replay counts one
    shard; replicated model state counts fully)."""
    replay_storage: int
    replay_tree: int
    model_state: int
    headroom: int
    capacity: int          # effective per-device item capacity (pow2)
    detail: dict
    serving_transient: int = 0
    nccl: int = 0          # outside the allocator (NCCL_DEVICE_BYTES)
    swap: int = 0          # the cold tier's swap buffers (`swap_bytes`)

    @property
    def total(self) -> int:
        return (self.replay_storage + self.replay_tree
                + self.model_state + self.headroom
                + self.serving_transient + self.nccl + self.swap)

    def table(self) -> str:
        gib = 1024 ** 3
        rows = [("replay storage", self.replay_storage),
                ("sum-tree", self.replay_tree),
                ("model+opt state", self.model_state),
                ("transient headroom", self.headroom),
                ("serving gather", self.serving_transient),
                ("NCCL buffers", self.nccl),
                ("cold swap buffers", self.swap),
                ("TOTAL per device", self.total)]
        body = "\n".join(f"  {k:<20} {v / gib:8.2f} GiB" for k, v in rows)
        extra = ", ".join(f"{k}={v}" for k, v in self.detail.items())
        if self.nccl:
            extra += (", NCCL buffers: measured for up to two ranks, a "
                      "floor for more")
        return f"{body}\n  ({extra})"


def _frame_ring_bytes(capacity: int, seg_transitions: int, n_step: int,
                      obs_shape: tuple[int, ...]) -> tuple[int, dict]:
    h, w, stack = obs_shape
    f = seg_transitions + n_step + stack - 1
    s = capacity // seg_transitions
    frames = s * f * pad128(h * w)
    fields = capacity * 4 * 4  # action/reward/discount/next_off, 4B each
    return frames + fields, {"layout": "frame_ring", "frame_rows": s * f,
                             "frame_row_bytes": pad128(h * w)}


def _flat_bytes(capacity: int, obs_shape: tuple[int, ...],
                obs_dtype) -> tuple[int, dict]:
    obs = _leaf_stored_bytes(obs_shape, obs_dtype)
    per_item = 2 * obs + 3 * 4  # obs + next_obs + action/reward/discount
    return capacity * per_item, {"layout": "flat", "item_bytes": per_item}


def _sequence_bytes(capacity: int, seq_len: int, obs_shape: tuple[int, ...],
                    obs_dtype, lstm_size: int,
                    frame_mode: bool) -> tuple[int, dict]:
    if frame_mode:
        h, w, stack = obs_shape
        obs = _leaf_stored_bytes((seq_len + stack - 1, h, w), obs_dtype)
    else:
        obs = _leaf_stored_bytes((seq_len, *obs_shape), obs_dtype)
    per_item = obs + seq_len * 4 * 4 + 2 * lstm_size * 4
    return capacity * per_item, {"layout": "sequence",
                                 "seq_item_bytes": per_item,
                                 "frame_mode": frame_mode}


def replay_budget(cfg: Any, obs_shape: tuple[int, ...],
                  obs_dtype=np.uint8) -> tuple[int, int, int, dict]:
    """-> (storage_bytes, tree_bytes, per_device_capacity, detail) for
    cfg (a RunConfig), per device after dp sharding, capacity rounded to
    the pow2 the drivers actually allocate."""
    r = cfg.replay
    dp = max(getattr(cfg.parallel, "dp", 1), 1)
    cap = next_pow2(max(r.capacity // dp, 2)) if dp > 1 \
        else next_pow2(r.capacity)
    if r.kind == "sequence":
        storage, detail = _sequence_bytes(
            cap, r.seq_length, obs_shape, obs_dtype,
            lstm_size=getattr(cfg.network, "lstm_size", 512),
            # the SHARED predicate (replay/sequence.py) — pricing must
            # follow the layout runtime/family.py actually selects
            frame_mode=sequence_frame_mode(r.storage, obs_shape))
    elif frame_ring_mode(r.storage, obs_shape):
        storage, detail = _frame_ring_bytes(
            cap, r.seg_transitions, cfg.learner.n_step, obs_shape)
    else:
        storage, detail = _flat_bytes(cap, obs_shape, obs_dtype)
    tree = 2 * cap * 4 if r.kind != "uniform" else 4
    detail["dp"] = dp
    return storage, tree, cap, detail


def model_state_bytes(param_count: int, adam: bool = True) -> int:
    """params + target copy (+2 adam moments), all f32."""
    per = 4 * (2 + (2 if adam else 0))
    return param_count * per


def serving_transient_bytes(cfg: Any, param_count: int) -> int:
    """The serving tier's coalesced forward gathers one tenant's params
    per row of the padded batch (float32): the largest bucket (the
    next power of two of max_batch, or of a vector actor's larger
    request) x params, for the one family a driver or actor host
    registers. 0 without the tier or coalescing."""
    serving = getattr(cfg, "serving", None)
    if serving is None or not (serving.multi_tenant and serving.coalesce):
        return 0
    bucket = next_pow2(max(cfg.inference.max_batch,
                           cfg.actors.envs_per_actor, 1))
    return bucket * param_count * 4


def run_budget(cfg: Any, obs_shape: tuple[int, ...], obs_dtype=np.uint8,
               param_count: int = 5_000_000) -> HbmBudget:
    """Budget a RunConfig per device. `param_count` defaults to a
    generous flagship-CNN-class estimate when the caller has not built
    the network yet (Nature-CNN ~1.7M, LSTM-Q ~6.5M params)."""
    storage, tree, cap, detail = replay_budget(cfg, obs_shape, obs_dtype)
    return HbmBudget(replay_storage=storage, replay_tree=tree,
                     model_state=model_state_bytes(param_count),
                     headroom=TRANSIENT_HEADROOM, capacity=cap,
                     detail=detail,
                     serving_transient=serving_transient_bytes(
                         cfg, param_count))


def device_hbm_bytes(device=None) -> int | None:
    """Device memory of the card `device` (default: the current one),
    from its properties; None without a card or for a CPU device (no
    budget to enforce there)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return None
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(
        device if device is not None else torch.cuda.current_device())
        .total_memory)


def card_budget(budget: HbmBudget, shards_per_card: int) -> HbmBudget:
    """The budget of one card that holds `shards_per_card` replay
    shards: the dp-sharded learner's mesh may put several (all of them,
    on a mesh of one card repeated) on a card, and each shard's storage
    and sum-tree count there; the model state is whole on every card."""
    if shards_per_card == 1:
        return budget
    return dataclasses.replace(
        budget, replay_storage=budget.replay_storage * shards_per_card,
        replay_tree=budget.replay_tree * shards_per_card,
        capacity=budget.capacity * shards_per_card,
        detail=dict(budget.detail, shards_per_card=shards_per_card))


def check_hbm_fits(cfg: Any, obs_shape: tuple[int, ...], obs_dtype=np.uint8,
                   param_count: int = 5_000_000, device=None,
                   hbm_bytes: int | None = None,
                   shards_per_card: int = 1,
                   processes_per_card: int = 1,
                   nccl: bool = False) -> HbmBudget:
    """Raise ValueError (loudly, with the budget table and the fix)
    when the config's footprint on one card (with `shards_per_card` of
    its replay shards, `card_budget`, times the `processes_per_card`
    that each hold such a share, plus NCCL's buffers when the process
    exchanges over `nccl`) exceeds the card's memory. Returns this
    process's budget either way on success; returns without a check
    when there is no card to budget (`device_hbm_bytes` None)."""
    budget = card_budget(run_budget(cfg, obs_shape, obs_dtype, param_count),
                         shards_per_card)
    if nccl:
        budget = dataclasses.replace(budget, nccl=NCCL_DEVICE_BYTES)
    limit = hbm_bytes if hbm_bytes is not None else device_hbm_bytes(device)
    if limit is None:
        return budget
    if budget.total * processes_per_card > limit:
        gib = 1024 ** 3
        shared = (f" x {processes_per_card} processes on the card"
                  if processes_per_card > 1 else "")
        raise ValueError(
            f"config {getattr(cfg, 'name', '?')!r} needs "
            f"{budget.total / gib:.2f} GiB per device{shared} but the "
            f"device has "
            f"{limit / gib:.2f} GiB of memory.\n{budget.table()}\n"
            f"Fix: lower replay.capacity (per-device items: "
            f"{budget.capacity}), raise parallel.dp to shard the replay "
            f"wider, or switch replay.storage='frame_ring' for pixel "
            f"configs.")
    return budget


def swap_bytes(item_spec: dict, block: int,
               ptail: int | None = None) -> int:
    """The cold tier's swap buffers for one replay shard: the evict
    graph's outputs (the start, `block` staging units of `item_spec` in
    staging layout, their leaf priorities) and the add_at graph's static
    inputs (the same again), which stay allocated on the shard's card.
    `ptail`: the priorities' trailing length (a frame ring's segment),
    None for one priority a unit."""
    unit = sum(math.prod(s.shape)
               * torch.empty(0, dtype=s.dtype).element_size()
               for s in item_spec.values())
    pri = 4 * (ptail or 1)
    return 2 * (block * (unit + pri) + 8)


def mesh_budgets(cfg: Any, obs_shape: tuple[int, ...], obs_dtype,
                 param_shapes: dict[str, tuple[int, ...]], mesh,
                 min_dim: int = 256, swap_per_shard: int = 0,
                 processes_per_card: int = 1,
                 cross_nccl: bool = False) -> dict:
    """The budget of every distinct card of a one-process mesh over
    several cards (parallel/cards.py), {card: HbmBudget}: the replay
    shards it owns (one copy per shard, on its row's owner), the
    parameters it holds with their target and Adam moments (a card
    group's replicated params and piece 0 of each split one on the
    owner, piece t on tp partner t: parallel/sharding.py), the
    headroom (the inference server's replica of the whole params rides
    in it, as on one card), NCCL's part on the owners when more than
    one exchange over NCCL, and `swap_per_shard` (`swap_bytes` above)
    for each shard an owner holds. `param_shapes`: the whole net's
    ``{state_dict key: shape}``. For a multi-host rank over several
    cards: `cross_nccl` adds the cross-rank communicator's part on the
    first owner, and `processes_per_card` (the most ranks on one of
    its cards) multiplies each card's total in `check_mesh_fits`."""
    from ape_x_dqn_tpu_torch.parallel.sharding import torch_split

    base = run_budget(cfg, obs_shape, obs_dtype,
                      sum(math.prod(s) for s in param_shapes.values()))
    held: dict = {d: 0 for d in mesh.cards}
    groups = mesh.groups
    for g in groups:
        tp = len(g.tp_devices) if g.split else 1
        for key, shape in param_shapes.items():
            n = math.prod(shape)
            if torch_split(key, tuple(shape), tp, min_dim) is None:
                held[g.owner] += n
            else:
                for dev in g.tp_devices:
                    held[dev] += n // tp
    cuda = mesh.device.type == "cuda"
    nccl = NCCL_DEVICE_BYTES if (len(groups) > 1 and cuda) else 0
    owners = {g.owner for g in groups}
    out = {}
    for dev in mesh.cards:
        shards = mesh.shards_on(dev)
        part = nccl if dev in owners else 0
        if cross_nccl and cuda and dev == mesh.device:
            part += NCCL_DEVICE_BYTES
        detail = dict(base.detail, shards_on_card=shards,
                      params_on_card=held[dev])
        if processes_per_card > 1:
            detail["processes_per_card"] = processes_per_card
        b = dataclasses.replace(
            base, replay_storage=base.replay_storage * shards,
            replay_tree=base.replay_tree * shards,
            capacity=base.capacity * shards,
            model_state=model_state_bytes(held[dev]),
            nccl=part, swap=swap_per_shard * shards, detail=detail)
        out[dev] = b
    return out


def check_mesh_fits(cfg: Any, obs_shape: tuple[int, ...], obs_dtype,
                    param_shapes: dict[str, tuple[int, ...]], mesh,
                    min_dim: int = 256, hbm_bytes: int | None = None,
                    swap_per_shard: int = 0, processes_per_card: int = 1,
                    cross_nccl: bool = False) -> dict:
    """`check_hbm_fits` for every card of a one-process mesh over
    several cards, or of a multi-host rank's (`mesh_budgets`), before
    anything is allocated: raises ValueError naming the first card that
    does not fit. -> {card: budget}."""
    budgets = mesh_budgets(cfg, obs_shape, obs_dtype, param_shapes, mesh,
                           min_dim, swap_per_shard=swap_per_shard,
                           processes_per_card=processes_per_card,
                           cross_nccl=cross_nccl)
    gib = 1024 ** 3
    for dev, b in budgets.items():
        limit = hbm_bytes if hbm_bytes is not None else device_hbm_bytes(dev)
        if limit is not None and b.total * processes_per_card > limit:
            shared = (f" x {processes_per_card} processes"
                      if processes_per_card > 1 else "")
            raise ValueError(
                f"config {getattr(cfg, 'name', '?')!r} needs "
                f"{b.total / gib:.2f} GiB{shared} on card {dev} of the mesh "
                f"({b.detail['shards_on_card']} replay shards) but the "
                f"card has {limit / gib:.2f} GiB of memory.\n{b.table()}\n"
                f"Fix: lower replay.capacity, or spread the rows over "
                f"more cards (parallel.dp, the device list).")
    return budgets
