"""Device mesh construction and placements.

Counterpart of ``ape_x_dqn_tpu/parallel/mesh.py``. The learner scales
over a (dp, tp) grid of devices with named axes:

- "dp": data parallel — replay shards + batch shards + the gradient
  reduction.
- "tp": tensor parallel — large dense kernels column-split.

As in the original, dp x tp is the whole mesh (an Ape-X system has no
pipeline, sequence or expert parallelism to express), and R2D2
sequences shard across the batch axis, never time.

A mesh is a device list, cut into dp rows of tp entries
(`devices[d][t]`); the list may repeat a device. Terms:

- row: one dp index, `devices[d]`;
- owner: the device of a row's first entry;
- card group: the rows that share an owner (`Mesh.groups`).

[c0, c1, c2, c3] * 2 at dp=4, tp=2 gives rows (c0, c1), (c2, c3),
(c0, c1), (c2, c3): c0 owns rows 0 and 2, c1 holds their tp partners.

Where a replay shard lives. GSPMD replicates a shard over its row's tp
devices; the port keeps ONE copy, on the row's owner: it computes the
same numbers at 1/tp of the replay memory and of the ingest copies
(utils/hbm.py budgets each card so). A mesh of one device repeated
(``["cpu"] * 8``, ``[card] * 8``) therefore holds every shard stacked
on that device, one card group, as before (parallel/dist_learner.py);
a mesh over several distinct devices holds one stacked group per owner
(parallel/cards.py), and a row whose tp entries are distinct devices
column-splits its dense layers across them (parallel/tensor_parallel.py).
On the CPU, ``cpu:0 .. cpu:3`` are distinct device objects whose
tensors all land on ``cpu``: a mesh over them runs the per-card code
without a card.

The placements are the original's `replicated` (one copy on every
distinct device of the mesh) and `batch_sharding` (dim 0 split over the
mesh positions, the flattened (dp, tp) grid, as the inference servers
split a batch; the rows of one device grouped).

Across processes (the multi-host learner, runtime/multihost_driver.py)
each process holds its own dp rows on its one card; a rank whose mesh
covers several cards is not ported (ROADMAP Queue A item 6).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CardGroup:
    """The rows one owner holds, and their tp devices (the same for
    every row of the group; entry 0 is the owner)."""

    owner: torch.device
    rows: tuple[int, ...]
    tp_devices: tuple[torch.device, ...]

    @property
    def split(self) -> bool:
        """Whether the rows' tp entries are distinct devices, so the
        dense layers split across them."""
        return len(set(self.tp_devices)) > 1


class Mesh:
    """A dp x tp grid of `torch.device`s (`devices[d][t]`)."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: list[list[torch.device]]):
        self.devices = devices
        self.dp = len(devices)
        self.tp = len(devices[0])

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def flat(self) -> list[torch.device]:
        """The mesh positions in order (d * tp + t)."""
        return [dev for row in self.devices for dev in row]

    @property
    def cards(self) -> list[torch.device]:
        """The distinct devices, in order of first appearance."""
        return list(dict.fromkeys(self.flat))

    @property
    def distinct(self) -> bool:
        """Whether the mesh spans more than one device."""
        return len(self.cards) > 1

    @property
    def device(self) -> torch.device:
        """The first device: the owner of row 0 (every shard's card on a
        mesh of one device)."""
        return self.devices[0][0]

    @property
    def groups(self) -> list[CardGroup]:
        """The card groups in order of their first row."""
        owners = list(dict.fromkeys(row[0] for row in self.devices))
        out = []
        for owner in owners:
            rows = tuple(d for d, row in enumerate(self.devices)
                         if row[0] == owner)
            tps = {tuple(self.devices[d]) for d in rows}
            if len(tps) != 1:
                raise NotImplementedError(
                    f"rows {rows} share the owner {owner} but not their "
                    f"tp devices {sorted(map(str, tps))}: one card group "
                    f"keeps one set of tp partners")
            out.append(CardGroup(owner, rows, tps.pop()))
        return out

    def shards_on(self, device: torch.device) -> int:
        """Replay shards the mesh places on `device`: the rows it owns
        (module docstring; every row on a mesh of one device)."""
        device = torch.device(device)
        return sum(1 for row in self.devices if row[0] == device)

    def positions_on(self, device: torch.device) -> list[int]:
        """The mesh positions on `device`, in order."""
        device = torch.device(device)
        return [p for p, dev in enumerate(self.flat) if dev == device]


def _visible_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(dp: int | None = None, tp: int = 1,
              devices: list | None = None) -> Mesh:
    """A dp x tp mesh over `devices` (default: the visible cards), in
    order; the list may repeat a device. Devices of two types raise."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else _visible_devices())
    n = len(devices)
    if dp is None:
        dp = n // tp
    assert 1 <= dp * tp <= n, f"dp({dp}) * tp({tp}) > device count ({n})"
    used = devices[:dp * tp]
    types = sorted({d.type for d in used})
    if len(types) > 1:
        raise ValueError(f"a mesh holds devices of one type, got {types} "
                         f"({[str(d) for d in used]})")
    return Mesh([used[d * tp:(d + 1) * tp] for d in range(dp)])


class Replicated:
    """`replicated(mesh)`: one copy of a tensor, or of a dict of them,
    on every distinct device of the mesh."""

    def __init__(self, mesh: Mesh):
        self.cards = mesh.cards

    def put(self, x):
        """-> {device: copy} (`x` itself where it already lies; a leaf
        that is not a tensor stays as it is)."""
        def to(v, dev):
            return v.to(dev) if isinstance(v, torch.Tensor) else v

        def one(dev):
            if isinstance(x, dict):
                return {k: to(v, dev) for k, v in x.items()}
            return to(x, dev)

        return {dev: one(dev) for dev in self.cards}


class BatchSplit:
    """`batch_sharding(mesh)`: dim 0 of a batch whose length is a
    multiple of the mesh size, split into mesh.size equal parts, part p
    on mesh position p's device; a device's parts are grouped in
    position order."""

    def __init__(self, mesh: Mesh):
        self.size = mesh.size
        self.cards = mesh.cards
        self._positions = {dev: mesh.positions_on(dev) for dev in self.cards}

    def rows(self, n: int) -> dict[torch.device, torch.Tensor]:
        """{device: the batch rows it holds} (int64 on the host)."""
        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.size} mesh positions")
        part = n // self.size
        return {dev: torch.cat([torch.arange(p * part, (p + 1) * part)
                                for p in pos])
                for dev, pos in self._positions.items()}

    def split(self, x: torch.Tensor) -> dict[torch.device, torch.Tensor]:
        """-> {device: its rows of x, on it}."""
        return {dev: x.index_select(0, idx.to(x.device)).to(dev)
                for dev, idx in self.rows(x.shape[0]).items()}

    def gather(self, parts: dict, n: int) -> torch.Tensor:
        """The inverse of `split`, on the host."""
        rows = self.rows(n)
        first = next(iter(parts.values()))
        out = torch.empty((n, *first.shape[1:]), dtype=first.dtype)
        for dev, v in parts.items():
            out[rows[dev]] = v.cpu()
        return out


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def batch_sharding(mesh: Mesh) -> BatchSplit:
    return BatchSplit(mesh)
