"""Device mesh construction.

Counterpart of ``ape_x_dqn_tpu/parallel/mesh.py``. The learner scales
over a (dp, tp) grid of devices with named axes:

- "dp": data parallel — replay shards + batch shards + the gradient
  reduction.
- "tp": tensor parallel — large dense kernels column-split.

As in the original, dp x tp is the whole mesh (an Ape-X system has no
pipeline, sequence or expert parallelism to express), and R2D2
sequences shard across the batch axis, never time.

The port places every shard of a process's dp-sharded learner on ONE
card (parallel/dist_learner.py keeps the shards stacked on a leading
axis): a device list may repeat a card, the counterpart of the original
tests' emulated host devices. Several cards are used through the
multi-host learner (runtime/multihost_driver.py), one rank per card
(the CLI's ``--coordinator/--num-processes/--process-id``): each
process gets a mesh of its own dp rows (dp_local x tp) on its card, and
the cross-process gradient rides NCCL on the device when every rank has
its card to itself, gloo through the host when ranks share one
(parallel/multihost.py). A single-process mesh over more than one
DISTINCT card still raises, as do the tp column split across cards and
the servers' batch split over cards (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import torch


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
    def device(self) -> torch.device:
        """The card every shard lives on."""
        return self.devices[0][0]

    def shards_on(self, device: torch.device) -> int:
        """Replay shards the mesh places on `device`: the dp rows that
        hold it (a shard is replicated over its row's tp devices, and a
        row that repeats a card holds one copy there)."""
        device = torch.device(device)
        return sum(1 for row in self.devices if device in row)


def _visible_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(dp: int | None = None, tp: int = 1,
              devices: list | None = None) -> Mesh:
    """A dp x tp mesh over `devices` (default: the visible cards). The
    list may repeat a device; more than one distinct device raises."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else _visible_devices())
    n = len(devices)
    if dp is None:
        dp = n // tp
    assert 1 <= dp * tp <= n, f"dp({dp}) * tp({tp}) > device count ({n})"
    used = devices[:dp * tp]
    distinct = sorted({str(d) for d in used})
    if len(distinct) > 1:
        raise NotImplementedError(
            f"a mesh over {len(distinct)} distinct devices ({distinct}) "
            f"in one process is not ported to the PyTorch package yet "
            f"(ROADMAP Queue A item 6); pass one card repeated dp*tp "
            f"times, or run one rank per card through the multi-host "
            f"learner (--coordinator/--num-processes/--process-id), "
            f"whose gradient exchange is NCCL")
    return Mesh([used[d * tp:(d + 1) * tp] for d in range(dp)])
