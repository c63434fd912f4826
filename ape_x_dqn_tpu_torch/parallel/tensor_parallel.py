"""The tp column split across distinct cards.

The original column-splits its large dense kernels over the mesh's "tp"
axis (parallel/sharding.py) and lets GSPMD insert the collectives. Here
a row whose tp entries are distinct devices (parallel/mesh.py) holds
each split layer as pieces, piece t on device t, and computes it
explicitly:

- the layer's input reaches every tp device of the row (one copy per
  device; the row's owner, device 0, keeps it);
- each device computes its output columns from its piece;
- the partial outputs are all-gathered, onto the owner for a dense
  layer, onto every device at each step of an LSTM unroll (the next
  step's recurrent matmul needs the whole h).

Every copy is differentiable (`move`), so the backward runs through
autograd, and each piece's gradient lands on its device: no device ever
holds a whole split kernel. The replicated layers (the convolutions,
the heads) stay whole, on the owner only. `move`'s backward copies the
gradient back on the stream that was current on the source card when
the forward ran: autograd runs a node's backward with only its own
card's stream set, and a plain ``Tensor.to`` across cards there would
order itself after the other card's default stream, which no CUDA
graph's capture holds (CUDA refuses it: cudaErrorStreamCaptureIsolation).

`ColumnSplitLinear` replaces an ``nn.Linear`` (models/qnets.py's
`_dense` calls its `dense`); `ColumnSplitLSTMCell` replaces the
``LSTMCell`` of models/lstm_q.py, whose gates are concatenated, so a
device's piece of each LSTM tensor is four strided blocks, one per gate
(parallel/sharding.py: `piece`). The LSTM keeps its carry in the
compute dtype across the unroll as the whole cell does (the bf16
carry): each device's slice of (c, h) rounds exactly where the whole
cell's would.

`split_module` splits a whole net in place, `param_layout` maps the
split net's parameter list onto the whole net's (checkpoints, Adam's
moments, publication). On a row of one device repeated nothing is
split: the layers stay whole, as before.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ape_x_dqn_tpu_torch.models.lstm_q import LSTMCell, LSTMState
from ape_x_dqn_tpu_torch.parallel.sharding import join, piece, torch_split


class _Move(torch.autograd.Function):
    """x.to(device), differentiable, with the backward's copy on the
    source card's forward-time stream (module docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, device: torch.device):
        ctx.src = x.device
        ctx.stream = (torch.cuda.current_stream(x.device) if x.is_cuda
                      else None)
        return x.to(device)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if ctx.stream is None:
            return grad.to(ctx.src), None
        with torch.cuda.stream(ctx.stream):
            return grad.to(ctx.src), None


def move(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`x` on `device` (itself when it lies there), differentiably."""
    if x.device == device:
        return x
    return _Move.apply(x, device)


def _pieces(x: torch.Tensor, kind: str, devices) -> nn.ParameterList:
    tp = len(devices)
    return nn.ParameterList(
        nn.Parameter(piece(x.detach(), kind, t, tp).to(dev).clone())
        for t, dev in enumerate(devices))


class ColumnSplitLinear(nn.Module):
    """An ``nn.Linear`` with its output features split over `devices`
    (the original's (None, "tp") kernel and ("tp",) bias)."""

    kinds = {"weight": "rows", "bias": "rows"}

    def __init__(self, layer: nn.Linear, devices):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        self.weight = _pieces(layer.weight, "rows", self.devices)
        self.bias = _pieces(layer.bias, "rows", self.devices)

    def dense(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """`_dense` of the whole layer: x [..., in] -> [..., out] in the
        compute dtype, on x's device."""
        xd = x.to(dt)
        ys = [move(F.linear(move(xd, dev), w.to(dt), b.to(dt)), x.device)
              for dev, w, b in zip(self.devices, self.weight, self.bias)]
        return torch.cat(ys, dim=-1)


class ColumnSplitLSTMCell(nn.Module):
    """The LSTM cell with its hidden units split over `devices`: device
    t holds units [t*H/tp, (t+1)*H/tp) of every gate (its rows of
    weight_ih, weight_hh and bias_hh) and that slice of the carry."""

    kinds = {"weight_ih": "gates", "weight_hh": "gates",
             "bias_hh": "gates"}

    def __init__(self, cell: LSTMCell, devices):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        self.hidden = cell.hidden
        self.dtype = cell.dtype
        self.weight_ih = _pieces(cell.weight_ih, "gates", self.devices)
        self.weight_hh = _pieces(cell.weight_hh, "gates", self.devices)
        self.bias_hh = _pieces(cell.bias_hh, "gates", self.devices)

    def unroll(self, feats: torch.Tensor, state: LSTMState
               ) -> tuple[torch.Tensor, LSTMState]:
        """feats [B, T, F] and the float32 carry on the owner -> (h of
        every step [B, T, H] in the compute dtype, the final carry in
        float32), on the owner."""
        dt, owner = self.dtype, feats.device
        b, t = feats.shape[:2]
        w = self.hidden // len(self.devices)
        fd = feats.reshape(b * t, -1).to(dt)
        xps = [F.linear(move(fd, dev), wi.to(dt)).reshape(b, t, -1)
               for dev, wi in zip(self.devices, self.weight_ih)]
        w_hh = [p.to(dt) for p in self.weight_hh]
        b_hh = [p.to(dt) for p in self.bias_hh]
        c0, h0 = (s.to(dt) for s in state)
        cs = [move(c0[:, i * w:(i + 1) * w], dev)
              for i, dev in enumerate(self.devices)]
        hs_full = [move(h0, dev) for dev in self.devices]
        ys = []
        for step in range(t):
            out = [LSTMCell.cell(xps[i][:, step], cs[i], hs_full[i],
                                 w_hh[i], b_hh[i])
                   for i in range(len(self.devices))]
            cs = [o[0] for o in out]
            # all-gather h: every device's next matmul needs all of it
            hs_full = [torch.cat([move(o[1], dev) for o in out], dim=-1)
                       for dev in self.devices]
            ys.append(hs_full[0])
        c = torch.cat([move(ci, owner) for ci in cs], dim=-1)
        return (torch.stack(ys, dim=1),
                (c.float(), move(hs_full[0], owner).float()))


SPLIT_TYPES = (ColumnSplitLinear, ColumnSplitLSTMCell)


def split_module(net: nn.Module, devices, min_dim: int = 256) -> list[str]:
    """Column-split, in place, every layer of `net` (on devices[0])
    whose parameters split over `devices` (parallel/sharding.py:
    `torch_split`): an ``nn.Linear`` becomes a `ColumnSplitLinear`, an
    ``LSTMCell`` a `ColumnSplitLSTMCell`. A split parameter of any other
    layer raises. -> the split layers' names, in order."""
    devices = [torch.device(d) for d in devices]
    tp = len(devices)
    if tp < 2 or len(set(devices)) < 2:
        return []
    wanted = {k for k, v in net.state_dict().items()
              if torch_split(k, tuple(v.shape), tp, min_dim)}
    names = []
    for name, mod in list(net.named_modules()):
        if isinstance(mod, nn.Linear) \
                and f"{name}.weight" in wanted:
            new = ColumnSplitLinear(mod, devices)
        elif isinstance(mod, LSTMCell) and f"{name}.weight_ih" in wanted:
            new = ColumnSplitLSTMCell(mod, devices)
        else:
            continue
        parent, _, last = name.rpartition(".")
        setattr(net.get_submodule(parent) if parent else net, last, new)
        names.append(name)
        wanted -= {f"{name}.{k}" for k in new.kinds}
    if wanted:
        raise NotImplementedError(
            f"the tp split across cards splits dense layers and the "
            f"LSTM; {sorted(wanted)} would split too (raise min_dim)")
    return names


def param_layout(net: nn.Module) -> list[tuple[str, str | None, list[int]]]:
    """The whole net's parameters, in its order, as (state_dict key,
    split kind or None, indices into ``list(net.parameters())`` of its
    pieces, or of itself)."""
    index = {id(p): i for i, p in enumerate(net.parameters())}
    out = []
    for name, mod in net.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, SPLIT_TYPES):
            for key, kind in mod.kinds.items():
                out.append((prefix + key, kind,
                            [index[id(p)] for p in getattr(mod, key)]))
        elif not isinstance(mod, nn.ParameterList):
            for key, p in mod.named_parameters(recurse=False):
                out.append((prefix + key, None, [index[id(p)]]))
    return out


def whole_tensors(net: nn.Module, tensors: list[torch.Tensor],
                  device=None) -> dict[str, torch.Tensor]:
    """Tensors aligned with ``net.parameters()`` (the params, their
    gradients, Adam's moments) -> {whole key: whole tensor}, pieces
    joined (on `device`, default the owner)."""
    out = {}
    for key, kind, idx in param_layout(net):
        v = (join([tensors[i] for i in idx], kind) if kind is not None
             else tensors[idx[0]])
        out[key] = v if device is None else v.to(device)
    return out


@torch.no_grad()
def load_whole(net: nn.Module, tensors: list[torch.Tensor],
               whole: dict[str, torch.Tensor]) -> None:
    """Copy whole tensors ({whole key: tensor}) into `tensors` (aligned
    with ``net.parameters()``) IN PLACE, piece by piece."""
    layout = param_layout(net)
    missing = {k for k, _, _ in layout} ^ set(whole)
    if missing:
        raise KeyError(f"whole params do not match the net: "
                       f"{sorted(missing)}")
    for key, kind, idx in layout:
        v = whole[key]
        if kind is None:
            tensors[idx[0]].copy_(v)
            continue
        for t, i in enumerate(idx):
            tensors[i].copy_(piece(v.to(tensors[i].device), kind, t,
                                   len(idx)))
