"""The dp-sharded learner over distinct cards, in one process.

The original runs its multi-chip presets in ONE process over every
device it sees (``ape_x_dqn_tpu/runtime/driver.py`` builds the mesh over
``jax.devices()``): GSPMD places each replay shard on its mesh row,
column-splits the dense kernels over "tp" and inserts the gradient
reduction. Here a mesh over several distinct devices (parallel/mesh.py)
becomes one `CardsLearner` over its card groups (the rows that share an
owner):

- each group is a dp-sharded learner of its own (parallel/
  dist_learner.py) on its owner, its rows' replay shards stacked
  [dp_c, ...] there, as one card holds all of them on a mesh of one
  card: one descent and one gather-kernel launch per group and draw;
- its net is a replica of the whole net, column-split across the rows'
  tp devices when they are distinct cards (parallel/tensor_parallel.py),
  whole otherwise; every group applies the same update to its replica;
- each group runs the exchanged step bodies of the multi-host learner
  with its own IS max M_c, and `CardExchange`, the in-process exchange,
  all-gathers the groups' packed vectors; every group then sums them
  in group order, as the multi-host learner sums in rank order, so the
  arithmetic is that learner's with groups for processes;
- the noise is the full [dp, n] draw of the one generator, made on the
  first card and sliced per group (as `process_rows` slices it per
  rank), so the draws are the stacked learner's;
- ingest (`land_add`, `add_landed`, `add`) splits each
  [.., dp, chunk] block by rows and adds per group.

The exchange. On the card it is one ``torch.cuda.nccl.all_gather`` over
one tensor and one stream per owner (torch's binding of NCCL, made with
one small call in the constructor, before any capture); on the CPU,
plain copies. There is no fallback: a build without NCCL, or a first
call that fails, raises.

Streams. Every endpoint enters from the caller's current stream on the
first card: each other card's work runs on a stream of its own (one
per card and calling stream, so the learner's and ingest's threads
keep apart), which waits for the caller's stream first, and the
caller's stream waits for all of them at the end, so whatever the
caller orders on its stream (runtime/driver.py's events) covers every
card.

Graphs. On the card every train endpoint replays captured graphs
(runtime/step_graph.py: `CardsStep`): each group's stretches between
two exchanges are graphs of their own, with the exchange between them;
a group split across tp partner cards captures each stretch as one
graph over its cards. `step_graphs` report how many graphs a call
replays. The ingest add replays one add graph per group.

Checkpoints are independent of the layout (`CardsTrainState.tree`): the
params, the target and Adam's moments are saved whole (the pieces
joined), the replay stacked [dp, ...] in row order, exactly as the
stacked learner saves them; a restore copies them into the pieces in
place (the graphs hold the addresses).

The cold tier and legacy staging over distinct cards are not ported
(ROADMAP Queue A item 6): the driver raises for them.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from ape_x_dqn_tpu_torch.parallel.mesh import CardGroup, Mesh
from ape_x_dqn_tpu_torch.parallel.sharding import make_param_shardings
from ape_x_dqn_tpu_torch.parallel.tensor_parallel import (load_whole,
                                                          param_layout,
                                                          split_module,
                                                          whole_tensors)
from ape_x_dqn_tpu_torch.runtime.learner import SingleChipLearner
from ape_x_dqn_tpu_torch.runtime.step_graph import CardsStep, drive_cards


class CardExchange:
    """The per-SGD-step exchange among a mesh's card groups: the
    groups' packed float32 vectors `sends` ([L] each, on their owners)
    -> one [ngroups, L] result per group, on its owner, in group order
    (written into `outs` when given). `GradExchange`'s interface
    (parallel/multihost.py) for a call that takes every group's vector
    at once: `nproc` (the groups), `count`, `stats`, `capturable`
    (False: the call runs between graphs, runtime/step_graph.py:
    `CardsStep`)."""

    capturable = False

    def __init__(self, devices: list[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        self.nproc = len(self.devices)
        cuda = self.devices[0].type == "cuda"
        self.mode = "nccl" if cuda and self.nproc > 1 else "copy"
        self.reset()
        if self.mode == "nccl":
            self._make_communicator()

    def _make_communicator(self) -> None:
        from torch.cuda import nccl

        xs = [torch.zeros(1, device=d) for d in self.devices]
        if not hasattr(torch._C, "_nccl_all_gather") \
                or not nccl.is_available(xs):
            raise RuntimeError(
                f"the exchange over {[str(d) for d in self.devices]} "
                f"needs NCCL, which this torch build lacks; not falling "
                f"back to host copies")
        outs = [torch.empty(self.nproc, device=d) for d in self.devices]
        try:
            nccl.all_gather(xs, outs)
            for d in self.devices:
                torch.cuda.synchronize(d)
        except RuntimeError as e:
            raise RuntimeError(f"NCCL's first all-gather over "
                               f"{[str(d) for d in self.devices]} failed: "
                               f"{e}; not falling back to host copies"
                               ) from e

    def __call__(self, sends: list[torch.Tensor],
                 outs: list[torch.Tensor] | None = None
                 ) -> list[torch.Tensor]:
        n = sends[0].numel()
        if outs is None:
            outs = [torch.empty((self.nproc, n), dtype=torch.float32,
                                device=s.device) for s in sends]
        if self.mode == "nccl":
            from torch.cuda import nccl

            nccl.all_gather(
                sends, [o.view(-1) for o in outs],
                streams=[torch.cuda.current_stream(s.device)
                         for s in sends])
        else:
            for out in outs:
                for i, s in enumerate(sends):
                    out[i].copy_(s)
        self.count([n])
        return outs

    def count(self, sizes: list[int]) -> None:
        for n in sizes:
            self.calls += 1
            self.bytes_sent += n * 4
            self.bytes_received += self.nproc * n * 4

    def reset(self) -> None:
        self.calls = self.bytes_sent = self.bytes_received = 0

    def stats(self) -> dict:
        return {"calls": self.calls, "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received,
                "groups": self.nproc, "backend": self.mode,
                "per": "group and call: bytes_sent is one group's vector, "
                       "bytes_received the [groups, L] it gets back"}


@dataclass
class CardsTrainState:
    """The card groups' `DistTrainState`s, in group order, and the one
    generator whose [dp, n] draws they share."""

    groups: list
    rows: list[tuple[int, ...]]
    generator: torch.Generator
    step: int
    cards: list[torch.device]

    @contextlib.contextmanager
    def _ordered(self):
        """Every other card's current stream after the first card's (the
        caller orders its stream on the first card after the learner's
        and ingest's), and the first card's after theirs at the end."""
        first, rest = self.cards[0], self.cards[1:]
        if first.type != "cuda":
            yield
            return
        for d in rest:
            torch.cuda.current_stream(d).wait_stream(
                torch.cuda.current_stream(first))
        yield
        for d in rest:
            torch.cuda.current_stream(first).wait_stream(
                torch.cuda.current_stream(d))

    @property
    def dp(self) -> int:
        return sum(len(r) for r in self.rows)

    def tree(self, with_replay: bool = False) -> dict:
        """`runtime/learner.py: checkpoint_tree` of the stacked learner,
        from the groups: whole params (group 0's pieces joined, on its
        owner), the replay stacked [dp, ...] in row order on the host."""
        with self._ordered():
            return self._tree(with_replay)

    def _tree(self, with_replay: bool) -> dict:
        g0 = self.groups[0]
        opt = g0.opt_state

        def whole(net) -> dict:
            return {k: v.detach() for k, v in whole_tensors(
                net, list(net.parameters())).items()}

        tree = {
            "params": whole(g0.net),
            "target_params": whole(g0.target_net),
            "opt_state": {
                "count": opt.count,
                "mu": list(whole_tensors(g0.net, opt.mu).values()),
                "nu": list(whole_tensors(g0.net, opt.nu).values())},
            "rng": self.generator.get_state(), "step": int(self.step)}
        if with_replay:
            tree["replay"] = self._stacked_replay()
        return tree

    def _stacked_replay(self) -> dict:
        dp = self.dp
        first = self.groups[0].replay

        def stacked(get):
            like = get(first)
            out = torch.empty((dp, *like.shape[1:]), dtype=like.dtype)
            for st, rows in zip(self.groups, self.rows):
                out[list(rows)] = get(st.replay).cpu()
            return out

        pos = np.zeros(dp, np.int64)
        size = np.zeros(dp, np.int64)
        for st, rows in zip(self.groups, self.rows):
            pos[list(rows)] = st.replay.pos
            size[list(rows)] = st.replay.size
        return {"storage": {k: stacked(lambda r, k=k: r.storage[k])
                            for k in first.storage},
                "tree": stacked(lambda r: r.tree),
                "pos": pos.tolist(), "size": size.tolist()}

    @torch.no_grad()
    def restore(self, tree: dict) -> None:
        """Write a `tree` payload (of any layout) back IN PLACE, piece
        by piece, as `restore_checkpoint_tree` does."""
        with self._ordered():
            self._restore(tree)

    def _restore(self, tree: dict) -> None:
        for st, rows in zip(self.groups, self.rows):
            for net, key in ((st.net, "params"),
                             (st.target_net, "target_params")):
                load_whole(net, list(net.parameters()), tree[key])
            keys = [k for k, _, _ in param_layout(st.net)]
            saved = tree["opt_state"]
            st.opt_state.count.copy_(saved["count"])
            load_whole(st.net, st.opt_state.mu, dict(zip(keys, saved["mu"])))
            load_whole(st.net, st.opt_state.nu, dict(zip(keys, saved["nu"])))
            if "replay" in tree:
                r, rep = st.replay, tree["replay"]
                idx = list(rows)
                for k, v in rep["storage"].items():
                    r.storage[k].copy_(v[idx])
                r.tree.copy_(rep["tree"][idx])
                r.pos = [rep["pos"][i] for i in idx]
                r.size = [rep["size"][i] for i in idx]
            st.step = int(tree["step"])
        self.generator.set_state(tree["rng"])
        self.step = int(tree["step"])


class CardsLearner(SingleChipLearner):
    """A dp-sharded learner over a mesh of several distinct cards
    (module docstring), with the stacked learner's endpoints.
    `make_learner(replay, mesh, exchange, rows)` builds one group's
    `DistDQNLearner` or `DistSequenceLearner`; `make_replay(device)` its
    per-shard replay on its owner. `min_dim`: the smallest dimension
    the tp split divides (parallel/sharding.py)."""

    def __init__(self, make_learner: Callable, make_replay: Callable,
                 lcfg, mesh: Mesh, min_dim: int = 256):
        self.mesh = mesh
        self.lcfg = lcfg
        self.dp = mesh.dp
        self.min_dim = min_dim
        self.groups: list[CardGroup] = mesh.groups
        sizes = {len(g.rows) for g in self.groups}
        if len(sizes) != 1:
            raise NotImplementedError(
                f"the card groups hold {sorted(sizes)} rows: the "
                f"exchange's arithmetic needs as many on every owner")
        self.exchange = CardExchange([g.owner for g in self.groups])
        self.learners = [
            make_learner(make_replay(g.owner),
                         Mesh([list(g.tp_devices)] * len(g.rows)),
                         self.exchange, list(g.rows))
            for g in self.groups]
        self.replay = self.learners[0].replay
        self.b_local = lcfg.batch_size // self.dp
        self.split_layers: list[str] = []
        self.param_specs: dict[str, tuple] = {}
        self._capture = True
        self._streams: dict[int, dict] = {}

    @property
    def capture(self) -> bool:
        return self._capture

    @capture.setter
    def capture(self, value: bool) -> None:
        self._capture = value
        for lrn in self.learners:
            lrn.capture = value

    @property
    def cards(self) -> list[torch.device]:
        return self.mesh.cards

    # -- state ---------------------------------------------------------------

    def init(self, net: nn.Module, item_spec: Any,
             generator: torch.Generator) -> CardsTrainState:
        """One replica of `net` per group on its owner (`net` itself
        stays whole: the inference server's apply fn holds it), split
        across the rows' tp cards where they are distinct, with its
        target, Adam and dp_c empty replay shards."""
        self.param_specs = make_param_shardings(net, self.mesh, self.min_dim)
        states = []
        for group, lrn in zip(self.groups, self.learners):
            replica = copy.deepcopy(net).to(group.owner)
            if group.split:
                self.split_layers = split_module(
                    replica, group.tp_devices, self.min_dim)
            lrn.param_specs = self.param_specs
            states.append(lrn.init(replica, item_spec, generator))
        return CardsTrainState(groups=states,
                               rows=[g.rows for g in self.groups],
                               generator=generator, step=0,
                               cards=self.cards)

    # -- streams -------------------------------------------------------------

    @contextlib.contextmanager
    def on_cards(self):
        """Run the body with a stream of its own current on every other
        card, forked from and joined back into the caller's current
        stream on the first card (module docstring); nothing on the
        CPU."""
        if self.mesh.device.type != "cuda":
            yield
            return
        first = self.mesh.device
        cur = torch.cuda.current_stream(first)
        streams = self._streams.get(cur.cuda_stream)
        if streams is None:
            streams = {d: torch.cuda.Stream(device=d)
                       for d in self.cards if d != first}
            self._streams[cur.cuda_stream] = streams
        with contextlib.ExitStack() as stack:
            for s in streams.values():
                s.wait_stream(cur)
                stack.enter_context(torch.cuda.stream(s))
            stack.enter_context(torch.cuda.device(first))
            yield
        for s in streams.values():
            cur.wait_stream(s)

    def _each(self, fn: Callable) -> list:
        """fn(i, group, learner) for every group, with its owner the
        current device."""
        out = []
        for i, (group, lrn) in enumerate(zip(self.groups, self.learners)):
            with (torch.cuda.device(group.owner)
                  if group.owner.type == "cuda"
                  else contextlib.nullcontext()):
                out.append(fn(i, group, lrn))
        return out

    # -- the step --------------------------------------------------------------

    def _per_draw(self) -> int:
        return self.b_local

    def _noises(self, state: CardsTrainState, n: int,
                noise: torch.Tensor | None) -> list[torch.Tensor]:
        """The full [dp, n] draw (or the fed one), sliced per group onto
        its owner."""
        if noise is None:
            noise = torch.rand((self.dp, n), generator=state.generator,
                               device=self.mesh.device)
        return [noise[list(g.rows)].to(g.owner) for g in self.groups]

    def _metrics(self, outs: list[dict]) -> dict:
        """Group 0's metrics (the loss, the means and the gradient are
        global), with the per-shard |TD| bounds over every group."""
        m = outs[0]
        dev = m["loss"].device
        diag = dict(m["diag"])
        for key, fn in (("shard_td_mean_min", torch.minimum),
                        ("shard_td_mean_max", torch.maximum)):
            if key in diag:
                v = diag[key]
                for o in outs[1:]:
                    v = fn(v, o["diag"][key].to(dev))
                diag[key] = v
        return {**m, "diag": diag}

    def _run_cards(self, key, fn: Callable, state: CardsTrainState,
                   n: int, noise: torch.Tensor | None) -> dict:
        """Run the endpoint `key`'s `CardsStep` (built on first use) on
        an n-wide draw per shard, on the cards' streams."""
        graphs = self.__dict__.setdefault("_graphs", {})
        if key not in graphs:
            steps = key[1] if isinstance(key, tuple) else 1
            name = "train_step" if steps == 1 else f"train_step_k{steps}"
            graphs[key] = CardsStep(
                [lrn._weak_body(fn) for lrn in self.learners],
                self.exchange, self.groups,
                name=f"{type(self).__name__}"
                     f"[{type(self.learners[0]).__name__}].{name}",
                steps=steps)
        with self.on_cards():
            noises = self._noises(state, n, noise)
            return self._metrics(graphs[key](state.groups, noises,
                                             self.capture))

    def _advance(self, state: CardsTrainState, k: int) -> None:
        state.step += k
        for st in state.groups:
            st.step = state.step

    def _train_step(self, state: CardsTrainState,
                    noise: torch.Tensor | None = None):
        metrics = self._run_cards(
            "step", lambda lrn, s, u: lrn._step_body(s, u), state,
            self.b_local, noise)
        self._advance(state, 1)
        return state, metrics

    def _train_step_k(self, state: CardsTrainState, k: int,
                      noise: torch.Tensor | None = None):
        metrics = self._run_cards(
            ("k", k), lambda lrn, s, u: lrn._step_body_k(s, k, u), state,
            k * self.b_local, noise)
        self._advance(state, k)
        return state, metrics

    def sample_k(self, state: CardsTrainState, k: int,
                 noise: torch.Tensor | None = None):
        with self.on_cards():
            noises = self._noises(state, k * self.b_local, noise)
            return self._each(lambda i, g, lrn: lrn._sample_stage(
                state.groups[i].replay, k, noises[i]))

    def learn_k(self, state: CardsTrainState, sample, k: int):
        """The K SGD steps of a prefetched sample, eagerly, with the
        exchange between them (as the stacked learner's `learn_k`)."""
        with self.on_cards():
            metrics = self._metrics(drive_cards(
                [lrn._learn_stage(st, smp, k) for lrn, st, smp in
                 zip(self.learners, state.groups, sample)], self.exchange))
        self._advance(state, k)
        return state, metrics

    # -- ingest ----------------------------------------------------------------

    def _rows(self, x: torch.Tensor, axis: int, rows) -> torch.Tensor:
        """x's `rows` along `axis`: a view when they are consecutive
        (so a pinned staging block stays pinned), else a copy."""
        rows = list(rows)
        if rows == list(range(rows[0], rows[0] + len(rows))):
            return x.narrow(axis, rows[0], len(rows))
        return x.index_select(axis, torch.tensor(rows, device=x.device))

    def add(self, state: CardsTrainState, items: Any,
            td_abs: torch.Tensor) -> CardsTrainState:
        """items {key: [dp, B, ...]}, td_abs [dp, B]: each group adds
        its rows (eagerly)."""
        with self.on_cards():
            self._each(lambda i, g, lrn: lrn.add(
                state.groups[i],
                {k: self._rows(v, 0, g.rows).to(g.owner)
                 for k, v in items.items()},
                self._rows(td_abs, 0, g.rows).to(g.owner)))
        return state

    def land_add(self, g: int, views: dict, lead: tuple) -> list:
        """`GraphedEndpoints.land_add` per group: each takes its rows of
        the [.., dp, chunk] blocks (`lead`)."""
        axis = 1 if g > 1 else 0

        def one(i, group, lrn):
            sub_lead = lead[:axis] + (len(group.rows),) + lead[axis + 1:]
            sub = {}
            for k, v in views.items():
                x = self._rows(v.reshape(lead + tuple(v.shape[1:])), axis,
                               group.rows)
                sub[k] = x.reshape(-1, *v.shape[1:])
            return lrn.land_add(g, sub, sub_lead)

        with self.on_cards():
            return self._each(one)

    def add_landed(self, state: CardsTrainState, g: int,
                   inputs: list) -> CardsTrainState:
        with self.on_cards():
            self._each(lambda i, grp, lrn: lrn.add_landed(
                state.groups[i], g, inputs[i]))
        return state

    def add_graphs(self) -> dict:
        """Group 0's add graphs (every group replays its own alike)."""
        return self.learners[0].add_graphs()

    # -- publication and observability ------------------------------------------

    def publish_params(self, state: CardsTrainState
                       ) -> dict[str, torch.Tensor]:
        """Whole params, on the first card (the pieces joined there)."""
        with self.on_cards():
            net = state.groups[0].net
            return {k: v.detach().clone()
                    for k, v in whole_tensors(net,
                                              list(net.parameters())).items()}

    def shard_stats(self, state: CardsTrainState) -> dict:
        """The stacked learner's `shard_stats` in row order over the
        groups."""
        per = [lrn.shard_stats(st)
               for lrn, st in zip(self.learners, state.groups)]
        out: dict = {}
        for key in ("sizes", "live", "fill", "tree_mass"):
            vals = [None] * self.dp
            for st, g in zip(per, self.groups):
                for r, v in zip(g.rows, st[key]):
                    vals[r] = v
            out[key] = vals
        out["fill_min"] = min(out["fill"])
        out["fill_max"] = max(out["fill"])
        out["tp_split_params"] = per[0]["tp_split_params"]
        return out

    def layout(self) -> dict:
        """The mesh over cards, for the driver's summary and the CLI's
        header."""
        return {"cards": [str(d) for d in self.cards],
                "rows_per_card": {str(g.owner): list(g.rows)
                                  for g in self.groups},
                "tp_partners": {str(g.owner): [str(d) for d in
                                               g.tp_devices[1:]]
                                for g in self.groups if g.split},
                "split_layers": list(self.split_layers)}


def group_learner(cls, lcfg, rcfg=None) -> Callable:
    """`make_learner` for `CardsLearner` over a dist learner class."""
    def make(replay, mesh, exchange, rows):
        if rcfg is None:
            return cls(replay, lcfg, mesh, exchange=exchange, rows=rows)
        return cls(replay, lcfg, rcfg, mesh, exchange=exchange, rows=rows)
    return make

