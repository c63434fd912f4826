"""The comparison that decides ``correct`` in a learner cell: the
program's first macro-step against the reference's, number by number,
each against its limit from the cell's workload file. The learner
references (``reference/dqn.py``, ``reference/r2d2.py``) export it as
their ``compare`` and ``NAMES``; a reference of another kind of cell
brings its own.

The numbers (each a relative gap; how their limits were set is in
PERF.md):
- ``loss``: the last grad-step's loss of the first macro-step (read and
  printed, not held to a limit).
- ``adam_mu``: Adam's first moment after the macro-step (the gradients
  as the optimizer got them), by the worst leaf: the gap between the
  two sides' norms of a leaf over the larger of the reference's norm of
  that leaf and of the median leaf.
- ``mu_diff``: the same first moment by the norm of the DIFFERENCE
  between the two sides over the reference's norm, for the median leaf:
  the norms alone hardly see a gradient taken over the wrong rows (one
  card group's half of the batch, where the exchange between cards is
  left out), whose norm is about the whole batch's; the median leaf is
  steady from seed to seed where the worst (a small bias) swings.
- ``update``: the parameters' change over the macro-step, read from
  the PUBLISHED copy, by the worst leaf as above; leaves whose first
  gradient in the reference is under a thousandth of the median leaf's
  (moved by round-off alone under Adam) are left out.
- ``step1_priorities``: the sum-tree's leaves after the write-back
  against the reference's, over the leaves the first grad-step drew
  (and no later one) and every leaf no step drew, over the norm of the
  first step's written priorities. The first step's |TD|s come from the
  seed's weights alone, so they read the draw, the gather, the nets'
  forward and the write-back without the later steps' Adam updates,
  which turn rounding-sized gradient differences into whole update
  steps on near-zero gradients. Where a leaf was drawn twice by the
  first step, the write that lands is either, so the one nearest the
  program's is taken.
"""

from __future__ import annotations

import statistics

import torch

# every number `compare` reads; a cell holds those its workload file
# gives a limit (`loss` is read and reported, held by none: PERF.md)
NAMES = ("loss", "adam_mu", "mu_diff", "update", "step1_priorities")


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of | |prog_l| - |ref_l| | / max(|ref_l|, median
    |ref|), prog and ref {leaf: norm}; `keep` limits the leaves."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in ref)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def median_leaf_diff(prog: dict, ref: dict) -> float:
    """median over leaves of |prog_l - ref_l| / |ref_l|, prog and ref
    {leaf: tensor} (leaves the reference leaves at 0 left out)."""
    return statistics.median(
        float((prog[n].to(v.device).double() - v.double()).norm())
        / float(v.double().norm())
        for n, v in ref.items() if float(v.double().norm()) > 0)


def step1_priorities_gap(prog_leaves: torch.Tensor, ref: dict) -> float:
    dev = prog_leaves.device
    first = {leaf: [v for _, v in draws]
             for leaf, draws in ref["written"].items()
             if all(j == 0 for j, _ in draws)}
    later = [leaf for leaf in ref["written"] if leaf not in first]
    expected = ref["leaves0"].to(dev).double().clone()
    idx = torch.tensor(list(first), dtype=torch.long, device=dev)
    got = prog_leaves[idx].tolist()
    nearest = [min(c, key=lambda v, g=g: abs(v - g))
               for g, c in zip(got, first.values())]
    expected[idx] = torch.tensor(nearest, dtype=torch.float64, device=dev)
    diff = prog_leaves.double() - expected
    diff[torch.tensor(later, dtype=torch.long, device=dev)] = 0.0
    den = float(torch.tensor(nearest, dtype=torch.float64).norm())
    return float(diff.norm()) / max(den, 1e-30)


def compare(readings: dict, ref: dict) -> dict:
    """{number: gap} of the program's `readings` ({"loss", "mu" {leaf:
    tensor}, "published" {leaf: tensor}, "leaves"}) against the
    reference's `follow` result."""
    med = statistics.median(ref["grad0"].values())
    moved = {n for n, g in ref["grad0"].items() if g >= 1e-3 * med}
    d_ref = _leaf_norms({n: ref["params"][n] - ref["params0"][n]
                         for n in ref["params"]})
    d_prog = _leaf_norms({n: readings["published"][n].to(
        ref["params0"][n].device).float() - ref["params0"][n]
        for n in ref["params"]})
    return {
        "loss": abs(readings["loss"] - ref["loss"]) / max(abs(ref["loss"]),
                                                          1e-30),
        "adam_mu": worst_leaf_gap(_leaf_norms(readings["mu"]),
                                  _leaf_norms(ref["mu"])),
        "mu_diff": median_leaf_diff(readings["mu"], ref["mu"]),
        "update": worst_leaf_gap(d_prog, d_ref, keep=moved),
        "step1_priorities": step1_priorities_gap(readings["leaves"], ref),
    }


def as_readings(ref: dict) -> dict:
    """A reference's `follow` result in the program's readings' form,
    for a control or a fault put in the program's place (a leaf drawn
    twice keeps its last write)."""
    leaves = ref["leaves0"].clone()
    for leaf, draws in ref["written"].items():
        leaves[leaf] = draws[-1][1]
    return {"loss": ref["loss"], "mu": ref["mu"],
            "published": ref["params"], "leaves": leaves}
