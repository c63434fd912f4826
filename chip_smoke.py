#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (ape_x_dqn_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed 0]

Phases, one result line each with its seconds; any failure exits
non-zero:
1. device    the card's name and power limit (nvidia-smi); no CUDA -> exit 2
2. build     nvcc builds every kernel from the sources in the checkout
3. kernel    each kernel against its plain PyTorch version on the card at
             each main path's shapes (bitwise for the gather: the frame
             ring's 7168-byte frame rows and flat replay's 28,288-byte
             packed 84x84x4 stacks, the latter from 32,768 rows and from
             a full 2^20-row leaf of 29.66 GB; the r2d2 replay's
             585,728-byte packed single-frame sequences, 256 rows from a
             full 65,536-row leaf of 38.39 GB), with its time, the plain
             version's, one library call's, a contiguous copy of the
             same bytes, and its bound
4. reference one K=4 macro-step of a small float32 learner on the
             card and on the CPU from the same weights, replay and
             noise: the kernel path agrees with the plain one
5. main      the `pong` frame-ring learner at full width and full 2^20
             capacity: prefill >= min_fill transitions through add_many,
             then K=4 macro-steps through train_step_k; kernel launch
             counts are zeroed just before and read just after; then a
             torch.profiler pass: device busy share and top kernels.
             Its 10.3 GB ring is freed before the next phases.
6. apex      `python -m ape_x_dqn_tpu_torch.runtime.train --config pong
             --total-env-frames 60000 --wall-clock-limit 180`, the
             default CLI mode: the Ape-X driver with 8 vector actors x 16
             synthetic-Atari envs (native preprocessing), the batched
             inference server on the card, the pinned ingest stager and
             the frame-ring learner at full width and 2^20 capacity,
             paced at 1.6e-3 grad-steps per frame; launch counts zeroed
             just before and read just after (two gather launches per
             K=4 macro-step); publications counted; one shipped segment
             read back from the ring bitwise; the driver freed after
7. r2d2      `python -m ape_x_dqn_tpu_torch.runtime.train --config r2d2
             --set parallel.dp=1 --set parallel.tp=1 --actors 8 --set
             replay.min_fill=256 --total-env-frames 30000
             --wall-clock-limit 180`: the R2D2 preset at full width
             (Nature-CNN torso, LSTM 512, dueling, bf16, sequences of 80
             with burn-in 40, batch 64, K=4) through the default CLI
             mode: 8 recurrent vector actors x 16 envs, stateful
             {obs, c, h} queries to the inference server, a 65,536-
             sequence frame-mode prioritized replay (38.39 GB of packed
             rows) and the SequenceLearner; launch counts zeroed just
             before and read just after (one gather launch per draw);
             publications counted; frames/s before and after min_fill;
             the first shipped sequence read back from replay slot 0
             bitwise; the final eval through the recurrent policy; then
             the learner alone on the run's replay (host clock, and a
             torch.profiler pass); the driver freed after
8. cartpole  `python -m ape_x_dqn_tpu_torch.runtime.train --config
             cartpole_smoke --single-process` for 9,000 frames on the
             card: the repo's quick learning bar (last20 > 60)
9. pong-sp   the same CLI with `--config pong --set
             learner.sample_prefetch=True` for 24,000 frames: the
             dueling Nature-CNN at full width over a 2^20-slot flat
             prioritized replay (59.3 GB of packed pixel rows), K=4 with
             the double-buffered sampler; launch counts zeroed just
             before and read just after; two gather launches per
             sample_k call; one drawn sample bitwise vs plain
10. the kernels line, the card line, and the contract's last line.

It imports torch and the port only: no JAX, nothing of ape_x_dqn_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM published peak memory rate (NVIDIA data sheet), at 700 W
PEAK_BYTES_PER_S = 3.35e12
# main path: 2 warm-up + 8 timed train_step_k calls, then macro-steps
# split into their two stages for CUDA-event stage times, then a
# torch.profiler pass (after the launch counts are read)
MACRO_STEPS = 10
STAGED_STEPS = 3
PROFILE_STEPS = 3
# r2d2: macro-steps of the learner alone after the driver's run
R2D2_ALONE = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pong_setup(dev):
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.envs.base import EnvSpec

    cfg = get_config("pong")
    # 18 actions: the full ALE action set, as the JAX bench sizes pong
    spec = EnvSpec(obs_shape=(84, 84, 4), obs_dtype=np.dtype(np.uint8),
                   discrete=True, num_actions=18)
    return cfg, spec


def segments(replay, spec, g_outer: int, g: int, rng) -> tuple[dict, object]:
    """Synthetic staged segments [g_outer, g, ...] as bench.py's
    _seg_chunk builds them, from numpy."""
    b, f = replay.B, replay.F
    shape = (g_outer, g, b)
    items = {
        "seg_frames": torch.from_numpy(rng.integers(
            0, 255, (g_outer, g, f, *spec.obs_shape[:2]), dtype=np.uint8)),
        "action": torch.from_numpy(
            rng.integers(0, spec.num_actions, shape).astype(np.int32)),
        "reward": torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)),
        "discount": torch.full(shape, 0.99 ** 3),
        "next_off": torch.full(shape, 3, dtype=torch.int32),
    }
    return items, torch.from_numpy(
        rng.uniform(0.1, 2.0, shape).astype(np.float32))


def kernel_site(dev, seed: int, site: str, n_rows: int, row: int,
                m: int) -> dict:
    """gather_rows vs plain on the card at one call site's shape: m
    indices into a [n_rows, row] uint8 buffer, bitwise on 8 random
    index sets and on sets with duplicates and both ends, int64 and
    int32; then kernel / plain / index_select / contiguous-copy times
    (CUDA events, median of 5 rounds of 50 launches in turns, the 8
    index sets cycled so the rows a call reads are not all served from
    the 50 MB L2 by the previous call; the copy moves the same m * row
    bytes from 8 contiguous slices of the source in turn) and the byte
    bound."""
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg

    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    src = torch.randint(0, 256, (n_rows, row), dtype=torch.uint8,
                        device=dev, generator=g)
    idx_sets = [torch.randint(0, n_rows, (m,), device=dev, generator=g)
                for _ in range(8)]
    edge = idx_sets[0].clone()
    edge[:6] = torch.tensor([0, n_rows - 1, n_rows - 1, 0, 0, 7],
                            device=dev)
    max_err = 0
    for idx in [*idx_sets, edge, edge.to(torch.int32)]:
        out = fg.gather_rows(src, idx)
        torch.cuda.synchronize()
        ref = fg.gather_rows_reference(src, idx)
        check(out.shape == ref.shape and out.dtype == ref.dtype,
              "gather_rows shape/dtype")
        max_err = max(max_err, int((out.int() - ref.int()).abs().max()))
        check(torch.equal(out, ref),
              f"gather_rows != plain (bitwise) at the {site} shape")

    def cycle(fn):
        it = iter(range(1 << 30))
        return lambda: fn(src, idx_sets[next(it) % len(idx_sets)])

    copy_out = torch.empty((m, row), dtype=torch.uint8, device=dev)
    slices = [src[j * m:(j + 1) * m] for j in range(8)]
    check(n_rows >= 8 * m, f"{site}: too few rows for 8 copy slices")
    copy_it = iter(range(1 << 30))
    versions = {
        "ms": cycle(fg.gather_rows),
        "plain_ms": cycle(fg.gather_rows_reference),
        "library_ms": cycle(lambda s_, i: s_.index_select(0, i)),
        "copy_ms": lambda: copy_out.copy_(slices[next(copy_it) % 8]),
    }
    rounds = {k: [] for k in versions}
    for _ in range(5):  # in turns, so drift hits every version alike
        for k, fn in versions.items():
            rounds[k].append(cuda_ms(fn, iters=50))
    times = {k: float(np.median(v)) for k, v in rounds.items()}
    nbytes = 2 * m * row + m * idx_sets[0].element_size()
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"kernel gather_rows [{site}]: bitwise equal to plain on "
        f"{len(idx_sets) + 2} index sets of {m} rows x {row} B from "
        f"{n_rows} rows = {n_rows * row / 1e9:.2f} GB (dups and both ends "
        f"incl.); ms={times['ms']:.5f} plain_ms={times['plain_ms']:.5f} "
        f"library_ms={times['library_ms']:.5f} (index_select) "
        f"copy_ms={times['copy_ms']:.5f} (contiguous copy of the same "
        f"bytes) bound_ms={bound_ms:.5f} ({nbytes} B at 3.35 TB/s); "
        f"rounds={json.dumps(rounds)}; {time.perf_counter() - t0:.2f} s")
    del src, idx_sets, edge, slices, copy_out
    torch.cuda.empty_cache()
    return {"site": site, "shape": [n_rows, row], "indices": m,
            "max_abs_err": max_err, "bound_ms": bound_ms, **times}


def phase_kernel(dev, seed: int) -> list[dict]:
    """The gather at every main path's shapes: one side of a K=4 x B=512
    frame-ring draw (8192 frame rows of 7168 B from a ring of the pong
    preset's full row count), one side of the same draw from flat
    replay (2048 packed 84x84x4 stacks of 28,288 B), timed from 32,768
    rows (as in earlier runs) and from the 2^20 rows of one leaf of the
    pong preset's flat replay (29.66 GB, freed after), and one K=4 x
    B=64 draw of the r2d2 preset's packed single-frame sequences
    (585,728 B rows) from its full 65,536-sequence leaf (38.39 GB,
    freed after)."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.replay.packing import PixelPacker, pad128
    from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
    from ape_x_dqn_tpu_torch.runtime.build import build_prioritized_replay
    from ape_x_dqn_tpu_torch.utils.misc import next_pow2

    cfg, spec = pong_setup(dev)
    capacity = next_pow2(cfg.replay.capacity)
    geo = build_prioritized_replay(cfg, spec, capacity, dev)
    kb = cfg.learner.sample_chunk * cfg.learner.batch_size
    n_rows, row, m = geo.S * geo.F, geo.frame_row, kb * geo.stack
    check(n_rows >= 1_441_792 and row == 7168 and m == 8192,
          f"unexpected frame-ring shape {n_rows}x{row}, m={m}")
    flat_row = pad128(int(np.prod(spec.obs_shape)))
    check(flat_row == 28288 and kb == 2048 and capacity == 1 << 20,
          f"unexpected flat shape: row {flat_row}, m={kb}, "
          f"capacity {capacity}")
    r2 = get_config("r2d2")
    spec = sequence_item_spec((84, 84, 4), np.uint8, r2.replay.seq_length,
                              r2.network.lstm_size, frame_mode=True)
    seq_row = PixelPacker(spec).storage_spec(spec)["seq_frames"].shape[0]
    seq_cap = next_pow2(r2.replay.capacity)
    seq_m = r2.learner.sample_chunk * r2.learner.batch_size
    check(seq_row == 585_728 and seq_cap == 65_536 and seq_m == 256,
          f"unexpected sequence shape: row {seq_row}, capacity {seq_cap}, "
          f"m={seq_m}")
    return [kernel_site(dev, seed, "frame_ring", n_rows, row, m),
            kernel_site(dev, seed, "flat", 32768, flat_row, kb),
            kernel_site(dev, seed, "flat_full", capacity, flat_row, kb),
            kernel_site(dev, seed, "sequence", seq_cap, seq_row, seq_m)]


def phase_reference(dev, seed: int) -> None:
    """One K=4 macro-step of a small float32 learner, run on the card
    (kernel path) and on the CPU (plain path) from the same weights,
    replay contents and stratification noise: one draw from identical
    trees, so both train on the same transitions. TF32 is off for this
    phase, so the card computes in full float32. Tolerances: loss 1e-4
    relative; params 2 * lr per Adam step absolute (one element's
    normalised update can flip sign where its gradient is at rounding
    level); leaf priorities 2e-3 absolute, except leaves drawn twice
    (see below)."""
    from ape_x_dqn_tpu_torch.configs import (LearnerConfig, NetworkConfig,
                                             ReplayConfig)
    from ape_x_dqn_tpu_torch.ops import sum_tree
    from ape_x_dqn_tpu_torch.runtime.build import build_learner

    cfg, spec = pong_setup(dev)
    cfg = cfg.replace(
        network=NetworkConfig(kind="nature_cnn", cnn_channels=(8, 16, 16),
                              torso_dense=64, compute_dtype="float32"),
        replay=ReplayConfig(kind="prioritized", capacity=4096,
                            storage="frame_ring", seg_transitions=16),
        learner=LearnerConfig(batch_size=32, sample_chunk=4,
                              target_sync_every=3),
        seed=seed)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for d in (dev, torch.device("cpu")):
            learner, state = build_learner(cfg, spec, device=d)
            rng = np.random.default_rng(seed)
            items, td = segments(learner.replay, spec, 2, 64, rng)
            learner.add_many(state, items, td)
            noise = torch.from_numpy(rng.uniform(
                size=4 * cfg.learner.batch_size).astype(np.float32))
            # the leaves this macro-step's one draw will return (the
            # same descent train_step_k makes, read-only)
            drawn, _ = sum_tree.sample(state.replay.tree.cpu(),
                                       noise.numel(), state.replay.size,
                                       noise)
            state, m = learner.train_step_k(state, 4, noise.to(d))
            runs.append((state, m))
        (gs, g2), (cs, c2) = runs
        for key in ("loss", "q_mean", "grad_norm"):
            a, b_ = g2[key].item(), c2[key].item()
            check(math.isfinite(a) and abs(a - b_) <= 1e-4 * abs(b_) + 1e-6,
                  f"reference {key}: card {a} vs cpu {b_}")
        tol = 2 * cfg.learner.lr * gs.step
        err = max(float((p.cpu() - q).abs().max()) for p, q in
                  zip(gs.net.state_dict().values(),
                      cs.net.state_dict().values()))
        check(err <= tol, f"reference params differ by {err} > {tol}")
        # a leaf drawn twice gets two write-back values, and which one
        # lands is unordered on the card: those leaves are not compared.
        # A leaf holds (|td| + 1e-6)^0.6, whose slope is unbounded near
        # td = 0: a float32-level TD difference d moves a leaf by up to
        # d^0.6 (2.5e-4 at d = 1e-6), so the others get 2e-3 absolute
        cap = learner.replay.capacity
        once = torch.ones(cap, dtype=torch.bool)
        leaves, counts = torch.unique(drawn, return_counts=True)
        once[leaves[counts > 1]] = False
        terr = float((gs.replay.tree[cap:].cpu()
                      - cs.replay.tree[cap:])[once].abs().max())
        check(terr <= 2e-3, f"reference tree leaves differ by {terr}")
        log(f"reference: card vs cpu after {gs.step} grad-steps: loss "
            f"{g2['loss'].item():.6f} vs {c2['loss'].item():.6f}, max "
            f"param diff {err:.3g} (tol {tol:.3g}), max leaf priority "
            f"diff {terr:.3g} (tol 2e-3; {int((~once).sum())} leaves drawn "
            f"twice not compared)")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def profile_macro_steps(learner, state, k: int, n: int) -> str:
    """n train_step_k calls under torch.profiler: device busy share
    (kernel time over wall time) and the kernels that take the most
    device time. The profiler's own host cost inflates the wall time,
    so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = learner.train_step_k(state, k)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)

    busy_us = sum(dev_us(e) for e in kern)
    if not kern or busy_us <= 0:
        return "profile: no device time in the trace (not measured)"
    top = sorted(kern, key=dev_us, reverse=True)[:12]
    rows = [{"kernel": e.key[:90], "count": e.count / n,
             "ms_per_macro": round(dev_us(e) / n / 1e3, 4)} for e in top]
    return (f"profile: {n} macro-steps, wall {wall_us / n / 1e3:.3f} "
            f"ms/macro-step under the profiler, device busy "
            f"{busy_us / n / 1e3:.3f} ms/macro-step = "
            f"{busy_us / wall_us:.3f} of wall, "
            f"{sum(e.count for e in kern) / n:.0f} kernel launches per "
            f"macro-step; top by device time: {json.dumps(rows)}")


def phase_main(dev, seed: int) -> dict:
    """The pong learner at full width and capacity through the port's
    entry points. -> the launch counts of this run."""
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.runtime.build import build_learner

    cfg, spec = pong_setup(dev)
    k = cfg.learner.sample_chunk
    check(k == 4 and cfg.learner.batch_size == 512
          and cfg.network.compute_dtype == "bfloat16", "pong preset drift")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    learner, state = build_learner(cfg, spec, device=dev)
    replay = learner.replay
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ring_gb = state.replay.storage["frames"].numel() / 1e9
    check(replay.capacity == 1 << 20, f"capacity {replay.capacity}")

    rng = np.random.default_rng(seed)
    per_group = 256                   # segments per staged block
    groups = -(-cfg.replay.min_fill // (per_group * replay.B))
    items, td = segments(replay, spec, groups, per_group, rng)

    fg.gather_rows.launches = 0       # count the main path's run only
    t0 = time.perf_counter()
    state = learner.add_many(state, items, td)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    check(state.replay.size >= cfg.replay.min_fill,
          f"prefill reached {state.replay.size}")

    root0 = state.replay.tree[1].item()
    losses = []
    warm = 2
    for _ in range(warm):
        state, m = learner.train_step_k(state, k)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MACRO_STEPS - warm):
        state, m = learner.train_step_k(state, k)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grad_steps_s = (MACRO_STEPS - warm) * k / wall
    root1 = state.replay.tree[1].item()

    # per-stage device times: the two stages train_step_k composes
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    sample_ms, learn_ms = [], []
    for _ in range(STAGED_STEPS):
        ev[0].record()
        sample = learner._sample_stage(state.replay, k, None,
                                       state.generator)
        ev[1].record()
        state, m = learner._learn_stage(state, sample, k)
        ev[2].record()
        torch.cuda.synchronize()
        sample_ms.append(ev[0].elapsed_time(ev[1]))
        learn_ms.append(ev[1].elapsed_time(ev[2]))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = {"gather_rows": fg.gather_rows.launches}

    loss_vals = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in loss_vals), f"loss {loss_vals}")
    check(root1 != root0, "tree root unchanged by the write-backs")
    total = MACRO_STEPS + STAGED_STEPS
    want = 2 * total                  # one launch per side per draw
    check(launches["gather_rows"] == want,
          f"gather_rows launched {launches['gather_rows']} times, "
          f"expected {want} ({total} macro-steps x 2 sides)")
    diag = {key: round(v.item(), 6) for key, v in m["diag"].items()}
    check(all(math.isfinite(v) for v in diag.values()), f"diag {diag}")

    # one macro-step's gathered batch: kernel vs plain on the same rows
    noise = torch.rand(k * cfg.learner.batch_size, device=dev,
                       generator=state.generator)
    got, idx, _ = replay.sample_items(state.replay,
                                      k * cfg.learner.batch_size, noise)
    obs_rows, next_rows = replay.stack_rows(state.replay, idx)
    frames = state.replay.storage["frames"]
    for key, rows in (("obs", obs_rows), ("next_obs", next_rows)):
        want_stack = replay.unpack_stack(
            fg.gather_rows_reference(frames, rows))
        check(got[key].shape == (k * cfg.learner.batch_size, 84, 84, 4),
              f"{key} shape {tuple(got[key].shape)}")
        check(torch.equal(got[key], want_stack),
              f"sampled {key}: kernel != plain")

    log(f"main: pong learner, dueling Nature-CNN bf16, 84x84x4 uint8, "
        f"{spec.num_actions} actions, batch {cfg.learner.batch_size}, "
        f"K={k}, ring {replay.S * replay.F} rows = {ring_gb:.2f} GB for "
        f"{replay.capacity} transitions; build {build_s:.2f} s, prefill "
        f"{state.replay.size} transitions in {fill_s:.2f} s; "
        f"{MACRO_STEPS} train_step_k + {STAGED_STEPS} staged macro-steps; "
        f"grad-steps/s={grad_steps_s:.2f} (host clock over "
        f"{MACRO_STEPS - warm} macro-steps after {warm} warm-up); "
        f"sample_stage_ms={float(np.median(sample_ms)):.3f} "
        f"learn_stage_ms={float(np.median(learn_ms)):.3f} (CUDA events, "
        f"median of {STAGED_STEPS}); losses={[round(x, 5) for x in loss_vals]}"
        f"; root {root0:.3f} -> {root1:.3f}; launches={launches}; "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}; "
        f"gathered obs/next_obs bitwise equal to plain; diag={diag}")
    log(profile_macro_steps(learner, state, k, PROFILE_STEPS))
    # free the 10.3 GB ring before the flat replay's 59.3 GB
    del learner, state, replay, sample, frames, got, items
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_cli(argv: list[str]) -> tuple[dict, float]:
    """`python -m ape_x_dqn_tpu_torch.runtime.train ARGV` in this
    process, its one JSON summary line captured (so that this script's
    only JSON lines are the kernels line and the last line). -> (the
    summary, wall seconds)."""
    from ape_x_dqn_tpu_torch.runtime import train

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"train.main({argv}) exited {rc}")
    lines = buf.getvalue().strip().splitlines()
    check(len(lines) == 1, f"expected one summary line, got {lines}")
    return json.loads(lines[0]), wall


def phase_cartpole() -> None:
    """cartpole_smoke learns on the card: the repo's quick bar."""
    out, wall = run_cli(["--config", "cartpole_smoke", "--single-process",
                         "--total-env-frames", "9000", "--device", "cuda"])
    check(out["episodes"] >= 5 and out["last20_return"] > 60.0,
          f"cartpole_smoke did not clear last20 > 60: {out}")
    log(f"cartpole: `--config cartpole_smoke --single-process "
        f"--total-env-frames 9000 --device cuda` cleared the quick bar "
        f"(last20 {out['last20_return']:.2f} > 60 over "
        f"{out['episodes']} episodes); frames/s={out['frames'] / wall:.1f} "
        f"grad-steps/s={out['grad_steps'] / wall:.1f} (host clock over "
        f"the whole run: acting, one sync per greedy frame, and "
        f"training); summary={json.dumps(out)}; {wall:.2f} s")


def phase_apex(seed: int) -> dict:
    """The Ape-X driver through the default CLI mode at the pong preset:
    actors and the inference server share the card with the frame-ring
    learner. BatchedInferenceServer.update_params is wrapped to count
    publications, DQNLearner.train_many to stamp the training window
    and count macro-steps, LoopbackTransport.send_experience to keep a
    copy of the first segment an actor ships, and ApexDriver.__init__ to
    keep the driver for the read-back after the run. -> the launch
    counts of this run."""
    from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.envs import native
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.parallel.inference_server import (
        BatchedInferenceServer)
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
    from ape_x_dqn_tpu_torch.runtime.learner import DQNLearner

    cfg = get_config("pong")
    k = cfg.learner.sample_chunk
    check(k == 4 and cfg.actors.num_actors == 8
          and cfg.actors.envs_per_actor == 16
          and cfg.replay.storage == "frame_ring"
          and cfg.learner.steps_per_frame_cap == 1.6e-3, "pong preset drift")
    check(native.available(), "the native frame preprocessing did not "
          "build: the apex phase must run the native path")
    calls = {"publications": 0, "train_many": 0, "macro": 0, "singles": 0,
             "first_s": None, "last_s": None}
    seen: dict = {}
    first_seg: list[dict] = []
    send_lock = threading.Lock()
    orig = (BatchedInferenceServer.update_params, DQNLearner.train_many,
            LoopbackTransport.send_experience, ApexDriver.__init__)

    def update_params(self, params, version):
        calls["publications"] += 1
        return orig[0](self, params, version)

    def train_many(self, state, n, noise=None):
        if calls["first_s"] is None:
            calls["first_s"] = time.perf_counter()
        out = orig[1](self, state, n, noise)
        calls["last_s"] = time.perf_counter()
        calls["train_many"] += 1
        calls["macro"] += n // k
        calls["singles"] += n % k
        return out

    def send_experience(self, batch):
        # the first segment enqueued lands in the ring's segment slot 0
        # (FIFO queue and stager, a fresh ring)
        with send_lock:
            if not first_seg:
                first_seg.append({key: np.array(v, copy=True)
                                  for key, v in batch.items()})
            return orig[2](self, batch)

    def driver_init(self, *a, **kw):
        orig[3](self, *a, **kw)
        seen["driver"] = self

    threads_before = {t.ident for t in threading.enumerate()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (BatchedInferenceServer.update_params, DQNLearner.train_many,
     LoopbackTransport.send_experience, ApexDriver.__init__) = (
        update_params, train_many, send_experience, driver_init)
    fg.gather_rows.launches = 0       # count the main path's run only
    try:
        out, wall = run_cli([
            "--config", "pong", "--seed", str(seed),
            "--total-env-frames", "60000", "--wall-clock-limit", "180",
            "--device", "cuda"])
    finally:
        (BatchedInferenceServer.update_params, DQNLearner.train_many,
         LoopbackTransport.send_experience, ApexDriver.__init__) = orig
    launches = {"gather_rows": fg.gather_rows.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]

    driver = seen.pop("driver")
    replay, st = driver.replay, driver.state.replay.storage
    server = out["server"]
    train_s = (calls["last_s"] - calls["first_s"]
               if calls["first_s"] is not None else 0.0)
    ev = out["eval"] or {}
    log(f"apex: `--config pong --total-env-frames 60000 "
        f"--wall-clock-limit 180 --device cuda`: {cfg.actors.num_actors} "
        f"vector actors x {cfg.actors.envs_per_actor} "
        f"{cfg.env.kind} envs ({'native' if native.available() else 'numpy'}"
        f" preprocessing), server max_batch {cfg.inference.max_batch} "
        f"deadline {cfg.inference.deadline_ms} ms, frame ring of "
        f"{replay.capacity} transitions; frames={out['frames']} "
        f"frames/s={out['frames'] / wall:.1f} over the run; "
        f"grad_steps={out['grad_steps']} in {calls['train_many']} "
        f"train_many calls ({calls['macro']} macro-steps), "
        f"grad-steps/s={out['grad_steps'] / max(train_s, 1e-9):.2f} over "
        f"the training window ({train_s:.2f} s); server "
        f"batches={server['batches']} items={server['items']} "
        f"avg_batch={server['avg_batch']:.2f} "
        f"items/s={server['items'] / wall:.1f}; ingest_dropped="
        f"{out['ingest_dropped']}; publications={calls['publications']}; "
        f"launches={launches}; peak_mem_gb={peak_gb:.2f}; episodes="
        f"{out['episodes']} avg_return={out['avg_return']:.3f}; "
        f"eval={json.dumps(ev)}; summary={json.dumps(out)}; {wall:.2f} s")
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(not left, f"driver threads still running after the run: {left}")
    check(out["grad_steps"] >= 32, f"grad_steps {out['grad_steps']} < 32")
    check(out["grad_steps"] == k * calls["macro"] + calls["singles"],
          f"grad_steps {out['grad_steps']} != the train_many calls' "
          f"{calls['macro']} macro-steps + {calls['singles']} singles")
    want = 2 * (calls["macro"] + calls["singles"])
    check(launches["gather_rows"] == want,
          f"gather_rows launched {launches['gather_rows']} times, expected "
          f"{want} (2 per draw: {calls['macro']} macro-steps, "
          f"{calls['singles']} singles)")
    check(calls["publications"] >= 1, "no param publication reached the "
          "inference server")
    check(server["avg_batch"] >= 8, f"server avg_batch {server}")

    # the first shipped segment, read back from the ring's slot 0
    check(first_seg and "seg_frames" in first_seg[0], "no segment shipped")
    seg = first_seg.pop()
    f, b = replay.F, replay.B
    got_frames = st["frames"][:f, :replay.frame_bytes].reshape(f, 84, 84)
    check(torch.equal(got_frames.cpu(), torch.from_numpy(
        seg["seg_frames"][0])), "ring slot 0 frames != the shipped segment")
    for key in ("action", "reward", "discount", "next_off"):
        check(torch.equal(st[key][:b].cpu(), torch.from_numpy(seg[key][0])),
              f"ring slot 0 {key} != the shipped segment")
    log("apex: the first shipped segment read back from ring slot 0 "
        "bitwise (frames and fields)")
    del driver, replay, st, got_frames, seg
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_r2d2(seed: int) -> dict:
    """The r2d2 preset through the CLI's default mode on one card, at
    full width. Wrapped for the checks after the run:
    BatchedInferenceServer.update_params counts publications,
    SequenceLearner.train_many stamps the training window, counts
    macro-steps and keeps the last loss, ApexDriver.run stamps the
    run's start, LoopbackTransport.send_experience keeps a copy of the
    first batch an actor ships, ApexDriver.__init__ keeps the driver,
    and the driver's eval-policy factory counts the recurrent policy's
    queries. -> the launch counts of this run."""
    from ape_x_dqn_tpu_torch.comm.transport import LoopbackTransport
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.parallel.inference_server import (
        BatchedInferenceServer)
    from ape_x_dqn_tpu_torch.runtime import driver as driver_mod
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
    from ape_x_dqn_tpu_torch.runtime.sequence_learner import SequenceLearner

    cfg = get_config("r2d2")
    net, rep, ln = cfg.network, cfg.replay, cfg.learner
    k = ln.sample_chunk
    check(net.kind == "lstm_q" and net.lstm_size == 512
          and net.torso_dense == 512 and net.dueling
          and net.compute_dtype == "bfloat16" and rep.seq_length == 80
          and rep.seq_overlap == 40 and rep.burn_in == 40
          and rep.capacity == 65_536 and rep.storage == "frame_ring"
          and ln.batch_size == 64 and k == 4 and ln.n_step == 5
          and ln.value_rescale and ln.target_sync_every == 2500
          and cfg.actors.envs_per_actor == 16, "r2d2 preset drift")
    calls = {"publications": 0, "train_many": 0, "macro": 0, "singles": 0,
             "first_s": None, "last_s": None, "run_s": None,
             "frames_at_first": 0, "frames_at_last": 0,
             "policy_queries": 0, "loss": None}
    seen: dict = {}
    first: list[dict] = []
    send_lock = threading.Lock()
    orig = (BatchedInferenceServer.update_params,
            SequenceLearner.train_many, LoopbackTransport.send_experience,
            ApexDriver.__init__, ApexDriver.run,
            driver_mod.make_eval_policy_factory)

    def update_params(self, params, version):
        calls["publications"] += 1
        return orig[0](self, params, version)

    def train_many(self, state, n, noise=None):
        frames = seen["driver"]._frames_total
        if calls["first_s"] is None:
            calls["first_s"] = time.perf_counter()
            calls["frames_at_first"] = frames
        calls["frames_at_last"] = frames
        out = orig[1](self, state, n, noise)
        calls["last_s"] = time.perf_counter()
        calls["train_many"] += 1
        calls["macro"] += n // k
        calls["singles"] += n % k
        calls["loss"] = out[1]["loss"]     # read after the run
        return out

    def send_experience(self, batch):
        # the first batch enqueued lands first in replay slot 0 (FIFO
        # queue and stager, one sequence a block, a fresh ring)
        with send_lock:
            if not first:
                first.append({key: np.array(v, copy=True)
                              for key, v in batch.items()})
            return orig[2](self, batch)

    def driver_init(self, *a, **kw):
        orig[3](self, *a, **kw)
        seen["driver"] = self

    def driver_run(self, *a, **kw):
        calls["run_s"] = time.perf_counter()
        return orig[4](self, *a, **kw)

    def policy_factory(family, lstm_size, query_fn):
        def counted(inp):
            calls["policy_queries"] += 1
            return query_fn(inp)
        return orig[5](family, lstm_size, counted)

    threads_before = {t.ident for t in threading.enumerate()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (BatchedInferenceServer.update_params, SequenceLearner.train_many,
     LoopbackTransport.send_experience, ApexDriver.__init__,
     ApexDriver.run, driver_mod.make_eval_policy_factory) = (
        update_params, train_many, send_experience, driver_init,
        driver_run, policy_factory)
    fg.gather_rows.launches = 0       # count the main path's run only
    try:
        out, wall = run_cli([
            "--config", "r2d2", "--seed", str(seed),
            "--set", "parallel.dp=1", "--set", "parallel.tp=1",
            "--actors", "8", "--set", "replay.min_fill=256",
            "--total-env-frames", "30000", "--wall-clock-limit", "180",
            "--device", "cuda"])
    finally:
        (BatchedInferenceServer.update_params, SequenceLearner.train_many,
         LoopbackTransport.send_experience, ApexDriver.__init__,
         ApexDriver.run, driver_mod.make_eval_policy_factory) = orig
    t_end = time.perf_counter()
    launches = {"gather_rows": fg.gather_rows.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]

    driver = seen.pop("driver")
    storage = driver.state.replay.storage
    replay_gb = sum(v.numel() * v.element_size()
                    for v in storage.values()) / 1e9
    server = out["server"]
    trained = calls["first_s"] is not None
    train_s = calls["last_s"] - calls["first_s"] if trained else 0.0
    fill_s = (calls["first_s"] if trained else t_end) - calls["run_s"]
    f0 = calls["frames_at_first"]
    f1 = calls["frames_at_last"] - f0
    loss = calls["loss"].item() if calls["loss"] is not None else math.nan
    ev = out["eval"] or {}
    log(f"r2d2: `--config r2d2 --set parallel.dp=1 --set parallel.tp=1 "
        f"--actors 8 --set replay.min_fill=256 --total-env-frames 30000 "
        f"--wall-clock-limit 180 --device cuda`: LSTM {net.lstm_size} over "
        f"the Nature-CNN torso, dueling, bf16, sequences of "
        f"{rep.seq_length} (burn-in {rep.burn_in}), batch {ln.batch_size}, "
        f"K={k}; 8 recurrent vector actors x {cfg.actors.envs_per_actor} "
        f"{cfg.env.kind} envs; frame-mode prioritized replay of "
        f"{driver.replay.capacity} sequences = {replay_gb:.2f} GB; "
        f"frames={out['frames']} frames/s={out['frames'] / wall:.1f} over "
        f"the run, {f0 / max(fill_s, 1e-9):.1f} before min_fill "
        f"({f0} frames in {fill_s:.2f} s) and {f1 / max(train_s, 1e-9):.1f} "
        f"in the training window ({f1} frames); "
        f"grad_steps={out['grad_steps']} in {calls['train_many']} "
        f"train_many calls ({calls['macro']} macro-steps), "
        f"grad-steps/s={out['grad_steps'] / max(train_s, 1e-9):.2f} over "
        f"the training window ({train_s:.2f} s); last loss {loss:.6f}; "
        f"server batches={server['batches']} items={server['items']} "
        f"avg_batch={server['avg_batch']:.2f}; ingest_dropped="
        f"{out['ingest_dropped']}; publications={calls['publications']}; "
        f"launches={launches}; peak_mem_gb={peak_gb:.2f}; episodes="
        f"{out['episodes']} avg_return={out['avg_return']:.3f}; eval="
        f"{json.dumps(ev)} ({calls['policy_queries']} recurrent policy "
        f"queries); summary={json.dumps(out)}; {wall:.2f} s")
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(not left, f"driver threads still running after the run: {left}")
    check(out["grad_steps"] > 0 and math.isfinite(loss),
          f"grad_steps {out['grad_steps']}, last loss {loss}")
    check(out["grad_steps"] == k * calls["macro"] + calls["singles"],
          f"grad_steps {out['grad_steps']} != the train_many calls' "
          f"{calls['macro']} macro-steps + {calls['singles']} singles")
    want = calls["macro"] + calls["singles"]
    check(launches["gather_rows"] == want,
          f"gather_rows launched {launches['gather_rows']} times, expected "
          f"{want} (1 per draw: {calls['macro']} macro-steps, "
          f"{calls['singles']} singles)")
    check(calls["publications"] >= 1, "no param publication reached the "
          "inference server")
    check(ev.get("episodes", 0) > 0 and calls["policy_queries"] > 0,
          f"the final eval did not run the recurrent policy: {ev}, "
          f"{calls['policy_queries']} queries")

    # the first shipped sequence, read back from replay slot 0
    check(first and "seq_frames" in first[0], "no sequence shipped")
    seq = first.pop()
    frames = seq["seq_frames"][0]
    got = storage["seq_frames"][0, :frames.size].reshape(frames.shape)
    check(torch.equal(got.cpu(), torch.from_numpy(frames)),
          "replay slot 0 frames != the shipped sequence")
    for key in ("actions", "rewards", "terminals", "mask", "init_c",
                "init_h"):
        check(torch.equal(storage[key][0].cpu(),
                          torch.from_numpy(seq[key][0])),
              f"replay slot 0 {key} != the shipped sequence")
    log("r2d2: the first shipped sequence read back from replay slot 0 "
        "bitwise (single frames and fields)")
    # the learner alone on the run's replay (outside the counted run):
    # host clock over R2D2_ALONE macro-steps after one warm-up, then the
    # profiler's device busy share and launches per macro-step
    learner, state = driver.learner, driver.state
    state, _ = learner.train_step_k(state, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(R2D2_ALONE):
        state, _ = learner.train_step_k(state, k)
    torch.cuda.synchronize()
    alone = R2D2_ALONE * k / (time.perf_counter() - t0)
    log(f"r2d2: the learner alone after the run: grad-steps/s={alone:.2f} "
        f"(host clock over {R2D2_ALONE} train_step_k after 1 warm-up)")
    log(profile_macro_steps(learner, state, k, PROFILE_STEPS))
    del driver, storage, got, seq, learner, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_pong_single_process(seed: int) -> dict:
    """The pong preset through the CLI with the double-buffered sampler,
    at full width over a 2^20-slot flat prioritized replay. sample_k and
    learn_k are wrapped to count their calls (and to keep the learner
    and its state for the check after the run). -> the launch counts of
    this run."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.envs.atari import atari_backend
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.runtime.learner import DQNLearner

    cfg = get_config("pong")
    k, b = cfg.learner.sample_chunk, cfg.learner.batch_size
    check(k == 4 and b == 512 and cfg.network.compute_dtype == "bfloat16"
          and cfg.replay.min_fill == 20_000, "pong preset drift")
    calls = {"sample_k": 0, "learn_k": 0, "first_s": None}
    seen = {}
    orig_sample_k, orig_learn_k = DQNLearner.sample_k, DQNLearner.learn_k

    def sample_k(self, state, k_, noise=None):
        if calls["first_s"] is None:
            calls["first_s"] = time.perf_counter()
        calls["sample_k"] += 1
        seen["learner"], seen["state"] = self, state
        return orig_sample_k(self, state, k_, noise)

    def learn_k(self, state, sample, k_):
        calls["learn_k"] += 1
        return orig_learn_k(self, state, sample, k_)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DQNLearner.sample_k, DQNLearner.learn_k = sample_k, learn_k
    fg.gather_rows.launches = 0       # count the main path's run only
    try:
        out, wall = run_cli([
            "--config", "pong", "--single-process", "--seed", str(seed),
            "--total-env-frames", "24000",
            "--set", "learner.sample_prefetch=True", "--device", "cuda"])
    finally:
        DQNLearner.sample_k, DQNLearner.learn_k = orig_sample_k, orig_learn_k
    t_end = time.perf_counter()
    launches = {"gather_rows": fg.gather_rows.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(math.isfinite(out["final_loss"]), f"loss {out['final_loss']}")
    check(calls["learn_k"] > 0 and calls["sample_k"] == calls["learn_k"] + 1,
          f"sample_k {calls['sample_k']} calls vs learn_k "
          f"{calls['learn_k']}: expected one prologue draw more")
    check(out["grad_steps"] == k * calls["learn_k"],
          f"grad_steps {out['grad_steps']} != K x {calls['learn_k']} "
          f"macro-steps")
    check(launches["gather_rows"] == 2 * calls["sample_k"],
          f"gather_rows launched {launches['gather_rows']} times, expected "
          f"2 per sample_k call ({calls['sample_k']} calls)")

    # one drawn sample (outside the counted run): kernel vs plain
    learner, state = seen.pop("learner"), seen.pop("state")
    replay = learner.replay
    storage = state.replay.storage
    check(replay.capacity == 1 << 20 and storage["obs"].shape[1] == 28288,
          f"replay {replay.capacity} x {tuple(storage['obs'].shape)}")
    ring_gb = sum(v.numel() * v.element_size()
                  for v in storage.values()) / 1e9
    items_k, idx_k, _, _ = learner.sample_k(state, k)
    torch.cuda.synchronize()
    idx = idx_k.reshape(-1)
    for key in ("obs", "next_obs"):
        want = fg.gather_rows_reference(storage[key], idx)
        want = want[:, :84 * 84 * 4].reshape(-1, 84, 84, 4)
        got = items_k[key].reshape(-1, 84, 84, 4)
        check(torch.equal(got, want), f"sampled {key}: kernel != plain")
    train_s = t_end - calls["first_s"]
    log(f"pong-sp: `--config pong --single-process --total-env-frames "
        f"24000 --set learner.sample_prefetch=True --device cuda`: "
        f"dueling Nature-CNN bf16, 84x84x4 uint8, "
        f"{cfg.env.kind}/{atari_backend(cfg.env.kind)} backend, batch {b}, "
        f"K={k} with prefetch; flat prioritized replay of "
        f"{replay.capacity} slots = {ring_gb:.2f} GB (obs + next_obs "
        f"packed rows of 28288 B); summary={json.dumps(out)}; "
        f"{calls['sample_k']} sample_k (1 prologue) + {calls['learn_k']} "
        f"learn_k calls; launches={launches}; frames/s="
        f"{out['frames'] / wall:.1f} grad-steps/s="
        f"{out['grad_steps'] / wall:.2f} over the whole run; training "
        f"window (first sample_k to the end, {train_s:.2f} s): "
        f"grad-steps/s={out['grad_steps'] / train_s:.2f}; "
        f"peak_mem_gb={peak_gb:.2f}; one drawn sample's obs/next_obs "
        f"bitwise equal to plain; {wall:.2f} s")
    del learner, state, replay, storage, items_k
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build (set-up time)
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    build_s = fg.build()
    log(f"build: frame_gather.cu with nvcc for sm_90a in {build_s:.2f} s")

    # 3. kernel vs plain at every call site's shape (four sites)
    sites = phase_kernel(dev, args.seed)
    # 4. small reference: card vs cpu
    t0 = time.perf_counter()
    phase_reference(dev, args.seed)
    log(f"reference: {time.perf_counter() - t0:.2f} s")
    # 5. the frame-ring learner
    t0 = time.perf_counter()
    ring = phase_main(dev, args.seed)
    log(f"main: {time.perf_counter() - t0:.2f} s")
    # 6. the Ape-X driver through the default CLI mode
    apex = phase_apex(args.seed)
    # 7. the R2D2 preset through the same driver
    t0 = time.perf_counter()
    r2d2 = phase_r2d2(args.seed)
    log(f"r2d2: {time.perf_counter() - t0:.2f} s")
    # 8. the single-process trainer learns cartpole on the card
    phase_cartpole()
    # 9. the single-process trainer at the pong preset's full size
    flat = phase_pong_single_process(args.seed)

    # one entry per kernel; its top-level numbers are the flat replay's
    # call site at its real size (flat_full), `sites` has all four
    sites[0]["launches"] = ring["gather_rows"]
    sites[0]["apex_launches"] = apex["gather_rows"]
    sites[1]["launches"] = sites[2]["launches"] = flat["gather_rows"]
    sites[3]["launches"] = r2d2["gather_rows"]
    for site in sites:
        check(site["launches"] > 0, f"gather_rows never launched on the "
              f"{site['site']} path")
    check(apex["gather_rows"] > 0, "gather_rows never launched on the apex "
          "path")
    top = sites[2]
    kern = {"name": "gather_rows", "route": "cuda",
            "source": "ape_x_dqn_tpu_torch/csrc/frame_gather.cu",
            "replaces": "ape_x_dqn_tpu/ops/frame_gather.py:46",
            "launches": top["launches"],
            "launches_by_path": {"main": ring["gather_rows"],
                                 "apex": apex["gather_rows"],
                                 "r2d2": r2d2["gather_rows"],
                                 "pong-sp": flat["gather_rows"]},
            "max_abs_err": max(s_["max_abs_err"] for s_ in sites),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"], "copy_ms": top["copy_ms"],
            "sites": sites}
    log(json.dumps({"kernels": [kern]}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
