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
             then K=4 macro-steps through train_step_k, which replays a
             captured CUDA graph after one eager warm-up call and one
             capture (each replay counts the gather launches it
             carries); kernel launch counts are zeroed just before and
             read just after; then the learner's rate eager and as a
             graph, and a torch.profiler pass of each: device busy
             share, kernels per macro-step and top kernels. Its 10.3 GB
             ring is freed before the next phases.
6. apex      `python -m ape_x_dqn_tpu_torch.runtime.train --config pong
             --total-env-frames 60000 --wall-clock-limit 120`, the
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
             the learner alone on the run's replay, eager and as a
             graph (host clock, and a torch.profiler pass of each); the
             driver freed after
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
10. dpg      `python -m ape_x_dqn_tpu_torch.runtime.train --config
             apex_dpg --set env.id=pendulum --actors 8 --set
             replay.min_fill=5000 --total-env-frames 60000
             --wall-clock-limit 90`: the Ape-X DPG preset at its width
             (actor and critic MLPs of 300/200, batch 256, a 2^20-slot
             prioritized replay) through the default CLI mode, on the
             native pendulum (no dm_control on the card's machine);
             frames/s before min_fill and in the training window,
             grad-steps/s in the window, drops, publications, peak
             memory, the final greedy eval, and the learner replaying
             its captured one-step graph; then the learner alone on the
             run's replay, eager and as a graph. There is no pixel leaf,
             so no gather site.
11. remote    the learner in this process through `python -m
             ape_x_dqn_tpu_torch.runtime.train --config pong --actors 0
             --listen 127.0.0.1:0 --set comm.shm=true --checkpoint-dir
             <tmp> --set checkpoint_every=32 --set
             learner.publish_every=16 --total-env-frames 60000
             --wall-clock-limit 150`, fed by two `python -m
             ape_x_dqn_tpu_torch.runtime.actor_host --config pong`
             processes on the card (4 vector actors x 16 envs each,
             actor offsets 0 and 4, 6,000 frames per actor: the apex
             phase's 8 x 16 fleet): host A over shared memory, host B
             over TCP (comm.shm=false on its side); frames from both
             hosts reach replay, both pull params past version 0, host
             A's shared-memory bytes > 0 and host B's 0; launch counts
             zeroed just before and read just after (two gather
             launches per draw, the graph replayed); frames/s, drops,
             host ms per ingest add (beside apex's), wire bytes per
             frame, param bytes per pull, publications and checkpoint
             saves; no driver thread and no /dev/shm segment left
12. resume   a second CLI run over the same checkpoint directory with the
             preset's 8 local vector actors (`--set replay.min_fill=2048
             --set learner.steps_per_frame_cap=None`, 16 grad-steps past
             the saved step): params, target params and Adam state equal
             the newest file bitwise before the first train call, the
             grad-step counter goes on from the saved step, the learner
             captures after the restore and replays
13. eval-only `--config pong --eval-only --checkpoint-dir <tmp> --games
             pong,breakout`: one summary with median_hns_synthetic (no
             ale_py on the card's machine) and no median_hns, the
             restored params the checkpoint's (CRC-32)
14. the kernels line, the card line, and the contract's last line.

It imports torch and the port only: no JAX, nothing of ape_x_dqn_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# H100 SXM published peak memory rate (NVIDIA data sheet), at 700 W
PEAK_BYTES_PER_S = 3.35e12
# main path: 2 warm-up (the eager warm-up and the capture) + 8 timed
# train_step_k calls, then macro-steps split into their two stages for
# CUDA-event stage times, then eager and graph rates and a
# torch.profiler pass of each (after the launch counts are read)
MACRO_STEPS = 10
STAGED_STEPS = 3
PROFILE_STEPS = 3
RATE_STEPS = 8
# r2d2: macro-steps of the learner alone after the driver's run
R2D2_ALONE = 4
# dpg: grad-steps of the learner alone after the driver's run
DPG_ALONE = 64
# the entry points' device (the CLI's and the actor hosts')
DEVICE = "cuda"
# remote: two actor hosts of 4 vector actors (the apex fleet's 8 x 16),
# 6,000 frames per actor (48,000 in all: ~76 grad-steps at the preset's
# 1.6e-3 per frame, so publications every 16 and checkpoints every 32
# grad-steps both happen)
REMOTE_HOST_ACTORS = 4
REMOTE_FRAMES_PER_ACTOR = 6000
REMOTE_WALL_S = 150
REMOTE_HOST_TIMEOUT_S = 120
REMOTE_SETS = ("comm.shm=true", "checkpoint_every=32",
               "learner.publish_every=16")
REMOTE_HOST_SETS: tuple[str, ...] = ()
# resume: grad-steps past the saved step; the replay is not saved, so
# the run refills a small min_fill, then trains at the preset's pace
# (a dispatch of 8 grad-steps starts while this run's steps are under
# 1.6e-3 x its frames: 16 steps take ~5,000 frames)
RESUME_MORE = 16
RESUME_WALL_S = 120
RESUME_SETS = ("replay.min_fill=2048",)
# eval-only: two games of the score table
EVAL_GAMES = "pong,breakout"
EVAL_SETS: tuple[str, ...] = ()


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


def learner_step(learner, state, k: int):
    """One macro-step (K > 1) or grad-step of the learner alone."""
    if k > 1:
        return learner.train_step_k(state, k)
    return learner.train_step(state)


def learner_rate(learner, state, k: int, n: int, capture: bool) -> float:
    """Grad-steps/s of the learner alone by the host clock over n calls
    after one untimed call (the eager warm-up, or with `capture` on and
    no graph yet, the capture), with its graphs (`capture`) or eager."""
    learner.capture = capture
    try:
        state, _ = learner_step(learner, state, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = learner_step(learner, state, k)
        torch.cuda.synchronize()
        return n * k / (time.perf_counter() - t0)
    finally:
        learner.capture = True


def profile_macro_steps(learner, state, k: int, n: int,
                        capture: bool) -> str:
    """n learner calls (macro-steps, or grad-steps at K=1) under
    torch.profiler, as captured graphs or eager: device busy share
    (kernel time over wall time), kernels per call and the kernels that
    take the most device time. The profiler's own host cost inflates
    the wall time, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    learner.capture = capture
    state, _ = learner_step(learner, state, k)   # not profiled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = learner_step(learner, state, k)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    learner.capture = True
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)

    busy_us = sum(dev_us(e) for e in kern)
    form = "graph" if capture else "eager"
    unit = "macro-step" if k > 1 else "grad-step"
    if not kern or busy_us <= 0:
        return (f"profile ({form}): no device time in the trace (not "
                f"measured)")
    top = sorted(kern, key=dev_us, reverse=True)[:12]
    rows = [{"kernel": e.key[:90], "count": e.count / n,
             "ms_per_call": round(dev_us(e) / n / 1e3, 4)} for e in top]
    return (f"profile ({form}): {n} {unit}s, wall "
            f"{wall_us / n / 1e3:.3f} ms/{unit} under the profiler, "
            f"device busy {busy_us / n / 1e3:.3f} ms/{unit} = "
            f"{busy_us / wall_us:.3f} of wall, "
            f"{sum(e.count for e in kern) / n:.0f} kernels per {unit}; "
            f"top by device time: {json.dumps(rows)}")


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
        sample = learner.sample_k(state, k)
        ev[1].record()
        state, m = learner.learn_k(state, sample, k)
        ev[2].record()
        torch.cuda.synchronize()
        sample_ms.append(ev[0].elapsed_time(ev[1]))
        learn_ms.append(ev[1].elapsed_time(ev[2]))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = {"gather_rows": fg.gather_rows.launches}

    loss_vals = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in loss_vals), f"loss {loss_vals}")
    check(len(set(loss_vals)) > 1, f"every call returned one loss "
          f"{loss_vals}: replayed metrics must be fresh copies")
    check(root1 != root0, "tree root unchanged by the write-backs")
    graph = learner.step_graphs()[("k", k)]
    check(graph.captured and graph.gathers == 2,
          f"the macro-step graph: captured {graph.captured}, "
          f"{graph.gathers} gather launches a replay (expected 2)")
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
        f"{MACRO_STEPS} train_step_k (a warm-up, a capture, then graph "
        f"replays) + {STAGED_STEPS} staged macro-steps (sample_k, learn_k: "
        f"eager); grad-steps/s={grad_steps_s:.2f} (host clock over "
        f"{MACRO_STEPS - warm} graph replays after the warm-up and the "
        f"capture); "
        f"sample_stage_ms={float(np.median(sample_ms)):.3f} "
        f"learn_stage_ms={float(np.median(learn_ms)):.3f} (CUDA events, "
        f"median of {STAGED_STEPS}); losses={[round(x, 5) for x in loss_vals]}"
        f"; root {root0:.3f} -> {root1:.3f}; launches={launches}; "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}; "
        f"gathered obs/next_obs bitwise equal to plain; diag={diag}")
    eager = learner_rate(learner, state, k, RATE_STEPS, capture=False)
    graphed = learner_rate(learner, state, k, RATE_STEPS, capture=True)
    log(f"main: the pong learner alone, grad-steps/s eager={eager:.2f} "
        f"graph={graphed:.2f} (host clock over {RATE_STEPS} macro-steps "
        f"each, after one untimed call; the same learner and replay)")
    log(profile_macro_steps(learner, state, k, PROFILE_STEPS, False))
    log(profile_macro_steps(learner, state, k, PROFILE_STEPS, True))
    # free the 10.3 GB ring before the flat replay's 59.3 GB
    del learner, state, replay, sample, frames, got, items
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_graphed(driver, key, gathers: int) -> None:
    """The driver's learner replayed its captured graph for `key`
    (carrying `gathers` gather launches a replay) and its actors ran
    without the learner-priority gate."""
    graph = driver.learner.step_graphs().get(key)
    check(driver.learner.graphed and graph is not None and graph.captured,
          f"the driver's learner did not replay a captured {key} graph")
    check(graph.gathers == gathers, f"the {key} graph carries "
          f"{graph.gathers} gather launches, expected {gathers}")
    check(not driver._gate_actors, "the actors were gated")


@contextlib.contextmanager
def timed_adds():
    """ApexDriver._ship_staged timed by the host clock around each call
    (the ingest thread's add: the host-to-device copies, the wait for
    _state_lock and the add's dispatch). Yields the list of seconds."""
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver

    orig = ApexDriver._ship_staged
    secs: list[float] = []

    def ship(self, views, g):
        t0 = time.perf_counter()
        out = orig(self, views, g)
        secs.append(time.perf_counter() - t0)
        return out

    ApexDriver._ship_staged = ship
    try:
        yield secs
    finally:
        ApexDriver._ship_staged = orig


def adds_summary(secs: list[float]) -> str:
    if not secs:
        return "adds: none"
    ms = np.asarray(secs) * 1e3
    return (f"adds: {len(ms)} calls, host ms median {np.median(ms):.2f} "
            f"p90 {np.percentile(ms, 90):.2f} max {ms.max():.2f}, "
            f"{ms.sum() / 1e3:.2f} s in all")


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
             "first_s": None, "last_s": None, "dropped_at_first": 0}
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
            calls["dropped_at_first"] = seen["driver"].transport.dropped
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
        with timed_adds() as adds:
            out, wall = run_cli([
                "--config", "pong", "--seed", str(seed),
                "--total-env-frames", "60000", "--wall-clock-limit", "120",
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
        f"--wall-clock-limit 120 --device cuda`: {cfg.actors.num_actors} "
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
        f"{out['ingest_dropped']} ({calls['dropped_at_first']} transport "
        f"batches before the first train dispatch); {adds_summary(adds)}; "
        f"publications={calls['publications']}; "
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
    check_graphed(driver, ("k", k), gathers=2)

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
        "bitwise (frames and fields); the learner replayed its captured "
        "macro-step graph with the actors ungated")
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
             "policy_queries": 0, "loss": None, "dropped_at_first": 0}
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
            calls["dropped_at_first"] = seen["driver"].transport.dropped
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
        with timed_adds() as adds:
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
        f"{out['ingest_dropped']} ({calls['dropped_at_first']} transport "
        f"batches before the first train dispatch); {adds_summary(adds)}; "
        f"publications={calls['publications']}; "
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
    check_graphed(driver, ("k", k), gathers=1)

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
    # the learner alone on the run's replay (outside the counted run),
    # eager and as a graph: host clock over R2D2_ALONE macro-steps after
    # one untimed call, then the profiler's device busy share and
    # kernels per macro-step
    learner, state = driver.learner, driver.state
    eager = learner_rate(learner, state, k, R2D2_ALONE, capture=False)
    graphed = learner_rate(learner, state, k, R2D2_ALONE, capture=True)
    log(f"r2d2: the learner alone after the run: grad-steps/s "
        f"eager={eager:.2f} graph={graphed:.2f} (host clock over "
        f"{R2D2_ALONE} train_step_k each, after one untimed call)")
    log(profile_macro_steps(learner, state, k, PROFILE_STEPS, False))
    log(profile_macro_steps(learner, state, k, PROFILE_STEPS, True))
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


def phase_dpg(seed: int) -> None:
    """The apex_dpg preset through the CLI's default mode on one card,
    at its width, on the native pendulum. Wrapped for the checks after
    the run: BatchedInferenceServer.update_params counts publications,
    DPGLearner.train_many stamps the training window, counts grad-steps
    and keeps the last losses, ApexDriver.run stamps the run's start and
    ApexDriver.__init__ keeps the driver."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.parallel.inference_server import (
        BatchedInferenceServer)
    from ape_x_dqn_tpu_torch.runtime.dpg_learner import DPGLearner
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver

    cfg = get_config("apex_dpg")
    net, rep, ln = cfg.network, cfg.replay, cfg.learner
    check(net.kind == "dpg" and tuple(net.dpg_hidden) == (300, 200)
          and net.compute_dtype == "float32" and rep.kind == "prioritized"
          and rep.capacity == 1_000_000 and ln.batch_size == 256
          and ln.n_step == 5 and ln.sample_chunk == 1
          and ln.steps_per_frame_cap is None
          and cfg.actors.num_actors == 32, "apex_dpg preset drift")
    calls = {"publications": 0, "train_many": 0, "grad_steps": 0,
             "first_s": None, "last_s": None, "run_s": None,
             "frames_at_first": 0, "frames_at_last": 0, "losses": None,
             "dropped_at_first": 0}
    seen: dict = {}
    orig = (BatchedInferenceServer.update_params, DPGLearner.train_many,
            ApexDriver.__init__, ApexDriver.run)

    def update_params(self, params, version):
        calls["publications"] += 1
        return orig[0](self, params, version)

    def train_many(self, state, n, noise=None):
        frames = seen["driver"]._frames_total
        if calls["first_s"] is None:
            calls["first_s"] = time.perf_counter()
            calls["frames_at_first"] = frames
            calls["dropped_at_first"] = seen["driver"].transport.dropped
        calls["frames_at_last"] = frames
        out = orig[1](self, state, n, noise)
        calls["last_s"] = time.perf_counter()
        calls["train_many"] += 1
        calls["grad_steps"] += n
        calls["losses"] = (out[1]["loss"], out[1]["policy_loss"])
        return out

    def driver_init(self, *a, **kw):
        orig[2](self, *a, **kw)
        seen["driver"] = self

    def driver_run(self, *a, **kw):
        calls["run_s"] = time.perf_counter()
        return orig[3](self, *a, **kw)

    argv = ["--config", "apex_dpg", "--seed", str(seed),
            "--set", "env.id=pendulum", "--actors", "8",
            "--set", "replay.min_fill=5000", "--total-env-frames", "60000",
            "--wall-clock-limit", "90", "--device", "cuda"]
    threads_before = {t.ident for t in threading.enumerate()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (BatchedInferenceServer.update_params, DPGLearner.train_many,
     ApexDriver.__init__, ApexDriver.run) = (
        update_params, train_many, driver_init, driver_run)
    try:
        with timed_adds() as adds:
            out, wall = run_cli(argv)
    finally:
        (BatchedInferenceServer.update_params, DPGLearner.train_many,
         ApexDriver.__init__, ApexDriver.run) = orig
    t_end = time.perf_counter()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    driver = seen.pop("driver")
    trained = calls["first_s"] is not None
    train_s = calls["last_s"] - calls["first_s"] if trained else 0.0
    fill_s = (calls["first_s"] if trained else t_end) - calls["run_s"]
    f0 = calls["frames_at_first"]
    f1 = calls["frames_at_last"] - f0
    losses = ([x.item() for x in calls["losses"]]
              if calls["losses"] is not None else [math.nan, math.nan])
    ev = out["eval"] or {}
    server = out["server"]
    log(f"dpg: `{' '.join(argv)}`: actor and critic MLPs "
        f"{tuple(net.dpg_hidden)} float32, batch {ln.batch_size}, n-step "
        f"{ln.n_step}, tau {ln.tau}; 8 actors (the preset has "
        f"{cfg.actors.num_actors}) x {cfg.actors.envs_per_actor} native "
        f"pendulum env; prioritized replay of {driver.replay.capacity} "
        f"slots; frames={out['frames']} frames/s="
        f"{out['frames'] / wall:.1f} over the run, "
        f"{f0 / max(fill_s, 1e-9):.1f} before min_fill ({f0} frames in "
        f"{fill_s:.2f} s) and {f1 / max(train_s, 1e-9):.1f} in the "
        f"training window ({f1} frames); grad_steps={out['grad_steps']} "
        f"in {calls['train_many']} train_many calls, grad-steps/s="
        f"{out['grad_steps'] / max(train_s, 1e-9):.2f} over the training "
        f"window ({train_s:.2f} s); last critic/policy loss "
        f"{losses[0]:.6f}/{losses[1]:.6f}; server "
        f"batches={server['batches']} items={server['items']} "
        f"avg_batch={server['avg_batch']:.2f}; ingest_dropped="
        f"{out['ingest_dropped']} ({calls['dropped_at_first']} transport "
        f"batches before the first train dispatch); {adds_summary(adds)}; "
        f"publications={calls['publications']}; "
        f"peak_mem_gb={peak_gb:.2f}; episodes={out['episodes']} "
        f"avg_return={out['avg_return']:.3f}; eval={json.dumps(ev)}; "
        f"summary={json.dumps(out)}; {wall:.2f} s")
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(not left, f"driver threads still running after the run: {left}")
    check(out["grad_steps"] > 0 and out["grad_steps"] == calls["grad_steps"]
          and all(math.isfinite(x) for x in losses),
          f"grad_steps {out['grad_steps']} ({calls['grad_steps']} through "
          f"train_many), last losses {losses}")
    check(calls["publications"] >= 1, "no param publication reached the "
          "inference server")
    check(driver.replay.capacity == 1 << 20,
          f"replay capacity {driver.replay.capacity}")
    check(ev.get("episodes", 0) > 0 and math.isfinite(ev["mean_return"]),
          f"the final eval did not run: {ev}")
    check_graphed(driver, "step", gathers=0)
    learner, state = driver.learner, driver.state
    eager = learner_rate(learner, state, 1, DPG_ALONE, capture=False)
    graphed = learner_rate(learner, state, 1, DPG_ALONE, capture=True)
    log(f"dpg: the learner alone after the run: grad-steps/s "
        f"eager={eager:.2f} graph={graphed:.2f} (host clock over "
        f"{DPG_ALONE} train_step each, after one untimed call)")
    log(profile_macro_steps(learner, state, 1, DPG_ALONE // 4, False))
    log(profile_macro_steps(learner, state, 1, DPG_ALONE // 4, True))
    del driver, learner, state
    gc.collect()
    torch.cuda.empty_cache()


def shm_left(names: set[str]) -> list[str]:
    """Those of the shared-memory segments `names` still in /dev/shm."""
    return sorted(n for n in names
                  if os.path.exists(os.path.join("/dev/shm", n.lstrip("/"))))


def spawn_actor_host(port: int, offset: int, shm: bool,
                     sets: tuple[str, ...]) -> subprocess.Popen:
    """One `python -m ape_x_dqn_tpu_torch.runtime.actor_host` process:
    REMOTE_HOST_ACTORS vector actors of the pong preset's 16 envs at
    global actor indices [offset, offset + REMOTE_HOST_ACTORS), its own
    inference server on the card, comm.shm as asked."""
    argv = [sys.executable, "-m", "ape_x_dqn_tpu_torch.runtime.actor_host",
            "--config", "pong", "--connect", f"127.0.0.1:{port}",
            "--actors", str(REMOTE_HOST_ACTORS), "--actor-offset",
            str(offset), "--frames-per-actor", str(REMOTE_FRAMES_PER_ACTOR),
            "--device", DEVICE, "--set", f"comm.shm={str(shm).lower()}"]
    for s in sets:
        argv += ["--set", s]
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def host_result(proc: subprocess.Popen, name: str) -> dict:
    try:
        out, err = proc.communicate(timeout=REMOTE_HOST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise RuntimeError(f"check failed: actor host {name} did not end "
                           f"within {REMOTE_HOST_TIMEOUT_S} s: "
                           f"{err[-2000:]}")
    check(proc.returncode == 0,
          f"actor host {name} exited {proc.returncode}: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_remote(seed: int, ckpt_dir: str) -> dict:
    """The learner in this process through the CLI with `--listen` and no
    local actors, fed by two actor-host processes on the card: host A
    over shared memory, host B over TCP (comm.shm=false on its side).
    Wrapped: SocketIngestServer.__init__ starts the hosts once the port
    is bound, the shared-memory ring, the param area and the hosts'
    namespace probes record their segments' names (the leak check
    looks at those alone), DQNLearner.train_many counts macro-steps and stamps the
    training window, BatchedInferenceServer.update_params counts
    publications, ApexDriver.__init__ keeps the driver. -> the launch
    counts of this run and the checkpoint step it left."""
    from ape_x_dqn_tpu_torch.comm import native as comm_native
    from ape_x_dqn_tpu_torch.comm import shm_transport
    from ape_x_dqn_tpu_torch.comm.param_codec import ParamBlobProvider
    from ape_x_dqn_tpu_torch.comm.socket_transport import SocketIngestServer
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.parallel.inference_server import (
        BatchedInferenceServer)
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
    from ape_x_dqn_tpu_torch.runtime.learner import DQNLearner

    check(comm_native.available(), "the native framing codec did not "
          "build: the remote phase must run the native wire path")
    k = 4
    calls = {"publications": 0, "train_many": 0, "macro": 0, "singles": 0,
             "first_s": None, "last_s": None, "dropped_at_first": 0,
             "frames_at_first": 0, "run_s": None}
    seen: dict = {}
    hosts: dict[str, subprocess.Popen] = {}
    orig = (SocketIngestServer.__init__, DQNLearner.train_many,
            BatchedInferenceServer.update_params, ApexDriver.__init__,
            ApexDriver.run)
    orig_shm = (shm_transport.ShmRingServer.__init__,
                shm_transport.ShmParamArea.__init__,
                shm_transport.check_probe)
    segs: dict[str, set[str]] = {"ring": set(), "params": set(),
                                 "probe": set()}

    def ring_init(self, *a, **kw):
        orig_shm[0](self, *a, **kw)
        segs["ring"].add(self.name)

    def area_init(self, *a, **kw):
        orig_shm[1](self, *a, **kw)
        segs["params"].add(self.name)

    def check_probe(name, *a, **kw):
        segs["probe"].add(str(name))
        return orig_shm[2](name, *a, **kw)

    def server_init(self, *a, **kw):
        orig[0](self, *a, **kw)
        hosts["A"] = spawn_actor_host(self.port, 0, True, REMOTE_HOST_SETS)
        hosts["B"] = spawn_actor_host(self.port, REMOTE_HOST_ACTORS, False,
                                      REMOTE_HOST_SETS)

    def train_many(self, state, n, noise=None):
        if calls["first_s"] is None:
            calls["first_s"] = time.perf_counter()
            calls["dropped_at_first"] = seen["driver"].transport.dropped
            calls["frames_at_first"] = seen["driver"]._frames_total
        out = orig[1](self, state, n, noise)
        calls["last_s"] = time.perf_counter()
        calls["train_many"] += 1
        calls["macro"] += n // k
        calls["singles"] += n % k
        return out

    def update_params(self, params, version):
        calls["publications"] += 1
        return orig[2](self, params, version)

    def driver_init(self, *a, **kw):
        orig[3](self, *a, **kw)
        seen["driver"] = self

    def driver_run(self, *a, **kw):
        calls["run_s"] = time.perf_counter()
        return orig[4](self, *a, **kw)

    argv = ["--config", "pong", "--seed", str(seed), "--actors", "0",
            "--listen", "127.0.0.1:0", "--checkpoint-dir", ckpt_dir,
            "--total-env-frames", "60000", "--wall-clock-limit",
            str(REMOTE_WALL_S), "--device", DEVICE]
    for s in REMOTE_SETS:
        argv += ["--set", s]
    threads_before = {t.ident for t in threading.enumerate()}
    torch.cuda.synchronize()
    (shm_transport.ShmRingServer.__init__,
     shm_transport.ShmParamArea.__init__,
     shm_transport.check_probe) = (ring_init, area_init, check_probe)
    (SocketIngestServer.__init__, DQNLearner.train_many,
     BatchedInferenceServer.update_params, ApexDriver.__init__,
     ApexDriver.run) = (server_init, train_many, update_params,
                        driver_init, driver_run)
    fg.gather_rows.launches = 0       # count the main path's run only
    try:
        with timed_adds() as adds:
            out, wall = run_cli(argv)
        hout = {name: host_result(p, name) for name, p in hosts.items()}
    finally:
        (SocketIngestServer.__init__, DQNLearner.train_many,
         BatchedInferenceServer.update_params, ApexDriver.__init__,
         ApexDriver.run) = orig
        (shm_transport.ShmRingServer.__init__,
         shm_transport.ShmParamArea.__init__,
         shm_transport.check_probe) = orig_shm
        for p in hosts.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    launches = {"gather_rows": fg.gather_rows.launches}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    segs_left = shm_left(set().union(*segs.values()))
    driver = seen.pop("driver")
    wire = out["wire"]
    by_actor = {int(a): n for a, n in out["frames_by_actor"].items()}
    frames_a = sum(n for a, n in by_actor.items() if a < REMOTE_HOST_ACTORS)
    frames_b = sum(n for a, n in by_actor.items() if a >= REMOTE_HOST_ACTORS)
    train_s = (calls["last_s"] - calls["first_s"]
               if calls["first_s"] is not None else 0.0)
    fill_fps = (calls["frames_at_first"]
                / max((calls["first_s"] or 0.0) - calls["run_s"], 1e-9))
    # what one pull would cost as a full, coded and raw, for the
    # run's final params (the denominator of host B's bytes per pull)
    prov = ParamBlobProvider("bfloat16", "delta-q8")
    prov.publish({key: v.detach().cpu().numpy() for key, v in
                  driver.learner.publish_params(driver.state).items()}, 0)
    full_coded = len(prov.coded_reply(-1, -1, 0)[0])
    full_raw = len(prov.versioned_reply(-1, -1, 0)[0])
    a, b = hout["A"], hout["B"]
    # host B's pulls after its first (full) one: deltas and
    # header-only "unchanged" replies
    b_pulls = max(b["param_pulls_applied"], 1)
    b_delta = b["param_bytes_in"] - b["param_bytes_bootstrap"]
    log(f"remote: `{' '.join(argv)}` with two actor hosts of "
        f"{REMOTE_HOST_ACTORS} vector actors x 16 envs each on the card "
        f"(`--frames-per-actor {REMOTE_FRAMES_PER_ACTOR}`; host A "
        f"comm.shm=true, host B comm.shm=false); frames={out['frames']} "
        f"(host A {frames_a}, host B {frames_b}) frames/s reaching replay="
        f"{out['frames'] / wall:.1f} over the run, "
        f"{fill_fps:.1f} before the first train dispatch; grad_steps={out['grad_steps']} "
        f"in {calls['train_many']} train_many calls ({calls['macro']} "
        f"macro-steps) over {train_s:.2f} s; ingest_dropped="
        f"{out['ingest_dropped']} ({calls['dropped_at_first']} transport "
        f"batches before the first train dispatch); {adds_summary(adds)}; "
        f"wire: host B {b['bytes_out']} B on TCP for {b['frames']} "
        f"frames ({b['bytes_out'] / max(b['frames'], 1):.1f} B/frame, "
        f"codec ratio {b['wire_compression_ratio']:.3f}), host A "
        f"{a['shm_bytes_out']} B through {a['shm_posts']} shared-memory "
        f"slots and {a['bytes_out']} B in {a['shm_fallbacks']} TCP "
        f"fallbacks for {a['frames']} frames "
        f"({(a['shm_bytes_out'] + a['bytes_out']) / max(a['frames'], 1):.1f}"
        f" B/frame); learner side: {wire['bytes_in']} B on TCP (decoded "
        f"{wire['raw_bytes_in']}), {wire['shm_bytes_in']} B in "
        f"{wire['shm_doorbells']} doorbells, {wire['shm_torn_slots']} torn; "
        f"params: host B "
        f"{b['param_bytes_bootstrap']} B in its first pull (a full), then "
        f"{b_delta} B for {b['param_pulls_applied']} applied pulls "
        f"({b_delta / b_pulls:.0f} B per pull, delta-q8, "
        f"{b['param_resyncs']} resyncs) against a full of {full_coded} B "
        f"coded / {full_raw} B raw; server param bytes out "
        f"{wire['param_bytes_out']} (uncoded "
        f"{wire['param_raw_bytes_out']}, ratio "
        f"{wire['param_compression_ratio']:.3f}); host A "
        f"{a['shm_param_reads']} seqlock param reads; last versions A "
        f"{a['last_param_version']} B {b['last_param_version']}; "
        f"publications={calls['publications']}; checkpoint saves="
        f"{out['checkpoint_saves']}; shared-memory segments made "
        f"{ {kind: len(v) for kind, v in segs.items()} }, "
        f"{len(segs_left)} left; launches={launches}; "
        f"host A={json.dumps(a)}; host B={json.dumps(b)}; "
        f"summary={json.dumps(out)}; {wall:.2f} s")
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(a["errors"] == [] and b["errors"] == [],
          f"actor host errors: A {a['errors']} B {b['errors']}")
    check(frames_a > 0 and frames_b > 0,
          f"frames from both hosts must reach replay: {by_actor}")
    check(a["last_param_version"] > 0 and b["last_param_version"] > 0,
          f"each host must pull params past version 0: A "
          f"{a['last_param_version']} B {b['last_param_version']}")
    check(a["shm_negotiated"] and a["shm_bytes_out"] > 0
          and wire["shm_bytes_in"] == a["shm_bytes_out"],
          f"host A's shared-memory bytes: {a}, the learner's {wire}")
    check(b["shm_bytes_out"] == 0 and b["shm_posts"] == 0,
          f"host B (comm.shm=false) used shared memory: {b}")
    check(out["grad_steps"] >= 32, f"grad_steps {out['grad_steps']} < 32")
    check(out["grad_steps"] == k * calls["macro"] + calls["singles"],
          f"grad_steps {out['grad_steps']} != the train_many calls' "
          f"{calls['macro']} macro-steps + {calls['singles']} singles")
    want = 2 * (calls["macro"] + calls["singles"])
    check(launches["gather_rows"] == want,
          f"gather_rows launched {launches['gather_rows']} times, expected "
          f"{want} (2 per draw)")
    check(calls["publications"] >= 1, "no param publication")
    check(out["checkpoint_saves"] >= 2, "fewer than two checkpoint saves")
    check_graphed(driver, ("k", k), gathers=2)
    check(not left, f"driver threads still running after the run: {left}")
    check(segs["ring"] and segs["probe"],
          f"host A's shared-memory ring and probe were not seen: {segs}")
    check(not segs_left, f"shared-memory segments left behind: {segs_left}")
    step = out["grad_steps"]
    del driver
    gc.collect()
    torch.cuda.empty_cache()
    return {**launches, "step": step}


def newest_checkpoint(ckpt_dir: str) -> tuple[int, dict]:
    from ape_x_dqn_tpu_torch.utils.checkpoint import CheckpointManager

    mngr = CheckpointManager(ckpt_dir)
    step = mngr.latest_step()
    check(step is not None, f"no checkpoint in {ckpt_dir}")
    return step, mngr.restore(step)


def phase_resume(seed: int, ckpt_dir: str, saved_step: int) -> dict:
    """A second CLI run over the remote phase's checkpoint directory,
    with the preset's 8 local vector actors, to RESUME_MORE grad-steps
    past the saved step. Wrapped: DQNLearner.train_many compares the
    learner's params, target params and Adam state with the newest
    checkpoint file, bitwise, before the first train call, and counts
    macro-steps; ApexDriver.__init__ keeps the driver. -> launch
    counts."""
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
    from ape_x_dqn_tpu_torch.runtime.learner import (DQNLearner,
                                                     checkpoint_tree)

    step, saved = newest_checkpoint(ckpt_dir)
    check(step == saved_step, f"newest checkpoint {step} != the remote "
          f"run's last grad-step {saved_step}")
    k = 4
    calls = {"train_many": 0, "macro": 0, "singles": 0, "compared": None,
             "restored_step": None}
    seen: dict = {}
    orig = (DQNLearner.train_many, ApexDriver.__init__)

    def compare(state) -> list[str]:
        live = checkpoint_tree(state)
        bad = []
        for part in ("params", "target_params"):
            for name, t in saved[part].items():
                if not torch.equal(live[part][name].detach().cpu(), t):
                    bad.append(f"{part}/{name}")
        opt = saved["opt_state"]
        if not torch.equal(live["opt_state"]["count"].cpu(), opt["count"]):
            bad.append("opt_state/count")
        for key in ("mu", "nu"):
            for i, (t, s) in enumerate(zip(live["opt_state"][key],
                                           opt[key])):
                if not torch.equal(t.cpu(), s):
                    bad.append(f"opt_state/{key}/{i}")
        return bad

    def train_many(self, state, n, noise=None):
        if calls["compared"] is None:
            calls["compared"] = compare(state)
            calls["captured_before"] = bool(self.step_graphs().get(
                ("k", k)) and self.step_graphs()[("k", k)].captured)
        out = orig[0](self, state, n, noise)
        calls["train_many"] += 1
        calls["macro"] += n // k
        calls["singles"] += n % k
        return out

    def driver_init(self, *a, **kw):
        orig[1](self, *a, **kw)
        seen["driver"] = self
        calls["restored_step"] = self._grad_steps_total

    argv = ["--config", "pong", "--seed", str(seed), "--checkpoint-dir",
            ckpt_dir, "--max-grad-steps", str(saved_step + RESUME_MORE),
            "--total-env-frames", "60000", "--wall-clock-limit",
            str(RESUME_WALL_S), "--device", DEVICE]
    for s in RESUME_SETS:
        argv += ["--set", s]
    threads_before = {t.ident for t in threading.enumerate()}
    (DQNLearner.train_many, ApexDriver.__init__) = (train_many, driver_init)
    fg.gather_rows.launches = 0
    try:
        out, wall = run_cli(argv)
    finally:
        (DQNLearner.train_many, ApexDriver.__init__) = orig
    launches = {"gather_rows": fg.gather_rows.launches}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    driver = seen.pop("driver")
    log(f"resume: `{' '.join(argv)}`: restored step "
        f"{calls['restored_step']} of {ckpt_dir}, params/target/Adam "
        f"bitwise equal to the file before the first train call "
        f"({'yes' if calls['compared'] == [] else calls['compared']}); "
        f"grad_steps={out['grad_steps']} ({out['grad_steps'] - saved_step} "
        f"after the restore, {calls['macro']} macro-steps); frames="
        f"{out['frames']}; ingest_dropped={out['ingest_dropped']}; "
        f"checkpoint saves={out['checkpoint_saves']}; launches={launches}; "
        f"summary={json.dumps(out)}; {wall:.2f} s")
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(calls["restored_step"] == saved_step,
          f"the driver resumed at {calls['restored_step']}, the file holds "
          f"{saved_step}")
    check(calls["compared"] == [], f"restored state differs from the "
          f"newest checkpoint: {calls['compared']}")
    check(not calls["captured_before"], "a graph was captured before the "
          "restore's first train call")
    check(out["grad_steps"] >= saved_step + RESUME_MORE,
          f"grad_steps {out['grad_steps']} did not go on from {saved_step}")
    lc = driver.cfg.learner
    cap, chunk = lc.steps_per_frame_cap, min(lc.train_chunk,
                                             lc.publish_every)
    check(cap is not None and out["grad_steps"] - saved_step
          <= cap * out["frames"] + chunk,
          f"the resumed run took {out['grad_steps'] - saved_step} "
          f"grad-steps for {out['frames']} frames, past the preset's pace "
          f"{cap}")
    want = 2 * (calls["macro"] + calls["singles"])
    check(launches["gather_rows"] == want,
          f"gather_rows launched {launches['gather_rows']} times, expected "
          f"{want} (2 per draw)")
    check_graphed(driver, ("k", k), gathers=2)
    step, _ = newest_checkpoint(ckpt_dir)
    check(step == out["grad_steps"], f"the resumed run's final checkpoint "
          f"is {step}, not {out['grad_steps']}")
    check(not left, f"driver threads still running after the run: {left}")
    del driver
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_eval_only(ckpt_dir: str) -> None:
    """`--eval-only` over the resumed run's checkpoint directory: the
    HNS suite harness on two games, through the restored params."""
    from ape_x_dqn_tpu_torch.runtime.evaluation import params_crc32

    step, saved = newest_checkpoint(ckpt_dir)
    argv = ["--config", "pong", "--eval-only", "--checkpoint-dir", ckpt_dir,
            "--games", EVAL_GAMES, "--device", DEVICE]
    for s in EVAL_SETS:
        argv += ["--set", s]
    out, wall = run_cli(argv)
    want_crc = params_crc32(saved["params"])
    log(f"eval-only: `{' '.join(argv)}`: restored step "
        f"{out['restored_step']}; scores={json.dumps(out['scores'])} "
        f"backends={json.dumps(out['backends'])} median_hns_synthetic="
        f"{out.get('median_hns_synthetic')}; params crc32 "
        f"{out['params_crc32']} (the file's {want_crc}); {wall:.2f} s")
    check(out["restored_step"] == step,
          f"restored step {out['restored_step']} != newest {step}")
    check("median_hns_synthetic" in out and "median_hns" not in out,
          f"expected median_hns_synthetic and no median_hns: {out}")
    check(set(out["scores"]) == set(EVAL_GAMES.split(",")),
          f"scores for {sorted(out['scores'])}")
    check(out["params_crc32"] == want_crc, "the params that played are not "
          "the checkpoint's")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    # 10. Ape-X DPG through the driver
    t0 = time.perf_counter()
    phase_dpg(args.seed)
    log(f"dpg: {time.perf_counter() - t0:.2f} s")
    # 11.-13. remote actor hosts, then resume and eval-only from the
    # checkpoints the remote run left
    ckpt_dir = tempfile.mkdtemp(prefix="apex-chip-smoke-ckpt-")
    try:
        t0 = time.perf_counter()
        remote = phase_remote(args.seed, ckpt_dir)
        log(f"remote: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        resume = phase_resume(args.seed, ckpt_dir, remote["step"])
        log(f"resume: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        phase_eval_only(ckpt_dir)
        log(f"eval-only: {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # one entry per kernel; its top-level numbers are the flat replay's
    # call site at its real size (flat_full), `sites` has all four
    sites[0]["launches"] = ring["gather_rows"]
    sites[0]["apex_launches"] = apex["gather_rows"]
    sites[1]["launches"] = sites[2]["launches"] = flat["gather_rows"]
    sites[3]["launches"] = r2d2["gather_rows"]
    for site in sites:
        check(site["launches"] > 0, f"gather_rows never launched on the "
              f"{site['site']} path")
    for path, counts in (("apex", apex), ("remote", remote),
                         ("resume", resume)):
        check(counts["gather_rows"] > 0, f"gather_rows never launched on "
              f"the {path} path")
    top = sites[2]
    kern = {"name": "gather_rows", "route": "cuda",
            "source": "ape_x_dqn_tpu_torch/csrc/frame_gather.cu",
            "replaces": "ape_x_dqn_tpu/ops/frame_gather.py:46",
            "launches": top["launches"],
            "launches_by_path": {"main": ring["gather_rows"],
                                 "apex": apex["gather_rows"],
                                 "r2d2": r2d2["gather_rows"],
                                 "pong-sp": flat["gather_rows"],
                                 "remote": remote["gather_rows"],
                                 "resume": resume["gather_rows"]},
            "max_abs_err": max(s_["max_abs_err"] for s_ in sites),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"], "copy_ms": top["copy_ms"],
            "sites": sites}
    log(f"total: {time.perf_counter() - t_start:.2f} s")
    log(json.dumps({"kernels": [kern]}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
