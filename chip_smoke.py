#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (ape_x_dqn_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed 0]

and on two or more cards, for the cards phase alone beside a one-card
atari57_apex run at the same depth (no contract line),

    python3 chip_smoke.py --cards-only

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
             full 65,536-row leaf of 38.39 GB; the dp-sharded learners'
             draws over all four shards' flat view: 8192 frame rows from
             atari57_apex's 2,883,584 and 256 sequences from r2d2's
             4 x 16,384; one rank of the multi-host learner's draw: 4096
             frame rows from two of those shards, 1,441,792 rows), with
             its time, the plain
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
             graph, the graph's rate with the enabled observability
             facade's stage windows on against off (interleaved), and a
             torch.profiler pass of each: device busy share, kernels per
             macro-step and top kernels. Its 10.3 GB ring is freed
             before the next phases.
6. apex      `python -m ape_x_dqn_tpu_torch.runtime.train --config pong
             --total-env-frames 40000 --wall-clock-limit 120`, the
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
             replay.min_fill=256 --total-env-frames 20000
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
             learner.sample_prefetch=True --set replay.min_fill=10000`
             for 12,000 frames: the
             dueling Nature-CNN at full width over a 2^20-slot flat
             prioritized replay (59.3 GB of packed pixel rows), K=4 with
             the double-buffered sampler; launch counts zeroed just
             before and read just after; two gather launches per
             sample_k call; one drawn sample bitwise vs plain
10. dpg      `python -m ape_x_dqn_tpu_torch.runtime.train --config
             apex_dpg --set env.id=pendulum --actors 8 --set
             replay.min_fill=5000 --total-env-frames 30000
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
             actor offsets 0 and 4, 4,000 frames per actor: the apex
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
14. obs      `--config pong --actors 4 --listen 127.0.0.1:0 --set
             obs.enabled=true --set obs.trace_path=<tmp>/trace.json --set
             obs.telemetry_every_s=1 --set remediation.mode=observe
             --profile-dir <tmp>/prof --metrics-file <tmp>/run.jsonl
             --total-env-frames 30000 --wall-clock-limit 90` beside one
             `actor_host --config pong` process (4 vector actors x 16
             envs over TCP, obs.enabled): the trace holds the ingest,
             learner and server threads' spans; the JSONL holds the
             sample-age and param-lag histograms, peer/<host>/...
             telemetry, graph_captures and the stage gauges in (0, 1];
             the profiler wrote its trace; the report prints its stage,
             staleness and roofline sections; a SIGUSR2 to this process
             mid-run left a blackbox-*.json and no handler; the run's
             HBM budget covers its measured peak; the gather launched
15. serve    the multi-tenant serving tier alone at the pong preset's
             width (the dueling Nature CNN on 84x84x4 uint8, bf16):
             eight tenants of one family, each from its own seed,
             classes [0,0,1,1,2,2,2,2], max_batch 64, vector requests of
             16: one mixed batch through the gathered forward, and one
             of 8 rows per tenant through the tier's TenantClients,
             against each tenant's plain forward (bf16, 1e-2, beside
             the least difference between two tenants on a row) and
             at least one gathered forward; closed-loop
             forwards/s of the single-tenant server and of the tier;
             an open-loop overload at twice the tier's rate, whose books
             close (offered == admitted + shed) with class 0 unshed.
             Then `--config pong --actors 4 --set
             serving.multi_tenant=true --set serving.default_class=0
             --set serving.queue_slo_items=128 --set
             remediation.mode=enforce --set obs.enabled=true
             --total-env-frames 25000
             --wall-clock-limit 90`, with a second tenant's open-loop
             load in class 2 for 15 s: a clean end, the learner's graph
             and the gather, the tenant's serve/<id>/ gauges in the
             summary and the JSONL, a set_backpressure action in the
             remediation record, gathered forwards in the driver
16. tiers    `--config pong --set replay.capacity=16384 --set
             replay.min_fill=8192 --set replay.cold_tier_capacity=16384
             --set replay.cold_tier_disk_dir=<tmp> --set
             replay.cold_tier_disk_capacity=262144 --total-env-frames
             60000 --wall-clock-limit 150` (8 vector actors x 16 envs):
             the door closure evicted == stored + dropped, evictions and
             recalls, disk spills and promotions, the hot ring exactly
             full with its host and device cursors equal, the evict and
             add_at graphs replayed, the gather launched; one region
             read by read_region through cold_pack and cold_unpack,
             restaged into a fresh ring on the card bitwise; host ms per
             swap and its split by part (the lock wait, the block's
             copy, the evict dispatch, the region's fetch and sync, the
             add_at dispatch, ColdStore.put), the compression ratio,
             cold against ring bytes per
             transition, frames/s against apex's
17. dist     the dp-sharded learners alone on their presets' own dp=4
             x tp=2 meshes of this card ([card] * 8, every shard on it):
             DistDQNLearner over atari57_apex's frame ring (batch 512,
             K=4, 4 shards of 524,288 transitions) and
             DistSequenceLearner over r2d2's replay (64 x 80, K=4, 4
             shards of 16,384 sequences): the graph against the eager
             body bitwise after 1 and 5 macro-steps, a dp=1 dist learner
             against the single-card learner (bf16, 3e-2), eager and
             graph grad-steps/s beside main's and r2d2's, the peak
             memory against the budget of four shards, shard_stats.
             Then both presets through ApexDriver on those meshes
             (atari57_apex: 8 actors x 16 envs, min_fill 20,000, 40,000
             frames, 120 s; r2d2: 8 actors, min_fill 256, 30,000
             frames, 180 s): a clean end, grad-steps, graph replays, the
             gather once per draw and side over all shards, the
             per-shard drop closure, replay_shards in lockstep,
             publications advancing; frames/s and host ms per add
             beside apex's and r2d2's
18. legacy   `--config pong --set replay.ingest_zero_copy=False --set
             actors.num_actors=4 --set replay.min_fill=2048
             --wall-clock-limit 20`: the legacy staging path (no stager)
             to a clean end, frames reaching replay, the learner
             training; host ms per flush's add
19. dist_cold the tiers: configuration at dp=2 through ApexDriver: at
             least one swap per shard, evicted == stored + dropped per
             shard, the swap graphs replayed
20. mh       the multi-host learner as two processes on this card over
             gloo, each through the CLI (`--coordinator 127.0.0.1:<free
             port> --num-processes 2 --process-id i`): mh_apex
             (atari57_apex at full width on its dp=4 x tp=2 mesh, two
             shards of 524,288 transitions a rank, 4 actors x 16 envs a
             rank, min_fill 20,000, 40,000 frames), mh_r2d2 (r2d2 the
             same way, two shards of 16,384 sequences a rank, min_fill
             256, 30,000 frames, 32 grad-steps) and mh_resume (pong at a
             small width, one shard a rank: 20 grad-steps into a
             checkpoint directory, then a second pair resumes at 20 and
             trains to 30). Before them this process frees its cache and
             prints what it still holds, before and after releasing
             cuBLAS's per-stream workspaces. Each pair: both ranks exit 0
             within MH_TIMEOUT_S (a rank that dies fails the phase), equal
             grad_steps, frames, loss and param CRC-32, each rank fed
             experience, exchanged once per SGD step, replayed its
             captured segments and add graph and launched the gather,
             under its memory budget on a card that holds both; printed:
             grad-steps/s in the training window beside dist:'s
             one-process rate, the exchange's ms and bytes per SGD step,
             each rank's peak beside its budget. The pairs pass
             `--device cuda:0`, so both ranks share card 0 (and gloo)
             however many cards are visible
21. mh_nccl  r2d2 at full width over NCCL, one rank per visible card,
             each through the CLI (`--coordinator ... --num-processes
             N`): on one card a world of one holding the whole dp=4 x
             tp=2 mesh; with two or more cards, also two ranks on two
             cards, and `dp_scaling_efficiency` (the two-rank
             grad-steps/s over twice the one-rank rate). 8 actors in
             all, min_fill 256, MH_NCCL_FRAMES frames, MH_NCCL_STEPS
             grad-steps. Checks: backend nccl, ONE captured graph per
             exchanged macro-step (no segments), the lockstep
             invariants, one exchange per SGD step of mh_r2d2's bytes,
             each rank's peak under its budget less NCCL's part; printed:
             grad-steps/s in the training window beside dist:'s
             one-process rate, the window's host seconds by part of the
             round loop, the gather launches. Before each run a probe
             (`nccl_probe`, spawned ranks at the same placement) makes
             the NCCL group and measures NCCL's memory outside the
             allocator across the communicator, one eager and one
             captured all-gather at r2d2's size (checked against the
             budget's NCCL part), and the collective's device time
             (CUDA events around calls queued behind a device sleep)
22. cards    the one-process mesh over distinct cards, where two or more
             are visible (on one card: `cards: skipped (1 card
             visible)`): (a) both presets' learners alone at full width
             on dp=4 x tp=2 spread over the cards ([c0, c1, c2, c3] * 2
             on four, [c0, c1] * 4 on two): the graphs against the
             eager bodies bitwise after 1 and CARDS_STEPS K=4
             macro-steps, against the stacked learner on card 0 from
             the same state (float32 without TF32, over the first
             macro-step: Adam's first moment, the metrics and the
             params' change within CARDS_REL_TOL, relative),
             grad-steps/s
             beside dist:'s, gather launches by card, graphs per
             macro-step, each card's peak against its budget; (b)
             `--config atari57_apex --set parallel.dp=<cards> --set
             parallel.tp=1` through the CLI on the default mesh (dp
             over the cards), (c) `--config r2d2 --set
             parallel.dp=<cards/2> --set parallel.tp=2` (tp across the
             cards, through the LSTM), each with dist_apex:'s and
             dist_r2d2:'s 8 actors, cut deeper (CARDS_APEX_FRAMES,
             CARDS_R2D2_FRAMES): a clean end, the summary's mesh block
             (graphs replayed, the gather on every owner, each card's
             peak under its budget), the window by part; (d) one batch of 64 through the
             single-policy server split over the cards against the
             one-card forward (bf16, 1e-2); and the gather at the CLI
             runs' per-card shapes, timed on the last card
23. the memory table (each preset's budget beside its measured peak and
             the card), the kernels line, the card line, and the
             contract's last line.

Every driver phase prints the ingest add's host ms (median, p90) and the
replays of its captured graphs by g (one graph per replay layout and g,
runtime/step_graph.py: AddGraph), and checks that they replayed.

It imports torch and the port only: no JAX, nothing of ape_x_dqn_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import signal
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
# pong-sp: frames of the single-process run at a cut min_fill; the first
# PONG_SP_MIN_FILL only fill the replay, then every frame trains (~2,000
# grad-steps)
PONG_SP_FRAMES = 12000
PONG_SP_MIN_FILL = 10000
# r2d2: the driver run's frame budget
R2D2_FRAMES = 20000
# dpg: grad-steps of the learner alone after the driver's run
DPG_ALONE = 64
# the entry points' device (the CLI's and the actor hosts')
DEVICE = "cuda"
# apex and dpg: the driver runs' frame budgets (apex trains ~64
# grad-steps at the preset's pace of 1.6e-3 a frame)
APEX_FRAMES = 40000
DPG_FRAMES = 30000
# remote: two actor hosts of 4 vector actors (the apex fleet's 8 x 16),
# 4,000 frames per actor (32,000 in all: ~51 grad-steps at the preset's
# 1.6e-3 per frame, so publications every 16 and checkpoints every 32
# grad-steps both happen)
REMOTE_HOST_ACTORS = 4
REMOTE_FRAMES_PER_ACTOR = 4000
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
# apex: the eager ingest add's host ms median and drops in the last run
# of this script before the add was captured (PERF.md section 5)
EAGER_ADD_MS = 320.32
EAGER_ADD_DROPS = 1608
# obs: 4 local vector actors beside one actor host of 4 (its actor
# offset follows the local ones), SIGUSR2 to this process mid-run
OBS_ACTORS = 4
OBS_FRAMES = 30000
OBS_WALL_S = 90
OBS_SIGNAL_AFTER_S = 30.0
OBS_SETS: tuple[str, ...] = ()
OBS_HOST_SETS: tuple[str, ...] = ("obs.enabled=true",)
# serve: the tier alone (8 tenants of the pong net, priority classes
# [0,0,1,1,2,2,2,2], max_batch 64, vector requests of 16), closed loop
# for SERVE_LOOP_S per server, then an open-loop overload at twice the
# tier's measured capacity for SERVE_OVERLOAD_S; then the pong driver
# with the tier (4 local vector actors, a small SLO line, remediation
# enforcing) and a second tenant's open-loop load of SERVE_FLOOD_ITEMS-
# item requests in class 2 for SERVE_FLOOD_S, from SERVE_FLOOD_AT_S into
# the run (two actor requests and one of its own fill a batch of 64, so
# the driver's tier runs gathered forwards too)
SERVE_CLASSES = (0, 0, 1, 1, 2, 2, 2, 2)
SERVE_VECTOR = 16
# a row against its tenant's plain forward, in bfloat16: the card's
# error was 9.8e-4 and a row of another tenant differs by ~0.17 (the
# phase prints both beside this limit)
SERVE_TOL = 1e-2
SERVE_LOOP_S = 4.0
SERVE_OVERLOAD_S = 4.0
SERVE_OVERLOAD_X = 2.0     # the open loop's rate over the measured one
SERVE_ACTORS = 4
SERVE_FRAMES = 25000
SERVE_WALL_S = 90
SERVE_SLO_ITEMS = 128
SERVE_FLOOD_AT_S = 20.0
SERVE_FLOOD_S = 15.0
SERVE_FLOOD_ITEMS = 32
SERVE_FLOOD_RATE = 1200.0  # requests per second
SERVE_SETS: tuple[str, ...] = ()
# tiers: the pong driver over a 16,384-transition ring with the RAM
# cold tier (16,384 transitions) and the disk rung (262,144)
TIERS_CAPACITY = 16384
TIERS_FRAMES = 60000
TIERS_WALL_S = 150
TIERS_SETS: tuple[str, ...] = ()
# frames/s of the driver phases, by phase (the tiers phase reads apex's),
# and the learners' rates alone (main_*, r2d2_*: the dist phase reads
# them); the ingest add's host ms median, by driver phase
RATES: dict[str, float] = {}
ADD_MS: dict[str, float] = {}
# dist: the dp-sharded learners alone on their presets' dp=4 x tp=2
# meshes of this card (graph vs eager bitwise after 1 and DIST_STEPS
# macro-steps; the fill: DIST_FILL_SEGS segments a shard on the frame
# ring, DIST_FILL_SEQS sequences a shard on r2d2's replay), then the
# drivers: atari57_apex cut as apex: is (8 actors x 16 envs, 40,000
# frames, 120 s; min_fill 20,000), r2d2 cut as r2d2: is (8 actors,
# min_fill 256, 30,000 frames, 180 s)
DIST_STEPS = 5
DIST_FILL_SEGS = 512
DIST_FILL_SEQS = 128
DIST_APEX_SETS = ("actors.num_actors=8", "replay.min_fill=20000")
DIST_APEX_FRAMES = 40000
DIST_APEX_WALL_S = 120
DIST_R2D2_SETS = ("actors.num_actors=8", "replay.min_fill=256")
DIST_R2D2_FRAMES = 30000
DIST_R2D2_WALL_S = 180
# legacy: pong with the legacy staging path, 4 actors, 20 s (a small
# min_fill so the learner trains, and the gather runs, in that time)
LEGACY_SETS = ("replay.ingest_zero_copy=False", "actors.num_actors=4",
               "replay.min_fill=2048")
LEGACY_WALL_S = 20
# dist_cold: the tiers: configuration at dp=2 (two shards of 8,192)
DIST_COLD_FRAMES = 30000
DIST_COLD_WALL_S = 90
# mh: the multi-host learner as two processes on this card over gloo,
# each launched through the CLI: atari57_apex and r2d2 on their own dp=4
# x tp=2 meshes, two shards a process (4 actors x 16 envs each, the 8
# of dist_apex: and dist_r2d2:); atari57_apex cut by frames as
# dist_apex: is, r2d2 by frames and grad-steps (multihost mode has no
# wall-clock limit); then the two-process checkpoint resume at a small
# width (pong with a small CNN, one shard a process, free-running);
# publications every 16 grad-steps, so each run publishes
MH_TIMEOUT_S = 420
MH_APEX_SETS = ("actors.num_actors=4", "replay.min_fill=20000",
                "learner.publish_every=16", "multihost_watchdog_s=120")
MH_APEX_FRAMES = 40000
MH_R2D2_SETS = ("actors.num_actors=4", "replay.min_fill=256",
                "learner.publish_every=16", "multihost_watchdog_s=120")
MH_R2D2_FRAMES = 30000
MH_R2D2_STEPS = 32
MH_RESUME_SETS = ("parallel.dp=2", "parallel.tp=1",
                  "network.cnn_channels=(8,16,16)", "network.torso_dense=32",
                  "learner.batch_size=64", "learner.steps_per_frame_cap=None",
                  "replay.capacity=65536", "replay.min_fill=2048",
                  "actors.num_actors=2", "learner.publish_every=16",
                  "multihost_watchdog_s=120")
MH_RESUME_STEPS = (20, 30)
# mh_nccl: r2d2 over NCCL, one rank per card (at most two), the 8
# actors of dist_r2d2: split over the ranks; cut by frames and
# grad-steps as mh_r2d2 is
MH_NCCL_SETS = ("replay.min_fill=256", "learner.publish_every=16",
                "multihost_watchdog_s=120")
MH_NCCL_ACTORS = 8
MH_NCCL_FRAMES = 30000
MH_NCCL_STEPS = 192
# nccl_probe: the device time of one all-gather from this many calls
# queued behind a device sleep of NCCL_SLEEP_CYCLES (about 100 ms at an
# H100's clock), so that the host's enqueue is not timed (a slow host
# took 11.2 ms to enqueue the 20 calls, past a 10.6 ms sleep)
NCCL_TIMED_CALLS = 20
NCCL_SLEEP_CYCLES = 200_000_000
NCCL_PROBE_TIMEOUT_S = 180
# cards: the one-process mesh over distinct cards (two or more visible):
# macro-steps of the learners alone, the CLI runs (8 actors as in
# dist_apex: and dist_r2d2:, cut deeper: atari57_apex to 24,000 frames
# with min_fill 10,000, r2d2 to 15,000 frames), and the split server's
# batch
CARDS_STEPS = 4
CARDS_APEX_SETS = ("actors.num_actors=8", "replay.min_fill=10000",
                   "learner.publish_every=16")
CARDS_APEX_FRAMES = 24000
CARDS_APEX_WALL_S = 60
CARDS_R2D2_FRAMES = 15000
CARDS_R2D2_WALL_S = 60
CARDS_SERVE_BATCH = 64
# cards (a) against the stacked learner, both in float32 with TF32 off,
# over the first macro-step (its four steps draw the same samples from
# the same trees), as ||x_cards - x_stacked|| / ||x_stacked||: Adam's
# first moment (the exchanged gradients' running mean), the scalar
# metrics and the params' change, each within CARDS_REL_TOL. Adam moves
# every param by about lr a step whatever its gradient, so the largest
# param difference cannot tell a fault from rounding; these can. On
# four H100s: the first moment 6.0e-5 (atari57_apex) and 1.4e-4 (r2d2,
# gradients summed over 80 LSTM steps), the metrics 1.4e-6 / 2.1e-6,
# the params' change 2.5e-5 / 3.5e-5; a learner left unchanged scores 1
# on the params' change and the first moment, one whose groups skip the
# exchange 0.70-0.75 (tests/test_torch_cards_cuda.py). Later draws
# sample a full-width replay through priorities that differ in their
# last bits, so a few samples move (the params' change 0.00533 after
# four macro-steps of atari57_apex): reported, not held.
CARDS_REL_TOL = 1e-3
# the bf16 tolerance of the CPU parity tests (tests/test_torch_models.py)
BF16_TOL = 3e-2
# the card's name and power limit (nvidia-smi), set by main and printed
# beside the serve and tiers phases' numbers
CARD = ""


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
    # the dp-sharded learners' draws: one launch per side (per draw)
    # over the shard-major flat view of all dp shards
    a57 = get_config("atari57_apex")
    dp = a57.parallel.dp
    shard = build_prioritized_replay(
        a57, pong_setup(dev)[1], next_pow2(a57.replay.capacity // dp), dev)
    dist_rows = dp * shard.S * shard.F
    check(dp == 4 and shard.capacity == 524_288 and dist_rows == 2_883_584,
          f"unexpected atari57_apex shards: dp {dp}, {shard.capacity} "
          f"slots, {dist_rows} rows")
    r2_dp = r2.parallel.dp
    r2_shard = next_pow2(r2.replay.capacity // r2_dp)
    check(r2_dp == 4 and r2_shard == 16_384, f"unexpected r2d2 shards: dp "
          f"{r2_dp}, {r2_shard} sequences")
    # the multi-host learner's per-process draw: two of atari57_apex's
    # four shards, half the indices
    mh_rows = (dp // 2) * shard.S * shard.F
    check(mh_rows == 1_441_792, f"unexpected mh rows {mh_rows}")
    return [kernel_site(dev, seed, "frame_ring", n_rows, row, m),
            kernel_site(dev, seed, "flat", 32768, flat_row, kb),
            kernel_site(dev, seed, "flat_full", capacity, flat_row, kb),
            kernel_site(dev, seed, "sequence", seq_cap, seq_row, seq_m),
            kernel_site(dev, seed, "dist_frame_ring", dist_rows, row, m),
            kernel_site(dev, seed, "dist_sequence", r2_dp * r2_shard,
                        seq_row, seq_m),
            kernel_site(dev, seed, "mh_frame_ring", mh_rows, row, m // 2)]


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


def windowed_rate(learner, state, k: int, n: int, obs) -> float:
    """`learner_rate` of the graphs with each call inside the enabled
    facade's train stage window (a CUDA event pair on the current
    stream), the windows read by one publish after the clock stops."""
    stream = torch.cuda.current_stream()
    state, _ = learner_step(learner, state, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        with obs.stage_window("train", k, stream=stream):
            state, _ = learner_step(learner, state, k)
    torch.cuda.synchronize()
    rate = n * k / (time.perf_counter() - t0)
    obs.publish(0)
    return rate


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
    RATES["main_eager"], RATES["main_graph"] = eager, graphed
    log(f"main: the pong learner alone, grad-steps/s eager={eager:.2f} "
        f"graph={graphed:.2f} (host clock over {RATE_STEPS} macro-steps "
        f"each, after one untimed call; the same learner and replay)")
    # the enabled facade's stage windows on against off, interleaved
    from ape_x_dqn_tpu_torch.configs import ObsConfig
    from ape_x_dqn_tpu_torch.obs.core import build_obs
    from ape_x_dqn_tpu_torch.utils.metrics import Metrics
    obs = build_obs(ObsConfig(enabled=True), Metrics())
    rates = {"off": [], "on": []}
    for _ in range(2):
        rates["off"].append(learner_rate(learner, state, k, RATE_STEPS,
                                         capture=True))
        rates["on"].append(windowed_rate(learner, state, k, RATE_STEPS,
                                         obs))
    dev_ms = obs.metrics.latest().get("gauge/device_ms_train")
    obs.close()
    check(dev_ms is not None and dev_ms > 0,
          f"the stage windows published no device time: {dev_ms}")
    log(f"main: the pong learner's graph, grad-steps/s with the enabled "
        f"facade's stage windows off={[round(r, 2) for r in rates['off']]}"
        f" on={[round(r, 2) for r in rates['on']]} (interleaved off, on, "
        f"off, on; {RATE_STEPS} macro-steps each); the windows' device "
        f"ms per macro-step (EWMA) {dev_ms:.3f}")
    log(profile_macro_steps(learner, state, k, PROFILE_STEPS, False))
    log(profile_macro_steps(learner, state, k, PROFILE_STEPS, True))
    # free the 10.3 GB ring before the next phases (the graph holds the
    # state it was captured on, and the learner and its graphs form a
    # cycle that only a collection frees)
    del learner, state, replay, sample, frames, got, items, graph, m
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_graphed(driver, key, gathers: int) -> None:
    """The driver's learner replayed its captured graph for `key`
    (carrying `gathers` gather launches a replay), its ingest adds
    replayed their captured graphs (one per g), and its actors ran
    without the learner-priority gate."""
    graph = driver.learner.step_graphs().get(key)
    check(driver.learner.graphed and graph is not None and graph.captured,
          f"the driver's learner did not replay a captured {key} graph")
    check(graph.gathers == gathers, f"the {key} graph carries "
          f"{graph.gathers} gather launches, expected {gathers}")
    check(not driver._gate_actors, "the actors were gated")
    adds = driver.learner.add_graphs()
    check(any(a.captured for a in adds.values())
          and sum(a.replays for a in adds.values()) > 0,
          f"the ingest adds replayed no captured graph: "
          f"{ {g: (a.captured, a.replays) for g, a in adds.items()} }")


# per phase: (the driver's HBM budget or None, peak allocated bytes)
MEMORY: dict[str, tuple] = {}


def note_memory(name: str, budget=None, base: int = 0) -> float:
    """Record the phase's peak allocated bytes (since its reset, less
    `base`, what was allocated before the phase began) beside its
    budget; -> the peak in GB."""
    peak = torch.cuda.max_memory_allocated() - base
    MEMORY[name] = (budget, peak)
    return peak / 1e9


@contextlib.contextmanager
def timed_parts():
    """Three parts of a driver's run timed by the host clock around each
    call: "add" (ApexDriver._ship_staged, the ingest thread's add: the
    host-to-device copies, the wait for _state_lock and the add's
    dispatch), "serve" (BatchedInferenceServer._forward, the serving
    thread's forward of one batch, its split over cards included) and
    "dispatch" (SingleChipLearner.train_many, the learner thread's
    dispatch of its steps, warm-up and captures included). Yields
    ({part: [seconds, ...]}, {part: [start, ...]})."""
    from ape_x_dqn_tpu_torch.parallel.inference_server import (
        BatchedInferenceServer)
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
    from ape_x_dqn_tpu_torch.runtime.learner import SingleChipLearner

    sites = {"add": (ApexDriver, "_ship_staged"),
             "serve": (BatchedInferenceServer, "_forward"),
             "dispatch": (SingleChipLearner, "train_many")}
    secs: dict[str, list] = {name: [] for name in sites}
    starts: dict[str, list] = {name: [] for name in sites}
    origs = {name: getattr(cls, attr) for name, (cls, attr) in sites.items()}

    def timed(name):
        orig = origs[name]

        def call(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(self, *args, **kwargs)
            finally:
                starts[name].append(t0)
                secs[name].append(time.perf_counter() - t0)
        return call

    for name, (cls, attr) in sites.items():
        setattr(cls, attr, timed(name))
    try:
        yield secs, starts
    finally:
        for name, (cls, attr) in sites.items():
            setattr(cls, attr, origs[name])


@contextlib.contextmanager
def timed_adds():
    """`timed_parts`' adds alone. Yields the list of seconds."""
    with timed_parts() as (secs, _):
        yield secs["add"]


def parts_summary(secs: dict, starts: dict, t0: float, wall: float) -> str:
    """Each part's host seconds and share of the run's wall seconds
    (the parts run on their own threads, so the shares may sum past
    1), and when the longest add started beside the first dispatch."""
    bits = [f"{name} {len(v)} calls {sum(v):.2f} s ({sum(v) / wall:.4f})"
            for name, v in secs.items()]
    line = "window by part: " + ", ".join(bits)
    if secs["add"] and secs["dispatch"]:
        i = int(np.argmax(secs["add"]))
        line += (f"; longest add {secs['add'][i] * 1e3:.1f} ms from "
                 f"{starts['add'][i] - t0:.2f} s, first dispatch "
                 f"{secs['dispatch'][0] * 1e3:.1f} ms from "
                 f"{starts['dispatch'][0] - t0:.2f} s")
    return line


def adds_summary(secs: list[float], out: dict) -> str:
    """The ingest adds' host times and the replays of their captured
    graphs (the run summary's add_graph_replays, by g)."""
    replays = out.get("add_graph_replays", {})
    if not secs:
        return f"adds: none, add graph replays {replays}"
    ms = np.asarray(secs) * 1e3
    return (f"adds: {len(ms)} calls, host ms median {np.median(ms):.2f} "
            f"p90 {np.percentile(ms, 90):.2f} max {ms.max():.2f}, "
            f"{ms.sum() / 1e3:.2f} s in all; add graph replays by g "
            f"{replays} ({sum(replays.values())} in all)")


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
                "--total-env-frames", str(APEX_FRAMES),
                "--wall-clock-limit", "120", "--device", "cuda"])
    finally:
        (BatchedInferenceServer.update_params, DQNLearner.train_many,
         LoopbackTransport.send_experience, ApexDriver.__init__) = orig
    launches = {"gather_rows": fg.gather_rows.launches}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    RATES["apex"] = out["frames"] / wall

    driver = seen.pop("driver")
    peak_gb = note_memory("pong", driver.hbm_budget)
    replay, st = driver.replay, driver.state.replay.storage
    server = out["server"]
    train_s = (calls["last_s"] - calls["first_s"]
               if calls["first_s"] is not None else 0.0)
    ev = out["eval"] or {}
    log(f"apex: `--config pong --total-env-frames {APEX_FRAMES} "
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
        f"batches before the first train dispatch); {adds_summary(adds, out)}; "
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
    ms = np.median(adds) * 1e3 if adds else math.nan
    ADD_MS["apex"] = ms
    log(f"apex: the ingest add as graph replays: host ms median {ms:.2f}, "
        f"{out['ingest_dropped']} dropped ({calls['dropped_at_first']} "
        f"before the first train dispatch); the eager add on this card "
        f"(PERF.md section 5, one call of this script, H100 at 700 W): "
        f"{EAGER_ADD_MS} ms median, {EAGER_ADD_DROPS} dropped")
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
                "--total-env-frames", str(R2D2_FRAMES),
                "--wall-clock-limit", "180", "--device", "cuda"])
    finally:
        (BatchedInferenceServer.update_params, SequenceLearner.train_many,
         LoopbackTransport.send_experience, ApexDriver.__init__,
         ApexDriver.run, driver_mod.make_eval_policy_factory) = orig
    t_end = time.perf_counter()
    launches = {"gather_rows": fg.gather_rows.launches}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]

    driver = seen.pop("driver")
    peak_gb = note_memory("r2d2", driver.hbm_budget)
    RATES["r2d2"] = out["frames"] / wall
    ADD_MS["r2d2"] = np.median(adds) * 1e3 if adds else math.nan
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
        f"--actors 8 --set replay.min_fill=256 --total-env-frames "
        f"{R2D2_FRAMES} "
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
        f"batches before the first train dispatch); {adds_summary(adds, out)}; "
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
    RATES["r2d2_eager"], RATES["r2d2_graph"] = eager, graphed
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
            "--total-env-frames", str(PONG_SP_FRAMES),
            "--set", f"replay.min_fill={PONG_SP_MIN_FILL}",
            "--set", "learner.sample_prefetch=True", "--device", "cuda"])
    finally:
        DQNLearner.sample_k, DQNLearner.learn_k = orig_sample_k, orig_learn_k
    t_end = time.perf_counter()
    launches = {"gather_rows": fg.gather_rows.launches}
    # the one-process trainer stores flat transitions: its budget is the
    # pong preset's over the flat layout
    from ape_x_dqn_tpu_torch.utils.hbm import run_budget
    net = seen["state"].net
    peak_gb = note_memory("pong-sp", run_budget(
        cfg.replace(replay=dataclasses.replace(cfg.replay, storage="flat")),
        (84, 84, 4), np.uint8,
        param_count=sum(p_.numel() for p_ in net.parameters())))

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
        f"{PONG_SP_FRAMES} --set replay.min_fill={PONG_SP_MIN_FILL} "
        f"--set learner.sample_prefetch=True --device "
        f"cuda`: "
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
            "--set", "replay.min_fill=5000", "--total-env-frames",
            str(DPG_FRAMES),
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
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    driver = seen.pop("driver")
    peak_gb = note_memory("apex_dpg", driver.hbm_budget)
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
        f"batches before the first train dispatch); {adds_summary(adds, out)}; "
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
        f"batches before the first train dispatch); {adds_summary(adds, out)}; "
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


def phase_obs(seed: int) -> dict:
    """The observability and operations planes on the pong preset, at
    full width and 2^20 capacity: the CLI in this process with 4 local
    vector actors, `--listen`, `obs.enabled`, a span trace, telemetry
    every second, the remediation engine observing, a torch.profiler
    window and a JSONL, beside one actor-host process of 4 vector actors
    x 16 envs over TCP with obs enabled. A timer sends SIGUSR2 to this
    process during the run. Checks the trace, the JSONL's instruments,
    the profiler's trace, the report, the flight recorder's dump, the
    HBM budget against the measured peak, and the gather's launches.
    -> the launch counts of this run."""
    import signal

    from ape_x_dqn_tpu_torch.comm.socket_transport import SocketIngestServer
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver

    tmp = tempfile.mkdtemp(prefix="apex-chip-smoke-obs-")
    trace, jsonl = os.path.join(tmp, "trace.json"), os.path.join(tmp,
                                                                 "run.jsonl")
    prof = os.path.join(tmp, "prof")
    seen: dict = {}
    hosts: dict[str, subprocess.Popen] = {}
    orig = (SocketIngestServer.__init__, ApexDriver.__init__,
            ApexDriver.run)
    handler_before = signal.getsignal(signal.SIGUSR2)

    def server_init(self, *a, **kw):
        orig[0](self, *a, **kw)
        hosts["A"] = spawn_actor_host(self.port, OBS_ACTORS, False,
                                      OBS_HOST_SETS)

    def driver_init(self, *a, **kw):
        orig[1](self, *a, **kw)
        seen["driver"] = self

    def driver_run(self, *a, **kw):
        timer = threading.Timer(OBS_SIGNAL_AFTER_S, os.kill,
                                (os.getpid(), signal.SIGUSR2))
        timer.start()
        try:
            return orig[2](self, *a, **kw)
        finally:
            timer.cancel()

    argv = ["--config", "pong", "--seed", str(seed), "--actors",
            str(OBS_ACTORS), "--listen", "127.0.0.1:0",
            "--set", "obs.enabled=true", "--set", f"obs.trace_path={trace}",
            "--set", "obs.telemetry_every_s=1",
            "--set", "remediation.mode=observe", "--profile-dir", prof,
            "--metrics-file", jsonl, "--total-env-frames",
            str(OBS_FRAMES), "--wall-clock-limit", str(OBS_WALL_S),
            "--device", DEVICE]
    for s_ in OBS_SETS:
        argv += ["--set", s_]
    threads_before = {t.ident for t in threading.enumerate()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (SocketIngestServer.__init__, ApexDriver.__init__, ApexDriver.run) = (
        server_init, driver_init, driver_run)
    fg.gather_rows.launches = 0       # count the main path's run only
    try:
        out, wall = run_cli(argv)
        host = host_result(hosts.pop("A"), "A")
    finally:
        (SocketIngestServer.__init__, ApexDriver.__init__,
         ApexDriver.run) = orig
        for proc in hosts.values():
            proc.kill()
            proc.communicate()
    launches = {"gather_rows": fg.gather_rows.launches}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    driver = seen.pop("driver")
    budget = driver.hbm_budget
    peak_gb = note_memory("obs", budget)
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(not left, f"driver threads still running after the run: {left}")
    check(host["frames"] > 0 and not host["errors"],
          f"the actor host: {host}")
    check_graphed(driver, ("k", 4), gathers=2)
    # 1. the span trace loads and holds the ingest, learner and server
    # threads' spans
    with open(trace) as fh:
        tr = json.load(fh)
    tnames = {ev["tid"]: ev["args"]["name"] for ev in tr["traceEvents"]
              if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    by_thread: dict[str, set] = {}
    for ev in tr["traceEvents"]:
        if ev.get("ph") == "X":
            by_thread.setdefault(tnames.get(ev["tid"], "?"),
                                 set()).add(ev["name"])
    for thread in ("ingest", "learner", "inference-server"):
        check(by_thread.get(thread), f"no span from the {thread} thread "
              f"in the trace: {sorted(by_thread)}")
    # 2. the JSONL's instruments
    last: dict = {}
    peers: set = set()
    with open(jsonl) as fh:
        for line in fh:
            rec = json.loads(line)
            last.update(rec)
            peers.update(k.split("/")[1] for k in rec
                         if k.startswith("peer/"))
    for key in ("hist/sample_age_steps", "hist/param_lag_steps"):
        check(last.get(key, {}).get("count", 0) > 0, f"{key}: "
              f"{last.get(key)}")
    check(peers, "no peer/<host>/... telemetry in the JSONL")
    check(last.get("ctr/graph_captures", 0) > 0,
          f"graph_captures {last.get('ctr/graph_captures')}")
    fracs = {k: last.get(f"gauge/{k}") for k in
             ("mfu_train", "hbm_bw_frac_train", "hbm_bw_frac_ingest")}
    check(all(v is not None and 0 < v <= 1 for v in fracs.values()),
          f"stage gauges outside (0, 1]: {fracs}")
    # 3. the torch.profiler window wrote its trace
    traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
    check(traces and os.path.getsize(os.path.join(prof, traces[0])) > 0,
          f"no torch.profiler trace in {prof}: {traces}")
    # 4. the report reads the run
    rep = subprocess.run([sys.executable, "-m",
                          "ape_x_dqn_tpu_torch.obs.report", jsonl],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(rep.returncode == 0, f"report exited {rep.returncode}: "
          f"{rep.stderr[-2000:]}")
    for section in ("stage-time breakdown", "staleness", "roofline"):
        check(section in rep.stdout, f"the report has no {section} "
              f"section:\n{rep.stdout[-3000:]}")
    # 5. SIGUSR2 dumped the flight recorder, and the hook is gone again
    dumps = [f for f in os.listdir(tmp) if f.startswith("blackbox-")]
    check(dumps, f"SIGUSR2 left no blackbox-*.json in {tmp}")
    with open(os.path.join(tmp, dumps[0])) as fh:
        box = json.load(fh)
    check(signal.getsignal(signal.SIGUSR2) == handler_before,
          "the flight recorder's SIGUSR2 handler outlived its run")
    # 6. the budget covers the measured peak
    check(budget is not None and budget.total >= peak_gb * 1e9,
          f"HBM budget {budget.total / 1e9 if budget else None} GB < "
          f"the measured peak {peak_gb:.2f} GB")
    # 7. the gather launched on this path
    check(launches["gather_rows"] > 0, "gather_rows never launched")
    log(f"obs: `{' '.join(argv)}` beside one actor host ({OBS_ACTORS} "
        f"vector actors x 16 envs over TCP, obs.enabled): "
        f"frames={out['frames']} ({host['frames']} from the host) "
        f"grad_steps={out['grad_steps']}; trace spans by thread "
        f"{ {t: len(n) for t, n in sorted(by_thread.items())} }; "
        f"sample_age_steps p50={last['hist/sample_age_steps']['p50']} "
        f"param_lag_steps p50={last['hist/param_lag_steps']['p50']}; "
        f"telemetry peers {sorted(peers)}; graph_captures="
        f"{last.get('ctr/graph_captures')} in "
        f"{last.get('ctr/graph_capture_ms', 0):.1f} ms; stage gauges "
        f"{fracs}, device_ms_train={last.get('gauge/device_ms_train')}, "
        f"device_ms_ingest={last.get('gauge/device_ms_ingest')}; "
        f"profiler trace {traces[0]}; report sections present; blackbox "
        f"dump {dumps[0]} ({len(box.get('records', box))} entries); "
        f"remediation {json.dumps(out.get('remediation'))}; HBM budget "
        f"{budget.total / 1e9:.2f} GB >= peak {peak_gb:.2f} GB; "
        f"launches={launches}; {adds_summary([], out)}; {wall:.2f} s")
    log("obs: report --\n" + "\n".join(
        "obs:   " + line for line in rep.stdout.splitlines()[:60]))
    shutil.rmtree(tmp, ignore_errors=True)
    del driver
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_net(dev):
    """The pong preset's dueling Nature CNN at full width (84x84x4, 18
    actions, bfloat16 compute) and one params dict per tenant, each from
    its own seed, on the card."""
    from ape_x_dqn_tpu_torch.models import build_network, init_params
    from ape_x_dqn_tpu_torch.runtime.family import server_apply_fn
    from ape_x_dqn_tpu_torch.utils.rng import component_generator

    cfg, spec = pong_setup(dev)
    params = []
    for seed in range(len(SERVE_CLASSES)):
        net = init_params(build_network(cfg.network, spec),
                          component_generator(seed, "net_init"))
        params.append({k: v.detach().to(dev)
                       for k, v in net.state_dict().items()})
    apply = server_apply_fn("dqn", build_network(cfg.network, spec).to(dev))
    return cfg, spec, apply, params


def closed_loop(clients: list, x: np.ndarray, seconds: float) -> float:
    """One thread per client, each querying SERVE_VECTOR-item requests
    back to back for `seconds`: -> items served per second."""
    served = [0] * len(clients)
    stop = time.perf_counter() + seconds

    def run(i):
        while time.perf_counter() < stop:
            clients[i].query_batch(x, SERVE_VECTOR)
            served[i] += SERVE_VECTOR

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(clients))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(served) / (time.perf_counter() - t0)


def phase_serve_tier(dev) -> dict:
    """The serving tier alone, at the pong preset's width: eight tenants
    of one family (classes SERVE_CLASSES), max_batch 64, vector
    requests of 16. (1) One mixed batch of 64 rows through the gathered
    forward, and one of 8 rows per tenant through the tier's
    TenantClients, against each tenant's plain forward on its own rows
    (bf16: SERVE_TOL, beside the least difference between two tenants
    on a row). (2) Closed-loop forwards/s of the single-tenant server (one
    policy, eight client threads) and of the tier (one thread per
    tenant): a number, not a check. (3) An open-loop overload at twice
    the tier's measured rate on a fresh tier: the books close (offered
    == admitted + shed), class 0 sheds nothing; the top class's p99."""
    from ape_x_dqn_tpu_torch.parallel.inference_server import (
        BatchedInferenceServer, MultiPolicyInferenceServer,
        _make_gather_apply)

    t0 = time.perf_counter()
    cfg, spec, apply, params = serve_net(dev)
    n = len(params)
    rng = np.random.default_rng(0)
    x64 = rng.integers(0, 255, (64, *spec.obs_shape)).astype(np.uint8)
    rows = rng.integers(0, n, 64)
    stacked = {k: torch.stack([p[k] for p in params]) for k in params[0]}
    with torch.inference_mode():
        # every tenant's plain forward on all 64 rows, before any tier's
        # dispatch thread runs: `apply` swaps one module's parameters
        # while it runs, so it has one caller at a time
        want = np.stack([apply(params[t], torch.from_numpy(x64).to(
            dev)).float().cpu().numpy() for t in range(n)])
        got = _make_gather_apply(apply)(
            stacked, torch.from_numpy(rows).to(dev),
            torch.from_numpy(x64).to(dev)).float().cpu().numpy()
    # what a row mapped to the wrong tenant would show: the least, over
    # rows and pairs of tenants, of the largest difference in a row
    spread = min(float(np.abs(want[a] - want[b]).max(axis=1).min())
                 for a in range(n) for b in range(n) if a != b)
    check(spread > 10 * SERVE_TOL, f"serve: tenants differ by only "
          f"{spread:.3g} on a row, too little for the {SERVE_TOL} limit")
    err = float(np.abs(got - want[rows, np.arange(64)]).max())
    check(err <= SERVE_TOL, f"serve: the gathered forward's rows != their "
          f"tenants' plain forward: max_abs_err {err:.3g} > {SERVE_TOL}")
    x = x64[:SERVE_VECTOR]
    example = np.zeros(spec.obs_shape, np.uint8)
    mb, dl = cfg.inference.max_batch, cfg.inference.deadline_ms

    def tier_of(slo):
        tier = MultiPolicyInferenceServer(
            max_batch=mb, deadline_ms=dl, queue_slo_items=slo, device=dev,
            priority_classes=3)
        clients = [tier.register_policy(f"pong{i}", apply, params[i],
                                        family="dqn",
                                        priority=SERVE_CLASSES[i])
                   for i in range(n)]
        clients[0].warmup(example, extra_sizes=(SERVE_VECTOR,))
        return tier, clients

    # the tier's own path: one mixed batch, 8 rows from each tenant,
    # through TenantClient.submit (the staging, padding rows, the
    # stacked-param cache, the per-request slicing of the reply)
    tier, clients = tier_of(1 << 20)
    try:
        gathered = tier.stats["gather_batches"]
        per = 64 // n
        tickets = [clients[i].submit(x64[per * i:per * (i + 1)], per)
                   for i in range(n)]
        tier_err = max(
            float(np.abs(t.wait(60.0) - want[i, per * i:per * (i + 1)])
                  .max()) for i, t in enumerate(tickets))
        gathered = tier.stats["gather_batches"] - gathered
    finally:
        tier.stop()
    check(tier_err <= SERVE_TOL, f"serve: the tier's replies != each "
          f"tenant's plain forward: max_abs_err {tier_err:.3g} > "
          f"{SERVE_TOL}")
    check(gathered >= 1, "serve: the mixed batch ran no gathered forward")
    err = max(err, tier_err)
    single = BatchedInferenceServer(apply, params[0], max_batch=mb,
                                    deadline_ms=dl, device=dev)
    try:
        single.warmup(example, extra_sizes=(SERVE_VECTOR,))
        single_rate = closed_loop([single] * n, x, SERVE_LOOP_S)
    finally:
        single.stop()
    tier, clients = tier_of(1 << 20)  # no shedding in the closed loop
    try:
        tier_rate = closed_loop(clients, x, SERVE_LOOP_S)
        closed = tier.stats
    finally:
        tier.stop()
    # the open-loop overload at twice the measured capacity
    tier, clients = tier_of(cfg.serving.queue_slo_items)
    try:
        per_s = SERVE_OVERLOAD_X * tier_rate / SERVE_VECTOR
        tickets = []
        t_start = time.perf_counter()
        i = 0
        while time.perf_counter() - t_start < SERVE_OVERLOAD_S:
            due = int((time.perf_counter() - t_start) * per_s)
            while i < due:
                tickets.append(clients[i % n].submit(x, SERVE_VECTOR))
                i += 1
            time.sleep(0.001)
        for t in tickets:
            t.event.wait(60.0)
        s = tier.stats
        top = [tier.tenant_stats(f"pong{j}") for j in range(n)
               if SERVE_CLASSES[j] == 0]
    finally:
        tier.stop()
    check(s["offered"] == len(tickets), f"serve: offered {s['offered']} "
          f"!= {len(tickets)} submitted")
    check(s["offered"] == s["admitted"] + s["shed"],
          f"serve: the shed accounting does not close: {s}")
    check(s["shed_by_class"][0] == 0, f"serve: class 0 shed: {s}")
    check(s["shed"] > 0, f"serve: twice the capacity shed nothing: {s}")
    top_p99 = max(t.get("p99_ms", 0.0) for t in top)
    out = {"single_rate": single_rate, "tier_rate": tier_rate,
           "ratio": tier_rate / single_rate, "max_abs_err": err,
           "tenant_spread": spread,
           "overload": s, "top_p99_ms": top_p99,
           "closed_gather_batches": closed["gather_batches"]}
    log(f"serve: tier alone, pong net at full width ({spec.obs_shape} "
        f"uint8, 18 actions, {cfg.network.compute_dtype}), {n} tenants "
        f"of one family, classes {list(SERVE_CLASSES)}, max_batch {mb}, "
        f"vector {SERVE_VECTOR}: gathered forward vs each tenant's plain "
        f"forward and the tier's replies to one mixed batch (8 x 8 rows, {gathered} gathered forward(s)) max_abs_err={err:.3g} (tol {SERVE_TOL}, tenants differ by >= {spread:.3g} on a row); closed loop "
        f"forwards/s single-tenant {single_rate:.1f} vs tier "
        f"{tier_rate:.1f} (ratio {tier_rate / single_rate:.4f}; tier "
        f"batches {closed['batches']}, gathered {closed['gather_batches']}, "
        f"avg_batch {closed['avg_batch']:.2f}); open loop at "
        f"{SERVE_OVERLOAD_X}x capacity "
        f"({per_s:.1f} requests/s for {SERVE_OVERLOAD_S} s): offered "
        f"{s['offered']} = admitted {s['admitted']} + shed {s['shed']} "
        f"(by class {s['shed_by_class']}), top class p99 "
        f"{top_p99:.2f} ms; {time.perf_counter() - t0:.2f} s; card {CARD}")
    return out


def phase_serve_driver(seed: int) -> dict:
    """The pong driver through the CLI with the serving tier
    (`serving.multi_tenant=true`): 4 local vector actors of 16 envs in
    class 0, a small SLO line (SERVE_SLO_ITEMS), `remediation.mode=
    enforce`, obs on with a JSONL. Wrapped:
    ApexDriver.__init__ keeps the driver, ApexDriver.run registers a
    second tenant of the family in class 2 and starts its open-loop load
    of SERVE_FLOOD_ITEMS-item requests (SERVE_FLOOD_RATE a second, for
    SERVE_FLOOD_S from SERVE_FLOOD_AT_S), which sheds and holds the
    queue at the SLO line, so the queue-SLO rule acts. Checks: a clean end, the learner's
    graph and the gather, the tenant's serve/<id>/ gauges in the summary
    and the JSONL, a set_backpressure action in the remediation record,
    the tier's books. -> the launch counts of this run."""
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
    from ape_x_dqn_tpu_torch.runtime.family import server_apply_fn

    tmp = tempfile.mkdtemp(prefix="apex-chip-smoke-serve-")
    jsonl = os.path.join(tmp, "run.jsonl")
    seen: dict = {}
    flood = {"submitted": 0, "shed": 0, "served": 0}
    orig = (ApexDriver.__init__, ApexDriver.run)

    def driver_init(self, *a, **kw):
        orig[0](self, *a, **kw)
        seen["driver"] = self

    def driver_run(self, *a, **kw):
        load = self.serving.register_policy(
            "pong-load", server_apply_fn(self.family, self.net),
            self.learner.publish_params(self.state), family=self.family,
            priority=2)
        example = np.zeros(self.spec.obs_shape, self.spec.obs_dtype)
        load.warmup(example, extra_sizes=(self.cfg.actors.envs_per_actor,))
        x = np.random.default_rng(seed).integers(
            0, 255, (SERVE_FLOOD_ITEMS, *self.spec.obs_shape)
        ).astype(np.uint8)
        done = threading.Event()

        def flood_loop():
            if done.wait(SERVE_FLOOD_AT_S):
                return
            tickets, t_start, i = [], time.perf_counter(), 0
            while not done.is_set():
                el = time.perf_counter() - t_start
                if el >= SERVE_FLOOD_S:
                    break
                while i < int(el * SERVE_FLOOD_RATE):
                    tickets.append(load.submit(x, SERVE_FLOOD_ITEMS))
                    i += 1
                time.sleep(0.002)
            for t in tickets:
                t.event.wait(30.0)
                if isinstance(t.result, Exception):
                    flood["shed"] += 1
                else:
                    flood["served"] += 1
            flood["submitted"] = len(tickets)

        th = threading.Thread(target=flood_loop, name="serve-flood")
        th.start()
        try:
            return orig[1](self, *a, **kw)
        finally:
            done.set()
            th.join(timeout=60)

    argv = ["--config", "pong", "--seed", str(seed), "--actors",
            str(SERVE_ACTORS), "--set", "serving.multi_tenant=true",
            "--set", "serving.default_class=0",
            "--set", f"serving.queue_slo_items={SERVE_SLO_ITEMS}",
            "--set", "serving.stats_every_s=1",
            "--set", "remediation.mode=enforce",
            "--set", "obs.enabled=true", "--metrics-file", jsonl,
            "--total-env-frames", str(SERVE_FRAMES), "--wall-clock-limit",
            str(SERVE_WALL_S), "--device", DEVICE]
    for s_ in SERVE_SETS:
        argv += ["--set", s_]
    threads_before = {t.ident for t in threading.enumerate()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ApexDriver.__init__, ApexDriver.run = driver_init, driver_run
    fg.gather_rows.launches = 0       # count the main path's run only
    try:
        with timed_adds() as adds:
            out, wall = run_cli(argv)
    finally:
        ApexDriver.__init__, ApexDriver.run = orig
    launches = {"gather_rows": fg.gather_rows.launches}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    driver = seen.pop("driver")
    peak_gb = note_memory("serve", driver.hbm_budget)
    RATES["serve"] = out["frames"] / wall
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(not left, f"driver threads still running after the run: {left}")
    check_graphed(driver, ("k", 4), gathers=2)
    check(launches["gather_rows"] > 0, "gather_rows never launched")
    tier = out.get("serving") or {}
    pid = driver.cfg.env.id
    gauges = [f"serve/{pid}/{k}" for k in ("offered", "admitted", "shed",
                                           "queue_depth", "p50_ms",
                                           "p99_ms")]
    check(all(g in tier for g in gauges),
          f"the summary lacks the tenant's gauges: {sorted(tier)}")
    check(tier["offered"] == tier["admitted"] + tier["shed"]
          and tier["shed_by_class"][0] == 0,
          f"serve: the tier's books: {tier}")
    last: dict = {}
    with open(jsonl) as fh:
        for line in fh:
            last.update(json.loads(line))
    check(all(f"gauge/{g}" in last for g in gauges),
          f"the JSONL lacks the tenant's gauges: "
          f"{sorted(k for k in last if k.startswith('gauge/serve'))}")
    rem = out.get("remediation") or {}
    acts = [r for r in rem.get("recent", [])
            if "backpressure" in str(r[2])]
    check(acts, f"no set_backpressure action in the remediation record: "
          f"{json.dumps(rem)[:2000]}")
    check(flood["submitted"] > 0 and flood["shed"] > 0,
          f"the second tenant's load shed nothing: {flood}")
    check(tier["gather_batches"] > 0, f"serve: the driver's tier ran no "
          f"gathered forward: {tier}")
    log(f"serve: driver `{' '.join(argv)}`: frames={out['frames']} "
        f"frames/s={out['frames'] / wall:.1f} grad_steps="
        f"{out['grad_steps']}; tier {json.dumps(tier)}; the second "
        f"tenant's load {flood}; remediation set_backpressure actions "
        f"{acts[:4]} (counts {rem.get('counts')}); ingest_dropped="
        f"{out['ingest_dropped']}; {adds_summary(adds, out)}; "
        f"launches={launches}; peak_mem_gb={peak_gb:.2f}; {wall:.2f} s; "
        f"card {CARD}")
    shutil.rmtree(tmp, ignore_errors=True)
    del driver
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class _TimedLock:
    """A driver's _state_lock with the wait to acquire it timed on the
    threads that set `on.active` (the swap's); others pass through."""

    def __init__(self, lock, on, waits: list):
        self._lock, self._on, self._waits = lock, on, waits

    def __enter__(self):
        t0 = time.perf_counter()
        self._lock.acquire()
        if getattr(self._on, "active", False):
            self._waits.append(time.perf_counter() - t0)
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


SWAP_PARTS = ("lock", "land", "evict", "fetch", "add_at", "put")


def split_swap(driver, on) -> dict:
    """Time the parts of each eviction swap of `driver` on the host
    clock, by wrapping its instance's calls: the wait for _state_lock,
    the block's host-to-device copy (land_add_at), the evict graph's
    dispatch, the fetch of the region (its copies and the host sync,
    which also waits for the learner's macro-step the ingest stream
    waits on), the add_at graph's dispatch, ColdStore.put (the zlib
    pack and the door). -> {part: [seconds per call]}."""
    parts: dict = {k: [] for k in SWAP_PARTS}
    driver._state_lock = _TimedLock(driver._state_lock, on, parts["lock"])

    def timed(obj, name, part):
        fn = getattr(obj, name)

        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            parts[part].append(time.perf_counter() - t0)
            return out

        setattr(obj, name, call)

    timed(driver.learner, "land_add_at", "land")
    timed(driver.learner, "evict_landed", "evict")
    timed(driver, "_fetch_region", "fetch")
    timed(driver.learner, "add_at_landed", "add_at")
    timed(driver._cold, "put", "put")
    return parts


def phase_tiers(seed: int) -> dict:
    """The pong driver through the CLI with the tiered cold replay, at
    full width (Nature CNN, 84x84x4, batch 512, K=4). Cuts:
    replay.capacity 16,384 (the ring fills early), min_fill 8,192, 8
    vector actors x 16 envs, 60,000 frames, 150 s. Tier:
    cold_tier_capacity 16,384 (the RAM store fills and displaces),
    cold_tier_disk_capacity 262,144 in a temporary directory. Wrapped:
    ApexDriver.__init__ keeps the driver and splits its swaps
    (split_swap), ApexDriver._ship_staged_cold is timed per swap on the
    host clock. Checks: the door closure, the
    recalls and evictions, the disk rung's spills and promotions, the
    hot ring exactly full with host and device cursors equal, the swap
    graphs' replays, the gather; then one region read by read_region
    through cold_pack and cold_unpack, restaged into a fresh ring on
    the card, bitwise. -> the launch counts of this run."""
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.replay.frame_ring import FrameRingReplay
    from ape_x_dqn_tpu_torch.replay.packing import (cold_pack, cold_plan,
                                                    cold_unpack)
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver

    tmp = tempfile.mkdtemp(prefix="apex-chip-smoke-tiers-")
    seen: dict = {}
    swaps: list[float] = []
    on = threading.local()
    orig = (ApexDriver.__init__, ApexDriver._ship_staged_cold)

    def driver_init(self, *a, **kw):
        orig[0](self, *a, **kw)
        seen["driver"] = self
        seen["parts"] = split_swap(self, on)

    def ship_cold(self, views, g):
        t0 = time.perf_counter()
        on.active = True
        try:
            out = orig[1](self, views, g)
        finally:
            on.active = False
        swaps.extend([(time.perf_counter() - t0) / g] * g)
        return out

    argv = ["--config", "pong", "--seed", str(seed),
            "--set", f"replay.capacity={TIERS_CAPACITY}",
            "--set", f"replay.min_fill={TIERS_CAPACITY // 2}",
            "--set", f"replay.cold_tier_capacity={TIERS_CAPACITY}",
            # the directory first: each --set validates the config
            "--set", f"replay.cold_tier_disk_dir={os.path.join(tmp, 'disk')}",
            "--set", f"replay.cold_tier_disk_capacity={16 * TIERS_CAPACITY}",
            "--total-env-frames", str(TIERS_FRAMES), "--wall-clock-limit",
            str(TIERS_WALL_S), "--device", DEVICE]
    for s_ in TIERS_SETS:
        argv += ["--set", s_]
    threads_before = {t.ident for t in threading.enumerate()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ApexDriver.__init__, ApexDriver._ship_staged_cold = driver_init, ship_cold
    fg.gather_rows.launches = 0       # count the main path's run only
    try:
        with timed_adds() as adds:
            out, wall = run_cli(argv)
    finally:
        ApexDriver.__init__, ApexDriver._ship_staged_cold = orig
    launches = {"gather_rows": fg.gather_rows.launches}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    driver = seen.pop("driver")
    peak_gb = note_memory("tiers", driver.hbm_budget)
    RATES["tiers"] = out["frames"] / wall
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(not left, f"driver threads still running after the run: {left}")
    check_graphed(driver, ("k", 4), gathers=2)
    check(launches["gather_rows"] > 0, "gather_rows never launched")
    ct = out.get("cold_tier") or {}
    disk = ct.get("disk") or {}
    check(ct.get("evicted", 0) > 0 and ct.get("recalled", 0) > 0,
          f"tiers: no eviction or no recall: {ct}")
    check(ct["evicted"] == ct["stored"] + ct["dropped"],
          f"tiers: the door closure evicted == stored + dropped fails: "
          f"{ct}")
    check(disk.get("spilled", 0) > 0 and disk.get("promoted", 0) > 0
          and disk.get("io_errors", 1) == 0,
          f"tiers: the disk rung did not spill and promote: {disk}")
    graphs = ct.get("swap_graph_replays", {})
    check(graphs.get("evict", 0) > 0 and graphs.get("add_at", 0) > 0,
          f"tiers: the swap graphs never replayed: {graphs}")
    replay, rs = driver.replay, driver.state.replay
    check(driver._replay_filled == driver.capacity == rs.size
          and (rs.pos, rs.size) == (int(rs.pos_dev), int(rs.size_dev)),
          f"tiers: the hot ring is not exactly full or its cursors "
          f"disagree: filled {driver._replay_filled}, size {rs.size}, "
          f"pos {rs.pos}, device {int(rs.pos_dev)}/{int(rs.size_dev)}, "
          f"capacity {driver.capacity}")
    # the pinned card check: read a region, pack, unpack, restage
    chunk = driver._stage_chunk
    with torch.no_grad():
        start = replay.evict_plan(rs, chunk)
        items, pri = replay.read_region(rs, start, chunk)
        host = {k: v.cpu().numpy() for k, v in items.items()}
        pri_h = pri.cpu().numpy()
    plan = cold_plan(driver._item_spec, (replay.B,))
    payload, raw = cold_pack(dict(host, priorities=pri_h), plan)
    back = cold_unpack(payload, plan, chunk)
    for k in host:
        check(np.array_equal(back[k], host[k]), f"tiers: cold round trip "
              f"changed {k}")
    check(np.array_equal(back["priorities"], pri_h),
          "tiers: cold round trip changed the priorities")
    fresh = FrameRingReplay(chunk * replay.B, replay.B, replay.n,
                            (replay.h, replay.w, replay.stack),
                            alpha=replay.alpha, eps=replay.eps,
                            device=rs.tree.device)
    fst = fresh.init()
    td = np.maximum(pri_h ** (1.0 / replay.alpha) - replay.eps, 0.0)
    fresh.add(fst, {k: torch.from_numpy(np.array(v))
                    for k, v in back.items() if k != "priorities"},
              torch.from_numpy(td.astype(np.float32)))
    got, _ = fresh.read_region(fst, torch.zeros((), dtype=torch.int64,
                                                device=rs.tree.device),
                               chunk)
    for k in host:
        check(np.array_equal(got[k].cpu().numpy(), host[k]),
              f"tiers: the restaged region's {k} != the region read")
    ring_bytes = (sum(v.numel() * v.element_size()
                      for v in rs.storage.values()) / driver.capacity)
    cold_bpt = ct["bytes"] / max(ct["transitions"], 1)
    ms = np.asarray(swaps) * 1e3
    parts = seen.pop("parts")
    total = max(sum(swaps), 1e-9)
    split = ", ".join(
        f"{k} {np.median(v) * 1e3 if v else math.nan:.2f} "
        f"({sum(v) / total:.1%})" for k, v in parts.items())
    rest = 1.0 - sum(sum(v) for v in parts.values()) / total
    apex_fps = RATES.get("apex", math.nan)
    log(f"tiers: `{' '.join(argv)}`: frames={out['frames']} "
        f"frames/s={out['frames'] / wall:.1f} (apex: {apex_fps:.1f}) "
        f"grad_steps={out['grad_steps']}; swaps {len(ms)}, host ms per "
        f"swap median {np.median(ms) if len(ms) else math.nan:.2f} p90 "
        f"{np.percentile(ms, 90) if len(ms) else math.nan:.2f}, split "
        f"by part as median ms per call (share of all swap host time): "
        f"{split}, the rest {rest:.1%}; cold "
        f"tier {json.dumps(ct)}; compression ratio "
        f"{ct['compression_ratio']:.2f}; cold bytes per transition "
        f"{cold_bpt:.1f} vs the ring's {ring_bytes:.1f} "
        f"({cold_bpt / ring_bytes:.4f}); one region of {chunk} segments "
        f"read by read_region, packed ({len(payload)} of {raw} B), "
        f"unpacked and restaged into a fresh ring on the card bitwise; "
        f"ingest_dropped={out['ingest_dropped']}; "
        f"{adds_summary(adds, out)}; launches={launches}; "
        f"peak_mem_gb={peak_gb:.2f}; {wall:.2f} s; card {CARD}")
    shutil.rmtree(tmp, ignore_errors=True)
    del driver, replay, rs, fresh, fst, items, pri, got
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- the dp-sharded learner ------------------------------------------------


@contextlib.contextmanager
def deterministic():
    """cuDNN's and PyTorch's deterministic algorithms, so two runs of one
    body agree bitwise (a K=4 draw may write one leaf twice: the
    deterministic write-back keeps the later one; the card tests' rule)."""
    old = (torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old[0]
        torch.use_deterministic_algorithms(old[1], warn_only=old[2])


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions without TF32's rounding."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def dist_learner(dev, seed: int, preset: str, capture: bool,
                 devices: list | None = None, dtype: str | None = None):
    """The preset's dp-sharded learner at full width on its own dp x tp
    mesh of this card (or of `devices`: over distinct cards, the card
    groups' learner, parallel/cards.py), its shards filled in lockstep
    from numpy (the same bits for every call with one seed); `dtype`
    replaces the preset's compute dtype. -> (cfg, learner, state)."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.models import build_network, init_params
    from ape_x_dqn_tpu_torch.parallel.cards import (CardsLearner,
                                                    group_learner)
    from ape_x_dqn_tpu_torch.parallel.dist_learner import (
        DistDQNLearner, DistSequenceLearner)
    from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
    from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
    from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
    from ape_x_dqn_tpu_torch.runtime.build import build_prioritized_replay
    from ape_x_dqn_tpu_torch.utils.misc import next_pow2
    from ape_x_dqn_tpu_torch.utils.rng import component_generator

    cfg = get_config(preset)
    if dtype is not None:
        cfg = cfg.replace(network=dataclasses.replace(cfg.network,
                                                      compute_dtype=dtype))
    _, spec = pong_setup(dev)
    dp, tp = cfg.parallel.dp, cfg.parallel.tp
    check(dp == 4 and tp == 2 and cfg.learner.sample_chunk == 4,
          f"{preset} preset drift: dp {dp}, tp {tp}")
    mesh = make_mesh(dp=dp, tp=tp, devices=devices or [dev] * (dp * tp))
    net = build_network(cfg.network, spec)
    init_params(net, component_generator(seed, "net_init"))
    net.to(dev)
    shard_cap = next_pow2(cfg.replay.capacity // dp)
    rng = np.random.default_rng(seed)
    gen = component_generator(seed, "learner", device=dev)
    if cfg.replay.kind == "sequence":
        rep = cfg.replay

        def seq_replay(d):
            return PrioritizedReplay(shard_cap, alpha=rep.alpha,
                                     beta=rep.beta, eps=rep.eps, device=d)

        learner = (CardsLearner(group_learner(DistSequenceLearner,
                                              cfg.learner, rep),
                                seq_replay, cfg.learner, mesh)
                   if mesh.distinct
                   else DistSequenceLearner(seq_replay(dev), cfg.learner,
                                            rep, mesh))
        state = learner.init(net, sequence_item_spec(
            (84, 84, 4), np.uint8, rep.seq_length, cfg.network.lstm_size,
            frame_mode=True), gen)
        n, seq, lstm = DIST_FILL_SEQS, rep.seq_length, cfg.network.lstm_size
        lead = (dp, n)
        items = {
            "seq_frames": torch.from_numpy(rng.integers(
                0, 255, lead + (seq + 3, 84, 84), dtype=np.uint8)),
            "actions": torch.from_numpy(rng.integers(
                0, spec.num_actions, lead + (seq,)).astype(np.int32)),
            "rewards": torch.from_numpy(
                rng.normal(size=lead + (seq,)).astype(np.float32)),
            "terminals": torch.zeros(lead + (seq,)),
            "mask": torch.ones(lead + (seq,)),
            "init_c": torch.from_numpy(
                0.3 * rng.normal(size=lead + (lstm,)).astype(np.float32)),
            "init_h": torch.from_numpy(
                0.3 * rng.normal(size=lead + (lstm,)).astype(np.float32)),
        }
        td = torch.from_numpy(rng.uniform(0.1, 2.0, lead).astype(np.float32))
        learner.add(state, items, td)
    else:
        def ring(d):
            return build_prioritized_replay(cfg, spec, shard_cap, d,
                                            frame_mode=True)

        learner = (CardsLearner(group_learner(DistDQNLearner, cfg.learner),
                                ring, cfg.learner, mesh)
                   if mesh.distinct
                   else DistDQNLearner(ring(dev), cfg.learner, mesh))
        replay = learner.replay
        state = learner.init(net, None, gen)
        per = 128
        for _ in range(DIST_FILL_SEGS // per):
            items, td = segments(replay, spec, dp, per, rng)
            learner.add(state, items, td)
    learner.capture = capture
    for d in mesh.cards:
        torch.cuda.synchronize(d)
    return cfg, learner, state


def dist_snapshot(state, m) -> dict:
    """Params, target params, Adam's moments and count, the shard trees,
    the cursors and every metric, on the host."""
    snap = {f"net.{k}": v.detach().cpu() for k, v in
            state.net.state_dict().items()}
    snap.update({f"target.{k}": v.detach().cpu() for k, v in
                 state.target_net.state_dict().items()})
    opt = state.opt_state
    snap["opt.count"] = opt.count.cpu()
    for i, (mu, nu) in enumerate(zip(opt.mu, opt.nu)):
        snap[f"opt.mu{i}"], snap[f"opt.nu{i}"] = mu.cpu(), nu.cpu()
    rs = state.replay
    snap["tree"] = rs.tree.cpu()
    snap["cursors"] = torch.cat([rs.pos_dev.cpu(), rs.size_dev.cpu()])
    from ape_x_dqn_tpu_torch.runtime.step_graph import pack_metrics
    snap["metrics"] = pack_metrics(m)[0].cpu()
    return snap


def dist_run(dev, seed: int, preset: str, capture: bool) -> dict:
    """DIST_STEPS macro-steps of the preset's dist learner (graphs, or
    eager with `capture` off), deterministic, snapshots after the 1st
    and the last; then its rate (host clock over RATE_STEPS macro-steps,
    deterministic algorithms off, the graph captured anew), its peak
    memory against the card's budget of four shards, and shard_stats.
    The learner is freed before this returns."""
    from ape_x_dqn_tpu_torch.utils.hbm import check_hbm_fits

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold is not this learner's
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg, learner, state = dist_learner(dev, seed, preset, capture)
    build_s = time.perf_counter() - t0
    k = cfg.learner.sample_chunk
    snaps = []
    with deterministic():
        for i in range(DIST_STEPS):
            state, m = learner.train_step_k(state, k)
            if i in (0, DIST_STEPS - 1):
                snaps.append(dist_snapshot(state, m))
    graph = learner.step_graphs()[("k", k)]
    captured, gathers = graph.captured, graph.gathers
    if capture:
        # capture anew without the deterministic algorithms for the rate
        learner.__dict__.pop("_graphs")
        del graph
        gc.collect()
        learner_step(learner, state, k)      # the eager warm-up
    rate = learner_rate(learner, state, k, RATE_STEPS, capture)
    stats = learner.shard_stats(state)
    params = sum(p.numel() for p in state.net.parameters())
    budget = check_hbm_fits(cfg, (84, 84, 4), np.uint8, param_count=params,
                            device=dev, shards_per_card=4)
    peak = note_memory(f"dist_learner_{preset}"
                       + ("" if capture else "_eager"), budget, base)
    replay_gb = sum(v.numel() * v.element_size()
                    for v in state.replay.storage.values()) / 1e9
    del learner, state, m
    gc.collect()
    torch.cuda.empty_cache()
    return {"snaps": snaps, "rate": rate, "stats": stats, "build_s": build_s,
            "captured": captured, "gathers": gathers, "peak_gb": peak,
            "budget_gb": budget.total / 1e9, "replay_gb": replay_gb,
            "base_gb": base / 1e9}


def dist_dp1_parity(dev, seed: int, preset: str) -> float:
    """A dp=1 dist learner against the single-card learner (DQNLearner,
    SequenceLearner) at the preset's width on identical weights, replay
    contents and noise, one K=4 macro-step each (eager: a first call):
    -> the largest parameter difference (BF16_TOL)."""
    import copy

    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.models import build_network, init_params
    from ape_x_dqn_tpu_torch.parallel.dist_learner import (
        DistDQNLearner, DistSequenceLearner)
    from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh
    from ape_x_dqn_tpu_torch.replay.prioritized import PrioritizedReplay
    from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
    from ape_x_dqn_tpu_torch.runtime.build import build_prioritized_replay
    from ape_x_dqn_tpu_torch.runtime.learner import DQNLearner
    from ape_x_dqn_tpu_torch.runtime.sequence_learner import SequenceLearner
    from ape_x_dqn_tpu_torch.utils.rng import component_generator

    cfg = get_config(preset)
    _, spec = pong_setup(dev)
    k, b = cfg.learner.sample_chunk, cfg.learner.batch_size
    mesh = make_mesh(dp=1, tp=1, devices=[dev])
    net = build_network(cfg.network, spec)
    init_params(net, component_generator(seed, "net_init"))
    net.to(dev)
    net2 = copy.deepcopy(net)
    gen = component_generator(seed, "learner", device=dev)
    rng = np.random.default_rng(seed + 1)
    if cfg.replay.kind == "sequence":
        rep, lstm = cfg.replay, cfg.network.lstm_size
        spec_i = sequence_item_spec((84, 84, 4), np.uint8, rep.seq_length,
                                    lstm, frame_mode=True)
        ra, rb = (PrioritizedReplay(512, device=dev) for _ in range(2))
        single = SequenceLearner(ra, cfg.learner, rep)
        sa = single.init(net, ra.init(spec_i), gen)
        dist = DistSequenceLearner(rb, cfg.learner, rep, mesh)
        sb = dist.init(net2, spec_i, gen)
        n, seq = 256, rep.seq_length
        items = {
            "seq_frames": rng.integers(0, 255, (n, seq + 3, 84, 84),
                                       dtype=np.uint8),
            "actions": rng.integers(0, 18, (n, seq)).astype(np.int32),
            "rewards": rng.normal(size=(n, seq)).astype(np.float32),
            "terminals": np.zeros((n, seq), np.float32),
            "mask": np.ones((n, seq), np.float32),
            "init_c": (0.3 * rng.normal(size=(n, lstm))).astype(np.float32),
            "init_h": (0.3 * rng.normal(size=(n, lstm))).astype(np.float32),
        }
        items = {key: torch.from_numpy(v) for key, v in items.items()}
        td = torch.from_numpy(rng.uniform(0.1, 2.0, n).astype(np.float32))
        single.add(sa, items, td)
        dist.add(sb, {key: v[None] for key, v in items.items()}, td[None])
    else:
        ra, rb = (build_prioritized_replay(cfg, spec, 1 << 16, dev,
                                           frame_mode=True)
                  for _ in range(2))
        single = DQNLearner(ra, cfg.learner)
        sa = single.init(net, ra.init(), gen)
        dist = DistDQNLearner(rb, cfg.learner, mesh)
        sb = dist.init(net2, None, gen)
        items, td = segments(ra, spec, 1, 512, rng)
        single.add(sa, {key: v[0] for key, v in items.items()}, td[0])
        dist.add(sb, items, td)
    noise = torch.rand(k * b, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    sa, ma = single.train_step_k(sa, k, noise)
    sb, mb = dist.train_step_k(sb, k, noise[None])
    torch.cuda.synchronize()
    diff = max(float((x - y).detach().abs().max()) for x, y in
               zip(sa.net.parameters(), sb.net.parameters()))
    loss_a, loss_b = ma["loss"].item(), mb["loss"].item()
    check(math.isfinite(loss_a) and abs(loss_a - loss_b)
          <= BF16_TOL * max(1.0, abs(loss_a)),
          f"{preset}: dp=1 dist loss {loss_b} vs the single-card "
          f"learner's {loss_a}")
    check(diff <= BF16_TOL, f"{preset}: dp=1 dist params {diff} from the "
          f"single-card learner's (tolerance {BF16_TOL})")
    del single, dist, sa, sb, ra, rb, net, net2
    gc.collect()
    torch.cuda.empty_cache()
    return diff


def phase_dist_learners(dev, seed: int) -> None:
    """The dp-sharded learners alone at full width on their presets' own
    dp=4 x tp=2 meshes of this card: DistDQNLearner over atari57_apex's
    frame ring (batch 512, K=4, 4 shards of 524,288 transitions) and
    DistSequenceLearner over r2d2's replay (64 x 80, K=4, 4 shards of
    16,384 sequences). For each: the graph against the eager body,
    bitwise, after 1 and DIST_STEPS macro-steps; a dp=1 dist learner
    against the single-card learner; eager and graph grad-steps/s beside
    main's and r2d2's; the peak memory against the budget; shard_stats."""
    for preset, single in (("atari57_apex", "main"), ("r2d2", "r2d2")):
        t0 = time.perf_counter()
        g = dist_run(dev, seed, preset, capture=True)
        e = dist_run(dev, seed, preset, capture=False)
        check(g["captured"] and not e["captured"],
              f"{preset}: the graph run did not capture, or the eager one "
              f"did")
        per_draw = 1 if preset == "r2d2" else 2
        check(g["gathers"] == per_draw, f"{preset}: the macro-step graph "
              f"carries {g['gathers']} gather launches, expected "
              f"{per_draw} (one launch per side over all four shards)")
        for after, gs, es in zip((1, DIST_STEPS), g["snaps"], e["snaps"]):
            check(gs.keys() == es.keys(), f"{preset}: snapshot keys")
            for name in gs:
                check(torch.equal(gs[name], es[name]), f"{preset}: {name} "
                      f"of the graph != the eager body after {after} "
                      f"macro-steps")
        stats = g["stats"]
        check(stats["fill_min"] == stats["fill_max"] > 0
              and len(set(stats["sizes"])) == 1,
              f"{preset}: shards not in lockstep: {stats}")
        check(g["peak_gb"] * 1e9 <= g["budget_gb"] * 1e9,
              f"{preset}: peak {g['peak_gb']:.2f} GB above the budget "
              f"{g['budget_gb']:.2f} GB")
        RATES[f"dist_{preset}_graph"] = g["rate"]
        diff = dist_dp1_parity(dev, seed, preset)
        log(f"dist: {preset} learner alone on its dp=4 x tp=2 mesh of this "
            f"card: graph == eager bitwise (params, target, Adam, the four "
            f"shard trees, cursors, metrics) after 1 and {DIST_STEPS} K=4 "
            f"macro-steps; {g['gathers']} gather launches a replay; "
            f"grad-steps/s eager={e['rate']:.2f} graph={g['rate']:.2f} "
            f"(host clock over {RATE_STEPS} macro-steps each; {single}: "
            f"single shard eager={RATES.get(single + '_eager', math.nan):.2f}"
            f" graph={RATES.get(single + '_graph', math.nan):.2f}, this "
            f"call); replay {g['replay_gb']:.2f} GB, build "
            f"{g['build_s']:.2f} s, peak {g['peak_gb']:.2f} GB (above the "
            f"{g['base_gb']:.2f} GB earlier phases still held) vs budget "
            f"{g['budget_gb']:.2f} GB; dp=1 dist vs single-card learner "
            f"max param diff {diff:.3g} (tolerance {BF16_TOL}); "
            f"shard_stats={json.dumps(stats)}; "
            f"{time.perf_counter() - t0:.2f} s; card {CARD}")


def dist_driver(seed: int, preset: str, sets: tuple, frames: int,
                wall_s: float, name: str) -> dict:
    """The preset through ApexDriver on its own dp x tp mesh of this card
    (mesh_devices = [card] * dp*tp), in this process. Wrapped: the
    server's update_params counts publications and their versions, the
    dist learner's train_many counts draws, ApexDriver._ship_staged is
    timed. Checks: a clean end, grad-steps > 0, the graphs replayed, the
    gather once per draw and side, the per-shard drop closure, the
    shards in lockstep, publications advancing. -> its summary."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.parallel.dist_learner import _DistLearnerBase
    from ape_x_dqn_tpu_torch.parallel.inference_server import (
        BatchedInferenceServer)
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
    from ape_x_dqn_tpu_torch.runtime.learner import SingleChipLearner
    from ape_x_dqn_tpu_torch.runtime.train import apply_overrides

    cfg = apply_overrides(get_config(preset), list(sets)).replace(seed=seed)
    dp, tp = cfg.parallel.dp, cfg.parallel.tp
    k = cfg.learner.sample_chunk
    calls = {"versions": [], "macro": 0, "singles": 0}
    orig = (BatchedInferenceServer.update_params,
            _DistLearnerBase.train_many)

    def update_params(self, params, version):
        calls["versions"].append(version)
        return orig[0](self, params, version)

    def train_many(self, state, n, noise=None):
        calls["macro"] += n // k
        calls["singles"] += n % k
        # through the base class's (timed, `timed_parts`) method
        return SingleChipLearner.train_many(self, state, n, noise)

    dev = torch.device(DEVICE)
    threads_before = {t.ident for t in threading.enumerate()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold is not this run's
    base = torch.cuda.memory_allocated()
    BatchedInferenceServer.update_params = update_params
    _DistLearnerBase.train_many = train_many
    t0 = time.perf_counter()
    try:
        # the stager binds the (timed) ship when the driver is built
        with timed_parts() as (secs, starts):
            driver = ApexDriver(cfg, device=dev,
                                mesh_devices=[dev] * (dp * tp))
            fg.gather_rows.launches = 0   # count the main path's run only
            out = driver.run(total_env_frames=frames,
                             wall_clock_limit_s=wall_s)
        torch.cuda.synchronize()
    finally:
        BatchedInferenceServer.update_params, _DistLearnerBase.train_many = \
            orig
    wall = time.perf_counter() - t0
    adds = secs["add"]
    launches = {"gather_rows": fg.gather_rows.launches}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    peak_gb = note_memory(name, driver.hbm_budget, base)
    per_draw = 1 if driver.family == "r2d2" else 2
    replays = sum(g.replays for g in driver.learner.add_graphs().values())
    shards = out.get("replay_shards", {})
    v = calls["versions"]
    fps = out["frames"] / wall
    single = "apex" if driver.family != "r2d2" else "r2d2"
    add_ms = np.median(adds) * 1e3 if adds else math.nan
    log(f"{name}: `{preset}` on its dp={dp} x tp={tp} mesh of this card "
        f"through ApexDriver (sets {list(sets)}, {frames} frames, "
        f"{wall_s} s): frames={out['frames']} frames/s={fps:.1f} "
        f"({single}: {RATES.get(single, math.nan):.1f}); grad_steps="
        f"{out['grad_steps']} ({calls['macro']} macro-steps); host ms per "
        f"add median {add_ms:.2f} ({single}: "
        f"{ADD_MS.get(single, math.nan):.2f}); "
        f"{adds_summary(adds, out)}; {parts_summary(secs, starts, t0, wall)}; "
        f"add graph replays {replays}; "
        f"dropped {out['ingest_dropped']} (per shard "
        f"{out['ingest_dropped_per_shard']}); publications {len(v)} "
        f"(versions {v[:3]}...{v[-1:]}); replay_shards="
        f"{json.dumps(shards)}; launches={launches}; peak_mem_gb="
        f"{peak_gb:.2f} above the {base / 1e9:.2f} GB earlier phases "
        f"still held (budget {driver.hbm_budget.total / 1e9:.2f} GB, "
        f"4 shards); {wall:.2f} s; card {CARD}")
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"{name}: actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(not left, f"{name}: driver threads still running: {left}")
    check(out["grad_steps"] > 0 and out["grad_steps"]
          == k * calls["macro"] + calls["singles"],
          f"{name}: grad_steps {out['grad_steps']}, draws {calls}")
    check(launches["gather_rows"]
          == per_draw * (calls["macro"] + calls["singles"]),
          f"{name}: gather_rows launched {launches['gather_rows']} times, "
          f"expected {per_draw} per draw ({calls})")
    check_graphed(driver, ("k", k), gathers=per_draw)
    check(sum(out["ingest_dropped_per_shard"]) == driver._stage_dropped
          and len(out["ingest_dropped_per_shard"]) == dp,
          f"{name}: the per-shard drop closure fails: "
          f"{out['ingest_dropped_per_shard']} vs {driver._stage_dropped}")
    check(shards["fill_min"] == shards["fill_max"] > 0
          and len(set(shards["sizes"])) == 1
          and driver.state.replay.pos.tolist()
          == driver.state.replay.pos_dev.tolist(),
          f"{name}: the shards are not in lockstep: {shards}")
    check(v and v[0] > 0 and all(a < b for a, b in zip(v, v[1:])),
          f"{name}: publications did not advance past version 0: {v}")
    RATES[name] = fps
    del driver
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_legacy(seed: int) -> dict:
    """`--config pong` with replay.ingest_zero_copy=False (no stager:
    batches concatenate into blocks at each flush and ship through the
    learner's eager add), 4 actors, LEGACY_WALL_S. ApexDriver._add_block
    is timed on the host clock. Checks: a clean end, no stager, frames
    reaching replay, the learner's graph and the gather. -> the launch
    counts of this run."""
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver

    seen: dict = {}
    flushes: list[float] = []
    orig = (ApexDriver.__init__, ApexDriver._add_block)

    def driver_init(self, *a, **kw):
        orig[0](self, *a, **kw)
        seen["driver"] = self

    def add_block(self, take, count):
        t0 = time.perf_counter()
        orig[1](self, take, count)
        flushes.append(time.perf_counter() - t0)

    argv = ["--config", "pong", "--seed", str(seed), "--total-env-frames",
            "60000", "--wall-clock-limit", str(LEGACY_WALL_S),
            "--device", DEVICE]
    for s_ in LEGACY_SETS:
        argv += ["--set", s_]
    threads_before = {t.ident for t in threading.enumerate()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ApexDriver.__init__, ApexDriver._add_block = driver_init, add_block
    fg.gather_rows.launches = 0       # count the main path's run only
    try:
        out, wall = run_cli(argv)
    finally:
        ApexDriver.__init__, ApexDriver._add_block = orig
    launches = {"gather_rows": fg.gather_rows.launches}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    driver = seen.pop("driver")
    peak_gb = note_memory("legacy", driver.hbm_budget)
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"legacy: actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(not left, f"legacy: driver threads still running: {left}")
    check(driver._stager is None, "legacy: the zero-copy stager was built")
    check(flushes and driver._replay_filled > 0
          and driver.state.replay.size == driver._replay_filled,
          f"legacy: no frames reached replay ({len(flushes)} flushes, "
          f"filled {driver._replay_filled})")
    check(out["grad_steps"] > 0 and launches["gather_rows"] > 0,
          f"legacy: grad_steps {out['grad_steps']}, launches {launches}")
    ms = np.asarray(flushes) * 1e3
    log(f"legacy: `{' '.join(argv)}`: frames={out['frames']} "
        f"frames/s={out['frames'] / wall:.1f} (apex: "
        f"{RATES.get('apex', math.nan):.1f}); {len(ms)} block adds, host "
        f"ms per flush's add median {np.median(ms):.2f} p90 "
        f"{np.percentile(ms, 90):.2f} (concatenate, copy, eager add; "
        f"apex's graphed add {ADD_MS.get('apex', math.nan):.2f}); replay "
        f"{driver._replay_filled} transitions; grad_steps="
        f"{out['grad_steps']}; dropped {out['ingest_dropped']}; "
        f"launches={launches}; peak_mem_gb={peak_gb:.2f}; {wall:.2f} s; "
        f"card {CARD}")
    del driver
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_dist_cold(seed: int) -> dict:
    """The tiers: configuration at dp=2 (two shards of TIERS_CAPACITY/2
    on a mesh of this card twice), through ApexDriver: each shard plans,
    reads and overwrites its own region. Checks: a clean end, at least
    one swap per shard, the closure evicted == stored + dropped per
    shard and in all, the swap graphs replayed, the gather. -> the
    launch counts of this run."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver
    from ape_x_dqn_tpu_torch.runtime.train import apply_overrides

    tmp = tempfile.mkdtemp(prefix="apex-chip-smoke-dist-cold-")
    sets = [f"replay.capacity={TIERS_CAPACITY}",
            f"replay.min_fill={TIERS_CAPACITY // 2}",
            f"replay.cold_tier_capacity={TIERS_CAPACITY}",
            f"replay.cold_tier_disk_dir={os.path.join(tmp, 'disk')}",
            f"replay.cold_tier_disk_capacity={16 * TIERS_CAPACITY}",
            "parallel.dp=2", "parallel.tp=1", *TIERS_SETS]
    cfg = apply_overrides(get_config("pong"), sets).replace(seed=seed)
    dev = torch.device(DEVICE)
    threads_before = {t.ident for t in threading.enumerate()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    driver = ApexDriver(cfg, device=dev, mesh_devices=[dev, dev])
    fg.gather_rows.launches = 0       # count the main path's run only
    out = driver.run(total_env_frames=DIST_COLD_FRAMES,
                     wall_clock_limit_s=DIST_COLD_WALL_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gather_rows": fg.gather_rows.launches}
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before]
    peak_gb = note_memory("dist_cold", driver.hbm_budget)
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"dist_cold: actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(not left, f"dist_cold: driver threads still running: {left}")
    check_graphed(driver, ("k", 4), gathers=2)
    ct = out.get("cold_tier") or {}
    ev, st, dr = (np.asarray(ct.get(f"{k}_per_shard", []))
                  for k in ("evicted", "stored", "dropped"))
    check(ev.shape == (2,) and (ev > 0).all()
          and np.array_equal(ev, st + dr) and ev.sum() == ct["evicted"]
          and ct["evicted"] == ct["stored"] + ct["dropped"],
          f"dist_cold: the per-shard closure fails or a shard never "
          f"swapped: {ct}")
    graphs = ct.get("swap_graph_replays", {})
    check(graphs.get("evict", 0) > 0 and graphs.get("add_at", 0) > 0,
          f"dist_cold: the swap graphs never replayed: {graphs}")
    rs = driver.state.replay
    check(rs.pos.tolist() == rs.pos_dev.tolist()
          and rs.size.tolist() == rs.size_dev.tolist()
          and (rs.size == TIERS_CAPACITY // 2).all(),
          f"dist_cold: shard cursors {rs.pos}/{rs.size} vs device "
          f"{rs.pos_dev.tolist()}/{rs.size_dev.tolist()}")
    log(f"dist_cold: the tiers: configuration at dp=2 (sets {sets}): "
        f"frames={out['frames']} frames/s={out['frames'] / wall:.1f} "
        f"(tiers: {RATES.get('tiers', math.nan):.1f}); grad_steps="
        f"{out['grad_steps']}; evicted per shard {ev.tolist()} = stored "
        f"{st.tolist()} + dropped {dr.tolist()}; recalled "
        f"{ct.get('recalled')}; swap graph replays {graphs}; "
        f"launches={launches}; peak_mem_gb={peak_gb:.2f}; {wall:.2f} s; "
        f"card {CARD}")
    shutil.rmtree(tmp, ignore_errors=True)
    del driver, rs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def held_memory() -> dict:
    """What this process still holds on the card after its phases, with
    its cache freed: allocated and reserved bytes, then the same after
    cuBLAS's per-stream workspaces are released (they are allocated
    through the caching allocator, one per (handle, stream) that ran a
    matmul, and live until released)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"allocated": torch.cuda.memory_allocated(),
           "reserved": torch.cuda.memory_reserved()}
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        torch.cuda.empty_cache()
    out["allocated_after_cublas"] = torch.cuda.memory_allocated()
    out["reserved_after_cublas"] = torch.cuda.memory_reserved()
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mh_ranks(name: str, argv: list[str], nproc: int = 2,
             device: str | None = None) -> list[dict]:
    """`nproc` ranks of `python -m ape_x_dqn_tpu_torch.runtime.train ARGV
    --device DEVICE --coordinator 127.0.0.1:<free port> --num-processes
    NPROC --process-id i`, started together (`device` None: the gloo
    pairs' one card, cuda:0, shared; "cuda" places rank i on card i);
    each must exit 0 within MH_TIMEOUT_S (a rank that dies fails the
    phase, and its survivor's collective fails or its StallWatchdog ends
    it). Each rank writes to files, not pipes (a full pipe would stall a
    rank inside the run and its peers in a collective), with Python's
    fault handler on: a rank still running at the deadline gets SIGABRT,
    which prints every thread's stack to its stderr, and then is killed.
    -> their summaries, with each one's stderr header."""
    if device is None:
        device = DEVICE if DEVICE == "cpu" else "cuda:0"
    port = free_port()
    logs = tempfile.mkdtemp(prefix=f"apex-chip-smoke-{name}-")
    files = [(open(os.path.join(logs, f"rank{pid}.out"), "w+"),
              open(os.path.join(logs, f"rank{pid}.err"), "w+"))
             for pid in range(nproc)]
    env = dict(os.environ, PYTHONFAULTHANDLER="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ape_x_dqn_tpu_torch.runtime.train", *argv,
         "--device", device, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(nproc), "--process-id", str(pid)],
        stdout=out, stderr=err, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for pid, (out, err) in enumerate(files)]
    deadline = time.monotonic() + MH_TIMEOUT_S
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        live = [p for p in procs if p.poll() is None]
        for p in live:
            p.send_signal(signal.SIGABRT)
        for p in live:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    ends = []
    for out, err in files:
        ends.append(tuple(f.seek(0) or f.read() for f in (out, err)))
        out.close()
        err.close()
    shutil.rmtree(logs, ignore_errors=True)
    codes = [p.returncode for p in procs]
    # every rank's stderr, so a failure names the rank that caused it
    check(codes == [0] * nproc, f"{name}: the ranks exited {codes} "
          f"(aborted after {MH_TIMEOUT_S} s when negative; the stacks "
          f"follow): " + " | ".join(
              f"rank {pid}: {err[-6000:]}"
              for pid, (_, err) in enumerate(ends)))
    outs = []
    for stdout, stderr in ends:
        out = json.loads(stdout.strip().splitlines()[-1])
        out["header"] = [ln for ln in stderr.splitlines()
                         if ln.startswith("[multihost]")]
        outs.append(out)
    return outs


def mh_check(name: str, outs: list[dict], steps0: int = 0,
             backend: str = "gloo") -> dict:
    """The lockstep invariants of a multi-rank run and what it measured:
    equal grad_steps, frames, loss and param checksum on every rank;
    each rank fed experience, exchanged once per SGD step of this run
    over `backend` ("gloo": every rank on one card, the macro-step in
    captured segments around the host collective; "nccl": every rank
    alone on its card, ONE captured graph per step endpoint), replayed
    its add graph, launched the gather, and peaked under its memory
    budget (less its NCCL part, which lies outside the allocator and
    `nccl_probe` holds apart) on a card that holds every rank on it.
    -> the run's numbers."""
    nproc = len(outs)
    key = [(o["grad_steps"], o["frames"], o["loss"],
            o["multihost"]["params_crc32"]) for o in outs]
    check(all(o["actor_errors"] == [] for o in outs),
          f"{name}: actor_errors {[o['actor_errors'] for o in outs]}")
    check(len(set(key)) == 1 and key[0][0] > steps0 and key[0][1] > 0
          and math.isfinite(key[0][2]),
          f"{name}: the ranks are not in lockstep: {key}")
    on_card = nproc if backend == "gloo" else 1
    card = torch.cuda.get_device_properties(0).total_memory
    per = []
    for pid, o in enumerate(outs):
        mh = o["multihost"]
        ex = mh["exchange"]
        steps = o["grad_steps"] - steps0
        graphs = list(mh["step_graphs"].values())
        check(o["frames_local"] > 0 and o["params_version"] > 0,
              f"{name}: rank {pid} fed nothing or never published: {o}")
        check(mh["backend"] == ex["backend"] == backend
              and mh["world_size"] == nproc
              and mh["processes_on_card"] == on_card
              and mh["rows"][1] - mh["rows"][0] > 0,
              f"{name}: rank {pid}'s group: {mh}")
        check(ex["calls"] == steps, f"{name}: rank {pid} exchanged "
              f"{ex['calls']} times for {steps} SGD steps")
        one_graph = bool(graphs) and all(n == 1 for n in graphs)
        check((one_graph if backend == "nccl"
               else any(n > 1 for n in graphs))
              and mh["add_graph_replays"] > 0,
              f"{name}: rank {pid} replayed the wrong step graphs for "
              f"{backend} or no add graph: {mh['step_graphs']}, "
              f"{mh['add_graph_replays']}")
        # the allocator's peak against the budget less NCCL's part
        nccl_budget = mh["hbm_budget_nccl_bytes"]
        check(mh["peak_mem_bytes"] <= mh["hbm_budget_bytes"] - nccl_budget
              and on_card * mh["hbm_budget_bytes"] <= card
              and (nccl_budget > 0) == (backend == "nccl"),
              f"{name}: rank {pid} peak {mh['peak_mem_bytes'] / 1e9:.2f} "
              f"GB vs its budget {mh['hbm_budget_bytes'] / 1e9:.2f} GB "
              f"({nccl_budget} B of it NCCL's)")
        check(mh["gather_rows_launches"] > 0,
              f"{name}: rank {pid} never launched gather_rows")
        calls = max(ex["calls"], 1)
        window = max(o["train_wall_s"], 1e-9)
        per.append({
            "grad_steps_per_s": steps / window,
            "dispatch_share": o["dispatch_s"] / window,
            # the window by part of the round loop, and what no part
            # holds (the loop's own bookkeeping)
            "round_share": {k: round(v / window, 4) for k, v in
                            {**o["round_s"], "rest": window - sum(
                                o["round_s"].values())}.items()},
            "collective_ms": (ex["collective_s"] / calls * 1e3
                              if backend == "gloo" else None),
            "wait_ms": (ex["wait_s"] / calls * 1e3 if backend == "gloo"
                        else None),
            "nccl_budget": nccl_budget,
            "bytes_per_step": ex["bytes_sent"] // calls,
            "launches": mh["gather_rows_launches"],
            "peak_gb": mh["peak_mem_bytes"] / 1e9,
            "peak_reserved_gb": mh["peak_reserved_bytes"] / 1e9,
            "budget_gb": mh["hbm_budget_bytes"] / 1e9})
    return {"ranks": per,
            "gather_rows": sum(r["launches"] for r in per)}


def mh_line(name: str, what: str, outs: list[dict], got: dict,
            wall: float, beside: str, backend: str = "gloo") -> None:
    r = got["ranks"]
    nproc = len(outs)
    where = (f"{nproc} ranks on this card over gloo" if backend == "gloo"
             else f"{nproc} rank(s), each alone on its card, over NCCL")
    if backend == "gloo":
        exchange = (f"{[round(x['collective_ms'], 3) for x in r]} ms in "
                    f"gloo's all_gather after "
                    f"{[round(x['wait_ms'], 3) for x in r]} ms waiting for "
                    f"the device")
    else:
        exchange = ("inside the step graph (its device time and NCCL's "
                    "memory: the nccl_probe line)")
    log(f"{name}: {what}: {where} ({outs[0]['header']}); lockstep: "
        f"grad_steps {[o['grad_steps'] for o in outs]}, frames "
        f"{[o['frames'] for o in outs]}, loss "
        f"{[o['loss'] for o in outs]!r}, params crc32 "
        f"{outs[0]['multihost']['params_crc32']} on every rank; "
        f"frames_local {[o['frames_local'] for o in outs]}; gather_rows "
        f"launches per rank {[x['launches'] for x in r]}; grad-steps/s in "
        f"the training window {[round(x['grad_steps_per_s'], 2) for x in r]} "
        f"({beside}), of which the dispatches (up to each one's loss on "
        f"the host) took {[round(x['dispatch_share'], 4) for x in r]}, "
        f"the window by part of the round loop "
        f"{[x['round_share'] for x in r]}; "
        f"the exchange per SGD step: {exchange}, "
        f"{r[0]['bytes_per_step']} B sent and "
        f"{nproc * r[0]['bytes_per_step']} B received a rank; peak "
        f"{[round(x['peak_gb'], 2) for x in r]} GB a rank (reserved "
        f"{[round(x['peak_reserved_gb'], 2) for x in r]}) vs its budget "
        f"{r[0]['budget_gb']:.2f} GB; step graphs a call replays "
        f"{outs[0]['multihost']['step_graphs']}; results "
        f"{json.dumps([{k: o[k] for k in ('grad_steps', 'frames', 'frames_local', 'wall_s', 'train_wall_s', 'dispatch_s', 'restored_step', 'params_version', 'checkpoint_saves')} for o in outs])}; "
        f"{wall:.2f} s; card {CARD}")


def phase_multihost(seed: int) -> dict:
    """The multi-host learner as two processes sharing this card over
    gloo, each through the CLI: `mh_apex` (atari57_apex at full width on
    its dp=4 x tp=2 mesh, two shards a rank), `mh_r2d2` (r2d2 the same
    way) and `mh_resume` (a two-rank checkpoint resume at a small
    width). Before them this process frees its cache and prints what it
    still holds. -> the gather launches by phase (both ranks)."""
    held = held_memory()
    log(f"mh: this process holds {held['allocated'] / 1e9:.3f} GB "
        f"allocated, {held['reserved'] / 1e9:.3f} GB reserved with its "
        f"cache freed; after releasing cuBLAS's per-stream workspaces "
        f"{held['allocated_after_cublas'] / 1e9:.3f} GB allocated, "
        f"{held['reserved_after_cublas'] / 1e9:.3f} GB reserved; card "
        f"{CARD}")
    launches = {}
    for name, preset, sets, extra, beside in (
            ("mh_apex", "atari57_apex", MH_APEX_SETS,
             ["--total-env-frames", str(MH_APEX_FRAMES)],
             "dist: atari57_apex learner alone, one process: "
             f"{RATES.get('dist_atari57_apex_graph', math.nan):.2f}"),
            ("mh_r2d2", "r2d2", MH_R2D2_SETS,
             ["--total-env-frames", str(MH_R2D2_FRAMES),
              "--max-grad-steps", str(MH_R2D2_STEPS)],
             "dist: r2d2 learner alone, one process: "
             f"{RATES.get('dist_r2d2_graph', math.nan):.2f}")):
        argv = ["--config", preset, "--seed", str(seed), *extra]
        for s_ in sets:
            argv += ["--set", s_]
        t0 = time.perf_counter()
        outs = mh_ranks(name, argv)
        wall = time.perf_counter() - t0
        got = mh_check(name, outs)
        mh_line(name, f"`{' '.join(argv)}`", outs, got, wall, beside)
        launches[name] = {"gather_rows": got["gather_rows"],
                          "bytes_per_step": got["ranks"][0]["bytes_per_step"]}
    ckpt = tempfile.mkdtemp(prefix="apex-chip-smoke-mh-ckpt-")
    try:
        t0 = time.perf_counter()
        base = ["--config", "pong", "--seed", str(seed),
                "--total-env-frames", "1000000", "--checkpoint-dir", ckpt]
        for s_ in MH_RESUME_SETS:
            base += ["--set", s_]
        first = mh_ranks("mh_resume", base + ["--max-grad-steps",
                                             str(MH_RESUME_STEPS[0])])
        got1 = mh_check("mh_resume", first)
        check(all(o["restored_step"] is None
                  and o["grad_steps"] == MH_RESUME_STEPS[0] for o in first),
              f"mh_resume: run 1 {first}")
        second = mh_ranks("mh_resume", base + ["--max-grad-steps",
                                              str(MH_RESUME_STEPS[1])])
        got2 = mh_check("mh_resume", second, steps0=MH_RESUME_STEPS[0])
        check(all(o["restored_step"] == MH_RESUME_STEPS[0]
                  and o["grad_steps"] == MH_RESUME_STEPS[1]
                  for o in second),
              f"mh_resume: run 2 did not resume at {MH_RESUME_STEPS[0]} "
              f"and train on to {MH_RESUME_STEPS[1]}: {second}")
        wall = time.perf_counter() - t0
        mh_line("mh_resume", f"`{' '.join(base)}` to "
                f"{MH_RESUME_STEPS[0]} grad-steps, then again to "
                f"{MH_RESUME_STEPS[1]} (restored_step "
                f"{second[0]['restored_step']} on both ranks); run 2",
                second, got2, wall, "a small CNN, free-running")
        launches["mh_resume"] = {"gather_rows": got1["gather_rows"]
                                 + got2["gather_rows"]}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return launches


def _outside_allocator(dev: torch.device) -> int:
    """Bytes of the card in use outside this process's caching allocator
    (its CUDA context, NCCL's buffers, ..., and other processes')."""
    free, total = torch.cuda.mem_get_info(dev)
    return total - free - torch.cuda.memory_reserved(dev)


def nccl_probe_rank(rank: int, nproc: int, port: int, numel: int,
                    out_dir: str) -> None:
    """One rank of `nccl_probe`, alone on card `rank`."""
    from ape_x_dqn_tpu_torch.parallel import multihost
    import torch.distributed as dist

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    multihost.init_multihost(f"127.0.0.1:{port}", nproc, rank, device=dev)
    graph = None
    try:
        send = torch.full((numel,), float(rank + 1), device=dev)
        out = torch.empty((nproc, numel), device=dev)
        torch.cuda.synchronize(dev)
        before = _outside_allocator(dev)
        ex = multihost.GradExchange("nccl", dev)   # the communicator
        ex(send, out)
        torch.cuda.synchronize(dev)
        eager = _outside_allocator(dev) - before
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        out.zero_()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            ex(send, out)
        graph.replay()
        torch.cuda.synchronize(dev)
        graphed = _outside_allocator(dev) - before
        right = bool(torch.equal(out, torch.arange(
            1, nproc + 1, dtype=torch.float32, device=dev)[:, None]
            .expand(nproc, numel)))
        # the device time: calls queued behind a device sleep, timed from
        # the end of the first one (which waits for every peer's sleep)
        multihost.barrier()
        stream = torch.cuda.current_stream(dev)
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        slept.record(stream)
        torch.cuda._sleep(NCCL_SLEEP_CYCLES)
        ex(send, out)
        start.record(stream)
        t0 = time.perf_counter()
        for _ in range(NCCL_TIMED_CALLS):
            ex(send, out)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record(stream)
        end.synchronize()
        res = {"rank": rank, "right": right, "nccl_bytes_eager": eager,
               "nccl_bytes": graphed,
               "device_ms_per_call": start.elapsed_time(end)
               / NCCL_TIMED_CALLS,
               "sleep_ms": slept.elapsed_time(start),
               "enqueue_ms": enqueue_ms, "calls": ex.stats()["calls"]}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        # the graph before the group: NCCL destroys no communicator that
        # a live graph's collective holds
        del graph
        gc.collect()
        dist.destroy_process_group()


def nccl_probe(nproc: int, numel: int) -> dict:
    """An NCCL group of `nproc` spawned ranks, rank i alone on card i, as
    `mh_nccl`'s ranks are placed: NCCL's memory outside the allocator
    across the communicator's creation, one eager and one captured
    all-gather of `numel` float32 a rank (r2d2's exchange), checked
    against the budget's NCCL part (utils/hbm.py: NCCL_DEVICE_BYTES);
    the gathered values; and one call's device time (NCCL_TIMED_CALLS
    calls queued behind a device sleep). -> rank 0's numbers, with
    every rank's."""
    import torch.multiprocessing as mp
    from ape_x_dqn_tpu_torch.utils.hbm import NCCL_DEVICE_BYTES

    out_dir = tempfile.mkdtemp(prefix="apex-chip-smoke-nccl-probe-")
    ctx = mp.start_processes(nccl_probe_rank,
                             args=(nproc, free_port(), numel, out_dir),
                             nprocs=nproc, join=False, start_method="spawn")
    deadline = time.monotonic() + NCCL_PROBE_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            check(time.monotonic() < deadline, f"nccl_probe: {nproc} "
                  f"rank(s) did not end within {NCCL_PROBE_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    for res in ranks:
        check(res["right"] and res["calls"] == 2 + NCCL_TIMED_CALLS,
              f"nccl_probe: rank {res['rank']} gathered wrong values or "
              f"miscounted: {res}")
        check(res["nccl_bytes"] <= NCCL_DEVICE_BYTES,
              f"nccl_probe: rank {res['rank']}'s NCCL took "
              f"{res['nccl_bytes']} B outside the allocator, above the "
              f"budget's NCCL part {NCCL_DEVICE_BYTES}: {res}")
        check(0 < res["device_ms_per_call"]
              and res["enqueue_ms"] < res["sleep_ms"],
              f"nccl_probe: rank {res['rank']}'s timing is not device "
              f"time alone (the host's enqueue outlasted the sleep): {res}")
    log(f"nccl_probe: {nproc} rank(s), each alone on its card, "
        f"all_gather_into_tensor of {numel * 4} B a rank: NCCL outside "
        f"the allocator {[r['nccl_bytes'] for r in ranks]} B after the "
        f"communicator, one eager and one captured call "
        f"({[r['nccl_bytes_eager'] for r in ranks]} B before the capture) "
        f"against the budget's {NCCL_DEVICE_BYTES}; device time "
        f"{[round(r['device_ms_per_call'], 5) for r in ranks]} ms a call "
        f"({NCCL_TIMED_CALLS} calls behind a "
        f"{[round(r['sleep_ms'], 2) for r in ranks]} ms device sleep, "
        f"enqueued in {[round(r['enqueue_ms'], 2) for r in ranks]} ms), "
        f"{[round(numel * 4 * nproc / r['device_ms_per_call'] / 1e6, 1) for r in ranks]} "
        f"GB/s received; card {CARD}")
    return {"ranks": ranks}


def phase_mh_nccl(seed: int, gloo_bytes: int) -> dict:
    """r2d2 at full width over NCCL, one rank per card, each through the
    CLI with `--device cuda` (rank i on card i): a world of one (the
    whole dp=4 mesh on card 0), then, where two or more cards are
    visible, two ranks on two cards and `dp_scaling_efficiency` (the
    two-rank grad-steps/s over twice the one-rank rate). Before each,
    `nccl_probe` at the same placement. Each run: the backend nccl, one
    graph per macro-step, the lockstep invariants, one exchange per SGD
    step of `gloo_bytes` (mh_r2d2's: the same model), each rank's peak
    under its budget. -> the gather launches (every rank of every
    run)."""
    cards = 1 if DEVICE == "cpu" else torch.cuda.device_count()
    rates, launches = {}, 0
    for nproc in ((1, 2) if cards >= 2 else (1,)):
        if DEVICE != "cpu":
            nccl_probe(nproc, gloo_bytes // 4)
        argv = ["--config", "r2d2", "--seed", str(seed),
                "--total-env-frames", str(MH_NCCL_FRAMES),
                "--max-grad-steps", str(MH_NCCL_STEPS),
                "--set", f"actors.num_actors={MH_NCCL_ACTORS // nproc}"]
        for s_ in MH_NCCL_SETS:
            argv += ["--set", s_]
        t0 = time.perf_counter()
        outs = mh_ranks("mh_nccl", argv, nproc, DEVICE)
        wall = time.perf_counter() - t0
        got = mh_check("mh_nccl", outs, backend="nccl")
        check(all(r["bytes_per_step"] == gloo_bytes for r in got["ranks"]),
              f"mh_nccl: {[r['bytes_per_step'] for r in got['ranks']]} B "
              f"a step, mh_r2d2 exchanged {gloo_bytes}")
        rates[nproc] = min(r["grad_steps_per_s"] for r in got["ranks"])
        launches += got["gather_rows"]
        mh_line("mh_nccl", f"`{' '.join(argv)}`", outs, got, wall,
                "dist: r2d2 learner alone, one process: "
                f"{RATES.get('dist_r2d2_graph', math.nan):.2f}",
                backend="nccl")
    if 2 in rates:
        log(f"mh_nccl: dp_scaling_efficiency "
            f"{rates[2] / (2 * rates[1]):.4f} (two ranks on two cards "
            f"{rates[2]:.2f} grad-steps/s, one rank {rates[1]:.2f}); card "
            f"{CARD}")
    else:
        log(f"mh_nccl: dp_scaling_efficiency not measured: {cards} card "
            f"visible, and two ranks need two")
    return {"gather_rows": launches}


def cards_devices() -> list:
    """The presets' dp=4 x tp=2 mesh spread over the visible cards:
    [c0, c1, c2, c3] * 2 with four or more (two card groups, each split
    over two cards), [c0, c1] * 4 with two or three (one group on c0,
    split with c1)."""
    n = 4 if torch.cuda.device_count() >= 4 else 2
    cards = [torch.device("cuda", i) for i in range(n)]
    return cards * (8 // n)


def cards_snapshot(state, m) -> dict:
    """`dist_snapshot` of a learner over cards, through its layout-free
    checkpoint tree (params, target and Adam whole), the groups' trees
    and cursors in group order, and every metric, on the host."""
    from ape_x_dqn_tpu_torch.runtime.learner import checkpoint_tree
    from ape_x_dqn_tpu_torch.runtime.step_graph import pack_metrics

    def host(t):
        return t.detach().cpu().clone()

    tree = checkpoint_tree(state)
    snap = {f"{part}.{k}": host(v)
            for part in ("params", "target_params")
            for k, v in tree[part].items()}
    opt = tree["opt_state"]
    snap["opt.count"] = host(opt["count"])
    for i, (mu, nu) in enumerate(zip(opt["mu"], opt["nu"])):
        snap[f"opt.mu{i}"], snap[f"opt.nu{i}"] = host(mu), host(nu)
    groups = getattr(state, "groups", [state])
    for i, st in enumerate(groups):
        snap[f"tree{i}"] = host(st.replay.tree)
        snap[f"cursors{i}"] = torch.cat([host(st.replay.pos_dev),
                                         host(st.replay.size_dev)])
    snap["metrics"] = host(pack_metrics(m)[0])
    for k, v in m.items():
        if k != "diag":         # the diagnostics are per group's rows
            snap[f"metric.{k}"] = host(v).float().reshape(-1)
    return snap


def rel_change(got: dict, want: dict, base: dict | None = None) -> float:
    """||(got - base) - (want - base)|| / ||want - base|| over the keys
    of `want` (without `base`: ||got - want|| / ||want||)."""
    def d(x, k):
        return x[k].double() - (base[k].double() if base else 0)

    num = sum(float(((d(got, k) - d(want, k)) ** 2).sum()) for k in want)
    den = sum(float((d(want, k) ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def cards_run(dev, seed: int, preset: str, devices: list,
              capture: bool, dtype: str | None = None) -> dict:
    """CARDS_STEPS K=4 macro-steps of the preset's learner over
    `devices` (graphs, or eager with `capture` off; deterministic),
    snapshots after the 1st and the last, the params before the first;
    with the graphs at the preset's dtype, the gather launches by card,
    the graphs a macro-step replays, then the rate (host clock over
    RATE_STEPS macro-steps, the graph captured anew without the
    deterministic algorithms) and each card's peak against its budget.
    `dtype` "float32" runs without TF32 and measures nothing. The
    learner is freed before this returns."""
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    from ape_x_dqn_tpu_torch.utils.hbm import mesh_budgets

    cards = list(dict.fromkeys(devices))
    base = {}
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
        base[d] = torch.cuda.memory_allocated(d)
    t0 = time.perf_counter()
    cfg, learner, state = dist_learner(dev, seed, preset, capture, devices,
                                       dtype)
    build_s = time.perf_counter() - t0
    k = cfg.learner.sample_chunk
    init = {n: v.detach().cpu().clone()
            for n, v in checkpoint_params(state).items()}
    fg.gather_rows.by_device.clear()
    fg.gather_rows.launches = 0       # count this learner's run only
    snaps = []
    with deterministic(), (no_tf32() if dtype == "float32"
                           else contextlib.nullcontext()):
        for i in range(CARDS_STEPS):
            state, m = learner.train_step_k(state, k)
            if i in (0, CARDS_STEPS - 1):
                snaps.append(cards_snapshot(state, m))
    torch.cuda.synchronize(dev)
    out = {"snaps": snaps, "build_s": build_s, "init": init,
           "launches": dict(fg.gather_rows.by_device)}
    if capture and len(cards) > 1 and dtype is None:
        graph = learner.step_graphs()[("k", k)]
        out.update(captured=graph.captured, graphs=graph.graphs,
                   gathers={str(o): n for o, n in graph.gathers.items()},
                   layout=learner.layout(),
                   exchange=learner.exchange.stats())
        learner.__dict__.pop("_graphs")
        del graph
        gc.collect()
        learner_step(learner, state, k)      # the eager warm-up
        out["rate"] = learner_rate(learner, state, k, RATE_STEPS, True)
        budgets = mesh_budgets(
            cfg, (84, 84, 4), np.uint8,
            {key: tuple(v.shape) for key, v in
             checkpoint_params(state).items()}, learner.mesh)
        out["memory"] = {
            str(d): (torch.cuda.max_memory_allocated(d) - base[d],
                     budgets[d].total) for d in cards}
    del learner, state, m
    gc.collect()
    for d in cards:
        torch.cuda.synchronize(d)
    torch.cuda.empty_cache()
    return out


def checkpoint_params(state) -> dict:
    from ape_x_dqn_tpu_torch.runtime.learner import checkpoint_tree

    return checkpoint_tree(state)["params"]


def cards_learners(dev, seed: int) -> dict:
    """cards (a): both presets' learners alone on their dp=4 x tp=2 mesh
    spread over the visible cards (`cards_devices`): the graphs against
    the eager bodies, bitwise, after 1 and CARDS_STEPS macro-steps; the
    learner against the stacked learner on this card (every shard here,
    the layers whole) from the same state and noise, both in float32
    without TF32, over the first macro-step (its four steps draw the
    same samples from the same trees): Adam's first moment, the scalar
    metrics and the params' change within CARDS_REL_TOL (`rel_change`);
    grad-steps/s beside dist:'s; gather launches by
    card; graphs per macro-step; each card's peak against its budget.
    -> the gather launches of the graph runs."""
    devices = cards_devices()
    launches = 0
    for preset in ("atari57_apex", "r2d2"):
        t0 = time.perf_counter()
        stacked = cards_run(dev, seed, preset, [dev] * 8, True, "float32")
        exact = cards_run(dev, seed, preset, devices, True, "float32")
        g = cards_run(dev, seed, preset, devices, True)
        e = cards_run(dev, seed, preset, devices, False)
        check(g["captured"], f"cards {preset}: the graph run did not "
              f"capture")
        for after, gs, es in zip((1, CARDS_STEPS), g["snaps"], e["snaps"]):
            check(gs.keys() == es.keys(), f"cards {preset}: snapshot keys")
            for name in gs:
                check(torch.equal(gs[name], es[name]), f"cards {preset}: "
                      f"{name} of the graphs != the eager bodies after "
                      f"{after} macro-steps")

        def params(snap):
            return {n[len("params."):]: v for n, v in snap.items()
                    if n.startswith("params.")}

        def scalars(snap):
            return {n: v for n, v in snap.items() if n.startswith("metric.")}

        init = stacked["init"]
        check(all(torch.equal(exact["init"][n], init[n]) for n in init),
              f"cards {preset}: the two learners start apart")
        def moments(snap):
            return {n: v for n, v in snap.items() if n.startswith("opt.mu")}

        mu = rel_change(moments(exact["snaps"][0]),
                        moments(stacked["snaps"][0]))
        first = rel_change(scalars(exact["snaps"][0]),
                           scalars(stacked["snaps"][0]))
        change = rel_change(params(exact["snaps"][0]),
                            params(stacked["snaps"][0]), init)
        later = rel_change(params(exact["snaps"][-1]),
                           params(stacked["snaps"][-1]), init)
        unchanged = rel_change(init, params(stacked["snaps"][0]), init)
        check(max(mu, first, change) <= CARDS_REL_TOL,
              f"cards {preset}: over the first macro-step, float32, Adam's "
              f"first moment {mu:.3g}, the metrics {first:.3g} and the "
              f"params' change {change:.3g} from the stacked learner's "
              f"(tolerance {CARDS_REL_TOL})")
        check(unchanged == 1.0, f"cards {preset}: the control scores "
              f"{unchanged}")
        per_draw = 1 if preset == "r2d2" else 2
        owners = g["layout"]["rows_per_card"]
        check(set(g["launches"]) == set(owners)
              and all(n == CARDS_STEPS * per_draw
                      for n in g["launches"].values()),
              f"cards {preset}: gather launches by card {g['launches']}, "
              f"expected {CARDS_STEPS * per_draw} on each owner {owners}")
        for card, (peak, budget) in g["memory"].items():
            check(peak <= budget, f"cards {preset}: card {card} peaked at "
                  f"{peak / 1e9:.2f} GB above its budget "
                  f"{budget / 1e9:.2f} GB")
        launches += sum(g["launches"].values())
        RATES[f"cards_{preset}"] = g["rate"]
        mem = {c: f"{p / 1e9:.2f}/{b / 1e9:.2f}"
               for c, (p, b) in g["memory"].items()}
        log(f"cards: {preset} learner alone on dp=4 x tp=2 over "
            f"{[str(d) for d in devices]}: layout "
            f"{json.dumps(g['layout'])}; graph == eager bitwise (params, "
            f"target, Adam, every group's trees and cursors, metrics) after "
            f"1 and {CARDS_STEPS} K=4 macro-steps; vs the stacked learner "
            f"on one card, float32 without TF32, relative distances over "
            f"the first macro-step: Adam's first moment {mu:.3g}, the "
            f"metrics {first:.3g}, the params' change {change:.3g} "
            f"(tolerance {CARDS_REL_TOL}; a learner left unchanged scores "
            f"{unchanged:.3g}); the params' change "
            f"after {CARDS_STEPS} {later:.3g} (not held: from the second "
            f"draw on, priorities that differ in their last bits move "
            f"some samples); graphs "
            f"per macro-step {g['graphs']}; gather "
            f"launches by card {g['launches']} ({g['gathers']} a replay); "
            f"exchange {json.dumps(g['exchange'])}; grad-steps/s graph="
            f"{g['rate']:.2f} (host clock over {RATE_STEPS} macro-steps; "
            f"dist: one card {RATES.get(f'dist_{preset}_graph', math.nan):.2f}"
            f", this call); peak/budget GB by card {mem}; build "
            f"{g['build_s']:.2f} s; {time.perf_counter() - t0:.2f} s; "
            f"card {CARD}")
    return {"gather_rows": launches}


def cards_cli(seed: int, name: str, preset: str, dp: int, tp: int,
              sets: tuple, frames: int, wall_s: float) -> dict:
    """cards (b)/(c): the preset through the CLI (`--config preset --set
    parallel.dp=.. --set parallel.tp=..`) on its default mesh, the
    visible cards: a clean end, the summary's mesh block (each card's
    peak above what it held before under its budget, graphs replayed,
    the gather on every owner), publications. -> its launches."""
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg

    cards = [torch.device(DEVICE, i)
             for i in range(torch.cuda.device_count())]
    base = {}
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
        base[str(d)] = torch.cuda.memory_allocated(d)
    argv = ["--config", preset, "--seed", str(seed), "--device", DEVICE,
            "--total-env-frames", str(frames),
            "--wall-clock-limit", str(wall_s),
            "--set", f"parallel.dp={dp}", "--set", f"parallel.tp={tp}"]
    for s_ in sets:
        argv += ["--set", s_]
    t0 = time.perf_counter()
    with timed_parts() as (secs, starts):
        fg.gather_rows.launches = 0   # count the main path's run only
        fg.gather_rows.by_device.clear()
        out, wall = run_cli(argv)
    adds = secs["add"]
    launches = fg.gather_rows.launches
    mesh = out.get("mesh")
    check(mesh is not None, f"{name}: the summary has no mesh block")
    check(out["actor_errors"] == [] and out["loop_errors"] == [],
          f"{name}: actor_errors {out['actor_errors']}, loop_errors "
          f"{out['loop_errors']}")
    check(out["grad_steps"] > 0, f"{name}: no grad-steps")
    k = "k4"
    check(mesh["step_graphs"].get(k, 0) > 0, f"{name}: no captured "
          f"macro-step graphs: {mesh['step_graphs']}")
    owners = set(mesh["rows_per_card"])
    per_card = mesh["per_card"]
    check(all(per_card[o]["gather_launches"] > 0 for o in owners),
          f"{name}: the gather did not launch on every owner: {per_card}")
    for card, c in per_card.items():
        peak = c["peak_allocated_bytes"] - base[card]
        check(peak <= c["budget_bytes"], f"{name}: card {card} peaked at "
              f"{peak / 1e9:.2f} GB above its budget "
              f"{c['budget_bytes'] / 1e9:.2f} GB")
    if tp > 1:
        check(mesh["split_layers"], f"{name}: tp={tp} split no layer")
    fps = out["frames"] / wall
    mem = {c: f"{(v['peak_allocated_bytes'] - base[c]) / 1e9:.2f}/"
              f"{v['budget_bytes'] / 1e9:.2f}" for c, v in per_card.items()}
    log(f"{name}: `{' '.join(argv)}` on the visible cards: frames="
        f"{out['frames']} frames/s={fps:.1f} (one card, "
        f"{'dist_apex' if 'apex' in name else 'dist_r2d2'}: "
        f"{RATES.get('dist_apex' if 'apex' in name else 'dist_r2d2', math.nan):.1f}"
        f"); grad_steps={out['grad_steps']}; layout cards {mesh['cards']}, "
        f"rows {mesh['rows_per_card']}, tp partners {mesh['tp_partners']}, "
        f"split {mesh['split_layers']}; graphs per call "
        f"{mesh['step_graphs']}; exchange {json.dumps(mesh['exchange'])}; "
        f"gather launches {launches} by card "
        f"{ {c: v['gather_launches'] for c, v in per_card.items()} }; "
        f"{adds_summary(adds, out)}; {parts_summary(secs, starts, t0, wall)}; "
        f"dropped {out['ingest_dropped']}; "
        f"peak/budget GB by card {mem}; {wall:.2f} s; card {CARD}")
    RATES[name] = fps
    gc.collect()
    torch.cuda.empty_cache()
    return {"gather_rows": launches}


def cards_server(seed: int) -> None:
    """cards (d): one batch of CARDS_SERVE_BATCH pong observations
    through the single-policy server over a mesh of the visible cards
    (the batch split over them, a replica of the params on each)
    against the plain forward of the whole batch on card 0 (bf16,
    1e-2)."""
    from ape_x_dqn_tpu_torch.parallel.inference_server import (
        BatchedInferenceServer)
    from ape_x_dqn_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    dev = torch.device(DEVICE, 0)
    _, spec, apply, params = serve_net(dev)
    mesh = make_mesh(dp=n, tp=1)
    server = BatchedInferenceServer(apply, params[0],
                                    max_batch=CARDS_SERVE_BATCH, mesh=mesh,
                                    device=dev)
    t0 = time.perf_counter()
    try:
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 255, (CARDS_SERVE_BATCH, *spec.obs_shape),
                         dtype=np.uint8)
        got = server.query_batch(x, CARDS_SERVE_BATCH)
        with torch.inference_mode():
            want = apply(params[0], torch.from_numpy(x).to(dev)).cpu()
        err = float(np.abs(np.asarray(got) - want.numpy()).max())
        check(np.asarray(got).shape == tuple(want.shape) and err <= 1e-2,
              f"cards server: the split batch's q {err} from the one-card "
              f"forward")
    finally:
        server.stop()
    log(f"cards: server over {[str(d) for d in mesh.cards]}: one batch of "
        f"{CARDS_SERVE_BATCH} pong observations split {mesh.size} ways, "
        f"max |q - one-card q| {err:.3g} (bf16, tolerance 1e-2); "
        f"{time.perf_counter() - t0:.2f} s; card {CARD}")


def cards_sites(seed: int) -> list[dict]:
    """The gather at the per-card shapes of the CLI runs over the cards,
    timed on the last card (the launcher's per-card set-up): one side
    of atari57_apex's K=4 x 512 draw at dp = the cards (one shard of
    524,288 transitions a card, 8192 / cards frame rows), and r2d2's at
    dp = cards / 2 (one shard of 65,536 / dp sequences on each owner,
    256 / dp rows)."""
    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.replay.packing import PixelPacker
    from ape_x_dqn_tpu_torch.replay.sequence import sequence_item_spec
    from ape_x_dqn_tpu_torch.runtime.build import build_prioritized_replay
    from ape_x_dqn_tpu_torch.utils.misc import next_pow2

    n = torch.cuda.device_count()
    last = torch.device("cuda", n - 1)
    a57 = get_config("atari57_apex")
    shard = build_prioritized_replay(
        a57, pong_setup(last)[1], next_pow2(a57.replay.capacity // n), last)
    kb = a57.learner.sample_chunk * a57.learner.batch_size
    r2 = get_config("r2d2")
    spec = sequence_item_spec((84, 84, 4), np.uint8, r2.replay.seq_length,
                              r2.network.lstm_size, frame_mode=True)
    seq_row = PixelPacker(spec).storage_spec(spec)["seq_frames"].shape[0]
    r2_dp = max(n // 2, 1)
    seq_m = r2.learner.sample_chunk * r2.learner.batch_size
    with torch.cuda.device(last):
        return [kernel_site(last, seed, "cards_frame_ring",
                            shard.S * shard.F, shard.frame_row,
                            kb * shard.stack // n),
                kernel_site(last, seed, "cards_sequence",
                            next_pow2(r2.replay.capacity // r2_dp), seq_row,
                            seq_m // r2_dp)]


def phase_cards(dev, seed: int) -> dict | None:
    """The one-process mesh over distinct cards, where two or more are
    visible: (a) `cards_learners`; (b) atari57_apex through the CLI
    with dp = the cards, tp=1 (dp over the cards); (c) r2d2 through
    the CLI with dp = cards / 2, tp=2 (tp across the cards, through
    the LSTM), both cut as CARDS_* say; (d) `cards_server`;
    and the gather at the per-card shapes (`cards_sites`). On one card:
    skipped, None."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"cards: skipped ({n} card visible)")
        return None
    t0 = time.perf_counter()
    out = {"learners": cards_learners(dev, seed)}
    log(f"cards (a): {time.perf_counter() - t0:.2f} s")
    out["cards_apex"] = cards_cli(seed, "cards_apex", "atari57_apex", n, 1,
                                  CARDS_APEX_SETS, CARDS_APEX_FRAMES,
                                  CARDS_APEX_WALL_S)
    out["cards_r2d2"] = cards_cli(seed, "cards_r2d2", "r2d2",
                                  max(n // 2, 1), 2, DIST_R2D2_SETS,
                                  CARDS_R2D2_FRAMES, CARDS_R2D2_WALL_S)
    cards_server(seed)
    out["sites"] = cards_sites(seed)
    log(f"cards: {time.perf_counter() - t0:.2f} s")
    return out


def memory_table() -> list[str]:
    """The HBM budget of each preset's run beside its measured peak and
    the card's memory; the transient the budget must cover (the peak
    less the replay and the model state) beside its headroom."""
    gib = 1024 ** 3
    card = torch.cuda.get_device_properties(0).total_memory
    lines = [f"memory: card {card / gib:.2f} GiB; per run: budget GiB "
             f"(replay + tree + model + headroom + the serving tier's "
             f"gather) vs measured peak GiB "
             f"(torch.cuda.max_memory_allocated), transient = peak - "
             f"replay - tree - model"]
    for name, (budget, peak) in MEMORY.items():
        if budget is None:
            continue
        fixed = budget.replay_storage + budget.replay_tree \
            + budget.model_state
        lines.append(
            f"memory: {name}: budget {budget.total / gib:.2f} (replay "
            f"{budget.replay_storage / gib:.2f}, tree "
            f"{budget.replay_tree / gib:.3f}, model "
            f"{budget.model_state / gib:.3f}, headroom "
            f"{budget.headroom / gib:.2f}, serving gather "
            f"{budget.serving_transient / gib:.2f}) vs peak "
            f"{peak / gib:.2f}; "
            f"transient {(peak - fixed) / gib:.2f}; "
            f"{'fits' if budget.total <= card else 'EXCEEDS the card'}; "
            f"{'covers' if budget.total >= peak else 'BELOW'} the peak")
    return lines


def cards_only(dev, seed: int) -> int:
    """`--cards-only`, on two or more cards: atari57_apex through
    ApexDriver on its dp=4 x tp=2 mesh of card 0 at cards_apex's depth
    (`dist_driver` with CARDS_APEX_SETS and CARDS_APEX_FRAMES), then the
    cards phase, so that the one-card and the over-cards rates and
    windows come from one call. Prints no contract line. -> 0 when
    every check passed."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"cards-only: needs two cards or more, {n} visible")
        return 1
    failed = []
    t0 = time.perf_counter()
    try:
        dist_driver(seed, "atari57_apex", CARDS_APEX_SETS,
                    CARDS_APEX_FRAMES, CARDS_APEX_WALL_S, "dist_apex")
    except Exception as e:    # reported, and the exit code says so
        failed.append(f"dist_apex: {e!r}")
    log(f"dist_apex (one card, cards_apex's depth): "
        f"{time.perf_counter() - t0:.2f} s")
    try:
        out = phase_cards(dev, seed)
        log("cards sites: " + json.dumps(out["sites"]))
        log("cards launches: " + json.dumps(
            {k: v["gather_rows"] for k, v in out.items() if k != "sites"}))
    except Exception as e:
        failed.append(f"cards: {e!r}")
    log(f"cards-only: {'FAILED ' + '; '.join(failed) if failed else 'passed'}"
        f" in {time.perf_counter() - t0:.2f} s; card {CARD}")
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards-only", action="store_true",
                    help="on two or more cards: dist_apex at cards_apex's "
                         "depth and the cards phase only (`cards_only`); "
                         "no contract line")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    global CARD
    card = CARD = card_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build (set-up time)
    from ape_x_dqn_tpu_torch.ops import frame_gather as fg
    build_s = fg.build()
    log(f"build: frame_gather.cu with nvcc for sm_90a in {build_s:.2f} s")
    if args.cards_only:
        return cards_only(dev, args.seed)

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
    # 14. the observability and operations planes
    t0 = time.perf_counter()
    obs = phase_obs(args.seed)
    log(f"obs: {time.perf_counter() - t0:.2f} s")
    # 15. the multi-tenant serving tier, alone and in the driver
    t0 = time.perf_counter()
    phase_serve_tier(dev)
    serve = phase_serve_driver(args.seed)
    log(f"serve: {time.perf_counter() - t0:.2f} s")
    # 16. the tiered cold replay through the driver
    t0 = time.perf_counter()
    tiers = phase_tiers(args.seed)
    log(f"tiers: {time.perf_counter() - t0:.2f} s")
    # 17. the dp-sharded learners alone, then through the driver on the
    # presets' own dp=4 x tp=2 meshes of this card
    t0 = time.perf_counter()
    phase_dist_learners(dev, args.seed)
    dist_apex = dist_driver(args.seed, "atari57_apex", DIST_APEX_SETS,
                            DIST_APEX_FRAMES, DIST_APEX_WALL_S, "dist_apex")
    dist_r2d2 = dist_driver(args.seed, "r2d2", DIST_R2D2_SETS,
                            DIST_R2D2_FRAMES, DIST_R2D2_WALL_S, "dist_r2d2")
    log(f"dist: {time.perf_counter() - t0:.2f} s")
    # 18. the legacy staging path, 19. the cold tier at dp=2
    t0 = time.perf_counter()
    legacy = phase_legacy(args.seed)
    log(f"legacy: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dist_cold = phase_dist_cold(args.seed)
    log(f"dist_cold: {time.perf_counter() - t0:.2f} s")
    # 20. the multi-host learner: two ranks on this card over gloo
    t0 = time.perf_counter()
    mh = phase_multihost(args.seed)
    log(f"mh: {time.perf_counter() - t0:.2f} s")
    # 21. r2d2 over NCCL, one rank per card, one graph per macro-step
    t0 = time.perf_counter()
    mh["mh_nccl"] = phase_mh_nccl(args.seed,
                                  mh["mh_r2d2"]["bytes_per_step"])
    log(f"mh_nccl: {time.perf_counter() - t0:.2f} s")
    # 22. the one-process mesh over distinct cards (two or more visible)
    cards = phase_cards(dev, args.seed)
    for line in memory_table():
        log(line)

    # one entry per kernel; its top-level numbers are the flat replay's
    # call site at its real size (flat_full), `sites` has all four
    sites[0]["launches"] = ring["gather_rows"]
    sites[0]["apex_launches"] = apex["gather_rows"]
    sites[1]["launches"] = sites[2]["launches"] = flat["gather_rows"]
    sites[3]["launches"] = r2d2["gather_rows"]
    sites[4]["launches"] = dist_apex["gather_rows"]
    sites[5]["launches"] = dist_r2d2["gather_rows"]
    sites[6]["launches"] = mh["mh_apex"]["gather_rows"]
    by_path = {}
    if cards is not None:
        cards["sites"][0]["launches"] = cards["cards_apex"]["gather_rows"]
        cards["sites"][1]["launches"] = cards["cards_r2d2"]["gather_rows"]
        sites += cards["sites"]
        by_path = {k: cards[k]["gather_rows"]
                   for k in ("learners", "cards_apex", "cards_r2d2")}
        by_path["cards_learners"] = by_path.pop("learners")
    for site in sites:
        check(site["launches"] > 0, f"gather_rows never launched on the "
              f"{site['site']} path")
    for path, counts in (("apex", apex), ("remote", remote),
                         ("resume", resume), ("obs", obs),
                         ("serve", serve), ("tiers", tiers),
                         ("legacy", legacy), ("dist_cold", dist_cold),
                         *mh.items()):
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
                                 "resume": resume["gather_rows"],
                                 "obs": obs["gather_rows"],
                                 "serve": serve["gather_rows"],
                                 "tiers": tiers["gather_rows"],
                                 "dist_apex": dist_apex["gather_rows"],
                                 "dist_r2d2": dist_r2d2["gather_rows"],
                                 "legacy": legacy["gather_rows"],
                                 "dist_cold": dist_cold["gather_rows"],
                                 **{k: v["gather_rows"]
                                    for k, v in mh.items()},
                                 **by_path},
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
