"""Atari-57 per-game suite trainer — the north-star protocol runner.

Counterpart of ``ape_x_dqn_tpu/runtime/suite.py`` on one card. The
Ape-X benchmark is per-game: Horgan et al. 2018 train ONE agent per
game and report the
median human-normalized score over the 57 games. This harness runs
those per-game trainings with one command — the full suite
sequentially, or a shard of games per invocation so a fleet of learner
hosts splits the suite — then evaluates each game's final policy
greedily and aggregates the suite metric.

Per game: a fresh ApexDriver on cfg with env.id=<game> (per-game
minimal action set, matching the paper protocol — the multi-game
id="atari57" shared-net fleet is a different, also-supported topology),
checkpoints + JSONL metrics under <out>/<game>/, and the driver's
unclipped greedy eval as the game score. Interrupted suites resume:
each game's driver auto-restores its own checkpoint directory, and
completed games (a result.json in their dir) are skipped.

Backend honesty mirrors runtime/evaluation.py: every result carries
per-game backends, and the aggregate is "median_hns" ONLY when every
game ran on the real ALE — synthetic stand-ins aggregate under
"median_hns_synthetic".

Usage:
    python -m ape_x_dqn_tpu_torch.runtime.suite --config atari57_apex \
        --out runs/suite --frames-per-game 50000000 \
        --set parallel.dp=1 --set parallel.tp=1  # on cuda
    # shard the suite across hosts:
    ... --games-shard 0/4    # host 0 of 4 trains games 0,4,8,...
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable

import torch

from ape_x_dqn_tpu_torch.configs import RunConfig
from ape_x_dqn_tpu_torch.utils.metrics import (
    ATARI_HUMAN_RANDOM, Metrics, human_normalized_score, median_hns)


def suite_games(games: Iterable[str] | None = None,
                shard: tuple[int, int] | None = None) -> tuple[str, ...]:
    out = tuple(games) if games is not None else tuple(
        sorted(ATARI_HUMAN_RANDOM))
    if shard is not None:
        i, n = shard
        if not 0 <= i < n:
            raise ValueError(f"shard {i}/{n} out of range")
        out = out[i::n]
    return out


def _check_mesh_fits(cfg: RunConfig) -> None:
    """Fail BEFORE the first game if the preset's parallel layout needs
    more devices than this host has: `atari57_apex` carries dp=4 x tp=2,
    and without this check a one-card host only finds out inside mesh
    construction after building envs and networks. The devices counted
    are the visible cards, the driver's default mesh devices
    (parallel/mesh.py)."""
    need = cfg.parallel.dp * cfg.parallel.tp
    if need <= 1:
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if need > have:
        raise ValueError(
            f"config wants a dp={cfg.parallel.dp} x tp={cfg.parallel.tp} "
            f"device mesh ({need} chips) but this host has {have} "
            f"device(s). On a single-chip host run with "
            f"--set parallel.dp=1 --set parallel.tp=1, or shard the "
            f"suite across hosts that have the chips (--games-shard).")


def train_one_game(cfg: RunConfig, game: str, game_dir: str,
                   total_env_frames: int | None,
                   max_grad_steps: int,
                   wall_clock_limit_s: float | None,
                   device: str = "cuda") -> dict:
    """One per-game Ape-X run; returns the driver summary + eval. The
    driver restores the game's own checkpoint directory, if it holds
    one, and resumes from it."""
    import gc

    import torch

    from ape_x_dqn_tpu_torch.runtime.driver import ApexDriver

    os.makedirs(game_dir, exist_ok=True)
    gcfg = cfg.replace(
        env=dataclasses.replace(cfg.env, id=game),
        checkpoint_dir=os.path.join(game_dir, "ckpt"))
    metrics = Metrics(log_path=os.path.join(game_dir, "metrics.jsonl"))
    driver = ApexDriver(gcfg, metrics=metrics, device=device)
    out = driver.run(total_env_frames=total_env_frames,
                     max_grad_steps=max_grad_steps,
                     wall_clock_limit_s=wall_clock_limit_s)
    metrics.close()
    # free this game's replay and graphs before the next game allocates
    # its own: a frame ring per game would otherwise pile up on the card
    del driver
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def run_suite_training(cfg: RunConfig, out_dir: str,
                       games: Iterable[str] | None = None,
                       shard: tuple[int, int] | None = None,
                       frames_per_game: int | None = None,
                       max_grad_steps_per_game: int = 10**9,
                       wall_clock_limit_s_per_game: float | None = None,
                       resume: bool = True,
                       device: str = "cuda") -> dict:
    """Train + evaluate each game; aggregate the suite metric.

    Requires cfg.eval_episodes > 0 (the per-game score IS the driver's
    final unclipped greedy eval)."""
    from ape_x_dqn_tpu_torch.envs.atari import atari_backend

    if cfg.eval_episodes <= 0:
        raise ValueError(
            "suite training needs cfg.eval_episodes > 0: the per-game "
            "score is the driver's final greedy eval")
    _check_mesh_fits(cfg)
    backend = atari_backend(cfg.env.kind)
    names = suite_games(games, shard)
    os.makedirs(out_dir, exist_ok=True)
    per_game: dict[str, dict] = {}
    for game in names:
        game_dir = os.path.join(out_dir, game)
        result_path = os.path.join(game_dir, "result.json")
        if resume and os.path.exists(result_path):
            with open(result_path) as fh:
                per_game[game] = json.load(fh)
            continue
        out = train_one_game(cfg, game, game_dir, frames_per_game,
                             max_grad_steps_per_game,
                             wall_clock_limit_s_per_game, device=device)
        rec = {
            "game": game,
            "backend": backend,
            "frames": out["frames"],
            "grad_steps": out["grad_steps"],
            "wall_s": out["wall_s"],
            "eval": out["eval"],
            "errors": bool(out["actor_errors"] or out["loop_errors"]),
        }
        per_game[game] = rec
        # only CLEAN runs with a real eval become resumable results: a
        # cached errored/eval-less record would be skipped forever (the
        # suite could never complete) and a partial score would
        # silently feed the median. A broken game retrains on resume
        # (its driver checkpoint still carries the progress).
        if not rec["errors"] and rec["eval"] is not None:
            with open(result_path, "w") as fh:
                json.dump(rec, fh)

    agg = _aggregate(names, per_game, shard=shard)
    # a shard writes its own file and NEVER the suite-level suite.json:
    # N shards sharing --out would otherwise overwrite each other with
    # partial aggregates, and a shard's median would masquerade under
    # the suite-level key. The full suite is
    # aggregated from the per-game result.json files (aggregate_suite /
    # CLI --aggregate-only) once every shard has finished.
    fname = (f"suite.{shard[0]}of{shard[1]}.json" if shard is not None
             else "suite.json")
    with open(os.path.join(out_dir, fname), "w") as fh:
        json.dump(agg, fh)
    return agg


def _aggregate(names: tuple[str, ...], per_game: dict[str, dict],
               shard: tuple[int, int] | None = None) -> dict:
    """Aggregate per-game records into the suite (or shard) summary.

    A sharded aggregate covers only the shard's games, so its median is
    a SHARD median: it is emitted under shard_median_hns[_synthetic]
    and the unqualified suite-level key is refused entirely."""
    clean = {g: r for g, r in per_game.items()
             if not r["errors"] and r.get("eval")}
    scores = {g: r["eval"]["mean_return"] for g, r in clean.items()}
    known = {g: s for g, s in scores.items() if g in ATARI_HUMAN_RANDOM}
    # the median key reflects the PER-GAME backends (resumed results
    # keep the backend they actually ran on): the unmarked north-star
    # key appears only when every aggregated game ran on the real ALE
    all_ale = bool(clean) and all(r["backend"] == "ale"
                                  for r in clean.values())
    agg: dict = {
        "games": list(names),
        "scores": scores,
        "hns": {g: human_normalized_score(g, s)
                for g, s in known.items()},
        "backends": {g: per_game[g]["backend"] for g in per_game},
        "per_game": per_game,
        "complete": len(scores) == len(names),
    }
    key = "median_hns" if all_ale else "median_hns_synthetic"
    if shard is not None:
        agg["shard"] = list(shard)
        key = "shard_" + key
    elif not agg["complete"]:
        # an incomplete aggregate's median covers only the finished
        # games — the same masquerade the shard key-prefix refuses
        key = "partial_" + key
    agg[key] = median_hns(known)
    return agg


def aggregate_suite(out_dir: str,
                    games: Iterable[str] | None = None) -> dict:
    """Build the FULL suite aggregate from per-game result.json files
    (the only shard-safe source of truth — every shard writes those)
    and write <out>/suite.json. Games without a result yet leave
    complete=false."""
    names = suite_games(games)
    per_game: dict[str, dict] = {}
    for game in names:
        path = os.path.join(out_dir, game, "result.json")
        if os.path.exists(path):
            with open(path) as fh:
                per_game[game] = json.load(fh)
    agg = _aggregate(names, per_game)
    with open(os.path.join(out_dir, "suite.json"), "w") as fh:
        json.dump(agg, fh)
    return agg


def main(argv: list[str] | None = None) -> int:
    import argparse

    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.runtime.train import apply_overrides

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="atari57_apex")
    ap.add_argument("--out", required=True,
                    help="suite output dir (per-game subdirs)")
    ap.add_argument("--games", default=None, metavar="G1,G2,...",
                    help="subset (default: all 57)")
    ap.add_argument("--games-shard", default=None, metavar="I/N",
                    help="train games I, I+N, I+2N, ... of the list "
                         "(fleet parallelism across learner hosts)")
    ap.add_argument("--frames-per-game", type=int, default=None)
    ap.add_argument("--max-grad-steps-per-game", type=int, default=10**9)
    ap.add_argument("--wall-clock-limit-per-game", type=float,
                    default=None)
    ap.add_argument("--no-resume", action="store_true",
                    help="retrain games that already have a result.json")
    ap.add_argument("--aggregate-only", action="store_true",
                    help="skip training: rebuild <out>/suite.json from "
                         "the per-game result.json files (run after "
                         "all --games-shard invocations finish)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; a CUDA "
                         "request without a card raises)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="dotted.key=value")
    args = ap.parse_args(argv)
    games = args.games.split(",") if args.games else None
    if args.aggregate_only:
        print(json.dumps(aggregate_suite(args.out, games=games)))
        return 0
    cfg = apply_overrides(get_config(args.config), args.set)
    shard = None
    if args.games_shard:
        i, n = args.games_shard.split("/", 1)
        shard = (int(i), int(n))
    agg = run_suite_training(
        cfg, args.out, games=games, shard=shard,
        frames_per_game=args.frames_per_game,
        max_grad_steps_per_game=args.max_grad_steps_per_game,
        wall_clock_limit_s_per_game=args.wall_clock_limit_per_game,
        resume=not args.no_resume, device=args.device)
    print(json.dumps(agg))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
