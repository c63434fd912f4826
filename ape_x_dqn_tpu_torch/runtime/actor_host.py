"""Remote actor host: actors in their own process feeding a learner host.

Counterpart of ``ape_x_dqn_tpu/runtime/actor_host.py``. The Ape-X paper
runs its actors in processes on many machines, each pushing experience
to one learner and pulling parameters from it. This module runs N actor
threads in one process, evaluates the policy on a LOCAL batched
inference server (on `device`, by default the card), pushes experience
to the learner's SocketIngestServer (``--listen``) over TCP, or through
shared memory when both run on one host (``comm.shm``), and pulls fresh
parameters on a cadence through the same connection. The actor class,
the server protocol and the warm-up example come from
runtime/family.py, so dqn, r2d2 and dpg hosts all work; each pulled
numpy tree is loaded with ``load_state_dict`` into the host's own
network before the server gets a copy.

What the original host has and the port does not yet is refused, naming
its ROADMAP Queue A item: telemetry and the flight recorder
(``obs.enabled``, items 17 and 19) and the multi-tenant serving tier
(``serving.multi_tenant``, item 16).

Entry points:
- run_actor_host(cfg, host, port, ...) — library call.
- ``python -m ape_x_dqn_tpu_torch.runtime.actor_host --config pong
  --connect HOST:PORT --actors 4`` — one actor process (on cuda; pass
  ``--device cpu`` for a host without a card).
"""

from __future__ import annotations

import os
import socket as socket_mod
import threading
import time
from typing import Any

import numpy as np
import torch

from ape_x_dqn_tpu_torch.comm.socket_transport import SocketTransport
from ape_x_dqn_tpu_torch.envs import make_env
from ape_x_dqn_tpu_torch.models import build_network
from ape_x_dqn_tpu_torch.models.dpg import (PARTS, server_params,
                                            split_server_params)
from ape_x_dqn_tpu_torch.obs.core import NULL_OBS
from ape_x_dqn_tpu_torch.parallel.inference_server import (
    BatchedInferenceServer)
from ape_x_dqn_tpu_torch.runtime.family import (
    actor_class, family_of, server_apply_fn, warmup_example)
from ape_x_dqn_tpu_torch.utils.misc import resolve_device


def default_peer_id(actor_offset: int = 0) -> str:
    """Stable-for-the-process, unique-across-the-fleet peer identity:
    hostname + pid + this host's slot in the global actor schedule."""
    return (f"{socket_mod.gethostname()}-{os.getpid()}"
            f"-a{actor_offset}")


def _refuse_unported(cfg) -> None:
    if cfg.obs.enabled:
        raise NotImplementedError(
            "obs.enabled=true asks the actor host for telemetry frames "
            "and a flight recorder, which the PyTorch package does not "
            "have yet: they wait for ROADMAP Queue A items 17 and 19. "
            "Run with obs.enabled=false.")
    if cfg.serving.multi_tenant:
        raise NotImplementedError(
            "serving.multi_tenant (the serving tier) is not ported to the "
            "PyTorch package yet: it waits for ROADMAP Queue A item 16")


def load_pulled_params(family: str, net: Any, tree: dict) -> dict:
    """Load a pulled numpy param tree into the host's network(s) with
    ``load_state_dict`` (strict: a key or shape the learner did not
    publish raises) and return an independent copy for the inference
    server, in the keys its forward takes (dpg: ``actor.*``,
    ``critic.*``)."""
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    if family == "dpg":
        parts = split_server_params(tensors)
        for name, module in zip(PARTS, net):
            module.load_state_dict(parts[name])
        return {k: v.detach().clone() for k, v in server_params(
            {name: m.state_dict() for name, m in zip(PARTS, net)}).items()}
    net.load_state_dict(tensors)
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def run_actor_host(cfg, host: str, port: int,
                   num_actors: int | None = None,
                   actor_offset: int = 0,
                   frames_per_actor: int | None = None,
                   param_poll_s: float | None = None,
                   stop_event: threading.Event | None = None,
                   wait_for_params_s: float = 60.0,
                   peer_id: str | None = None,
                   supervise: bool = False,
                   device: str | torch.device = "cuda") -> dict:
    """Run actors against a remote learner until their frame budget ends.

    actor_offset positions this host's actors inside the global eps_i
    schedule (host k of m runs indices [k*n, (k+1)*n) of num_actors*m).

    param_poll_s=None (the default) paces parameter pulls by ENV STEPS:
    the puller refreshes once the host's actors collectively advance
    cfg.actors.param_pull_every frames per actor (the paper's actors
    pull every ~400 env steps), with a 30 s keep-alive floor so an idle
    host still tracks the live epoch. A float restores a fixed
    wall-clock cadence. A failed pull keeps the last good params and
    widens the wait (bounded backoff) until pulls succeed again.

    supervise=True makes this host survive learner restarts: the wait
    for first params never times out (the transport's supervised
    reconnect loop keeps re-entering connect under backoff until a
    learner answers), and mid-run learner loss is survived by the
    transport (sends drop and back off; params re-converge to the live
    epoch on reconnect).

    device: where the host's inference server runs (a CUDA request
    without a card raises)."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
    n = num_actors or cfg.actors.num_actors
    stop_event = stop_event or threading.Event()
    peer = peer_id or default_peer_id(actor_offset)
    comm = cfg.comm
    transport = SocketTransport(
        host, port, wire_codec=comm.wire_codec,
        reconnect_base_s=comm.reconnect_base_s,
        reconnect_cap_s=comm.reconnect_cap_s,
        params_push=comm.params_push, param_codec=comm.param_codec,
        shm=comm.shm, shm_slots=comm.shm_slots,
        shm_slot_bytes=comm.shm_slot_bytes)

    # wait for the learner's first publication; under supervise the
    # wait is unbounded (a host that outlives its learner keeps
    # re-entering connect until one comes back)
    deadline = time.monotonic() + wait_for_params_s
    params, version = transport.get_params()
    while params is None and not stop_event.is_set() \
            and (supervise or time.monotonic() < deadline):
        time.sleep(0.2)
        params, version = transport.get_params()
    if params is None:
        transport.close()
        raise TimeoutError("learner never published parameters")
    bootstrap_bytes = transport.bytes_in  # the first (full) pull

    probe = make_env(cfg.env, seed=cfg.seed)
    family = family_of(cfg)
    net = build_network(cfg.network, probe.spec)
    for module in (net if family == "dpg" else (net,)):
        module.to(dev).requires_grad_(False)
    first = load_pulled_params(family, net, params)
    server = BatchedInferenceServer(
        server_apply_fn(family, net), first,
        max_batch=cfg.inference.max_batch,
        deadline_ms=cfg.inference.deadline_ms, device=dev)
    server.update_params(first, version)
    # one forward per bucket before the first query
    server.warmup(warmup_example(family, cfg, probe.spec),
                  extra_sizes=(cfg.actors.envs_per_actor,))

    # step-paced pulls (param_poll_s=None) read the live actors' frame
    # counters: refresh once the host advances param_pull_every frames
    # per actor (plain ints bumped by the actor threads: a cadence
    # heuristic, racy reads are fine)
    live_actors: list = [None] * n
    frame_paced = param_poll_s is None
    poll_tick = 0.2 if frame_paced else param_poll_s
    pull_every_frames = max(cfg.actors.param_pull_every, 1) * n
    pulls = {"applied": 0, "errors": 0}

    def param_puller() -> None:
        # NOTHING in here may kill the thread: a failed pull keeps the
        # last good params on the server and widens the wait. An epoch
        # change (learner restart) forces the update even when the new
        # incarnation's version counter restarted below ours.
        seen_epoch = transport.param_epoch
        seen_pull_errors = transport.param_pull_errors
        fail_streak = 0
        pulled_at_frames = 0
        pulled_at_t = time.monotonic()
        while not stop_event.wait(
                min(poll_tick * (2 ** min(fail_streak, 4)), 30.0)):
            if frame_paced and fail_streak == 0:
                total = sum(a.frames for a in live_actors
                            if a is not None)
                if (total - pulled_at_frames < pull_every_frames
                        and time.monotonic() - pulled_at_t < 30.0):
                    continue
                pulled_at_frames = total
            pulled_at_t = time.monotonic()
            try:
                # pushed params (if negotiated) come first: they are
                # publish-fresh; the conditional poll is the fallback
                # and the keep-alive
                p, v = transport.poll_pushed_params()
                if p is None:
                    p, v = transport.get_params()
                errs = transport.param_pull_errors
                if errs > seen_pull_errors:
                    pulls["errors"] += errs - seen_pull_errors
                    seen_pull_errors = errs
                    fail_streak += 1
                    continue
                fail_streak = 0
                if p is None:  # "unchanged" reply, or nothing pushed
                    continue
                ep = transport.param_epoch
                if v > server.params_version \
                        or (ep != -1 and ep != seen_epoch):
                    server.update_params(
                        load_pulled_params(family, net, p), v)
                    pulls["applied"] += 1
                seen_epoch = ep
            except Exception:  # noqa: BLE001 - the puller outlives anything
                pulls["errors"] += 1
                fail_streak += 1

    puller = threading.Thread(target=param_puller, name="param-pull",
                              daemon=True)
    puller.start()

    per_actor = frames_per_actor or (
        cfg.total_env_frames // max(cfg.actors.num_actors, 1))
    errors: list[tuple[int, Exception]] = []
    frames = [0] * n
    vector = cfg.actors.envs_per_actor > 1
    cls = actor_class(family, vector=vector)
    query = server.query_batch if vector else server.query

    def actor_thread(slot: int) -> None:
        idx = actor_offset + slot
        try:
            actor = cls(cfg, idx, query, transport, obs=NULL_OBS)
            live_actors[slot] = actor  # the puller paces off .frames
            frames[slot] = actor.run(per_actor, stop_event)
        except Exception as e:  # noqa: BLE001 - reported to the caller
            errors.append((idx, e))

    threads = [threading.Thread(target=actor_thread, args=(i,),
                                name=f"actor-{actor_offset + i}",
                                daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        # bounded join in a liveness loop: a wedged worker must not
        # wedge teardown unobservably
        while t.is_alive():
            t.join(timeout=5.0)
    stop_event.set()
    puller.join(timeout=2)
    server.stop()
    shm_negotiated = transport.shm_negotiated  # closing detaches it
    transport.close()
    return {"frames": sum(frames), "actors": n,
            "dropped": transport.dropped, "errors": errors,
            "drop_reasons": transport.drop_reasons,
            "reconnects": transport.reconnects,
            "epoch": transport.epoch,
            "epoch_changes": transport.epoch_changes,
            "param_pull_errors": transport.param_pull_errors,
            "param_pulls_applied": pulls["applied"],
            "param_pushes_in": transport.param_pushes_in,
            "param_codec_negotiated": transport.param_codec_negotiated,
            "param_resyncs": transport.param_resyncs,
            "bytes_out": transport.bytes_out,
            "wire_codec": transport.negotiated_codec,
            "wire_compression_ratio": round(
                transport.wire_compression_ratio, 3),
            "encode_ms": round(transport.encode_ms, 1),
            "param_bytes_in": transport.bytes_in,
            "param_bytes_bootstrap": bootstrap_bytes,
            "last_param_version": server.params_version,
            "peer_id": peer,
            "shm_negotiated": shm_negotiated,
            "shm_posts": transport.shm_posts,
            "shm_fallbacks": transport.shm_fallbacks,
            "shm_bytes_out": transport.shm_bytes_out,
            "shm_param_reads": transport.shm_param_reads,
            "device": str(dev)}


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    from ape_x_dqn_tpu_torch.configs import get_config
    from ape_x_dqn_tpu_torch.runtime.train import apply_overrides

    ap = argparse.ArgumentParser(
        prog="python -m ape_x_dqn_tpu_torch.runtime.actor_host",
        description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--actors", type=int, default=None)
    ap.add_argument("--actor-offset", type=int, default=0)
    ap.add_argument("--frames-per-actor", type=int, default=None)
    ap.add_argument("--param-poll-s", type=float, default=None,
                    help="fixed seconds between parameter pulls from "
                         "the learner. Default: step-paced — pull once "
                         "this host's actors advance "
                         "actors.param_pull_every env steps each "
                         "(Ape-X's ~400), 30s keep-alive")
    ap.add_argument("--peer-id", default=None,
                    help="name of this host (default: "
                         "hostname-pid-a<offset>)")
    ap.add_argument("--supervise", action="store_true",
                    help="survive learner restarts: wait indefinitely "
                         "for first params and keep re-entering the "
                         "connect path (backoff-capped) when the learner "
                         "goes away mid-run, instead of exiting")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the host's inference server "
                         "(default cuda; a CUDA request without a card "
                         "raises)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="dotted.key=value")
    args = ap.parse_args(argv)
    cfg = apply_overrides(get_config(args.config), args.set)
    host, port = args.connect.rsplit(":", 1)
    out = run_actor_host(cfg, host, int(port), num_actors=args.actors,
                         actor_offset=args.actor_offset,
                         frames_per_actor=args.frames_per_actor,
                         param_poll_s=args.param_poll_s,
                         peer_id=args.peer_id,
                         supervise=args.supervise, device=args.device)
    out["errors"] = [f"{i}: {e!r}" for i, e in out["errors"]]
    print(json.dumps(out), flush=True)
    return 1 if out["errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
