"""Checkpoint / resume on ``torch.save``.

Counterpart of ``ape_x_dqn_tpu/utils/checkpoint.py`` (an orbax manager
there) with its API: `save`, `restore`, `latest_step`, `item_keys`.
The driver (runtime/driver.py) saves params, target params, optimizer
state, the RNG state and the grad-step counter on its
``checkpoint_every`` cadence and once at shutdown, and restores the
newest checkpoint at construction; replay contents ride along only under
``RunConfig.checkpoint_replay``.

On disk: one file per step, ``<dir>/<step>.pt``, written to a temporary
name and renamed into place, so a killed writer never leaves a torn
newest checkpoint; the newest `max_to_keep` stay. A payload is a dict of
tensors, ints, lists and dicts (numpy arrays are stored as tensors) and
loads with ``torch.load(weights_only=True)``, which unpickles nothing
else.

Saves do not stall the caller, as orbax's async save does not: `save`
hands the payload to a writer thread, which first waits for the CUDA
event the caller recorded after the payload's device copies (`ready`),
copies every tensor to the host and writes the file. One save is in
flight at a time; the next `save`, `wait_until_finished` and `close`
join it and raise if it failed, so a failed write is never silent.

STORAGE LAYOUT VERSIONING: every payload is stamped with
``STORAGE_LAYOUT_VERSION``; a restore that meets another version, or a
payload whose structure does not match the caller's template (a
replay-bearing checkpoint of another storage layout), fails with a
RuntimeError carrying the recovery guidance instead of a raw traceback.
Param-only checkpoints (the default) are unaffected by layout breaks.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any

import numpy as np
import torch

# Bump on any break in the on-disk layout of checkpointed device state
# (storage byte-rows, ReplayState fields, ...). v2 = the byte-row
# packing layout (replay/packing.py).
STORAGE_LAYOUT_VERSION = 2
_LAYOUT_KEY = "storage_layout_version"

_LAYOUT_GUIDANCE = (
    "this checkpoint was written under an incompatible storage layout "
    "(see utils/checkpoint.py STORAGE LAYOUT VERSIONING). Either restart "
    "the run fresh, or restore the checkpoint on the code version that "
    "wrote it and re-save params-only (checkpoint_replay=False)")

_FILE = re.compile(r"^(\d+)\.pt$")


def _to_host(x: Any) -> Any:
    """The payload with every tensor on the host and every numpy value
    as a tensor (what weights_only loading accepts)."""
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_host(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu")
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x))
    return x


def _structure(x: Any) -> Any:
    """Keys, lengths, shapes and dtypes of a payload (values dropped):
    what a template and a restored payload must agree on."""
    if isinstance(x, dict):
        return {k: _structure(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_structure(v) for v in x]
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, (np.ndarray, np.generic)):
        t = torch.from_numpy(np.array(x))
        return ("tensor", tuple(t.shape), t.dtype)
    return type(x).__name__


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max(int(max_to_keep), 1)
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{int(step)}.pt")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self._dir):
            m = _FILE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: Any, wait: bool = False,
             ready: Any = None) -> None:
        """Write `state` as checkpoint `step` on the writer thread.
        `ready`: an event (``torch.cuda.Event``) recorded after the
        payload's device tensors were produced; the writer synchronises
        on it before copying them to the host. wait=True returns once
        the file is in place."""
        self.wait_until_finished()
        if isinstance(state, dict) and _LAYOUT_KEY not in state:
            # the stamp rides inside the payload, so it survives any
            # relocation of the directory
            state = {**state, _LAYOUT_KEY: STORAGE_LAYOUT_VERSION}
        self._writer = threading.Thread(
            target=self._write, args=(int(step), state, ready),
            name="checkpoint-writer", daemon=True)
        self._writer.start()
        if wait:
            self.wait_until_finished()

    def _write(self, step: int, state: Any, ready: Any) -> None:
        tmp = f"{self._path(step)}.tmp.{os.getpid()}"
        try:
            if ready is not None:
                ready.synchronize()
            torch.save(_to_host(state), tmp)
            os.replace(tmp, self._path(step))
            for old in self.all_steps()[:-self._max_to_keep]:
                os.unlink(self._path(old))
        except Exception as e:  # raised by wait_until_finished
            self._error = e
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def wait_until_finished(self) -> None:
        """Join the save in flight; raise if it failed."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(f"checkpoint write into {self._dir} failed: "
                               f"{err!r}") from err

    # -- restore -------------------------------------------------------------

    def _load(self, step: int, mmap: bool = False) -> Any:
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True, mmap=mmap)

    def restore(self, step: int | None = None, template: Any = None) -> Any:
        """The payload of checkpoint `step` (default: the newest), its
        tensors on the host, or None when there is none. `template`,
        when given, must have the saved structure (keys, lengths,
        shapes, dtypes; its values are ignored)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        self.wait_until_finished()
        try:
            out = self._load(step)
        except (OSError, RuntimeError, EOFError, ValueError) as e:
            raise RuntimeError(
                f"checkpoint {self._path(step)} does not load ({e!s:.300})"
                f" — most likely " + _LAYOUT_GUIDANCE) from e
        ver = out.pop(_LAYOUT_KEY, None) if isinstance(out, dict) else None
        if ver is not None and int(ver) != STORAGE_LAYOUT_VERSION:
            raise RuntimeError(
                f"checkpoint storage layout v{int(ver)} does not match "
                f"this code's v{STORAGE_LAYOUT_VERSION} — "
                + _LAYOUT_GUIDANCE)
        if template is not None:
            if isinstance(template, dict):
                template = {k: v for k, v in template.items()
                            if k != _LAYOUT_KEY}
            want, got = _structure(template), _structure(out)
            if want != got:
                raise RuntimeError(
                    f"checkpoint restore failed at step {step} with a "
                    f"structure mismatch (saved {got!s:.200}, expected "
                    f"{want!s:.200}) — most likely " + _LAYOUT_GUIDANCE)
        return out

    def item_keys(self, step: int | None = None) -> set[str] | None:
        """Top-level keys of a saved payload (version stamp excluded),
        or None when there is no checkpoint. Lets a restore follow what
        was SAVED: toggling RunConfig.checkpoint_replay between runs
        must not brick resume (the flag governs saves; restores follow
        the file). The file is memory-mapped, not read."""
        keys = self._raw_item_keys(step)
        if keys is not None:
            keys.discard(_LAYOUT_KEY)
        return keys

    def _raw_item_keys(self, step: int | None = None) -> set[str] | None:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        self.wait_until_finished()
        out = self._load(step, mmap=True)
        return set(out) if isinstance(out, dict) else None

    def close(self) -> None:
        self.wait_until_finished()
