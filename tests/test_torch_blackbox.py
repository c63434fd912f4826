"""The port's flight recorder (obs/blackbox.py) against the JAX
package's: the same records in, the same dump out (its ring, its
counters, the registry snapshot, heartbeats, context providers; the
host-specific fields aside), written atomically as
``blackbox-<peer>.json``; the crash hooks chain and unchain the same
way, the SIGUSR2 handler installs only on the main thread, and an
`Obs.close` uninstalls every hook it installed."""

import json
import signal
import sys
import threading

import pytest

from ape_x_dqn_tpu import configs as jcfgs
from ape_x_dqn_tpu.obs import blackbox as jbb
from ape_x_dqn_tpu.obs import core as jcore
from ape_x_dqn_tpu_torch import configs as tcfgs
from ape_x_dqn_tpu_torch.obs import blackbox as tbb
from ape_x_dqn_tpu_torch.obs import core as tcore

PKGS = {"jax": (jcfgs, jcore, jbb), "torch": (tcfgs, tcore, tbb)}
# what differs between two processes or two clocks, not two packages
VOLATILE = ("host", "pid", "wall_unix", "threads", "log_tail")


class RecMetrics:
    def __init__(self):
        self.records = []

    def log(self, step, **kw):
        self.records.append(kw)


def _obs(pkg, tmp_path, capacity):
    cfgs, core, _ = PKGS[pkg]
    return core.build_obs(cfgs.ObsConfig(
        enabled=True, blackbox_dir=str(tmp_path / pkg),
        blackbox_capacity=capacity), RecMetrics())


def _dump(pkg, tmp_path, capacity):
    obs = _obs(pkg, tmp_path, capacity)
    (tmp_path / pkg).mkdir()
    bb = obs.blackbox
    bb.set_peer("driver-7")
    bb.add_context_provider(lambda: {"peer_frames": {"host-a": {"seq": 3}}})
    obs.register("learner")
    obs.count("replay_adds", 12)
    for i in range(capacity + 3):
        bb.record("supervisor_restart", component=f"actor-{i}", step=i)
    bb.log_line("a warning")
    path = bb.dump("stall", component="learner", step=42,
                   extra={"why": "test"})
    with open(path) as fh:
        box = json.load(fh)
    for rec in box["records"]:
        rec.pop("t")
    for key in VOLATILE:
        box.pop(key, None)
    box["hb"] = sorted(box["hb"])
    return path, box, obs


@pytest.mark.parametrize("capacity", [4, 64])
def test_the_same_records_make_the_same_dump(tmp_path, capacity):
    jpath, jbox, _ = _dump("jax", tmp_path, capacity)
    tpath, tbox, tobs = _dump("torch", tmp_path, capacity)
    assert tpath.endswith("torch/blackbox-driver-7.json")
    assert jpath.endswith("jax/blackbox-driver-7.json")
    assert tbox == jbox
    assert tbox["dropped"] == max(capacity + 3 - capacity, 0)
    assert tbox["peer_frames"] == {"host-a": {"seq": 3}}
    assert not list((tmp_path / "torch").glob("*.tmp"))
    assert tobs.metrics.records[-1]["blackbox_reason"] == "stall"


def test_hooks_chain_and_unchain_like_the_original(tmp_path):
    """Both chain the excepthook and SIGUSR2 on install; on close both
    restore SIGUSR2, and the port also restores the excepthook, which
    the original leaves chained (its `uninstall` tests a fresh bound
    method with `is`)."""
    seen = []
    for pkg in ("jax", "torch"):
        obs = _obs(pkg, tmp_path, 8)
        before = (sys.excepthook, signal.getsignal(signal.SIGUSR2))
        obs.blackbox.install()
        installed = (sys.excepthook is not before[0],
                     signal.getsignal(signal.SIGUSR2) is not before[1])
        obs.close()
        restored = (sys.excepthook == before[0],
                    signal.getsignal(signal.SIGUSR2) == before[1])
        sys.excepthook = before[0]
        seen.append((installed, restored))
    assert seen[0] == ((True, True), (False, True))
    assert seen[1] == ((True, True), (True, True))


def test_sigusr2_dumps_and_installs_only_on_the_main_thread(tmp_path):
    (tmp_path / "torch").mkdir()
    obs = _obs("torch", tmp_path, 8)
    box = obs.blackbox
    before = signal.getsignal(signal.SIGUSR2)
    t = threading.Thread(target=box.install)
    t.start()
    t.join()
    assert signal.getsignal(signal.SIGUSR2) is before   # not off main
    box.uninstall()
    box.install()
    try:
        box.record("publish", step=1)
        signal.raise_signal(signal.SIGUSR2)
        with open(box.path) as fh:
            dump = json.load(fh)
        assert dump["reason"] == "sigusr2"
        assert [r["kind"] for r in dump["records"]] == ["publish",
                                                        "sigusr2"]
    finally:
        obs.close()
    assert signal.getsignal(signal.SIGUSR2) is before
