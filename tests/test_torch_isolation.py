"""The PyTorch package stands alone: no module of ape_x_dqn_tpu_torch/,
and not chip_smoke.py, imports jax, flax, optax or anything of the JAX
package, and importing the port's main path loads no JAX. Its copies of
configs.py and of the Atari score table must not drift from the
originals."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from ape_x_dqn_tpu import configs as jax_configs
from ape_x_dqn_tpu.utils import metrics as jax_metrics
from ape_x_dqn_tpu_torch import configs as torch_configs
from ape_x_dqn_tpu_torch.utils import metrics as torch_metrics

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ape_x_dqn_tpu")
SOURCES = sorted((ROOT / "ape_x_dqn_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_main_path_import_loads_no_jax():
    """A fresh interpreter that ignores PYTHON* variables (-E, so no
    sitecustomize on PYTHONPATH can preload jax) imports the port's main
    path; jax must not be among the loaded modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import ape_x_dqn_tpu_torch.runtime.build\n"
        "import ape_x_dqn_tpu_torch.runtime.single_process\n"
        "import ape_x_dqn_tpu_torch.runtime.train\n"
        "import ape_x_dqn_tpu_torch.runtime.driver\n"
        "import ape_x_dqn_tpu_torch.runtime.sequence_learner\n"
        "import ape_x_dqn_tpu_torch.runtime.vector_actor\n"
        "import ape_x_dqn_tpu_torch.replay.sequence\n"
        "import ape_x_dqn_tpu_torch.models.lstm_q\n"
        "import ape_x_dqn_tpu_torch.models.convert\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (str(ROOT), FORBIDDEN))
    env = {"PATH": "/usr/bin:/bin", "PYTHONNOUSERSITE": "1"}
    proc = subprocess.run([sys.executable, "-E", "-c", code],
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("name", sorted(jax_configs.PRESETS))
def test_config_copy_matches_original(name):
    assert sorted(torch_configs.PRESETS) == sorted(jax_configs.PRESETS)
    assert dataclasses.asdict(torch_configs.get_config(name)) \
        == dataclasses.asdict(jax_configs.get_config(name))


def test_atari_score_table_copy_matches_original():
    assert torch_metrics.ATARI_HUMAN_RANDOM == jax_metrics.ATARI_HUMAN_RANDOM
    scores = {"pong": 10.0, "breakout": 12.0, "alien": 900.0}
    assert torch_metrics.median_hns(scores) == jax_metrics.median_hns(scores)
    with pytest.raises(ValueError, match="space_invaders"):
        torch_metrics.human_normalized_score("spaceinvaders", 1.0)
