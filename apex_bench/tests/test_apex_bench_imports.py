"""Nothing under apex_bench/ imports JAX, the JAX package, the JAX-era
benchmark or the chip smoke script; the reference and the rest of the
yardstick import nothing of the port either (top-level module names,
compared whole)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ape_x_dqn_tpu", "bench",
             "chip_smoke"}
PORT = "ape_x_dqn_tpu_torch"
# the only modules that build the port's objects
ADAPTORS = {"adaptors"}


def imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


SOURCES = sorted(p for p in PKG.rglob("*.py") if "_cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(PKG)))
def test_no_forbidden_imports(path):
    names = imported(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    rel = path.relative_to(PKG)
    if rel.parts[0] not in ADAPTORS | {"tests"}:
        assert PORT not in names, f"{rel} imports the port"


def test_the_scan_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom ape_x_dqn_tpu.ops import x\n"
                 "from ape_x_dqn_tpu_torch import y\n")
    assert imported(p) == {"jax", "ape_x_dqn_tpu", PORT}
