"""The PyTorch port imports without JAX.

Every module of ``commonroad_rp_tpu_torch`` is imported in a fresh
interpreter where ``sys.modules["jax"] = None`` makes any ``import jax``
fail, and its source never names JAX in an import statement.
"""

import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "commonroad_rp_tpu_torch"


def _modules():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_every_port_module_imports_without_jax():
    modules = _modules()
    for name in ("ops.scoring", "ops.collision_kernel", "ops.cost",
                 "ops.cuda_build", "utils.evaluation", "native",
                 "baseline.oracle", "utils.checkpoint",
                 "utils.scenario_writer", "utils.solution_writer",
                 "utils.visualization", "examples.getting_started"):
        assert f"commonroad_rp_tpu_torch.{name}" in modules
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['commonroad_rp_tpu'] = None; import importlib; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None); print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PKG.parent, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_no_jax_import_statement(path):
    text = (PKG / path).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"^\s*(import|from) commonroad_rp_tpu\b(?!_torch)",
                         text, re.M)
