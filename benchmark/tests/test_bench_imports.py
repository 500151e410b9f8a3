"""The import guard compares whole top-level names, and nothing the
benchmark imports loads JAX or the JAX package."""

import ast
import subprocess
import sys
import types
from pathlib import Path

from benchmark.lib import guard

ROOT = Path(__file__).resolve().parents[2]


def test_guard_flags_the_jax_package():
    assert guard.offenders(["kalman_hydra_tpu.x", "numpy"]) \
        == ["kalman_hydra_tpu"]
    assert guard.offenders(["jax.numpy", "jaxlib", "flax.linen"]) \
        == ["flax", "jax", "jaxlib"]


def test_guard_passes_the_port():
    assert guard.offenders(["kalman_hydra_tpu_torch.x",
                            "kalman_hydra_tpu_torch", "jaxtyping"]) == []


def test_guard_reads_sys_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "kalman_hydra_tpu_torch.x",
                        types.ModuleType("kalman_hydra_tpu_torch.x"))
    before = guard.offenders()
    monkeypatch.setitem(sys.modules, "kalman_hydra_tpu.x",
                        types.ModuleType("kalman_hydra_tpu.x"))
    assert "kalman_hydra_tpu" in guard.offenders()
    assert "kalman_hydra_tpu" not in before


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "benchmark" / "reference").glob("*.py"):
        bad = _imports(p) & {"kalman_hydra_tpu_torch", "kalman_hydra_tpu",
                             "jax", "jaxlib", "flax"}
        assert not bad, (p.name, bad)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.lib import drivers, guard, harness\n"
            "drivers.Program(__import__('json').load(open(%r))['run_config'],"
            " 'cpu')\n"
            "print(guard.offenders())"
            % (str(ROOT), str(ROOT / "benchmark" / "configs"
                              / "farneback-1080p.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
