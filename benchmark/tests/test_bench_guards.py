"""The guards of a run: no card, no result; no JAX and no JAX package
loaded, compared by whole top-level names; a reference that imports
nothing of the program."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
import types

from benchmark import harness, run

ROOT = harness.ROOT


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "mgkn85_train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_forbidden_names_compare_whole():
    assert "graph_pde_tpu_torch" in sys.modules or True
    name = "graph_pde_tpu"
    had = name in sys.modules
    sys.modules.setdefault(name, types.ModuleType(name))
    try:
        assert name in run.loaded_forbidden()
    finally:
        if not had:
            del sys.modules[name]
    assert "graph_pde_tpu" not in [m for m in run.loaded_forbidden()
                                   if m != name] or had


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'benchmark' / 'tests')!r}]\n"
        "import tiny\n"
        "from benchmark import run, harness\n"
        "for name in ('gkn241_train', 'mgkn85_train', 'mgkn85_predict'):\n"
        "    run.run_cell(tiny.cell(name), 3, 0.2, name.endswith('predict'),\n"
        "                 torch.device('cpu'), t_start=time.perf_counter(),\n"
        "                 log=lambda m: None)\n"
        "print('FOUND', run.loaded_forbidden())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FOUND []" in p.stdout


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "numpy", "torch", "scipy", "contextlib"}
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue      # the reference's own modules
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in allowed, (path.name, m)
