"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names are compared whole (the port, ``repro_torch``, begins with
the JAX package's name, ``repro``, and is allowed)."""

import ast
import os
import subprocess
import sys

from portbench.harness import catalog
from portbench.harness.main import FORBIDDEN, forbidden_modules

REPO = os.path.dirname(catalog.ROOT)


def test_names_are_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.serve.api",
                              "reprox", "numpy"]) == []
    assert forbidden_modules(["repro", "repro.models.moe"]) == ["repro"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                              "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_no_source_of_the_benchmark_imports_them():
    found = []
    for d, _, files in os.walk(catalog.ROOT):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                found += [(path, n) for n in names
                          if n.split(".")[0] in FORBIDDEN]
    assert found == []


def test_a_run_loads_none_of_them():
    """A whole tiny serving run and its check, in a fresh interpreter."""
    code = (
        "import sys, time, torch\n"
        "sys.path[:0] = ['portbench/tests']\n"
        "from tiny import tiny_cell\n"
        "from portbench.harness import main, serve, catalog\n"
        "from portbench.harness.main import forbidden_modules\n"
        "cell = tiny_cell('granite_moe_3b_a800m.chat_tiered')\n"
        "rec, drv, w, p = serve.run_cell(cell, 3, 1.0, False,\n"
        "    torch.device('cpu'), time.perf_counter())\n"
        "drv.llm = None\n"
        "main.check_serve(cell, 3, drv, w)\n"
        "main.read_metrics(rec, catalog.metrics_for(\n"
        "    catalog.benchmark(), cell['name'], False))\n"
        "print(forbidden_modules(list(sys.modules)))\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_entry_point_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "granite_8b.rag_resident", "--seed", str(2 ** 31 + 1),
         "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3
    assert out.stdout == ""
