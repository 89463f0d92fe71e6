"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``, and the front
door imports with JAX made unimportable; so do the port's linter and its
four walkthroughs under ``examples/``.  Also: a CUDA entry point handed
CPU tensors raises instead of falling back, the MoE combine uses no
scatter-add, and the kernels layer imports nothing of the models above it."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


EXAMPLES = [os.path.join(ROOT, "examples", f"{name}_torch.py")
            for name in ("policy_playground", "quickstart",
                         "serve_guided_kv", "train_guided_offload")]


def port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")] + EXAMPLES
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    roots = set(imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


KERNEL_FILES = sorted(os.path.join(PORT, "kernels", f)
                      for f in os.listdir(os.path.join(PORT, "kernels"))
                      if f.endswith(".py"))


@pytest.mark.parametrize("path", KERNEL_FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_kernels_import_nothing_of_the_models(path):
    """``models`` imports ``kernels``; the reverse would be a cycle."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            parts = ("." * node.level + (node.module or "")).split(".")
            assert "models" not in parts, ast.dump(node)
        elif isinstance(node, ast.ImportFrom) and node.module:
            assert not node.module.startswith("repro_torch.models"), \
                node.module


def test_front_door_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.serve.api, repro_torch.kernels.ops, "
            "repro_torch.convert; print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


NEW_MODULES = ("repro_torch.dist.sharding", "repro_torch.dist.collectives",
               "repro_torch.launch.mesh", "repro_torch.models.common",
               "repro_torch.data.pipeline", "repro_torch.ft.elastic",
               "repro_torch.ckpt.checkpoint", "repro_torch.launch.analysis",
               "repro_torch.launch.dryrun", "repro_torch.kernels.cost")


@pytest.fixture(scope="module")
def blocked_imports():
    """Each of ``NEW_MODULES`` imported in one interpreter with ``jax`` and
    ``repro`` blocked: module -> "ok" or the error."""
    code = ("import importlib, sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    try:\n"
            "        importlib.import_module(m); print(m, 'ok')\n"
            "    except Exception as e:\n"
            "        print(m, repr(e))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    return dict(line.split(" ", 1) for line in out.stdout.splitlines())


@pytest.mark.parametrize("module", NEW_MODULES)
def test_distribution_modules_import_without_jax(module, blocked_imports):
    """The distribution layer's modules import with ``jax`` and ``repro``
    blocked."""
    assert blocked_imports[module] == "ok"


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import paged_attention as pa

    q = torch.zeros((2, 4, 64))
    pool = torch.zeros((8, 8, 4, 64))
    table = torch.zeros((2, 3), dtype=torch.int32)
    lengths = torch.ones((2,), dtype=torch.int32)
    before = dict(pa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        pa.paged_attention_cuda(q, pool, pool, table, lengths)
    with pytest.raises(ValueError, match="CUDA device"):
        pa.paged_prefill_cuda(q, pool, pool, table[0], lengths)
    assert pa.LAUNCHES == before

    x = torch.zeros((6, 16))
    wg = torch.zeros((3, 16, 8))
    wd = torch.zeros((3, 8, 16))
    sizes = torch.tensor([2, 0, 4], dtype=torch.int32)
    before = dict(mg.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        mg.moe_grouped_ffn_cuda(x, wg, wg, wd, sizes)
    with pytest.raises(ValueError, match="CUDA device"):
        mg.moe_grouped_ffn_cuda(x, wg, wg, wd, sizes, torch.arange(
            3, dtype=torch.int32))
    assert mg.LAUNCHES == before


SCATTERS = {"index_add_", "index_add", "scatter_add_", "scatter_add",
            "scatter_reduce_", "scatter_reduce", "index_put_", "index_put",
            "put_"}
# The MoE layer's dispatch and combine of every layout: the flat and
# per-row combines, the capacity buffer and its combine, the ep exchange.
MOE_FILES = {"models/moe.py": ("_Dispatch", "_Combine", "_sorted_ffn",
                               "_apply_dropless_per_row",
                               "_CapacityDispatch", "_CapacityCombine",
                               "_moe_dropless_ep", "_TakeSlice",
                               "_GatherSlices"),
             "dist/collectives.py": ("_RaggedAllToAll",)}


@pytest.mark.parametrize("path", sorted(MOE_FILES))
def test_moe_combine_is_not_a_scatter_add(path):
    """CUDA's index_add_ and scatter-adds are not deterministic; the MoE
    combines (flat, per-row, capacity, ep) and the capacity buffer are
    fixed-order sums and gathers instead."""
    full = os.path.join(PORT, path)
    with open(full, encoding="utf-8") as f:
        tree = ast.parse(f.read(), full)
    calls = {node.attr for node in ast.walk(tree)
             if isinstance(node, ast.Attribute)}
    assert not calls & SCATTERS, calls
    defined = {node.name for node in ast.walk(tree)
               if isinstance(node, (ast.FunctionDef, ast.ClassDef))}
    assert set(MOE_FILES[path]) <= defined


def backward_nodes(y):
    seen, stack = set(), [y.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("layout", ["flat", "per_row", "capacity"])
def test_moe_backward_accumulates_by_no_index(layout):
    """The layer's autograd graph in every single-process layout holds no
    backward that adds by index (advanced indexing's backward is an
    ``index_put_`` with accumulate; ``index_add`` and scatter-adds): the
    dispatch and combine gathers have their own fixed-order backwards."""
    import types

    from repro_torch.models import moe

    cfg = moe.MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2,
                        capacity_factor=0.5)
    g = torch.Generator().manual_seed(0)
    p = types.SimpleNamespace(
        router=torch.randn(16, 4, generator=g).requires_grad_(True),
        **{n: torch.randn(s, generator=g).requires_grad_(True)
           for n, s in (("w_gate", (4, 16, 8)), ("w_up", (4, 16, 8)),
                        ("w_down", (4, 8, 16)))})
    x = torch.randn(2, 8, 16, generator=g).requires_grad_(True)
    if layout == "capacity":
        y = moe.moe(p, x, cfg, dispatch="capacity")
        assert moe.dropped_picks(x, p.router, cfg) > 0
    else:
        y = moe._moe_dropless(p, x, cfg, per_row=layout == "per_row")
    nodes = backward_nodes(y)
    assert not nodes & {"IndexBackward0", "IndexPutBackward0",
                        "IndexAddBackward0", "ScatterAddBackward0",
                        "ScatterReduceBackward0"}, nodes
    torch.autograd.grad(y.sum(), [x, p.router, p.w_gate])


def test_default_device_is_the_card():
    from repro_torch._device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def test_training_entry_points_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.train, repro_torch.train, "
            "repro_torch.ckpt, repro_torch.kernels.flash_attention; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["repro_torch.models.ssm",
                                    "repro_torch.kernels.ssd_scan",
                                    "repro_torch.configs.zamba2_7b"])
def test_hybrid_modules_import_without_jax(module):
    """The hybrid slice's modules exist and import with JAX and the JAX
    package made unimportable (the static check above covers their source
    too)."""
    assert os.path.exists(os.path.join(ROOT, "src", *module.split(".")) +
                          ".py")
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            f"import {module}; print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_ssd_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import ssd_scan as ss

    x = torch.zeros((2, 8, 4, 32))
    dt = torch.zeros((2, 8, 4))
    A = torch.zeros((4,))
    bm = torch.zeros((2, 8, 16))
    before = dict(ss.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        ss.ssd_scan_cuda(x, dt, A, bm, bm)
    assert ss.LAUNCHES == before


def test_training_launcher_needs_the_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3_2_1b", "--smoke", "--steps", "1"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


def test_linter_and_walkthroughs_import_without_jax():
    """``repro_torch.check`` (every rule) and the four walkthroughs import
    with ``jax`` and ``repro`` blocked."""
    code = ("import importlib.util, sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            "import repro_torch.check as c; assert len(c.all_rules()) == 9\n"
            f"for path in {EXAMPLES!r}:\n"
            "    spec = importlib.util.spec_from_file_location('ex', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
