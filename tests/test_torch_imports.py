"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``, and the front
door imports with JAX made unimportable.  Also: a CUDA entry point handed
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


def port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
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


def test_moe_combine_is_not_a_scatter_add():
    """CUDA's index_add_ and scatter-adds are not deterministic; the MoE
    combine is a fixed-order sum instead."""
    path = os.path.join(PORT, "models", "moe.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    calls = {node.attr for node in ast.walk(tree)
             if isinstance(node, ast.Attribute)}
    assert not calls & {"index_add_", "index_add", "scatter_add_",
                        "scatter_add", "scatter_reduce_", "scatter_reduce",
                        "index_put_", "index_put", "put_"}, calls


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
