"""The port's cost walk (``launch.analysis.cost_of``) against the JAX
package's ``jaxpr_cost`` and against analytic counts.

- The reference's walk tests, counterpart for counterpart, with its
  numbers: a product's flops exactly; a Python loop of L products (the
  counterpart of a scan) L times one; nested loops multiply; a backward
  with remat counts its recomputation; a gather charges the rows it
  gathers, never the pool.
- A kernel entry point of ``kernels/ops.py`` counts the same on the CPU
  and on ``meta``, its formula exactly, and none of its plain body's ops.
- The smoke llama's training step: ``flops`` within 2% of the
  reference's ``jaxpr_cost`` of its own step, the matrix products'
  flops exactly equal.  The rest is the elementwise work the two
  spell differently: JAX's softmax and silu are primitives it counts
  (sub, exp, div, logistic, mul), aten's are fused ops the walk does not
  count, and the reference's checkpointed attention chunk recomputes its
  scores' elementwise ops once more.
- The headline, ``test_flops_validation_against_6nd``'s counterpart: the
  ``llama3_2_1b`` ``train_4k`` dry run on ``meta`` at the published
  widths is within 5% of 8 * N * 256 * 4096.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from _torch_threads import one_torch_thread  # noqa: F401
from repro.launch import analysis as ref_analysis
from repro_torch.kernels import ops
from repro_torch.launch.analysis import cost_of


def ref_flops(fn, *args):
    return ref_analysis.jaxpr_cost(jax.make_jaxpr(fn)(*args))["flops"]


def test_dot_flops_exact():
    x, w = torch.ones(64, 128), torch.ones(128, 32)
    got = cost_of(lambda: x @ w)["flops"]
    assert got == 2 * 64 * 128 * 32
    assert got == ref_flops(lambda a, b: a @ b, jnp.ones((64, 128)),
                            jnp.ones((128, 32)))


@pytest.mark.parametrize("L", [1, 4, 16])
def test_loop_multiplies_body_cost(L):
    ws = torch.ones(L, 16, 16)

    def f():
        x = torch.ones(8, 16)
        for i in range(L):
            x = x @ ws[i]

    def g(x, ws):
        return jax.lax.scan(lambda x, w: (x @ w, None), x, ws)[0]

    got = cost_of(f)["flops"]
    assert got == L * 2 * 8 * 16 * 16
    assert got == ref_flops(g, jnp.ones((8, 16)), jnp.ones((L, 16, 16)))


def test_nested_loops_multiply():
    ws = torch.ones(5, 8, 8)

    def f():
        x = torch.ones(4, 8)
        for i in range(5):
            for _ in range(3):
                x = x @ ws[i]

    assert cost_of(f)["flops"] == 5 * 3 * 2 * 4 * 8 * 8


def test_grad_and_remat_counted():
    """Remat-inclusive backward ~ 4x forward for a matmul chain (forward,
    recompute and two backward products), the reference's bounds."""
    w = torch.ones(32, 32, requires_grad=True)

    def f(x):
        for _ in range(6):
            x = checkpoint(lambda t: torch.tanh(t @ w), x,
                           use_reentrant=False)
        return x.sum()

    fwd = cost_of(lambda: f(torch.ones(16, 32)))["flops"]
    both = cost_of(lambda: f(torch.ones(16, 32)).backward())["flops"]
    dot = 2 * 16 * 32 * 32 * 6
    assert abs(fwd - dot) / dot < 0.2
    assert 2.8 <= both / fwd <= 4.8


def test_gather_counts_gathered_bytes_not_pool():
    pool = torch.zeros(1024, 256)               # 1 MB pool
    idx = torch.zeros(4, dtype=torch.long)
    for fn in (lambda: pool[idx], lambda: pool.index_select(0, idx),
               lambda: torch.nn.functional.embedding(idx, pool)):
        assert cost_of(fn)["bytes_dot"] < 64 * 1024


# --------------------------------------------------------- kernel calls
def flash_case(device):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    return [t.to(device).requires_grad_(True) for t in (q, k, v)]


def grouped_case(device):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(12, 8, generator=g)
    ws = [torch.randn(s, generator=g) for s in ((3, 8, 6), (3, 8, 6),
                                                 (3, 6, 8))]
    sizes = torch.tensor([5, 0, 7], dtype=torch.int32)
    return [t.to(device).requires_grad_(True) for t in (x, *ws)], sizes


def run_flash(device):
    q, k, v = flash_case(device)
    ops.flash_attention(q, k, v).sum().backward()


def run_grouped(device):
    leaves, sizes = grouped_case(device)
    ops.moe_grouped_ffn(*leaves, sizes.to(device)).sum().backward()


def run_ssd(device):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 8, 3, 4, generator=g)
    dt = torch.rand(2, 8, 3, generator=g)
    A = -torch.rand(3, generator=g)
    Bm, Cm = torch.randn(2, 8, 5, generator=g), torch.randn(
        2, 8, 5, generator=g)
    leaves = [t.to(device).requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    ops.ssd_scan(*leaves).sum().backward()


@pytest.mark.parametrize("run", [run_flash, run_grouped, run_ssd])
def test_entry_point_counts_the_same_on_cpu_and_meta(run):
    cpu, meta = cost_of(run, "cpu"), cost_of(run, "meta")
    assert cpu["flops"] == meta["flops"]
    assert cpu["kernels"] == meta["kernels"] and len(cpu["kernels"]) == 2


def test_entry_point_charges_its_formula_and_hides_its_body():
    """Attention over all 16 x 16 pairs: 4 * pairs * dh product flops
    forward, 10 * pairs * dh backward (the scores recomputed, four
    products); the body's einsums, softmax and masks are not counted:
    only the ``sum`` and its backward's ops lie outside the call."""
    B, S, H, dh = 2, 16, 4, 8
    pairs = B * H * S * S
    c = cost_of(run_flash, "cpu")
    assert c["kernels"] == {"flash_attention": 4.0 * pairs * dh + pairs,
                            "flash_attention_bwd": 10.0 * pairs * dh
                            + 2.0 * pairs}
    assert c["matmul_flops"] == 14.0 * pairs * dh
    assert c["flops"] == sum(c["kernels"].values())


# ------------------------------------------------------ the whole step
SMOKE_BATCH, SMOKE_SEQ = 4, 128


@functools.lru_cache(maxsize=None)
def smoke_step_costs():
    """(the port's cost_of, the reference's jaxpr_cost and its products'
    flops) of one smoke llama training step (loss, backward, AdamW)."""
    from repro.configs import get_smoke as ref_smoke
    from repro.models import build_model
    from repro.optim.adamw import AdamW as RefAdamW
    from repro.train.step import make_train_step as ref_step
    from repro_torch.configs import get_smoke
    from repro_torch.convert import jax_order
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_step

    cfg = get_smoke("llama3_2_1b")
    batch_np = SyntheticLM(cfg.vocab, SMOKE_SEQ, SMOKE_BATCH,
                           seed=0).batch_np(0)
    model = Model(cfg, device="meta")
    named = dict(model.named_parameters())
    params = {n: named[n] for n in jax_order(named)}
    opt = AdamW(lr=1e-4)
    port = cost_of(make_train_step(model, opt), params, opt.init(params),
                   {k: torch.from_numpy(v).to("meta")
                    for k, v in batch_np.items()})

    rm = build_model(ref_smoke("llama3_2_1b"))
    p = rm.abstract()
    ropt = RefAdamW(lr=1e-4)
    batch = {k: jax.ShapeDtypeStruct(v.shape, jnp.int32)
             for k, v in batch_np.items()}
    jx = jax.make_jaxpr(ref_step(rm, ropt))(
        p, jax.eval_shape(ropt.init, p), batch)
    full = ref_analysis.jaxpr_cost(jx)
    saved = ref_analysis._ELEMENTWISE_FLOPS
    ref_analysis._ELEMENTWISE_FLOPS = frozenset()
    try:
        products = ref_analysis.jaxpr_cost(jx)["flops"]
    finally:
        ref_analysis._ELEMENTWISE_FLOPS = saved
    return port, full, products


def test_smoke_step_flops_match_reference():
    port, full, products = smoke_step_costs()
    assert port["matmul_flops"] == products
    assert abs(port["flops"] - full["flops"]) / full["flops"] < 0.02


def test_smoke_step_counts_the_same_on_cpu_and_meta():
    """The step on CPU tensors (a real step) counts what ``meta`` counts."""
    from repro_torch.configs import get_smoke
    from repro_torch.convert import jax_order
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_step

    cfg = get_smoke("llama3_2_1b")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    named = dict(model.named_parameters())
    params = {n: named[n] for n in jax_order(named)}
    opt = AdamW(lr=1e-4)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg.vocab, SMOKE_SEQ, SMOKE_BATCH, seed=0).batch_np(0).items()}
    cpu = cost_of(make_train_step(model, opt), params, opt.init(params),
                  batch)
    meta = smoke_step_costs()[0]
    assert cpu["flops"] == meta["flops"]
    assert cpu["matmul_flops"] == meta["matmul_flops"]


def test_flops_validation_against_8nd(tmp_path):
    """The full train step's flops on ``meta`` at the published widths
    within 5% of the remat-inclusive 8 * N * D."""
    from repro_torch.configs import get
    from repro_torch.dist import abstract_mesh
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import Model
    from repro_torch.models.common import count_params

    rec = run_cell("llama3_2_1b", "train_4k",
                   abstract_mesh((1, 1), ("data", "model")), "pod256",
                   str(tmp_path), trace_only=True)
    assert rec["status"] == "ok", rec.get("error")
    n = count_params(Model(get("llama3_2_1b"), device="meta").param_defs())
    analytic = 8 * n * 256 * 4096
    assert abs(rec["global_cost"]["flops"] - analytic) / analytic < 0.05
    assert np.isfinite(rec["global_cost"]["bytes_dot"])
