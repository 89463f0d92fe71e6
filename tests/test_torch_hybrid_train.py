"""Hybrid training in the port against the JAX package, on the CPU, at
zamba2's smoke widths (7 layers, the shared block after every 3, d_model
128, 4 SSD heads of 32, state 16), inputs made with numpy from a seed.

The SSD backward: the port's plain version (``ref.ssd_bwd_reference``)
against autograd through the plain forward within 1e-5 of each output's
largest entry, and against ``jax.vjp`` of the JAX package's
``ssd_chunked`` with one chunk (S == Q, no initial state: the intra-chunk
block alone) within 1e-5; the backward kernel's plan; ``ops.ssd_scan``'s
gradient.  A Mamba2 layer's gradients against ``jax.vjp`` of
``repro.models.ssm.ssm_forward`` over two SSD chunks, within 1e-4 of each
leaf's norm.

The model.  In float64 (both packages' f32 islands widened to float64,
JAX under ``jax.enable_x64``) ``Model.loss`` and every gradient leaf equal
``jax.value_and_grad(model.loss)`` within 1e-8, remat on and off.  In f32
the loss agrees within rtol 1e-4 and every gradient leaf within F32_TOL of
the JAX leaf's norm: seven random zamba2 layers amplify f32 round-off, so
each package's own f32 gradient sits up to about 4e-3 from its float64
gradient (``test_f32_round_off_of_the_gradient``), as the hybrid serving
tests (``tests/test_torch_hybrid.py``) hold logits to 2e-3, not 1e-4.
Within the port: remat leaves the gradient bitwise unchanged; a 3-step
trajectory against the JAX Trainer (in float64, for the same reason); guided training lossless; the JAX
trainer's sites and decisions; the launcher."""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
import repro.models.ssm as jssm  # noqa: E402
import repro.models.transformer as jtransformer  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import GuidanceConfig as JGuidanceConfig  # noqa: E402
from repro.core import TPU_V5E as JTPU_V5E  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.common import init_params  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
import repro_torch.kernels.ref as ref  # noqa: E402
import repro_torch.models.layers as tlayers  # noqa: E402
import repro_torch.models.ssm as tssm  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.core import TPU_V5E, GuidanceConfig  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402
from repro_torch.train.step import jax_ndim  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "zamba2_7b"
F32 = torch.float32
SMOKE = get_smoke(ARCH)
SEQ = 256                 # two SSD chunks of 128
# f32 gradient leaves against the JAX package's, in norm (see the module
# docstring): each package's f32 leaf may sit up to F32_TOL / 2 from the
# float64 one, so the two up to F32_TOL apart.
F32_TOL = 1e-2


# ------------------------------------------------------------------ helpers
def ssd_inputs(rng, Bc, Q, H, P, N):
    """x, dt, A, B, C and dy as numpy f32, of the model's statistics."""
    return (rng.normal(size=(Bc, Q, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.1, size=(Bc, Q, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(Bc, Q, N)).astype(np.float32),
            rng.normal(size=(Bc, Q, N)).astype(np.float32),
            rng.normal(size=(Bc, Q, H, P)).astype(np.float32))


def assert_scaled(got, want, tol):
    """max|got - want| <= tol * max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def leaf_errors(port_state, jax_tree):
    """Each leaf's distance from the JAX leaf, over the JAX leaf's norm."""
    got = flat(params_to_numpy(port_state))
    want = flat(jax_tree)
    assert got.keys() == want.keys()
    out = {}
    for name in want:
        a = got[name].astype(np.float64)
        w = np.asarray(want[name], np.float64)
        assert a.shape == w.shape, name
        out[name] = np.linalg.norm(a - w) / np.linalg.norm(w)
    return out


def batch(seq=SEQ, n=2, seed=3):
    return SyntheticLM(SMOKE.vocab, seq, n, seed=seed).batch_np(0)


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def jax_model(remat=False, dtype=jnp.float32):
    return build_model(dataclasses.replace(jget_smoke(ARCH), remat=remat,
                                           dtype=dtype))


def jax_params(jm, seed=0, dtype=jnp.float32):
    return jax.tree.map(lambda a: a.astype(dtype),
                        jm.init(jax.random.PRNGKey(seed)))


def port_model(jm, jp, dtype=F32):
    cfg = dataclasses.replace(
        config_from_reference(dataclasses.replace(jm.cfg,
                                                  dtype=jnp.float32)),
        dtype=dtype)
    m = Model(cfg, device="cpu")
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jp),
                                        "cpu"))
    return m


def widen_islands(monkeypatch):
    """Both packages' f32 islands (their module constants ``F32``) become
    float64: the float64 comparison's only change to either package."""
    for mod in (jssm, jlayers, jtransformer):
        monkeypatch.setattr(mod, "F32", jnp.float64)
    for mod in (tssm, tlayers, ref):
        monkeypatch.setattr(mod, "F32", torch.float64)


# ------------------------------------------------------- the SSD backward
SSD_SHAPES = [(2, 64, 8, 32, 16), (2, 100, 5, 64, 32)]


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_plain_ssd_backward_equals_autograd_of_the_forward(shape):
    """dx, ddt, dA, dB, dC within 1e-5 of each output's largest entry."""
    x, dt, A, bm, cm, dy = (torch.from_numpy(a) for a in ssd_inputs(
        np.random.default_rng(shape[1]), *shape))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, bm, cm)]
    want = torch.autograd.grad(ref.ssd_reference(*leaves), leaves, dy)
    got = ref.ssd_bwd_reference(x, dt, A, bm, cm, dy)
    for g, w in zip(got, want):
        assert g.dtype == F32
        assert_scaled(g, w, 1e-5)


def test_plain_ssd_backward_keeps_the_input_dtype_and_stays_finite():
    """bf16 inputs give bf16 dx, dB, dC and f32 ddt, dA; the masked upper
    triangle, whose exponent overflows, puts no NaN in any output."""
    x, dt, A, bm, cm, dy = (torch.from_numpy(a) for a in ssd_inputs(
        np.random.default_rng(7), 2, 128, 4, 32, 16))
    dt = dt * 100                       # decays of up to e^-25600 a chunk
    out = ref.ssd_bwd_reference(x.bfloat16(), dt, A, bm.bfloat16(),
                                cm.bfloat16(), dy)
    assert [t.dtype for t in out] == [torch.bfloat16, F32, F32,
                                      torch.bfloat16, torch.bfloat16]
    assert all(torch.isfinite(t).all() for t in out)


@pytest.mark.parametrize("shape", [(2, 64, 8, 32, 16), (1, 128, 4, 32, 16)])
def test_plain_ssd_backward_matches_the_jax_chunked_vjp(shape):
    """``jax.vjp`` of the JAX package's ``ssd_chunked`` with S == Q and no
    initial state (the intra-chunk block alone; the final state's
    cotangent zero), within 1e-5 of each output's largest entry."""
    Bc, Q, H, P, N = shape
    x, dt, A, bm, cm, dy = ssd_inputs(np.random.default_rng(Q), *shape)
    cfg = jssm.SSMConfig(d_model=8, d_inner=H * P, head_dim=P, state_dim=N,
                         chunk=Q)
    (y, final), vjp = jax.vjp(
        lambda *a: jssm.ssd_chunked(*a, cfg),
        *(jnp.asarray(a) for a in (x, dt, A, bm, cm)))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(final)))
    got = ref.ssd_bwd_reference(
        *(torch.from_numpy(a) for a in (x, dt, A, bm, cm, dy)))
    assert_scaled(ref.ssd_reference(*(torch.from_numpy(a) for a in
                                      (x, dt, A, bm, cm))), y, 1e-5)
    for g, w in zip(got, want):
        assert_scaled(g, w, 1e-5)


def test_ops_ssd_scan_is_differentiable_on_the_cpu():
    """``ops.ssd_scan`` goes through ``SSDScan``: the plain forward's bits,
    and autograd gives ``ssd_bwd_reference``'s bits; no kernel counts."""
    x, dt, A, bm, cm, dy = (torch.from_numpy(a) for a in ssd_inputs(
        np.random.default_rng(11), 3, 64, 6, 32, 16))
    before = dict(ss.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, bm, cm)]
    y = ops.ssd_scan(*leaves)
    assert torch.equal(y.detach(), ref.ssd_reference(x, dt, A, bm, cm))
    got = torch.autograd.grad(y, leaves, dy)
    for g, w in zip(got, ref.ssd_bwd_reference(x, dt, A, bm, cm, dy)):
        assert torch.equal(g, w)
    with torch.no_grad():
        y = ops.ssd_scan(*leaves)
    assert y.grad_fn is None
    assert torch.equal(y, ref.ssd_reference(x, dt, A, bm, cm))
    assert ss.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_plan_reads_the_shapes_but_not_bc(dtype):
    """The head group (so the order of each chunk row's sums over the
    heads) does not depend on Bc; it divides H, fits shared memory, and the
    grids and scratch follow, per route.  At hybrid training's call: bf16
    14 heads a block, 256 blocks of 480 threads (runs of 3 subtiles); f32
    16 heads, 224 blocks of 256."""
    for Q in (1, 8, 64, 72, 100, 128, 256):
        for N in (1, 13, 16, 64, 128):
            for P in ss.HEAD_DIMS:
                for H in (1, 5, 112):
                    plans = [ss.plan_bwd(Bc, Q, H, P, N, dtype)
                             for Bc in (1, 3, 32)]
                    p = plans[0]
                    assert {q.head_group for q in plans} == {p.head_group}
                    assert {q.smem for q in plans} == {p.smem}
                    assert H % p.head_group == 0
                    assert p.smem <= ss.SMEM_LIMIT
                    assert p.reduce_smem <= ss.SMEM_LIMIT
                    G = p.head_group
                    if p.route == "simt":
                        assert G <= ss.BWD_MAX_GROUP
                        qt = -(-Q // 64) * 64
                        nt, tri = qt // 64, (qt, qt)
                    else:
                        assert G <= ss.BWD_MMA_MAX_GROUP
                        qs = -(-Q // 16) * 16
                        nt, tri = -(-qs // 64), (ss.tri_floats(qs),)
                    for Bc, q in zip((1, 3, 32), plans):
                        assert q.grid == (Bc * H // G,)
                        assert q.reduce_grid == (Bc + 1, 2 * nt)
                        assert q.scratch == (Bc, H // G) + tri
    p = ss.plan_bwd(32, 128, 112, 64, 64, dtype)
    want = ((14, (256,), 480) if dtype == torch.bfloat16
            else (16, (224,), 256))
    assert (p.head_group, p.grid, p.threads) == want


@pytest.mark.parametrize("Bc,Q,H,P,N", [(32, 128, 112, 64, 64),
                                        (3, 72, 6, 32, 13),
                                        (2, 256, 8, 64, 128)])
def test_backward_plan_routes_bf16_to_tensor_cores_and_f32_to_simt(
        Bc, Q, H, P, N):
    mma = ss.plan_bwd(Bc, Q, H, P, N, torch.bfloat16)
    simt = ss.plan_bwd(Bc, Q, H, P, N, F32)
    assert mma.route == "mma" and mma.chunk >= 1
    assert mma.threads == 32 * ss.bwd_warps(-(-Q // 16), mma.chunk)
    assert mma.threads <= 32 * ss.BWD_MMA_MAX_WARPS
    assert mma.tri_smem == (Q <= ss.TRI_SMEM_ROWS)
    assert mma.st_scratch == ((0,) if mma.tri_smem else mma.scratch)
    assert (simt.route, simt.chunk, simt.tri_smem, simt.threads) == \
        ("simt", 0, False, ss.BWD_THREADS)
    assert simt.st_scratch == (0,)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("P", ss.HEAD_DIMS)
def test_backward_plan_shared_memory_fits_every_shape(P, dtype):
    """Every (Q, N) the forward takes, at H = 112 (the largest head group
    of both routes, 14 and 16): each launch's shared memory fits a
    block's."""
    for Q in range(1, ss.MAX_CHUNK + 1):
        for N in range(1, ss.MAX_STATE + 1):
            p = ss.plan_bwd(2, Q, 112, P, N, dtype)
            assert 0 < p.smem <= ss.SMEM_LIMIT, (Q, N)
            assert 0 < p.reduce_smem <= ss.SMEM_LIMIT, (Q, N)


def bwd_covered(p, Bc, Q, H):
    """How often launch 1 reaches each (chunk row, head), on "mma" each
    (chunk row, head, strip of keys, subtile of rows) pair through the
    warps' runs, and launch 2 each (chunk row, 64-row tile) for dC and for
    dB, by the ``.cu`` file's index arithmetic."""
    groups = H // p.head_group
    ns = -(-Q // 16)
    heads = np.zeros((Bc, H), int)
    pairs = np.zeros((Bc, H, ns, ns), int)
    for blk in range(p.grid[0]):
        b, g = divmod(blk, groups)
        h0 = g * p.head_group
        heads[b, h0:h0 + p.head_group] += 1
        if p.route == "mma":
            runs = ss.bwd_runs(ns, p.chunk)
            assert len(runs) == p.threads // 32
            for s, _, us in runs:
                for u in us:
                    pairs[b, h0:h0 + p.head_group, s, u] += 1
    nt = p.reduce_grid[1] // 2
    tiles = np.zeros((Bc, 2, nt), int)
    for bx in range(p.reduce_grid[0] - 1):
        for by in range(p.reduce_grid[1]):
            tiles[bx, by // nt, by % nt] += 1
    return heads, pairs, tiles


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Bc,Q,H,P,N", [(32, 128, 112, 64, 64),
                                        (3, 72, 6, 32, 13),
                                        (2, 256, 8, 64, 128),
                                        (2, 100, 5, 64, 32),
                                        (1, 16, 3, 32, 8)])
def test_backward_grids_cover_each_row_and_head_once(Bc, Q, H, P, N,
                                                     dtype):
    """Launch 1 reaches every (chunk row, head) once, and on "mma" every
    causal (strip, subtile) pair of it exactly once through the runs and
    none above the diagonal; launch 2 every 64-row tile of dC and of dB
    of every chunk row once."""
    p = ss.plan_bwd(Bc, Q, H, P, N, dtype)
    heads, pairs, tiles = bwd_covered(p, Bc, Q, H)
    assert (heads == 1).all()
    if p.route == "mma":
        causal = np.triu(np.ones(pairs.shape[-2:], int))     # u >= s
        assert (pairs == causal).all()
    assert (tiles == 1).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Q,H,P,N", [(128, 112, 64, 64), (72, 6, 32, 13),
                                     (256, 8, 64, 128), (1, 5, 32, 1)])
def test_backward_plan_order_of_sums_does_not_change_with_bc(Q, H, P, N,
                                                             dtype):
    """Every field that sets an order of sums (the route, the head group
    that dS sums over, the runs whose dxdt add in order, the warps, where
    the triangles live) is the same for any number of chunk rows."""
    def order(p):
        return p.route, p.head_group, p.chunk, p.threads, p.tri_smem

    base = order(ss.plan_bwd(1, Q, H, P, N, dtype))
    for Bc in (1, 3, 32, 1000):
        assert order(ss.plan_bwd(Bc, Q, H, P, N, dtype)) == base


def test_backward_plan_refuses_what_the_forward_refuses():
    with pytest.raises(ValueError, match="head_dim"):
        ss.plan_bwd(2, 64, 4, 48, 16, F32)
    with pytest.raises(ValueError, match="chunk"):
        ss.plan_bwd(2, 300, 4, 32, 16, F32)
    with pytest.raises(ValueError, match="state"):
        ss.plan_bwd(2, 64, 4, 32, 200, F32)
    with pytest.raises(ValueError, match="float32 or"):
        ss.plan_bwd(2, 64, 4, 32, 16, torch.float16)
    with pytest.raises(ValueError, match="nothing to compute"):
        ss.plan_bwd(0, 64, 4, 32, 16, F32)


# ----------------------------------------------------------- Mamba2 layer
def test_mamba2_layer_gradients_match_jax():
    """Input and parameter gradients of a random projection of one Mamba2
    block's output over two SSD chunks, against ``jax.vjp`` of
    ``repro.models.ssm.ssm_forward``, each within 1e-4 of the JAX leaf's
    norm; the port's block reads its leaves from a namespace, as the
    trainer hands them."""
    cfg = jssm.SSMConfig(d_model=SMOKE.d_model, d_inner=SMOKE.d_inner,
                         head_dim=SMOKE.ssm_head_dim,
                         state_dim=SMOKE.ssm_state)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_params(jssm.ssm_defs(cfg),
                                  jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    u = rng.normal(size=(2, SEQ, cfg.d_model)).astype(np.float32)
    proj = rng.normal(size=(2, SEQ, cfg.d_model)).astype(np.float32)
    out, vjp = jax.vjp(lambda p, x: jssm.ssm_forward(p, x, cfg), jp,
                       jnp.asarray(u))
    jg, jgu = vjp(jnp.asarray(proj))
    leaves = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in jp.items()}
    ut = torch.from_numpy(u).requires_grad_(True)
    tcfg = tssm.SSMConfig(**dataclasses.asdict(cfg))
    y = tssm.ssm_forward(types.SimpleNamespace(**leaves), ut, tcfg)
    assert_scaled(y.detach(), out, 1e-4)
    grads = torch.autograd.grad(y, [ut, *leaves.values()],
                                torch.from_numpy(proj))
    for name, got, want in zip(["u", *leaves], grads,
                               [jgu, *(jg[k] for k in leaves)]):
        got = got.numpy().astype(np.float64)
        want = np.asarray(want, np.float64)
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), \
            name


# ------------------------------------------------------- loss and training
@pytest.fixture(scope="module")
def f32_reference():
    """The f32 JAX params, a batch of 2 x 256 tokens, and
    ``jax.value_and_grad(model.loss)`` with remat off and on."""
    jp = jax_params(jax_model(), seed=0)
    b = batch()
    out = {}
    for remat in (False, True):
        loss, grads = jax.value_and_grad(jax_model(remat).loss)(jp,
                                                                to_jax(b))
        out[remat] = (float(loss), jax.tree.map(np.asarray, grads))
    return jp, b, out


@pytest.mark.parametrize("remat", [False, True])
def test_hybrid_loss_and_gradients_match_jax_in_f32(f32_reference, remat):
    """Loss within rtol 1e-4, each gradient leaf within F32_TOL in norm
    (module docstring); the model's own tensors stay without grad."""
    jp, b, out = f32_reference
    want_loss, want_grads = out[remat]
    m = port_model(jax_model(remat), jp)
    assert m.cfg.remat == remat and m.cfg.family == "hybrid"
    loss, grads = value_and_grad(m, dict(m.named_parameters()), to_torch(b))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    errors = leaf_errors(grads, want_grads)
    assert max(errors.values()) <= F32_TOL, errors
    assert not any(p.requires_grad for p in m.parameters())


@pytest.mark.parametrize("remat", [False, True])
def test_hybrid_loss_and_gradients_match_jax_in_float64(monkeypatch, remat):
    """Both packages in float64: the loss and every gradient leaf within
    1e-8 (the algorithms agree; what f32 shows is round-off)."""
    widen_islands(monkeypatch)
    b = batch(seed=4)
    with jax.enable_x64(True):
        jm = jax_model(remat, jnp.float64)
        jp = jax_params(jm, seed=1, dtype=jnp.float64)
        want_loss, want_grads = jax.value_and_grad(jm.loss)(jp, to_jax(b))
        want_loss = float(want_loss)
        want_grads = jax.tree.map(np.asarray, want_grads)
        jp = jax.tree.map(np.asarray, jp)
    m = port_model(jm, jp, dtype=torch.float64)
    loss, grads = value_and_grad(m, dict(m.named_parameters()), to_torch(b))
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-8)
    errors = leaf_errors(grads, want_grads)
    assert max(errors.values()) <= 1e-8, errors


def test_f32_round_off_of_the_gradient(monkeypatch):
    """Why F32_TOL: the port's own f32 gradient against its float64
    gradient on the same weights and batch, every leaf within F32_TOL / 2
    in norm, and the largest distance above 1e-4 (so 1e-4 would fail on
    round-off alone)."""
    jp = jax_params(jax_model(), seed=0)
    b = to_torch(batch())
    m = port_model(jax_model(), jp)
    _, g32 = value_and_grad(m, dict(m.named_parameters()), b)
    widen_islands(monkeypatch)
    m64 = port_model(jax_model(), jax.tree.map(
        lambda a: np.asarray(a, np.float64), jp), dtype=torch.float64)
    _, g64 = value_and_grad(m64, dict(m64.named_parameters()), b)
    errors = {n: float((g32[n].double() - g).norm() / g.norm())
              for n, g in g64.items()}
    assert max(errors.values()) <= F32_TOL / 2, errors
    assert max(errors.values()) > 1e-4, errors


def test_hybrid_remat_does_not_change_the_gradient():
    """Loss and gradients bitwise equal with and without remat."""
    jp = jax_params(jax_model(), seed=1)
    plain = port_model(jax_model(False), jp)
    remat = port_model(jax_model(True), jp)
    b = to_torch(batch(seq=128))
    l1, g1 = value_and_grad(plain, dict(plain.named_parameters()), b)
    l2, g2 = value_and_grad(remat, dict(remat.named_parameters()), b)
    assert torch.equal(l1, l2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


def trainer_batches(n, seq=32, size=4, seed=3):
    src = SyntheticLM(SMOKE.vocab, seq, size, seed=seed)
    return [src.batch_np(i) for i in range(n)]


def test_hybrid_trainer_trajectory_matches_jax(monkeypatch):
    """Three steps of both trainers from the same weights and batches, the
    models in float64 (their f32 islands widened; both AdamWs keep their
    f32 update): losses within rtol 1e-5.  In f32 the gradients' round-off
    (module docstring) moves the losses apart by 3e-4 at the second step;
    in float64 they agree to 3e-8 there and 8e-7 at the third, and the
    smoke model amplifies any difference about a hundredfold a step
    (1.8e-4 at the fourth), so more steps would measure that growth, not
    the port."""
    widen_islands(monkeypatch)
    data = trainer_batches(3)
    with jax.enable_x64(True):
        jm = jax_model(dtype=jnp.float64)
        jp = jax_params(jm, seed=2, dtype=jnp.float64)
        opt = JAdamW(lr=1e-3, eps=1e-4)
        jtr = JTrainer(jm, opt, JTrainerConfig(steps=3, log_every=1),
                       rng=jax.random.PRNGKey(0))
        jtr.params = jax.tree.map(jnp.copy, jp)     # the step donates them
        jtr.opt_state = opt.init(jtr.params)
        jtr.run(iter(to_jax(b) for b in data))
        jp = jax.tree.map(np.asarray, jp)
    m = port_model(jm, jp, dtype=torch.float64)
    tr = Trainer(m, AdamW(lr=1e-3, eps=1e-4),
                 TrainerConfig(steps=3, log_every=1),
                 params=dict(m.state_dict()))
    tr.run(iter(to_torch(b) for b in data))
    got = [r["loss"] for r in tr.metrics_log]
    want = [r["loss"] for r in jtr.metrics_log]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert [r["step"] for r in tr.metrics_log] == [1, 2, 3]


def test_hybrid_guided_training_is_lossless_and_offloads():
    """Guided == unguided losses and parameters, bitwise, with state on
    the slow tier and the SSM groups among the sites."""
    data = [to_torch(b) for b in trainer_batches(6)]
    jm = jax_model()
    jp = jax_params(jm, seed=5)

    def trainer(gdt=None):
        m = port_model(jm, jp)
        return Trainer(m, AdamW(lr=1e-3, eps=1e-4),
                       TrainerConfig(steps=6, log_every=1, gdt=gdt),
                       params=dict(m.state_dict()))

    plain = trainer()
    state = sum(p.numel() * (p.element_size() + 8)
                for p in plain.params.values())
    guided = trainer(GuidanceConfig(
        enabled=True, fast_capacity_bytes=int(state * 0.6),
        interval_steps=2, promotion_threshold=1024))
    plain.run(iter(data))
    out = guided.run(iter(data))
    assert [r["loss"] for r in guided.metrics_log] == \
        [r["loss"] for r in plain.metrics_log]
    assert guided.placer.slow_bytes() > 0 and out["transfer_bytes"] > 0
    for name, p in plain.params.items():
        assert torch.equal(guided.params[name].data, p.data), name
    assert "params/ssm_layers/ssm" in guided._site_groups


def test_hybrid_sites_and_decisions_match_the_jax_trainer():
    """Same GuidanceConfig, TPU_V5E on both, bf16 weights (dt_bias, a_log
    and D f32) on both: the same sites with the same bytes (the
    ``ssm_layers`` and ``shared_attn`` groups among them), the same
    first-touch fractions, interval decisions and migration totals (the
    shared block's norm scales, 256 B each, are below the promotion
    threshold in both and get no arena); the stacked rank-1 SSM leaves (rank 2 in JAX) are decayed, the shared
    block's norm scales (rank 1) are not."""
    jm = jax_model()
    jp = jm.init(jax.random.PRNGKey(6))
    data = trainer_batches(6, size=2)
    total = sum(a.size * a.dtype.itemsize + 8 * a.size
                for a in jax.tree.leaves(jp))
    kw = dict(fast_capacity_bytes=int(total * 0.1), interval_steps=2,
              promotion_threshold=1024)
    jtr = JTrainer(jm, JAdamW(lr=1e-3),
                   JTrainerConfig(steps=6, log_every=1,
                                  gdt=JGuidanceConfig(enabled=True, **kw)),
                   hw=JTPU_V5E, rng=jax.random.PRNGKey(0))
    jtr.run(iter(to_jax(b) for b in data))
    m = port_model(jm, jp, dtype=torch.bfloat16)
    tr = Trainer(m, AdamW(lr=1e-3),
                 TrainerConfig(steps=6, log_every=1,
                               gdt=GuidanceConfig(enabled=True, **kw)),
                 hw=TPU_V5E, params=dict(m.state_dict()))
    tr.run(iter(to_torch(b) for b in data))
    keys = list(tr._site_groups)
    for tree in ("params", "adam_m", "adam_v"):
        for group in ("ssm_layers/ssm", "ssm_layers/ln", "shared_attn/attn",
                      "shared_attn/mlp"):
            assert f"{tree}/{group}" in keys
    assert keys == list(jtr._site_groups)
    for key, (site, arena, _) in tr._site_groups.items():
        jsite, jarena, _ = jtr._site_groups[key]
        assert site.path == jsite.path and site.kind.value == jsite.kind.value
        assert arena.resident_bytes == jarena.resident_bytes, key
        assert arena.fast_fraction == jarena.fast_fraction, key
    assert tr.gdt.migration_count == jtr.gdt.migration_count
    assert tr.gdt.total_bytes_migrated == jtr.gdt.total_bytes_migrated

    def stream(rt):
        return [(e.interval_index, e.decision.rental_cost_ns,
                 e.decision.purchase_cost_ns, e.decision.bytes_to_move,
                 e.decision.migrate, e.migrated, e.bytes_moved,
                 e.fast_bytes_after)
                for e in rt.events if e.kind == "interval"]

    assert stream(tr.gdt) == stream(jtr.gdt) and stream(tr.gdt)
    for name in ("dt_bias", "a_log", "D", "norm"):
        t = tr.params[f"ssm_layers.0.ssm.{name}"]
        assert t.dim() == 1 and jax_ndim(f"ssm_layers.0.ssm.{name}", t) == 2
    assert jax_ndim("ssm_layers.0.ln.scale",
                    tr.params["ssm_layers.0.ln.scale"]) == 2
    assert jax_ndim("shared_attn.ln1.scale",
                    tr.params["shared_attn.ln1.scale"]) == 1


def test_launcher_trains_the_hybrid_under_an_hbm_budget():
    """``python -m repro_torch.launch.train`` takes the hybrid arch,
    guided."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
         "--seq", "32", "--gdt-budget-mb", "1", "--gdt-interval", "2"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"transfer_bytes"' in proc.stdout and '"final_loss"' in proc.stdout
