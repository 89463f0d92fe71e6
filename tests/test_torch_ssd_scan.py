"""The SSD kernel's launch plan and the arithmetic of its bf16 route, on
the CPU.

``plan`` is plain Python: it runs here, where the CUDA kernel cannot.  Its
grid must cover every (chunk, head) pair exactly once, its shared memory
must fit the card over the whole range of shapes the kernel takes, and its
tiles and k step must not change with Bc or H (the order of every sum, so
each output's bits, depends on them).

The bf16 route feeds the second product with bf16 operands: x as the exact
bf16 it is, and the f32 weight W' = (C_i . B_j) exp(acum_i - acum_j) dt_j
as a bf16 pair hi = bf16(W'), lo = bf16(W' - hi), accumulated in f32.  An
emulation of that arithmetic in torch is held to ``SSD_TOL`` of max|y|
against ``ref.ssd_reference`` at the hybrid prefill's widths and against
``ssd_scan_pallas`` in interpret mode; a third test records why the split
exists: one bf16 rounding of W' misses the tolerance many times over.

The backward's bf16 route feeds its f32 operands (dY, W = S L, dS) the same
way, as hi/lo pairs, and x, B and C as they are: an emulation of that
arithmetic is held to ``SSD_BWD_TOL`` of each output's max against
``ref.ssd_bwd_reference`` and to a fifth of it against float64, and against
``jax.vjp`` of the JAX package's ``ssd_chunked``; one rounding of dY and W
misses ddt's and dA's 1e-4.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

# The kernel against its plain version, as a fraction of max|y| (the
# tolerance of the card's checks, tests/test_torch_gpu.py).
SSD_TOL = 1e-4
DTYPES = [torch.float32, torch.bfloat16]


# --------------------------------------------------------------------- plan
@pytest.mark.parametrize("Bc,Q,H,P,N", [(32, 128, 112, 64, 64),
                                        (2, 100, 5, 64, 32),
                                        (1, 256, 4, 32, 128),
                                        (3, 8, 6, 32, 16)])
def test_plan_routes_bf16_to_tensor_cores_and_f32_to_simt(Bc, Q, H, P, N):
    mma = ss.plan(Bc, Q, H, P, N, torch.bfloat16)
    simt = ss.plan(Bc, Q, H, P, N, torch.float32)
    assert (mma.route, mma.k_step) == ("mma", 16)
    assert mma.warps == -(-Q // 16) and mma.stages == 3
    assert (simt.route, simt.k_step, simt.stages) == ("simt", 1, 1)
    assert simt.warps == 8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P", ss.HEAD_DIMS)
def test_plan_shared_memory_fits_every_shape(P, dtype):
    # H = 112 lets the bf16 route take its largest head group (4 at P=32,
    # 2 at P=64) and f32 its 4: the most shared memory per Q and N.
    worst = 0
    for Q in range(1, ss.MAX_CHUNK + 1):
        for N in range(1, ss.MAX_STATE + 1):
            p = ss.plan(2, Q, 112, P, N, dtype)
            assert 0 < p.smem <= ss.SMEM_LIMIT, (Q, N)
            worst = max(worst, p.smem)
    assert worst == ss.plan(2, 256, 112, P, 128, dtype).smem


def covered(p, Bc, Q, H):
    """How often each (chunk, head, row) the grid's blocks reach, by the
    ``.cu`` file's index arithmetic."""
    count = np.zeros((Bc, H, Q), int)
    if p.route == "mma":
        groups = H // p.head_group
        for blk in range(p.grid[0]):
            b, g = divmod(blk, groups)
            h0 = g * p.head_group
            count[b, h0:h0 + p.head_group, :] += 1   # every row of Q
        assert p.warps * 16 >= Q                     # a strip per warp
    else:
        for tile in range(p.grid[0]):
            for g in range(p.grid[1]):
                for b in range(p.grid[2]):
                    h0 = g * p.head_group
                    count[b, h0:h0 + p.head_group,
                          tile * p.key_block:(tile + 1) * p.key_block] += 1
    return count


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Bc,Q,H,P", [(32, 128, 112, 64), (3, 100, 5, 64),
                                      (2, 8, 6, 32), (1, 256, 12, 32),
                                      (4, 200, 7, 64)])
def test_plan_grid_covers_each_chunk_and_head_once(Bc, Q, H, P, dtype):
    p = ss.plan(Bc, Q, H, P, 64, dtype)
    assert H % p.head_group == 0
    assert (covered(p, Bc, Q, H) == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Q,P,N", [(128, 64, 64), (100, 32, 40),
                                   (256, 64, 128), (8, 32, 16)])
def test_plan_tiles_and_k_step_do_not_change_with_Bc_or_H(Q, P, N, dtype):
    def tiles(p):
        return p.route, p.warps, p.key_block, p.k_step, p.stages

    base = tiles(ss.plan(1, Q, 1, P, N, dtype))
    for Bc in (1, 2, 32, 1000):
        for H in (1, 2, 5, 6, 112, 113):
            assert tiles(ss.plan(Bc, Q, H, P, N, dtype)) == base


def test_plan_refuses_shapes_by_name():
    bf = torch.bfloat16
    cases = [((2, 64, 4, 48, 16, bf), "head_dim P"),
             ((2, 0, 4, 32, 16, bf), "chunk of 1 to 256"),
             ((2, 257, 4, 32, 16, bf), "chunk of 1 to 256"),
             ((2, 64, 4, 32, 0, bf), "state of 1 to 128"),
             ((2, 64, 4, 32, 129, bf), "state of 1 to 128"),
             ((2, 64, 4, 32, 16, torch.float16), "float32 or bfloat16"),
             ((0, 64, 4, 32, 16, bf), "nothing to compute"),
             ((2, 64, 0, 32, 16, bf), "nothing to compute"),
             ((70000, 64, 4, 32, 16, torch.float32), "Bc=70000")]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            ss.plan(*args)
    # bf16 takes as many chunks as f32 refuses: its grid is one dimension.
    p = ss.plan(70000, 64, 4, 32, 16, bf)
    assert p.grid[1:] == (1, 1) and p.blocks * p.head_group == 70000 * 4


# ------------------------------------------------------ bf16 arithmetic
def emulate_mma_route(x, dt, A, Bm, Cm, feed: str = "pair"):
    """The bf16 route's arithmetic in torch: scores of the bf16 B and C
    rows summed in f32, W' = S exp(acum_i - acum_j) dt_j in f32 (zero above
    the diagonal, selected before exp), times x as its exact bf16, summed in
    f32.  ``feed`` says how the weights reach the bf16 product: "pair" (the
    kernel's: W' as hi = bf16(W') plus lo = bf16(W' - hi)), "once" (W'
    rounded once to bf16) or "xdt" (dt folded into x instead, x * dt and
    the weights each rounded once to bf16)."""
    f32, bf = torch.float32, torch.bfloat16
    Q = x.shape[1]
    acum = torch.cumsum(dt * A, dim=1)                         # (Bc,Q,H)
    S = torch.einsum("bin,bjn->bij", Cm.to(f32), Bm.to(f32))
    diff = acum[:, :, None, :] - acum[:, None, :, :]           # (Bc,i,j,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))[None, :, :,
                                                              None]
    zero = torch.zeros_like(diff)
    decay = torch.exp(torch.where(causal, diff, zero))
    xf = x.to(f32)
    if feed == "xdt":
        w = torch.where(causal, S[..., None] * decay, zero)
        xdt = (xf * dt[..., None]).to(bf).to(f32)
        return torch.einsum("bijh,bjhp->bihp", w.to(bf).to(f32), xdt)
    w = torch.where(causal, S[..., None] * decay * dt[:, None, :, :], zero)
    hi = w.to(bf).to(f32)
    y = torch.einsum("bijh,bjhp->bihp", hi, xf)
    if feed == "pair":
        lo = (w - hi).to(bf).to(f32)
        y = y + torch.einsum("bijh,bjhp->bihp", lo, xf)
    return y


def ssd_inputs(seed, Bc, Q, H, P, N):
    """x, B and C as bf16 (exact in f32), dt and A in f32, from numpy with
    the model's statistics (the JAX kernel test's ranges)."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(Bc, Q, H, P)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (Bc, Q, H)).astype(
        np.float32))
    A = torch.from_numpy(-rng.uniform(0.5, 2.0, (H,)).astype(np.float32))
    Bm = torch.from_numpy(rng.normal(size=(Bc, Q, N)).astype(np.float32))
    Cm = torch.from_numpy(rng.normal(size=(Bc, Q, N)).astype(np.float32))
    return x.to(bf), dt, A, Bm.to(bf), Cm.to(bf)


def float64_truth(x, dt, A, Bm, Cm):
    """The same function in float64 throughout."""
    f64 = torch.float64
    x, dt, A, Bm, Cm = (t.to(f64) for t in (x, dt, A, Bm, Cm))
    Q = x.shape[1]
    acum = torch.cumsum(dt * A, dim=1)
    diff = acum[:, :, None, :] - acum[:, None, :, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))[None, :, :,
                                                              None]
    decay = torch.where(causal, torch.exp(torch.where(
        causal, diff, torch.zeros_like(diff))), torch.zeros_like(diff))
    S = torch.einsum("bin,bjn->bij", Cm, Bm)
    return torch.einsum("bij,bijh,bjh,bjhp->bihp", S, decay, dt, x)


def scaled_err(got, want) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


HYBRID_SMALL = (2, 128, 112, 64, 64)     # two chunks of the hybrid prefill


def test_emulated_split_is_within_tolerance_at_the_hybrid_widths():
    args = ssd_inputs(0, *HYBRID_SMALL)
    want = ref.ssd_reference(*args)
    got = emulate_mma_route(*args)
    assert got.shape == want.shape and torch.isfinite(got).all()
    scale = float(want.abs().max()) + 1e-6
    torch.testing.assert_close(got / scale, want / scale, atol=SSD_TOL,
                               rtol=SSD_TOL)


@pytest.mark.parametrize("Bc,Q,H,P,N", [(2, 64, 8, 32, 16),
                                        (1, 100, 4, 64, 40)])
def test_emulated_split_matches_pallas_interpret(Bc, Q, H, P, N):
    x, dt, A, Bm, Cm = ssd_inputs(1, Bc, Q, H, P, N)
    jin = [jnp.asarray(t.to(torch.float32).numpy(), jnp.bfloat16)
           for t in (x, Bm, Cm)]
    pallas = ssd_scan_pallas(jin[0], jnp.asarray(dt.numpy()),
                             jnp.asarray(A.numpy()), jin[1], jin[2],
                             block_h=4, interpret=True)
    want = torch.from_numpy(np.array(pallas, np.float32))
    got = emulate_mma_route(x, dt, A, Bm, Cm)
    scale = float(want.abs().max()) + 1e-6
    torch.testing.assert_close(got / scale, want / scale, atol=SSD_TOL,
                               rtol=SSD_TOL)


def test_one_bf16_rounding_of_the_weights_misses_the_tolerance():
    """Why the kernel splits W': rounded once to bf16 (or with dt folded
    into x and both rounded) the weights carry 8 bits, and y misses 1e-4 of
    max|y| by more than tenfold; the hi/lo pair carries about 16 and stays
    inside with a wide margin (errors against float64, as fractions of
    max|y|: 2.6e-3, 3.2e-3 and 4.4e-6 with this seed)."""
    args = ssd_inputs(0, *HYBRID_SMALL)
    truth = float64_truth(*args)
    err = {feed: scaled_err(emulate_mma_route(*args, feed=feed), truth)
           for feed in ("once", "xdt", "pair")}
    assert err["once"] > 10 * SSD_TOL and err["xdt"] > 10 * SSD_TOL, err
    assert err["pair"] < SSD_TOL / 5, err


# ------------------------------------------------- bf16 backward arithmetic
# The backward against its plain version, as a fraction of each output's
# largest entry, by the output's dtype (tests/test_torch_gpu.py).
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")


def emulate_mma_bwd(x, dt, A, Bm, Cm, dy, feed: str = "pair",
                    rounded: bool = True):
    """The bf16 backward route's arithmetic in torch, every sum in f32: x,
    B and C as the exact bf16 they are; the f32 operands dY (into dW' and
    W^T dY), W = S L (into W^T dY) and dS (into dS B and dS^T C) as a bf16
    pair hi = bf16(v), lo = bf16(v - hi) with ``feed="pair"`` (the
    kernel's: x.hi + x.lo for dW', hi.hi + hi.lo + lo.hi for W^T dY, hi + lo
    against B and C), or rounded once to bf16 with ``feed="once"``; dt
    factored out of dW (dW = dt_j (dY_i . x_j)).  The decays are exp in
    float64 rounded to f32: the kernel's ex2.approx is within 2 ulp, and
    torch's f32 exp on the CPU is not always (about 3e-5 in some
    processes).  ``rounded=False`` returns dx, dB and dC in f32, before
    the final rounding to bf16 that every version takes."""
    f32, bf = torch.float32, torch.bfloat16
    Q = x.shape[1]

    def parts(v):
        hi = v.to(bf).to(f32)
        return [hi] if feed == "once" else [hi, (v - hi).to(bf).to(f32)]

    xf, Bf, Cf = x.to(f32), Bm.to(f32), Cm.to(f32)
    c = torch.cumsum(dt * A, dim=1)                            # (Bc,Q,H)
    diff = (c[:, :, None, :] - c[:, None, :, :]).double()      # (Bc,i,j,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))[None, :, :,
                                                              None]
    zero = torch.zeros((), dtype=f32)
    L = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)).to(f32),
                    zero)
    S = torch.einsum("bin,bjn->bij", Cf, Bf)
    W = S[..., None] * L
    dyp, wp = parts(dy), parts(W)
    dWp = sum(torch.einsum("bihp,bjhp->bijh", d, xf) for d in dyp)
    dW = torch.where(causal, dWp * dt[:, None, :, :], zero)
    pairs = ([(0, 0), (0, 1), (1, 0)] if feed == "pair" else [(0, 0)])
    dxdt = sum(torch.einsum("bijh,bihp->bjhp", wp[a], dyp[b])
               for a, b in pairs)
    G = dW * W
    dc = G.sum(dim=2) - G.sum(dim=1)
    da = torch.flip(torch.cumsum(torch.flip(dc, (1,)), dim=1), (1,))
    ddt = (xf * dxdt).sum(-1) + A * da
    dA = (da * dt).sum(dim=(0, 1))
    dsp = parts((dW * L).sum(-1))
    dC = sum(torch.einsum("bij,bjn->bin", d, Bf) for d in dsp)
    dB = sum(torch.einsum("bij,bin->bjn", d, Cf) for d in dsp)
    dx = dt[..., None] * dxdt
    if rounded:
        dx, dB, dC = (t.to(x.dtype) for t in (dx, dB, dC))
    return dx, ddt, dA, dB, dC


def bwd_inputs(seed, Bc, Q, H, P, N):
    """``ssd_inputs`` and an f32 output gradient dy."""
    x, dt, A, Bm, Cm = ssd_inputs(seed, Bc, Q, H, P, N)
    rng = np.random.default_rng(seed + 1000)
    dy = torch.from_numpy(rng.normal(size=(Bc, Q, H, P)).astype(np.float32))
    return x, dt, A, Bm, Cm, dy


def bwd_float64_truth(monkeypatch, *args):
    """``ref.ssd_bwd_reference`` with every value and sum in float64."""
    with monkeypatch.context() as m:
        m.setattr(ref, "F32", torch.float64)
        return ref.ssd_bwd_reference(*(t.double() for t in args))


def test_emulated_backward_split_is_within_tolerance_at_the_hybrid_widths(
        monkeypatch):
    """At two chunk rows of hybrid training's call: every output within
    SSD_BWD_TOL of ``ref.ssd_bwd_reference`` (in the output's dtype), and
    within a fifth of it of a float64 truth before dx, dB and dC round to
    bf16 (that rounding alone moves an entry by up to 2^-8 of it, which
    every version takes)."""
    args = bwd_inputs(0, *HYBRID_SMALL)
    want = ref.ssd_bwd_reference(*args)
    got = emulate_mma_bwd(*args)
    for name, g, w in zip(BWD_NAMES, got, want):
        assert g.dtype == w.dtype and torch.isfinite(g).all(), name
        assert scaled_err(g.float(), w.float()) <= SSD_BWD_TOL[g.dtype], name
    truth = bwd_float64_truth(monkeypatch, *args)
    raw = emulate_mma_bwd(*args, rounded=False)
    for name, g, w, t in zip(BWD_NAMES, raw, want, truth):
        assert scaled_err(g.double(), t) <= SSD_BWD_TOL[w.dtype] / 5, name


def test_emulated_backward_matches_the_jax_chunked_vjp():
    """``jax.vjp`` of the JAX package's ``ssd_chunked`` with S == Q and no
    initial state (the intra-chunk block alone, the final state's
    cotangent zero) on the same bf16-exact x, B and C: every output of
    the emulation within SSD_BWD_TOL of it, in the output's dtype."""
    from repro.models import ssm as jssm

    Bc, Q, H, P, N = 2, 64, 8, 32, 16
    args = bwd_inputs(2, Bc, Q, H, P, N)
    x, dt, A, Bm, Cm, dy = (t.to(torch.float32).numpy() for t in args)
    cfg = jssm.SSMConfig(d_model=8, d_inner=H * P, head_dim=P, state_dim=N,
                         chunk=Q)
    (_, final), vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, cfg),
                              *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(final)))
    got = emulate_mma_bwd(*args)
    for name, g, w in zip(BWD_NAMES, got, want):
        w = torch.from_numpy(np.array(w, np.float32))
        assert scaled_err(g.float(), w) <= SSD_BWD_TOL[g.dtype], name


def test_one_bf16_rounding_of_dy_and_w_misses_the_tolerance(monkeypatch):
    """Why the backward feeds dY and W as hi/lo pairs: rounded once to
    bf16, ddt and dA (f32 outputs, held to 1e-4 of their max) miss it
    several times over; the pairs stay inside with a wide margin (errors
    against float64, as fractions of each output's max, with this seed:
    once ddt 1.8e-3 and dA 7.6e-4; pair ddt 3.4e-6 and dA 1.7e-6)."""
    args = bwd_inputs(0, *HYBRID_SMALL)
    truth = bwd_float64_truth(monkeypatch, *args)
    err = {feed: [scaled_err(g.double(), t) for g, t in zip(
        emulate_mma_bwd(*args, feed=feed, rounded=False), truth)][1:3]
        for feed in ("once", "pair")}
    assert min(err["once"]) > 5 * SSD_BWD_TOL[torch.float32], err
    assert max(err["pair"]) < SSD_BWD_TOL[torch.float32] / 5, err
