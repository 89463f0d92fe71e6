"""The port's plain attention (``ref.mha_reference``, what a CPU tensor
takes through ``kernels.ops.flash_attention``) against the JAX package's
oracle and its Pallas flash kernel in interpret mode, forward and
gradient.  Inputs are made with numpy from a seed and handed to both sides.

f32 throughout, atol = rtol = 1e-5: the frameworks sum the two products in
different orders.  The CUDA kernels themselves run only on the card
(``tests/test_torch_gpu.py``, marked ``gpu``)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-5

SWEEP = [
    # B, Sq, Sk, H, K, dh, causal, window
    (2, 32, 32, 4, 4, 16, True, None),       # MHA causal
    (1, 48, 48, 8, 2, 16, True, None),       # GQA
    (2, 40, 40, 4, 2, 32, True, 9),          # sliding window
    (1, 24, 56, 4, 4, 16, True, None),       # Sq < Sk: q_offset > 0
    (1, 24, 56, 4, 2, 16, True, 12),         # q_offset with a window
    (2, 37, 37, 4, 2, 24, True, None),       # unaligned seq and dh
    (1, 32, 32, 4, 4, 16, False, None),      # non-causal
    (1, 20, 44, 4, 2, 16, False, None),      # non-causal, Sq != Sk
]


def inputs(B, Sq, Sk, H, K, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, dh), (B, Sk, K, dh), (B, Sk, K, dh),
                      (B, Sq, H, dh))]


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,K,dh,causal,window", SWEEP)
def test_mha_reference_matches_jax_oracle(B, Sq, Sk, H, K, dh, causal,
                                          window):
    q, k, v, _ = inputs(B, Sq, Sk, H, K, dh)
    got = ref.mha_reference(*map(torch.from_numpy, (q, k, v)),
                            causal=causal, window=window)
    want = jref.mha_reference(q, k, v, causal=causal, window=window)
    close(got, want)


@pytest.mark.parametrize("B,Sq,Sk,H,K,dh,causal,window", SWEEP)
def test_mha_reference_matches_pallas_interpret(B, Sq, Sk, H, K, dh, causal,
                                                window):
    q, k, v, _ = inputs(B, Sq, Sk, H, K, dh, seed=1)
    got = ref.mha_reference(*map(torch.from_numpy, (q, k, v)),
                            causal=causal, window=window)
    want = flash_attention_pallas(q, k, v, causal, window, True)
    close(got, want)


@pytest.mark.parametrize("window", [None, 7])
def test_rows_that_see_no_key_follow_the_oracle(window):
    """Causal with Sq > Sk: the first Sq - Sk rows sit at negative
    positions and see no key.  The JAX oracle gives them the mean of V over
    all Sk keys (a softmax over Sk scores of -1e30); the port's plain
    version and its CUDA kernel do the same.  The JAX Pallas kernel does
    not: its zero-padded keys enter that mean (ROADMAP.md queue C), so the
    comparison is with the oracle only."""
    q, k, v, do = inputs(1, 50, 20, 4, 2, 16, seed=2)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    got = ref.mha_reference(tq, tk, tv, causal=True, window=window)
    want, vjp = jax.vjp(
        lambda q, k, v: jref.mha_reference(q, k, v, causal=True,
                                           window=window), q, k, v)
    close(got, want)
    mean_v = v.mean(axis=1)                                   # (B, K, dh)
    close(got[:, :30], np.broadcast_to(
        np.repeat(mean_v, 2, axis=1)[:, None], (1, 30, 4, 16)))
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        close(g, w)


@pytest.mark.parametrize("B,Sq,Sk,H,K,dh,causal,window", SWEEP)
def test_mha_reference_gradients_match_jax_vjp(B, Sq, Sk, H, K, dh, causal,
                                               window):
    q, k, v, do = inputs(B, Sq, Sk, H, K, dh, seed=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = ref.mha_reference(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _, vjp = jax.vjp(
        lambda q, k, v: jref.mha_reference(q, k, v, causal=causal,
                                           window=window), q, k, v)
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        close(g, w)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_ops_flash_attention_on_cpu_takes_the_plain_path(causal, window):
    q, k, v, do = inputs(2, 30, 30, 8, 2, 16, seed=4)
    before = dict(fa.LAUNCHES)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    assert fa.LAUNCHES == before
    rq, rk, rv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    want = ref.mha_reference(rq, rk, rv, causal=causal, window=window)
    assert torch.equal(got, want)
    for g, w in zip(grads, torch.autograd.grad(want, (rq, rk, rv),
                                               torch.from_numpy(do))):
        assert torch.equal(g, w)


def test_mha_reference_keeps_the_input_dtype():
    q, k, v, _ = inputs(1, 16, 16, 4, 2, 16, seed=5)
    got = ref.mha_reference(*(torch.from_numpy(a).bfloat16()
                              for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = jref.mha_reference(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_flash_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in inputs(1, 16, 16, 4, 2, 64))
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_cuda(q, k, v)
    lse = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_cuda(q, k, v, q, lse, do)
    assert fa.LAUNCHES == before


# ------------------------------------------------------------------ plan
PLAN_SHAPES = [
    # B, Sq, Sk, H, K
    (2, 2048, 2048, 32, 8),     # the training shape
    (4, 1024, 1024, 32, 32),    # the hybrid prefill
    (1, 200, 200, 8, 2),        # not a multiple of any tile
    (1, 257, 257, 8, 2),
    (1, 1000, 300, 32, 8),      # Sq > Sk
    (3, 1, 65, 4, 1),           # one query row
]


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_plan_routes_bf16_to_tensor_cores_and_f32_to_simt(dh):
    assert fa.plan(2, 2048, 2048, 32, 8, dh, torch.bfloat16).route == "mma"
    assert fa.plan(2, 2048, 2048, 32, 8, dh, torch.float32).route == "simt"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_plan_shared_memory_fits_the_card(dh, dtype):
    p = fa.plan(2, 2048, 2048, 32, 8, dh, dtype)
    for smem in (p.fwd_smem, p.dkdv_smem, p.dq_smem):
        assert 0 < smem <= 227 * 1024
    if dtype == torch.bfloat16:
        # 16 query rows a warp; a 2-stage ring of 64-key tiles.
        assert p.rows_per_cta == 16 * p.warps and p.stages == 2
        assert p.fwd_smem == 2 * (dh + 8) * (p.rows_per_cta +
                                             2 * p.stages * 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,K", PLAN_SHAPES)
def test_plan_grids_cover_every_tile(B, Sq, Sk, H, K, dtype):
    for dh in fa.HEAD_DIMS:
        p = fa.plan(B, Sq, Sk, H, K, dh, dtype)
        for grid, heads, n, tile in (
                (p.fwd_grid, H, Sq, p.rows_per_cta),
                (p.dq_grid, H, Sq, p.dq_rows),
                (p.dkdv_grid, K, Sk, fa.KEY_TILE)):
            assert grid[:2] == (heads, B)
            assert (grid[2] - 1) * tile < n <= grid[2] * tile


@pytest.mark.parametrize("args,match", [
    ((1, 16, 16, 4, 2, 48, torch.bfloat16), "head_dim"),
    ((1, 16, 16, 4, 2, 72, torch.float32), "head_dim"),
    ((1, 16, 16, 6, 4, 64, torch.bfloat16), "group"),
    ((1, 16, 16, 4, 0, 64, torch.bfloat16), "group"),
    ((1, 0, 16, 4, 2, 64, torch.bfloat16), "nothing to attend"),
    ((1, 16, 0, 4, 2, 64, torch.float32), "nothing to attend"),
    ((1, 16, 16, 4, 2, 64, torch.float16), "float32 or bfloat16"),
    ((1, 64 * 65536, 16, 4, 2, 64, torch.float32), "Sq="),
    ((1, 16, 64 * 65536, 4, 2, 64, torch.bfloat16), "Sk="),
])
def test_plan_refuses_odd_shapes_by_name(args, match):
    with pytest.raises(ValueError, match=match):
        fa.plan(*args)
