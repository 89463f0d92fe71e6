"""Flash attention at head dims 80 (``stablelm_3b``) and 96
(``phi3_vision_4_2b``): the port's plain version, what a CPU tensor takes
through ``kernels.ops.flash_attention``, against the JAX package's Pallas
kernel ``flash_attention_pallas`` in interpret mode, forward and gradients
(its VJP), at a small S with and without a window; and the kernels' launch
plans at both head dims.  Inputs are made with numpy from a seed.

f32, atol = rtol = 1e-4: the frameworks sum in other orders, and the
gradients sum up to G * Sq terms.  The CUDA kernels themselves run only on
the card (``tests/test_torch_gpu.py``, marked ``gpu``)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-4
NEW_DIMS = (80, 96)
CASES = [
    # B, Sq, Sk, H, K, causal, window
    (1, 40, 40, 4, 2, True, None),
    (2, 33, 33, 4, 4, True, 9),
    (1, 24, 56, 4, 2, True, 12),      # q_offset with a window
    (1, 20, 44, 2, 1, False, None),
]


def inputs(B, Sq, Sk, H, K, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, dh), (B, Sk, K, dh), (B, Sk, K, dh),
                      (B, Sq, H, dh))]


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,K,causal,window", CASES)
@pytest.mark.parametrize("dh", NEW_DIMS)
def test_plain_matches_pallas_interpret_forward_and_gradients(
        dh, B, Sq, Sk, H, K, causal, window):
    q, k, v, do = inputs(B, Sq, Sk, H, K, dh, seed=dh + Sq)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    before = dict(fa.LAUNCHES)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    assert fa.LAUNCHES == before
    want, vjp = jax.vjp(
        lambda q, k, v: flash_attention_pallas(q, k, v, causal, window,
                                               True), q, k, v)
    close(got, want)
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        close(g, w)


@pytest.mark.parametrize("dh", NEW_DIMS)
def test_plan_at_the_new_head_dims(dh):
    """bf16: 4 warps of 16 rows (dh above 64), 32-row dK/dV steps, every
    block's shared memory as the .cu file reckons it and under 227 KB; f32:
    the SIMT tiles; both at stablelm's training call and phi3-vision's."""
    for dtype in (torch.bfloat16, torch.float32):
        p = fa.plan(2, 2048, 2048, 32, 32, dh, dtype)
        for smem in (p.fwd_smem, p.dkdv_smem, p.dq_smem):
            assert 0 < smem <= fa.SMEM_LIMIT
        assert p.fwd_grid == (32, 2, 2048 // p.rows_per_cta)
        assert p.dkdv_grid == (32, 2, 2048 // fa.KEY_TILE)
        assert p.dq_grid == (32, 2, 2048 // p.dq_rows)
        if dtype == torch.bfloat16:
            assert (p.route, p.warps, p.rows_per_cta, p.bwd_rows,
                    p.dq_rows) == ("mma", 4, 64, 32, 64)
            lds = 2 * (dh + 8)
            assert p.fwd_smem == lds * (64 + 2 * 2 * 64)
            assert p.dkdv_smem == lds * (2 * 64 + 2 * 2 * 32) + 4 * 2 * 2 * 32
            assert p.dq_smem == lds * (2 * 64 + 2 * 2 * 64)
        else:
            assert (p.route, p.rows_per_cta, p.warps) == ("simt", 64, 8)
            assert p.dkdv_smem == 4 * (4 * 64 * (dh + 1) + 2 * 64 * 65 +
                                       2 * 64)


@pytest.mark.parametrize("dh", NEW_DIMS)
def test_head_dims_off_the_instantiations_are_refused(dh):
    for off in (dh - 8, dh + 8):
        with pytest.raises(ValueError, match="head_dim"):
            fa.plan(1, 16, 16, 4, 2, off, torch.bfloat16)
    assert fa.plan(1, 16, 16, 4, 2, dh, torch.bfloat16).route == "mma"


def test_cuda_wrappers_refuse_cpu_tensors_at_dh_80():
    q, k, v, do = (torch.from_numpy(a)
                   for a in inputs(1, 16, 16, 4, 4, 80, seed=0))
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_cuda(q, k, v)
    assert fa.LAUNCHES == before
