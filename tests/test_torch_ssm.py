"""The port's Mamba2 block and its SSD plain version against the JAX
package, on the CPU.  Inputs are made with numpy from a seed and go
through both packages.

Tolerances, as fractions of the largest |y| (the JAX kernel test's
scaling):
- ``ref.ssd_reference`` against the JAX oracle: 1e-5 in both dtypes (bf16
  inputs are cast to f32 exactly, then both compute in f32, summing in
  other orders);
- against ``ssd_scan_pallas`` in interpret mode, and the chunked scan
  against JAX's: 1e-4, the JAX package's own kernel-against-model-chunk
  tolerance (the chunked form orders the sums differently again).
The whole block (``ssm_forward``, ``ssm_decode``) in f32 within 1e-4 of
its largest output, states and outputs alike.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import init_params  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(np.asarray(a, np.float32), JAX_DT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH_DT[dtype])


def ssd_case(rng, B, Q, H, P, N, dtype):
    x = both(rng.normal(size=(B, Q, H, P)), dtype)
    dt = both(rng.uniform(0.001, 0.1, size=(B, Q, H)), "float32")
    A = both(-rng.uniform(0.5, 2.0, size=(H,)), "float32")
    Bm = both(rng.normal(size=(B, Q, N)), dtype)
    Cm = both(rng.normal(size=(B, Q, N)), dtype)
    return [t[0] for t in (x, dt, A, Bm, Cm)], [t[1] for t in
                                                 (x, dt, A, Bm, Cm)]


def assert_scaled_close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol)


# The JAX package's SSD kernel sweep (tests/test_kernels.py).
SWEEP = [(2, 64, 8, 32, 16, 4), (1, 128, 4, 64, 64, 4),
         (2, 128, 16, 64, 64, 8), (1, 64, 2, 64, 32, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Q,H,P,N,bh", SWEEP)
def test_ssd_reference_matches_jax_oracle_and_pallas(B, Q, H, P, N, bh,
                                                     dtype):
    jin, tin = ssd_case(np.random.default_rng(2), B, Q, H, P, N, dtype)
    got = ref.ssd_reference(*tin)
    assert got.dtype == torch.float32 and got.shape == (B, Q, H, P)
    assert_scaled_close(got.numpy(), jref.ssd_reference(*jin), 1e-5)
    pallas = ssd_scan_pallas(*jin, block_h=bh, interpret=True)
    assert_scaled_close(got.numpy(), pallas, 1e-4)
    # A CPU tensor takes the plain version through ops.
    assert torch.equal(ops.ssd_scan(*tin), got)


def smoke_ssm_cfg(chunk=128):
    """zamba2's smoke widths: d_model 128, d_inner 256, 8 heads of 32,
    state 16."""
    return (jssm.SSMConfig(d_model=128, d_inner=256, head_dim=32,
                           state_dim=16, chunk=chunk),
            tssm.SSMConfig(d_model=128, d_inner=256, head_dim=32,
                           state_dim=16, chunk=chunk))


@pytest.mark.parametrize("S", [256, 64])
def test_ssd_chunked_matches_jax(S):
    """Two chunks of 128 (the carried state enters) and one chunk shorter
    than the configured 128."""
    jcfg, tcfg = smoke_ssm_cfg()
    jin, tin = ssd_case(np.random.default_rng(5), 2, S, 8, 32, 16,
                        "float32")
    jy, jstate = jssm.ssd_chunked(*jin, jcfg)
    ty, tstate = tssm.ssd_chunked(*tin, tcfg)
    assert ty.dtype == tstate.dtype == torch.float32
    assert tstate.shape == (2, 8, 16, 32)
    assert_scaled_close(ty.numpy(), jy, 1e-4)
    assert_scaled_close(tstate.numpy(), jstate, 1e-4)


def test_ssd_chunked_refuses_a_ragged_sequence():
    _, tcfg = smoke_ssm_cfg(chunk=64)
    _, tin = ssd_case(np.random.default_rng(0), 1, 96, 8, 32, 16,
                      "float32")
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm.ssd_chunked(*tin, tcfg)


def block_params(jcfg, tcfg, seed):
    """JAX's ``ssm_defs`` init cast to f32, and the port's ``SSM`` module
    holding the same values."""
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_params(jssm.ssm_defs(jcfg),
                                  jax.random.PRNGKey(seed)))
    # Non-trivial decay and skip weights (the init has zeros and ones).
    rng = np.random.default_rng(seed)
    H = jcfg.n_heads
    jp["a_log"] = jnp.asarray(rng.normal(0, 0.5, H), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.normal(-2, 0.5, H), jnp.float32)
    jp["D"] = jnp.asarray(rng.normal(1, 0.2, H), jnp.float32)
    tp = tssm.SSM(tcfg, "cpu", torch.float32)
    tp.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in jp.items()})
    return jp, tp


def test_ssm_forward_and_decode_match_jax():
    """``ssm_forward(return_state=True)`` over 256 positions (two chunks),
    then three ``ssm_decode`` steps from its states, in f32 at smoke
    widths."""
    jcfg, tcfg = smoke_ssm_cfg()
    jp, tp = block_params(jcfg, tcfg, 3)
    rng = np.random.default_rng(7)
    ju, tu = both(rng.normal(size=(2, 256, 128)), "float32")
    jout, jconv, jstate = jssm.ssm_forward(jp, ju, jcfg, return_state=True)
    tout, tconv, tstate = tssm.ssm_forward(tp, tu, tcfg, return_state=True)
    assert tconv.shape == (2, 3, 256) and tstate.shape == (2, 8, 16, 32)
    for got, want in ((tout, jout), (tconv, jconv), (tstate, jstate)):
        assert_scaled_close(got.numpy(), want, 1e-4)
    for _ in range(3):
        ju1, tu1 = both(rng.normal(size=(2, 1, 128)), "float32")
        jout, jconv, jstate = jssm.ssm_decode(jp, ju1, jconv, jstate, jcfg)
        tout, tconv, tstate = tssm.ssm_decode(tp, tu1, tconv, tstate, tcfg)
        for got, want in ((tout, jout), (tconv, jconv), (tstate, jstate)):
            assert_scaled_close(got.numpy(), want, 1e-4)


def test_short_prompt_conv_state_is_zero_padded():
    """With fewer positions than the conv window needs, the conv state is
    the prompt's pre-conv inputs behind zero rows, so decode continues as
    if the stream had started from zeros."""
    jcfg, tcfg = smoke_ssm_cfg()
    _, tp = block_params(jcfg, tcfg, 4)
    u = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 2, 128)).astype(np.float32))
    _, conv, _ = tssm.ssm_forward(tp, u, tcfg, return_state=True)
    assert conv.shape == (1, 3, 256)
    assert torch.all(conv[:, 0] == 0)
    torch.testing.assert_close(conv[:, 1:], tssm.project(u, tp.w_x),
                               rtol=0, atol=0)
