"""The port's plain paged attention (what a CPU tensor takes through
``repro_torch.kernels.ops``) against the JAX package's oracle and its
Pallas kernel in interpret mode, on the sweep of ``test_kernels.py``.
Inputs are made with numpy from a seed and handed to both sides.

Tolerances are those of ``test_kernels.py``: 2e-5 in f32, 2e-2 in bf16
(the two frameworks sum in different orders; bf16 rounds the output)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_pallas,
    paged_prefill_pallas,
)
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SWEEP = [
    (2, 8, 8, 64, 8, 8, 3, None),     # MHA
    (3, 8, 4, 64, 16, 8, 4, None),    # GQA
    (2, 4, 4, 128, 8, 16, 2, None),   # bigger pages
    (2, 8, 4, 64, 16, 8, 4, 7),       # sliding window
    (1, 8, 2, 96, 8, 8, 4, None),     # unaligned dh
]


def both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor."""
    return (jnp.asarray(a, JAX_DT[dtype]),
            torch.from_numpy(a).to(TORCH_DT[dtype]))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def decode_case(rng, B, H, K, dh, N, P, MP):
    q = rng.normal(size=(B, H, dh)).astype(np.float32)
    kp = rng.normal(size=(N, P, K, dh)).astype(np.float32)
    vp = rng.normal(size=(N, P, K, dh)).astype(np.float32)
    table = np.full((B, MP), -1, np.int32)
    lengths = np.zeros((B,), np.int32)
    slots = rng.permutation(N)
    si = 0
    for b in range(B):
        n_pages = int(rng.integers(1, MP + 1))
        lengths[b] = int(rng.integers((n_pages - 1) * P + 1, n_pages * P + 1))
        for pg in range(n_pages):
            table[b, pg] = slots[si]
            si += 1
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,dh,N,P,MP,window", SWEEP)
def test_paged_attention_matches_reference(B, H, K, dh, N, P, MP, window,
                                           dtype):
    q, kp, vp, table, lengths = decode_case(np.random.default_rng(0), B, H,
                                            K, dh, N, P, MP)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, kp, vp))
    got = ops.paged_attention(tq, tk, tv, torch.from_numpy(table),
                              torch.from_numpy(lengths), window=window)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, H, dh)
    want = jref.paged_attention_reference(jq, jk, jv, jnp.asarray(table),
                                          jnp.asarray(lengths), window=window)
    pallas = paged_attention_pallas(jq, jk, jv, jnp.asarray(table),
                                    jnp.asarray(lengths), window=window,
                                    interpret=True)
    for other in (want, pallas):
        np.testing.assert_allclose(as_np(got), as_np(other),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def prefill_case(rng, S, pad, N, P, K, dh, MP):
    q = rng.normal(size=(S + pad, 4 * K, dh)).astype(np.float32)
    q[S:] = 0.0
    kp = rng.normal(size=(N, P, K, dh)).astype(np.float32)
    vp = rng.normal(size=(N, P, K, dh)).astype(np.float32)
    table = np.full((MP,), -1, np.int32)
    slots = rng.permutation(N)
    for pg in range(-(-S // P)):
        table[pg] = slots[pg]
    lengths = np.concatenate([np.arange(1, S + 1),
                              np.zeros(pad)]).astype(np.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_paged_prefill_matches_reference(window, dtype):
    """S prompt rows with causal lengths 1..S plus padded zero-length rows,
    which must come out as zeros, never NaN."""
    S, pad = 11, 5
    q, kp, vp, table, lengths = prefill_case(np.random.default_rng(3), S,
                                             pad, 8, 4, 2, 64, 4)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, kp, vp))
    got = ops.paged_prefill(tq, tk, tv, torch.from_numpy(table),
                            torch.from_numpy(lengths), window=window)
    want = jref.paged_prefill_reference(jq, jk, jv, jnp.asarray(table),
                                        jnp.asarray(lengths), window=window)
    pallas = paged_prefill_pallas(jq, jk, jv, jnp.asarray(table),
                                  jnp.asarray(lengths), window=window,
                                  interpret=True)
    for other in (want, pallas):
        np.testing.assert_allclose(as_np(got)[:S], as_np(other)[:S],
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert np.all(as_np(got)[S:] == 0.0), "padded rows must be zeros"


@pytest.mark.parametrize("window", [None, 3, 9])
def test_window_masks_leading_pages_entirely(window):
    """Windows that leave the first pages wholly outside: the rows still
    match the reference (on the TPU such a page's exp(0) terms are wiped
    by a later rescale; here they must not leak in either)."""
    rng = np.random.default_rng(11)
    B, H, K, dh, N, P, MP = 3, 8, 2, 32, 12, 4, 4
    q, kp, vp, table, _ = decode_case(rng, B, H, K, dh, N, P, MP)
    for b in range(B):
        table[b] = rng.permutation(N)[:MP]
    lengths = np.array([16, 13, 10], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, "float32") for a in (q, kp, vp))
    got = ops.paged_attention(tq, tk, tv, torch.from_numpy(table),
                              torch.from_numpy(lengths), window=window)
    want = jref.paged_attention_reference(jq, jk, jv, jnp.asarray(table),
                                          jnp.asarray(lengths), window=window)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_prefill_row_bitwise_equals_decode(window, dtype):
    """Row t of a prefill equals a decode call for the same query, table
    and length, bit for bit — the property one-shot == chunked rests on."""
    S, pad = 11, 5
    q, kp, vp, table, lengths = prefill_case(np.random.default_rng(5), S,
                                             pad, 8, 4, 2, 64, 4)
    tq, tk, tv = (both(a, dtype)[1] for a in (q, kp, vp))
    pre = ops.paged_prefill(tq, tk, tv, torch.from_numpy(table),
                            torch.from_numpy(lengths), window=window)
    B = 4
    for t in range(S + pad):
        qq = torch.zeros((B,) + tuple(tq.shape[1:]), dtype=tq.dtype)
        qq[1] = tq[t]
        tb = torch.full((B, table.shape[0]), -1, dtype=torch.int32)
        tb[1] = torch.from_numpy(table)
        ll = torch.zeros((B,), dtype=torch.int32)
        ll[1] = int(lengths[t])
        dec = ops.paged_attention(qq, tk, tv, tb, ll, window=window)
        assert torch.equal(dec[1], pre[t]), f"row {t}"


def test_plain_versions_are_the_ops_on_cpu():
    """A CPU tensor takes the plain version: same result as calling it."""
    q, kp, vp, table, lengths = decode_case(np.random.default_rng(1), 2, 8,
                                            4, 64, 16, 8, 4)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    assert torch.equal(ops.paged_attention(*args),
                       ref.paged_attention_reference(*args))


# ------------------------------------------------ the kernel's launch plan
# ``plan`` is plain Python (it runs here, where the CUDA kernel cannot):
# the route, tile, key block, split and shared memory of every call.
from repro_torch.configs import ARCHS, get  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

PLAN_DTYPES = [torch.bfloat16, torch.float32]


def port_heads():
    """(H, K, dh) of each config the port carries that has attention
    (zamba2's shared attention, the encoder-decoder's and the VLM's
    included, as if they were ever paged; the xLSTM family's heads are
    its mLSTM's and sLSTM's, not attention heads)."""
    return [(c.n_heads, c.kv_heads, c.resolved_head_dim)
            for c in (get(a) for a in ARCHS) if c.family != "xlstm"]


@pytest.mark.parametrize("dtype", PLAN_DTYPES)
@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("H,K,dh", [(32, 8, 64), (24, 8, 64), (32, 32, 112),
                                    (8, 2, 128), (4, 4, 16)])
def test_plan_does_not_depend_on_rows_or_mp(H, K, dh, prefill, dtype):
    """The tile, the key block and the shared memory come from the heads,
    the head dim, the page size and the dtype: the launch's argument block
    carries the same plan whatever the number of rows (B or S) or MP, so a
    row's arithmetic is the same whatever the call."""
    p = pa.plan(H, K, dh, 16, dtype, prefill)
    for rows in (1, 3, 16, 21, 64, 150, 512, 2049):
        for MP in (1, 7, 32, 64, 128):
            a = pa._args(rows, H, K, dh, 16, MP, 0 if prefill else MP, 0,
                         dtype, prefill)
            assert (a.rows, a.MP) == (rows, MP)
            assert (a.tokens_per_cta, a.warps, a.smem_bytes) == (
                p.tokens_per_cta, p.warps, p.smem_bytes)
    assert p.route == ("mma" if dtype == torch.bfloat16 else "simt")
    if not prefill:
        assert p.tokens_per_cta == 1         # decode rows own their tables
    if dtype == torch.bfloat16:
        assert p.block_keys == 64
        assert p.tokens_per_cta * (H // K) <= p.warps * 16


@pytest.mark.parametrize("dtype", PLAN_DTYPES)
@pytest.mark.parametrize("P", [4, 8, 16, 32, 64])
def test_plan_smem_fits_every_port_config(P, dtype):
    for H, K, dh in port_heads():
        for prefill in (False, True):
            p = pa.plan(H, K, dh, P, dtype, prefill)
            assert 0 < p.smem_bytes <= pa.SMEM_LIMIT == 227 * 1024


def test_plan_raises_on_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        pa.plan(256, 1, 128, 64, torch.float32, False)
    with pytest.raises(ValueError, match="query heads per KV head"):
        pa.plan(256, 1, 64, 16, torch.bfloat16, True)
    with pytest.raises(ValueError, match="head_dim up to"):
        pa.plan(8, 8, 256, 16, torch.bfloat16, False)
    with pytest.raises(ValueError, match="multiple of 16"):
        pa.plan(8, 8, 72, 16, torch.bfloat16, False)
    with pytest.raises(ValueError, match="divides 64"):
        pa.plan(8, 8, 64, 24, torch.bfloat16, False)
    with pytest.raises(ValueError, match="do not group"):
        pa.plan(6, 4, 64, 16, torch.float32, False)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.plan(8, 8, 64, 16, torch.float16, False)
