"""The port's encoder-decoder family (``seamless_m4t_medium``: an audio
adapter over stub frame embeddings, an encoder, and decoder layers with
causal self-attention and cross attention over the encoder's output)
against the JAX package, on the CPU at the smoke widths in f32, the JAX
params cast to f32 and carried across by ``params_from_numpy``.

Across frameworks: the encoder's output (``_encode``), the logits of every
position, the loss and every gradient leaf; the prefill logits, the
self-attention K/V and the encoder memory ``xk``/``xv``; the port's
prefill-then-decode against JAX's ``decode`` run on JAX's prefill cache
(whose K/V have the prompt's length: zero-padded here to the cache's).
The frames are longer than the prompt, so every cross attention has
Sq != Sk.  The reference's encoder is causal (its ``_mask`` never reads
``AttnConfig.causal``); the port follows it, and a test pins that.
Tolerance 1e-4 of the largest entry.  Gradients: f32 round-off alone
moves a leaf by up to about 1.3e-3 of its largest entry here, in each
package against its own float64 gradient, so the f32 comparison holds
``F32_TOL``; in float64 the packages agree within 1e-8."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.layers import lm_head as jlm_head  # noqa: E402
from repro.models.layers import rmsnorm as jrmsnorm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.layers import norm, project  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "seamless_m4t_medium"
TOL = 1e-4
# Gradients in f32, as a fraction of each leaf's largest entry: the port's
# own f32 gradient sits up to about 1.3e-3 from its float64 gradient at the
# smoke widths (test_f32_round_off_of_the_gradient), JAX's likewise; in
# float64 the packages agree to 1e-8.
F32_TOL = 4e-3
SE, S = 24, 16                      # frames, prompt tokens


@functools.lru_cache(maxsize=None)
def pair(remat=False):
    """(JAX model, its f32 params, the port's f32 model with those
    weights)."""
    cfg = dataclasses.replace(jget_smoke(ARCH), remat=remat,
                              dtype=jnp.float32)
    jm = build_model(cfg)
    params = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jm.init(jax.random.PRNGKey(0)))
    tm = Model(config_from_reference(cfg), device="cpu")
    tm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params),
                                         device="cpu"))
    return jm, params, tm


def batch(B=2, Se=SE, T=S, seed=0):
    cfg = jget_smoke(ARCH)
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab, (B, T)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    frames = rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32)
    return {"tokens": tok, "labels": labels, "frames": frames}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def jencode(jm, params, frames):
    B, Se, _ = frames.shape
    pos = jnp.broadcast_to(jnp.arange(Se, dtype=jnp.int32), (B, Se))
    return jax.jit(jm._encode)(params, jnp.asarray(frames), pos)


def test_config_matches_the_reference():
    assert config_from_reference(jget(ARCH)) == configs.get(ARCH)
    assert config_from_reference(jget_smoke(ARCH)) == configs.get_smoke(ARCH)
    cfg = configs.get(ARCH)
    assert (cfg.family, cfg.enc_layers, cfg.n_layers,
            cfg.resolved_head_dim) == ("encdec", 12, 12, 64)
    with pytest.raises(ValueError, match="enc_layers"):
        Model(dataclasses.replace(cfg, enc_layers=0), device="meta")


def test_encoder_output_matches_jax():
    jm, params, tm = pair()
    frames = batch()["frames"]
    want = jencode(jm, params, frames)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames))
    close(got, want)


def test_the_encoder_is_causal_as_the_reference_is():
    """Changing the last frame changes no earlier position of the encoder's
    output, in the JAX package (``_mask`` ignores ``causal=False``) and in
    the port, which follows it."""
    jm, params, tm = pair()
    frames = batch()["frames"]
    moved = frames.copy()
    moved[:, -1] += 1.0
    for enc in (lambda f: np.asarray(jencode(jm, params, f)),
                lambda f: tm.encode(torch.from_numpy(f)).detach().numpy()):
        a, b = enc(frames), enc(moved)
        np.testing.assert_array_equal(a[:, :-1], b[:, :-1])
        assert np.abs(a[:, -1] - b[:, -1]).max() > 1e-3


def test_logits_and_loss_match_jax():
    jm, params, tm = pair()
    b = batch(seed=1)
    want = jax.jit(lambda p, x: jlm_head(p["head"], jrmsnorm(
        p["final_ln"], jm._trunk(p, x)[0])))(params, to_jax(b))
    tb = to_torch(b)
    with torch.no_grad():
        h = tm(tb["tokens"], frames=tb["frames"])
        got = project(norm(tm.final_ln.scale, h), tm.head.w).float()
    close(got, want)
    jl = float(jax.jit(jm.loss)(params, to_jax(b)))
    with torch.no_grad():
        tl = float(tm.loss(tb))
    assert abs(tl - jl) <= TOL * abs(jl)


@functools.lru_cache(maxsize=None)
def jax_grads():
    jm, params, _ = pair()
    b = batch(seed=2)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, to_jax(b))
    return b, float(loss), flat(jax.tree.map(np.asarray, grads))


def grad_errors(got, want):
    """Each leaf's largest distance from the JAX leaf, over the JAX leaf's
    largest entry."""
    got = flat(params_to_numpy(got))
    assert got.keys() == want.keys()
    return {n: float(np.abs(got[n].astype(np.float64) - want[n]).max()
                     / np.abs(want[n]).max()) for n in want}


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax_in_f32(remat):
    """The loss within 1e-4, every leaf (the adapter's and the encoder's
    included) within F32_TOL of its largest entry: f32 round-off alone
    moves a leaf by more than 1e-4 here (the next two tests)."""
    b, want_loss, want = jax_grads()
    tm = pair(remat)[2]
    loss, grads = value_and_grad(tm, dict(tm.named_parameters()),
                                 to_torch(b))
    assert abs(float(loss) - want_loss) <= TOL * abs(want_loss)
    errors = grad_errors(grads, want)
    assert {"audio_adapter/w", "enc_layers/attn/wq",
            "dec_layers/xattn/wk"} <= set(errors)
    assert max(errors.values()) <= F32_TOL, errors


def widen_islands(monkeypatch):
    """Both packages' f32 islands (their module constants ``F32``) become
    float64: the float64 comparison's only change to either package."""
    for mod in (jlayers, jtransformer, tlayers, tref):
        monkeypatch.setattr(mod, "F32",
                            jnp.float64 if mod in (jlayers, jtransformer)
                            else torch.float64)


def model64(tm):
    m = Model(dataclasses.replace(tm.cfg, dtype=torch.float64),
              device="cpu")
    m.load_state_dict({k: v.double() for k, v in tm.state_dict().items()})
    return m


def batch64(b):
    return {k: torch.from_numpy(v.astype(np.float64) if v.dtype ==
                                np.float32 else v) for k, v in b.items()}


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax_in_float64(monkeypatch, remat):
    """Both packages in float64: the loss and every gradient leaf within
    1e-8 (the algorithms agree; what f32 shows is round-off)."""
    widen_islands(monkeypatch)
    b = batch(seed=4)
    with jax.enable_x64(True):
        cfg = dataclasses.replace(jget_smoke(ARCH), remat=remat,
                                  dtype=jnp.float64)
        jm = build_model(cfg)
        jp = jax.tree.map(lambda a: a.astype(jnp.float64),
                          jm.init(jax.random.PRNGKey(1)))
        jb = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                             else v) for k, v in b.items()}
        want_loss, want = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
        want_loss = float(want_loss)
        want = flat(jax.tree.map(np.asarray, want))
        jp = jax.tree.map(np.asarray, jp)
    tm = Model(dataclasses.replace(
        config_from_reference(dataclasses.replace(cfg, dtype=jnp.float32)),
        dtype=torch.float64), device="cpu")
    tm.load_state_dict(params_from_numpy(jp, device="cpu"))
    assert tm.embed.tok.dtype == torch.float64
    loss, grads = value_and_grad(tm, dict(tm.named_parameters()), batch64(b))
    assert loss.dtype == torch.float64
    assert abs(float(loss) - want_loss) <= 1e-8 * abs(want_loss)
    errors = grad_errors(grads, want)
    assert max(errors.values()) <= 1e-8, errors


def test_f32_round_off_of_the_gradient(monkeypatch):
    """Why F32_TOL: the port's own f32 gradient against its float64
    gradient on the same weights and batch, every leaf within F32_TOL / 2
    of its largest entry, and the largest distance above 1e-4 (so 1e-4
    would fail on round-off alone)."""
    b, _, _ = jax_grads()
    tm = pair()[2]
    _, grads = value_and_grad(tm, dict(tm.named_parameters()), to_torch(b))
    widen_islands(monkeypatch)
    m = model64(tm)
    _, want = value_and_grad(m, dict(m.named_parameters()), batch64(b))
    errors = grad_errors(grads, flat(params_to_numpy(want)))
    assert 1e-4 < max(errors.values()) <= F32_TOL / 2, errors


def test_a_batch_without_frames_is_refused():
    tm = pair()[2]
    b = to_torch(batch())
    with pytest.raises(ValueError, match="needs frames"):
        tm.loss({"tokens": b["tokens"], "labels": b["labels"]})
    with pytest.raises(ValueError, match="needs frames"):
        tm.prefill(b["tokens"], tm.init_cache(2, S))


@functools.lru_cache(maxsize=None)
def jax_prefill():
    jm, params, _ = pair()
    b = batch(seed=3)
    logits, cache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(b["tokens"]),
                 "frames": jnp.asarray(b["frames"])},
        jm.init_cache(2, S + 4))
    return b, logits, cache


def test_prefill_logits_kv_and_encoder_memory_match_jax():
    b, jl, jc = jax_prefill()
    tm = pair()[2]
    tb = to_torch(b)
    tl, tc = tm.prefill(tb["tokens"], tm.init_cache(2, S + 4),
                        frames=tb["frames"])
    close(tl, jl)
    assert tc["kv"]["k"].shape[2] == S + 4
    assert np.asarray(jc["kv"]["k"]).shape[2] == S
    for n in ("k", "v"):
        got, want = tc["kv"][n].numpy(), np.asarray(jc["kv"][n])
        for i in range(want.shape[0]):
            close(got[i, :, :S], want[i])
        assert not got[:, :, S:].any()
    for n in ("xk", "xv"):
        got, want = tc[n].numpy(), np.asarray(jc[n])
        assert got.shape[2] == SE
        for i in range(want.shape[0]):
            close(got[i], want[i])


def test_prefill_then_decode_matches_jax_decode_on_its_prefill_cache():
    """JAX's decode continues from its own prefill cache, K/V zero-padded
    to the cache length; the port's from its own.  Greedy tokens equal,
    every step's logits within 1e-4."""
    jm, params, tm = pair()
    b, jl, jc = jax_prefill()
    n_new = 4
    pad = ((0, 0), (0, 0), (0, n_new), (0, 0), (0, 0))
    jc = {**jc, "kv": {n: jnp.pad(jc["kv"][n], pad) for n in ("k", "v")}}
    tb = to_torch(b)
    tl, tc = tm.prefill(tb["tokens"], tm.init_cache(2, S + n_new),
                        frames=tb["frames"])
    jdecode = jax.jit(jm.decode)
    for pos in range(S, S + n_new):
        nxt = np.asarray(jnp.argmax(jl, -1))
        assert tl.argmax(-1).tolist() == nxt.tolist()
        jl, jc = jdecode(params, jc, jnp.asarray(nxt[:, None]),
                         jnp.int32(pos))
        tl, tc = tm.decode(torch.tensor(nxt), tc, pos)
        close(tl, jl)


def test_weights_round_trip():
    jm = build_model(jget_smoke(ARCH))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    tm = Model(configs.get_smoke(ARCH), device="cpu")
    tm.load_state_dict(params_from_numpy(params, device="cpu"))
    assert len(tm.enc_layers) == 2 and len(tm.dec_layers) == 2
    back = flat(params_to_numpy(tm.state_dict()))
    want = flat(params)
    assert back.keys() == want.keys()
    for name in want:
        assert back[name].tobytes() == want[name].tobytes(), name


def test_the_launchers_refuse_it():
    """The train launcher names the batch's missing ``frames`` (its
    ``SyntheticLM`` makes tokens only); the serving launcher refuses the
    family, as the JAX one does."""
    with pytest.raises(SystemExit, match="frames"):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "1"])
    with pytest.raises(SystemExit, match="decoder LMs"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
