"""The port's VLM family (``phi3_vision_4_2b``: the dense decoder with a
vision adapter over stub patch embeddings, which stand before the token
embeddings and carry no loss) against the JAX package, on the CPU at the
smoke widths in f32, the JAX params cast to f32 and carried across by
``params_from_numpy``.

Across frameworks: the logits of every position (patches and tokens), the
loss and every gradient leaf (``_trunk``, ``loss``); the tokens-only
prefill against JAX's ``prefill`` (which reads only the tokens); the
prefill with patches against JAX's own VLM forward, ``_trunk`` ->
``final_ln`` -> ``lm_head`` at the last position (the port's prefill takes
the patches that JAX's drops: ROADMAP.md "Settled"); decode after it
against ``_trunk`` on the sequence one token longer.  Tolerance 1e-4 of
the largest entry.  Gradients: f32 round-off alone moves a leaf by up to
about 2.4e-4 of its largest entry here, so the f32 comparison holds
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

ARCH = "phi3_vision_4_2b"
TOL = 1e-4
# Gradients in f32, as a fraction of each leaf's largest entry: the port's
# own f32 gradient sits up to about 2.4e-4 from its float64 gradient at the
# smoke widths (test_f32_round_off_of_the_gradient); in float64 the
# packages agree to 1e-8.
F32_TOL = 1e-3
T = 24                              # tokens after the smoke config's 16 patches


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


@functools.lru_cache(maxsize=None)
def jlogits():
    """JAX's VLM forward: ``_trunk`` -> ``final_ln`` -> ``lm_head`` for
    every position, jitted once."""
    jm, params, _ = pair()
    return jax.jit(lambda b: jlm_head(params["head"], jrmsnorm(
        params["final_ln"], jm._trunk(params, b)[0])))


def batch(B=2, n_tok=T, seed=0):
    cfg = jget_smoke(ARCH)
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab, (B, n_tok)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    patches = rng.standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return {"tokens": tok, "labels": labels, "patches": patches}


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


def test_config_matches_the_reference():
    assert config_from_reference(jget(ARCH)) == configs.get(ARCH)
    assert config_from_reference(jget_smoke(ARCH)) == configs.get_smoke(ARCH)
    cfg = configs.get(ARCH)
    assert (cfg.family, cfg.resolved_head_dim, cfg.frontend_tokens) == \
        ("vlm", 96, 576)


def test_logits_of_every_position_and_the_loss_match_jax():
    jm, params, tm = pair()
    b = batch(seed=1)
    want = jlogits()({k: jnp.asarray(b[k]) for k in ("tokens", "patches")})
    tb = to_torch(b)
    with torch.no_grad():
        h = tm(tb["tokens"], patches=tb["patches"])
        got = project(norm(tm.final_ln.scale, h), tm.head.w).float()
    assert got.shape[1] == b["patches"].shape[1] + T
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
    """The loss within 1e-4, every leaf (the vision adapter's included)
    within F32_TOL of its largest entry: f32 round-off alone moves a leaf
    by more than 1e-4 here (the next two tests)."""
    b, want_loss, want = jax_grads()
    tm = pair(remat)[2]
    loss, grads = value_and_grad(tm, dict(tm.named_parameters()),
                                 to_torch(b))
    assert abs(float(loss) - want_loss) <= TOL * abs(want_loss)
    errors = grad_errors(grads, want)
    assert "vision_adapter/w" in errors
    assert max(errors.values()) <= F32_TOL, errors


def widen_islands(monkeypatch):
    """Both packages' f32 islands (their module constants ``F32``) become
    float64: the float64 comparison's only change to either package."""
    for mod in (jlayers, jtransformer):
        monkeypatch.setattr(mod, "F32", jnp.float64)
    for mod in (tlayers, tref):
        monkeypatch.setattr(mod, "F32", torch.float64)


def batch64(b):
    return {k: torch.from_numpy(v.astype(np.float64) if v.dtype ==
                                np.float32 else v) for k, v in b.items()}


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax_in_float64(monkeypatch, remat):
    """Both packages in float64: the loss and every gradient leaf within
    1e-8 (the algorithms agree; what f32 shows is round-off)."""
    widen_islands(monkeypatch)
    b = batch(seed=6)
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
    m = Model(dataclasses.replace(tm.cfg, dtype=torch.float64), device="cpu")
    m.load_state_dict({k: v.double() for k, v in tm.state_dict().items()})
    _, want = value_and_grad(m, dict(m.named_parameters()), batch64(b))
    errors = grad_errors(grads, flat(params_to_numpy(want)))
    assert 1e-4 < max(errors.values()) <= F32_TOL / 2, errors


def test_the_patch_positions_carry_no_loss():
    """Changing the labels has no say at the patch positions: the loss is
    the mean over the token labels alone."""
    tm = pair()[2]
    tb = to_torch(batch(seed=3))
    with torch.no_grad():
        h = norm(tm.final_ln.scale, tm(tb["tokens"], patches=tb["patches"]))
        logits = project(h, tm.head.w).float()[:, -T:]
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tb["labels"].reshape(-1).long(),
            ignore_index=-1)
        got = tm.loss(tb)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))


def test_forward_without_patches_is_refused():
    tm = pair()[2]
    tb = to_torch(batch())
    with pytest.raises(ValueError, match="needs patches"):
        tm.loss({"tokens": tb["tokens"], "labels": tb["labels"]})


def test_tokens_only_prefill_matches_jax_prefill():
    jm, params, tm = pair()
    b = batch(seed=4)
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(b["tokens"])},
                                 jm.init_cache(2, T))
    tl, tc = tm.prefill(torch.from_numpy(b["tokens"]), tm.init_cache(2, T))
    close(tl, jl)
    for n in ("k", "v"):
        want = np.asarray(jc["kv"][n])
        for i in range(want.shape[0]):
            close(tc["kv"][n][i], want[i])


def test_prefill_with_patches_then_decode_match_the_jax_forward():
    """Prefill of P patches + T tokens: the cache holds P + T positions and
    the logits equal JAX's forward at the last position; each greedy decode
    step equals JAX's forward of the sequence one token longer there."""
    _, _, tm = pair()
    b = batch(B=1, seed=5)
    P = b["patches"].shape[1]
    n_new = 3
    tb = to_torch(b)
    cache = tm.init_cache(1, P + T + n_new)
    tl, cache = tm.prefill(tb["tokens"], cache, patches=tb["patches"])
    assert cache["kv"]["k"][:, :, P + T:].abs().max() == 0
    assert cache["kv"]["k"][:, :, P + T - 1].abs().max() > 0
    seq = b["tokens"]
    for pos in range(P + T, P + T + n_new):
        want = jlogits()({"tokens": jnp.asarray(seq),
                          "patches": jnp.asarray(b["patches"])})[:, -1]
        close(tl, want)
        nxt = tl.argmax(-1)
        assert int(nxt) == int(jnp.argmax(want, -1)[0])
        seq = np.concatenate([seq, nxt.numpy()[:, None].astype(np.int32)],
                             axis=1)
        tl, cache = tm.decode(nxt, cache, pos)
    want = jlogits()({"tokens": jnp.asarray(seq),
                      "patches": jnp.asarray(b["patches"])})[:, -1]
    close(tl, want)


def test_weights_round_trip():
    jm = build_model(jget_smoke(ARCH))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    tm = Model(configs.get_smoke(ARCH), device="cpu")
    tm.load_state_dict(params_from_numpy(params, device="cpu"))
    back = flat(params_to_numpy(tm.state_dict()))
    want = flat(params)
    assert back.keys() == want.keys() and "vision_adapter/w" in want
    for name in want:
        assert back[name].tobytes() == want[name].tobytes(), name


def test_the_launchers_refuse_it():
    """The train launcher names the batch's missing ``patches`` (its
    ``SyntheticLM`` makes tokens only); the serving launcher refuses the
    family, as the JAX one does."""
    with pytest.raises(SystemExit, match="patches"):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "1"])
    with pytest.raises(SystemExit, match="decoder LMs"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
