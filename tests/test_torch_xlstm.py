"""The port's xLSTM family (``xlstm_350m``: mLSTM layers with one sLSTM
layer per ``slstm_every``) against the JAX package, on the CPU at the smoke
widths in f32, the JAX params cast to f32 (they are bf16 whatever
``cfg.dtype`` says) and carried across by ``params_from_numpy``.

Across frameworks: the blocks (``mlstm_parallel`` with its final state,
``slstm_forward`` with its final state), the logits of every position, the
loss and every gradient leaf; the prefill logits and every cache leaf; the
stepwise decode logits.  Inside the port: prefill-then-decode equals
stepwise decode in greedy tokens (the counterpart of
``tests/test_recurrent_prefill.py``).  Tolerance 1e-4: logits and states
as a fraction of the largest entry, gradients of each leaf's largest
entry; the two packages sum in other orders."""

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
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.layers import lm_head as jlm_head  # noqa: E402
from repro.models.layers import rmsnorm as jrmsnorm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.models.layers import norm, project  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "xlstm_350m"
TOL = 1e-4
STATE = ("sc", "sn", "sh", "sm")


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
def jdecode():
    jm = pair()[0]
    return jax.jit(jm.decode)


def tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        1, jget_smoke(ARCH).vocab, (B, S)).astype(np.int32)


def close(got, want, tol=TOL):
    """Within ``tol`` of the largest entry of ``want``."""
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
    assert (cfg.family, cfg.n_layers, cfg.slstm_every) == ("xlstm", 24, 8)
    m = Model(configs.get_smoke(ARCH), device="cpu")
    assert m._xlstm_counts() == (3, 1)
    assert [(list(r), j) for r, j in m._xlstm_segments()] == [([0, 1, 2], 0)]


def test_published_layout_is_seven_mlstm_layers_per_slstm_layer():
    tm = Model(configs.get(ARCH), device="meta")
    assert tm._xlstm_counts() == build_model(jget(ARCH))._xlstm_counts() \
        == (21, 3)
    assert [(r.start, r.stop, j) for r, j in tm._xlstm_segments()] == [
        (0, 7, 0), (7, 14, 1), (14, 21, 2)]


def block_pair(kind, seed):
    """A JAX block's f32 params and the same block as the port reads it."""
    cfg = jxlstm.XLSTMConfig(d_model=64, n_heads=2)
    defs = (jxlstm.mlstm_defs if kind == "mlstm" else jxlstm.slstm_defs)(cfg)
    from repro.models.common import init_params
    p = jax.tree.map(lambda a: a.astype(jnp.float32),
                     init_params(defs, jax.random.PRNGKey(seed)))
    tp = type("P", (), {k: torch.tensor(np.asarray(v))
                        for k, v in p.items()})
    return cfg, p, tp


@pytest.mark.parametrize("S", [8, 256])
def test_mlstm_parallel_and_its_state_match_jax(S):
    cfg, p, tp = block_pair("mlstm", 1)
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(
        np.float32)
    want, wC, wn = jxlstm.mlstm_parallel(p, jnp.asarray(x), cfg,
                                         return_state=True)
    tcfg = txlstm.XLSTMConfig(d_model=64, n_heads=2)
    got, C, n = txlstm.mlstm_parallel(tp, torch.from_numpy(x), tcfg,
                                      return_state=True)
    close(got.detach(), want)
    close(C.detach(), wC)
    close(n.detach(), wn)


def test_mlstm_decode_matches_jax():
    cfg, p, tp = block_pair("mlstm", 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    C = rng.standard_normal((2, 2, 64, 64)).astype(np.float32)
    n = rng.standard_normal((2, 2, 64)).astype(np.float32)
    want = jxlstm.mlstm_decode(p, jnp.asarray(x), jnp.asarray(C),
                               jnp.asarray(n), cfg)
    got = txlstm.mlstm_decode(tp, torch.from_numpy(x), torch.from_numpy(C),
                              torch.from_numpy(n),
                              txlstm.XLSTMConfig(d_model=64, n_heads=2))
    for g, w in zip(got, want):
        close(g, w)


def test_slstm_forward_and_its_state_match_jax():
    cfg, p, tp = block_pair("slstm", 4)
    x = np.random.default_rng(5).standard_normal((2, 24, 64)).astype(
        np.float32)
    want, wstate = jxlstm.slstm_forward(p, jnp.asarray(x), cfg)
    got, state = txlstm.slstm_forward(
        tp, torch.from_numpy(x), txlstm.XLSTMConfig(d_model=64, n_heads=2))
    close(got, want)
    for g, w in zip(state, wstate):
        close(g, w)


def test_an_mlstm_prompt_off_the_chunk_is_refused():
    _, _, tm = pair()
    with pytest.raises(ValueError, match="multiple"):
        tm.prefill(torch.ones((1, 130), dtype=torch.long),
                   tm.init_cache(1, 140))


def test_logits_and_loss_match_jax():
    jm, params, tm = pair()
    tok = tokens(2, 256)
    want = jax.jit(lambda p, b: jlm_head(p["head"], jrmsnorm(
        p["final_ln"], jm._trunk(p, b)[0])))(params,
                                              {"tokens": jnp.asarray(tok)})
    t = torch.from_numpy(tok)
    with torch.no_grad():
        got = project(norm(tm.final_ln.scale, tm(t)), tm.head.w).float()
    close(got, want)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    jl = float(jax.jit(jm.loss)(params, {"tokens": jnp.asarray(tok),
                                         "labels": jnp.asarray(labels)}))
    with torch.no_grad():
        tl = float(tm.loss({"tokens": t, "labels": torch.from_numpy(labels)}))
    assert abs(tl - jl) <= TOL * abs(jl)


@functools.lru_cache(maxsize=None)
def jax_grads():
    jm, params, _ = pair()
    tok = tokens(2, 256, seed=7)
    labels = np.roll(tok, -1, axis=1)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)})
    return tok, labels, float(loss), flat(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(remat):
    """Every leaf within 1e-4 of its largest entry; the sLSTM's ``norm``,
    which the reference never reads, has a zero gradient in both."""
    tok, labels, want_loss, want = jax_grads()
    tm = pair(remat)[2]
    assert tm.cfg.remat == remat
    loss, grads = value_and_grad(
        tm, dict(tm.named_parameters()),
        {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(labels)})
    assert abs(float(loss) - want_loss) <= TOL * abs(want_loss)
    got = flat(params_to_numpy(grads))
    assert got.keys() == want.keys()
    for name in want:
        if not np.abs(want[name]).any():
            assert name == "slstm_layers/slstm/norm", name
            assert not got[name].any()
            continue
        close(got[name], want[name])
    assert not any(p.requires_grad for p in tm.parameters())


@pytest.mark.parametrize("arch", [ARCH, "llama3_2_1b"])
def test_only_the_declared_unread_leaves_get_zero_gradients(arch):
    """``value_and_grad`` fills zeros only for ``Model.unread_leaves``
    (the sLSTM layers' ``norm``); a tensor the loss does not reach
    otherwise raises, for every family."""
    tm = Model(configs.get_smoke(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    want = {"slstm_layers.0.slstm.norm"} if arch == ARCH else set()
    assert tm.unread_leaves == want
    tok = torch.from_numpy(tokens(1, 16, seed=3).astype(np.int64))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    params = dict(tm.named_parameters())
    _, grads = value_and_grad(tm, params, batch)
    assert grads.keys() == params.keys()
    for name in want:
        assert not grads[name].any()
    params["unread.w"] = torch.ones(4)
    with pytest.raises(RuntimeError, match="not have been used"):
        value_and_grad(tm, params, batch)


def cache_close(tcache, jcache):
    assert set(tcache) == set(jcache) == {"C", "n", *STATE}
    for name in jcache:
        want = np.asarray(jcache[name])
        got = tcache[name].numpy()
        for i in range(want.shape[0]):
            close(got[i], want[i])


@pytest.mark.parametrize("S", [8, 256])
def test_prefill_logits_and_every_state_match_jax(S):
    jm, params, tm = pair()
    tok = tokens(2, S, seed=S)
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(tok)},
                                 jm.init_cache(2, S + 4))
    tl, tc = tm.prefill(torch.from_numpy(tok), tm.init_cache(2, S + 4))
    close(tl, jl)
    cache_close(tc, jc)


def test_stepwise_decode_logits_match_jax():
    jm, params, tm = pair()
    tok = tokens(2, 12, seed=9)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    for pos in range(tok.shape[1]):
        jl, jc = jdecode()(params, jc, jnp.asarray(tok[:, pos:pos + 1]),
                           jnp.int32(pos))
        tl, tc = tm.decode(torch.from_numpy(tok[:, pos]), tc, pos)
        close(tl, jl)
    cache_close(tc, jc)


@pytest.mark.parametrize("S", [8, 128])
def test_prefill_then_decode_matches_stepwise(S):
    """Greedy tokens equal, logits within 1e-4 of the largest."""
    tm = pair()[2]
    tok = torch.from_numpy(tokens(1, S, seed=11))
    n_new = 4
    logits, cache = tm.prefill(tok, tm.init_cache(1, S + n_new))
    a, la = [], [logits]
    for pos in range(S, S + n_new):
        nxt = logits.argmax(-1)
        a.append(int(nxt))
        logits, cache = tm.decode(nxt, cache, pos)
        la.append(logits)
    cache = tm.init_cache(1, S + n_new)
    for pos in range(S):
        logits, cache = tm.decode(tok[:, pos], cache, pos)
    b, lb = [], [logits]
    for pos in range(S, S + n_new):
        nxt = logits.argmax(-1)
        b.append(int(nxt))
        logits, cache = tm.decode(nxt, cache, pos)
        lb.append(logits)
    assert a == b
    for x, y in zip(la, lb):
        close(x, y)


def test_weights_round_trip_with_their_f32_leaves():
    jm = build_model(jget_smoke(ARCH))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    state = params_from_numpy(params, device="cpu")
    tm = Model(configs.get_smoke(ARCH), device="cpu")
    tm.load_state_dict(state)
    assert tm.mlstm_layers[0].mlstm.w_i.dtype == torch.float32
    assert tm.slstm_layers[0].slstm.r_z.dtype == torch.float32
    assert tm.mlstm_layers[0].mlstm.w_q.dtype == torch.bfloat16
    back = flat(params_to_numpy(tm.state_dict()))
    want = flat(params)
    assert back.keys() == want.keys()
    for name in want:
        assert back[name].dtype.itemsize == want[name].dtype.itemsize, name
        assert back[name].tobytes() == want[name].tobytes(), name


def test_init_follows_the_reference_statistics():
    tm = Model(configs.get_smoke(ARCH), device="cpu").init(
        torch.Generator().manual_seed(0))
    m, s = tm.mlstm_layers[0].mlstm, tm.slstm_layers[0].slstm
    assert bool((m.b_f == 1).all()) and not m.b_i.any()
    assert all(not getattr(s, f"b_{g}").any() for g in "ifzo")
    assert bool((m.norm == 1).all()) and bool((s.norm == 1).all())
    assert abs(float(s.r_i.std()) - 0.3) < 0.03
    assert abs(float(m.w_q.float().std()) - 128 ** -0.5) < 0.01


def test_the_launchers_train_it_and_refuse_to_page_it(capsys):
    """The train launcher takes the xLSTM arch through the ``Trainer``,
    guided; the serving launcher refuses it, as the JAX one does."""
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "32",
                       "--gdt-budget-mb", "1", "--gdt-interval", "1"])
    out = capsys.readouterr().out
    assert '"transfer_bytes"' in out and '"final_loss"' in out
    with pytest.raises(SystemExit, match="decoder LMs"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
