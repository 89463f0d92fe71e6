"""The port's training slice against the JAX package at its smoke widths
(2 layers, d_model 128), on the CPU: layers, loss and gradients, AdamW,
the int8 round trip, the data stream, the Trainer's trajectory, guided
tiering, the placer's contract, checkpoints across the two packages, and
the launcher's failure drill.

f32 unless a test says otherwise; the JAX package declares its weights in
bf16 whatever ``cfg.dtype`` says, so f32 comparisons cast its params to
f32 and carry them across with ``params_from_numpy``.  Tolerances: layers
1e-5 (other summation orders); the loss rtol 1e-4, and each gradient leaf
within 1e-4 of the JAX leaf in norm (at these random weights both f32
gradients sit up to 9e-5 from a float64 evaluation of the same model, in
norm: rmsnorm's backward cancels large terms, so entries near zero carry
round-off of the leaf's scale); AdamW and the schedule within 1 ulp
and the schedule's cosine within 2 (XLA's f32 cos is not correctly
rounded); a 5-step trajectory rtol 1e-3."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import GuidanceConfig as JGuidanceConfig  # noqa: E402
from repro.core import TPU_V5E as JTPU_V5E  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.dist import compress as jcompress  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    jax_order,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.core import (  # noqa: E402
    CLX,
    TPU_V5E,
    ArenaBackend,
    ArenaManager,
    GuidanceConfig,
    GuidanceRuntime,
    SiteKind,
    SiteRegistry,
)
from repro_torch.core.placement import TorchArenaPlacer  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.dist import compress  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.train import (  # noqa: E402
    StepConfig,
    Trainer,
    TrainerConfig,
    value_and_grad,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32


# ------------------------------------------------------------------ helpers
def jax_model(remat=False):
    return build_model(dataclasses.replace(jget_smoke("llama3_2_1b"),
                                           remat=remat))


def jax_params(jm, seed=0, dtype=jnp.float32):
    return jax.tree.map(lambda a: a.astype(dtype),
                        jm.init(jax.random.PRNGKey(seed)))


def port_model(jm, jp, dtype=F32):
    """The port's model of ``jm``'s config in ``dtype``, holding ``jp``."""
    cfg = dataclasses.replace(config_from_reference(jm.cfg), dtype=dtype)
    m = Model(cfg, device="cpu")
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jp),
                                        "cpu"))
    return m


def batches(vocab, n, batch=2, seq=32, seed=3):
    src = SyntheticLM(vocab, seq, batch, seed=seed)
    return [src.batch_np(i) for i in range(n)]


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def bits(a):
    """Raw bits of a numpy leaf (bf16 as ml_dtypes or as |V2 alike)."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def assert_leaves_close(port_state, jax_tree, rtol):
    """Each leaf within ``rtol`` of the JAX leaf, in norm."""
    got = flat(params_to_numpy(port_state))
    want = flat(jax_tree)
    assert got.keys() == want.keys()
    for name in want:
        a = got[name].astype(np.float64)
        w = np.asarray(want[name], np.float64)
        assert a.shape == w.shape, name
        assert np.linalg.norm(a - w) <= rtol * np.linalg.norm(w), name


# ------------------------------------------------------------------- layers
def test_training_layers_match_jax():
    rng = np.random.default_rng(0)
    B, S, d, H, K, dh, f, V = 2, 12, 32, 4, 2, 8, 48, 40
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    np.testing.assert_allclose(
        tl.norm(torch.from_numpy(scale), torch.from_numpy(x)).numpy(),
        np.asarray(jl.rmsnorm({"scale": scale}, x)), atol=1e-5, rtol=1e-5)

    p = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, H, dh)), ("wk", (d, K, dh)),
                      ("wv", (d, K, dh)), ("wo", (H, dh, d)))}
    acfg = jl.AttnConfig(d_model=d, n_heads=H, kv_heads=K, head_dim=dh,
                         rope_theta=500000.0, window=5)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jl.attention(p, x, acfg, jnp.asarray(pos))
    got = tl.attention({n: torch.from_numpy(w) for n, w in p.items()},
                       torch.from_numpy(x), torch.arange(S),
                       tl.rope_freqs(dh, 500000.0, "cpu"), window=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)

    m = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                      ("w_down", (f, d)))}
    np.testing.assert_allclose(
        tl.swiglu({n: torch.from_numpy(w) for n, w in m.items()},
                  torch.from_numpy(x)).numpy(),
        np.asarray(jl.mlp(m, x)), atol=1e-5, rtol=1e-5)

    head = (rng.normal(size=(d, V)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -1                                   # ignored positions
    for chunk in (4, 5, 512):                            # 3, 1 and 1 chunks
        got = tl.chunked_lm_loss(torch.from_numpy(head), torch.from_numpy(x),
                                 torch.from_numpy(labels), chunk=chunk)
        want = jl.chunked_lm_loss({"w": head}, x, labels, chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    logits = rng.normal(size=(B, S, V)).astype(np.float32)
    np.testing.assert_allclose(
        float(tl.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))),
        float(jl.cross_entropy(logits, labels)), rtol=1e-5)


# ------------------------------------------------------ loss and gradients
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(remat):
    jm = jax_model(remat)
    jp = jax_params(jm)
    m = port_model(jm, jp)
    assert m.cfg.remat == remat
    b = batches(jm.cfg.vocab, 1, batch=2, seq=64)[0]
    want_loss, want_grads = jax.value_and_grad(jm.loss)(jp, to_jax(b))
    loss, grads = value_and_grad(m, dict(m.named_parameters()), to_torch(b))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert_leaves_close(grads, want_grads, rtol=1e-4)
    # The module's own parameters stay frozen: training makes its leaves.
    assert not any(p.requires_grad for p in m.parameters())
    assert float(m.loss(to_torch(b))) == float(loss)


def test_remat_does_not_change_the_gradient():
    jm = jax_model(False)
    jp = jax_params(jm, seed=1)
    plain = port_model(jm, jp)
    remat = port_model(jax_model(True), jp)
    b = to_torch(batches(jm.cfg.vocab, 1, seq=48)[0])
    l1, g1 = value_and_grad(plain, dict(plain.named_parameters()), b)
    l2, g2 = value_and_grad(remat, dict(remat.named_parameters()), b)
    assert torch.equal(l1, l2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


# -------------------------------------------------------------- optimizer
def opt_tree(rng):
    """A small parameter tree, leaves in JAX's (sorted) order: a matrix, a
    vector (no decay), a bf16 3-D leaf."""
    return {"a": rng.normal(size=(6, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32),
            "c": rng.normal(size=(3, 4, 5)).astype(np.float32)}


def assert_within_ulp(got: torch.Tensor, want, maxulp=1):
    """Within ``maxulp`` units in the last place of the tensor's own dtype
    (bf16 compared as bit patterns of same-signed values)."""
    if got.dtype == torch.bfloat16:
        a = got.view(torch.int16).numpy().astype(np.int32)
        b = np.asarray(want).view(np.int16).astype(np.int32)
        assert np.all(np.sign(a) == np.sign(b))
        assert np.abs(a - b).max() <= maxulp
    else:
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp)


@pytest.mark.parametrize("grads,grad_clip", [("normal", None),
                                              ("integer", 1.0)])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_update_matches_jax(grads, grad_clip, schedule):
    """Four updates of a tree with an f32 matrix, an f32 vector (no decay)
    and a bf16 3-D leaf, within 1 ulp of JAX's (bitwise on this CPU).
    Clipping is held with integer gradients, whose global norm both
    frameworks sum exactly; for other gradients the norm's summation order
    differs (``test_adamw_clipping_of_normal_gradients``)."""
    rng = np.random.default_rng(0)
    params = opt_tree(rng)
    dtypes = {"a": (jnp.float32, F32), "b": (jnp.float32, F32),
              "c": (jnp.bfloat16, torch.bfloat16)}
    jp = {n: jnp.asarray(a, dtypes[n][0]) for n, a in params.items()}
    tp = {n: torch.from_numpy(a).to(dtypes[n][1]) for n, a in params.items()}
    lr = (3e-2, 3e-2) if schedule == "constant" else (
        jcosine(3e-2, 2, 6), cosine_schedule(3e-2, 2, 6))
    jopt = JAdamW(lr=lr[0], grad_clip=grad_clip)
    topt = AdamW(lr=lr[1], grad_clip=grad_clip)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = {n: rng.normal(size=a.shape) * 3 for n, a in params.items()}
        if grads == "integer":
            g = {n: np.round(a) for n, a in g.items()}
        g = {n: a.astype(np.float32) for n, a in g.items()}
        jp, js, jnorm = jopt.update(
            {n: jnp.asarray(a, dtypes[n][0]) for n, a in g.items()}, js, jp)
        tp, ts, tnorm = topt.update(
            {n: torch.from_numpy(a).to(dtypes[n][1]) for n, a in g.items()},
            ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        if grad_clip is not None:
            assert float(tnorm) > grad_clip       # clipping is active
        assert_within_ulp(tnorm, jnorm)
        for n in params:
            assert tp[n].dtype == dtypes[n][1]
            assert_within_ulp(tp[n], jp[n])
            assert_within_ulp(ts.m[n], js.m[n])
            assert_within_ulp(ts.v[n], js.v[n])


def test_adamw_clipping_of_normal_gradients():
    """With clipping on normal gradients the global norm agrees within
    1 ulp (XLA and torch sum a leaf's squares in different orders), and
    that ulp of scale carries into the moments: they agree to 1e-5
    relative to each leaf's largest entry."""
    rng = np.random.default_rng(1)
    params = opt_tree(rng)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    jopt, topt = JAdamW(lr=3e-2), AdamW(lr=3e-2)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = {n: (rng.normal(size=a.shape) * 3).astype(np.float32)
             for n, a in params.items()}
        jp, js, jnorm = jopt.update({n: jnp.asarray(a) for n, a in g.items()},
                                    js, jp)
        tp, ts, tnorm = topt.update(
            {n: torch.from_numpy(a) for n, a in g.items()}, ts, tp)
        assert_within_ulp(tnorm, jnorm)
        for n in params:
            for got, want in ((tp[n], jp[n]), (ts.m[n], js.m[n]),
                              (ts.v[n], js.v[n])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=1e-5 * float(np.abs(want).max()))


def test_cosine_schedule_matches_jax():
    """Warmup steps bitwise; the cosine part within 2 ulps: XLA's f32 cos
    is not correctly rounded and the port's is (each is 1 ulp off the
    other at some steps, in either direction), and that ulp passes through
    two more f32 roundings."""
    j = jcosine(3e-4, 5, 40)
    t = cosine_schedule(3e-4, 5, 40)
    for step in range(0, 45):
        got = t(step)
        want = np.asarray(j(jnp.asarray(step, jnp.int32)))
        assert got.dtype == np.float32
        if step < 5:
            assert got == want
        np.testing.assert_array_max_ulp(got, want, 2)


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("shape", [(1000,), (256,), (3, 7, 50), (2, 256)])
def test_quantize_roundtrip_is_bitwise_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * rng.uniform(0.01, 10)).astype(np.float32)
    x.reshape(-1)[:256 if x.size > 256 else 0] = 0.0   # an all-zero block
    got = compress.quantize_roundtrip(torch.from_numpy(x))
    want = jcompress.quantize_roundtrip(jnp.asarray(x))
    assert got.dtype == F32 and got.shape == shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    q = compress.quantize(torch.from_numpy(x))
    jq = jcompress.quantize(jnp.asarray(x))
    assert np.array_equal(q.q.numpy(), np.asarray(jq.q))
    assert q.nbytes_compressed == jq.nbytes_compressed


def test_quantize_roundtrip_of_bf16_is_bitwise_jax():
    x = np.random.default_rng(5).normal(size=(300,)).astype(np.float32)
    got = compress.quantize_roundtrip(torch.from_numpy(x).bfloat16())
    want = jcompress.quantize_roundtrip(jnp.asarray(x, jnp.bfloat16))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 512, 32, 2),
                                                  (7, 128256, 2048, 2),
                                                  (3, 1000, 100, 5)])
def test_synthetic_lm_batches_equal_jax(seed, vocab, seq, batch):
    ours = SyntheticLM(vocab, seq, batch, seed=seed)
    theirs = JSyntheticLM(vocab, seq, batch, seed=seed)
    for step in (0, 1, 17):
        a, b = ours.batch_np(step), theirs.batch_np(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ---------------------------------------------------------------- trainer
def jax_trainer(jm, jp, opt, cfg, hw=None):
    kw = {} if hw is None else {"hw": hw}
    tr = JTrainer(jm, opt, cfg, rng=jax.random.PRNGKey(0), **kw)
    tr.params = jax.tree.map(jnp.copy, jp)       # the step donates them
    tr.opt_state = opt.init(tr.params)
    return tr


def test_trainer_trajectory_matches_jax():
    """Five steps of both trainers from the same f32 weights and batches.
    Adam's step is about lr * sign(g) wherever |g| >> eps, so with the
    default eps = 1e-8 a gradient entry of round-off size moves its weight
    by a full step in a direction that any two f32 evaluations pick
    differently (the port in f32 and in float64 part by as much as the port
    and JAX do).  eps = 1e-4 keeps those entries' steps small, and the
    trajectories then agree to about 5e-5."""
    jm = jax_model()
    jp = jax_params(jm, seed=2)
    data = batches(jm.cfg.vocab, 5, batch=4, seq=32)
    jtr = jax_trainer(jm, jp, JAdamW(lr=1e-3, eps=1e-4),
                      JTrainerConfig(steps=5, log_every=1))
    jtr.run(iter(to_jax(b) for b in data))
    m = port_model(jm, jp)
    tr = Trainer(m, AdamW(lr=1e-3, eps=1e-4),
                 TrainerConfig(steps=5, log_every=1),
                 params=dict(m.state_dict()))
    tr.run(iter(to_torch(b) for b in data))
    got = [r["loss"] for r in tr.metrics_log]
    want = [r["loss"] for r in jtr.metrics_log]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    assert [r["step"] for r in tr.metrics_log] == [1, 2, 3, 4, 5]


def port_trainer(seed=4, steps=1, **kw):
    """A port Trainer at the smoke widths in f32; its AdamW has eps = 1e-4
    (see ``test_trainer_trajectory_matches_jax``)."""
    jm = jax_model()
    m = port_model(jm, jax_params(jm, seed=seed))
    return Trainer(m, kw.pop("opt", AdamW(lr=1e-3, eps=1e-4,
                                          weight_decay=0.0,
                                          grad_clip=None)),
                   TrainerConfig(steps=steps, log_every=1, **kw),
                   params=dict(m.state_dict()))


def test_grad_accumulation_matches_full_batch():
    data = [to_torch(b) for b in batches(512, 2, batch=8, seq=32)]
    full = port_trainer()
    acc = port_trainer(step=StepConfig(accum=4))
    full.run(iter(data))
    acc.run(iter(data))
    np.testing.assert_allclose(acc.metrics_log[0]["loss"],
                               full.metrics_log[0]["loss"], rtol=1e-6)
    for name, p in full.params.items():
        # Adam's first step is about lr * sign(g): 1e-3 per entry.
        np.testing.assert_allclose(acc.params[name].numpy(), p.numpy(),
                                   atol=1e-6, err_msg=name)


def test_int8_compression_tracks_uncompressed():
    data = [to_torch(b) for b in batches(512, 12, batch=8, seq=32)]
    runs = {}
    for comp in (None, "int8"):
        tr = port_trainer(steps=12, opt=AdamW(lr=1e-2, weight_decay=0.0),
                          step=StepConfig(compression=comp))
        tr.run(iter(data))
        runs[comp] = [r["loss"] for r in tr.metrics_log]
    assert np.isfinite(runs["int8"]).all()
    assert runs["int8"] != runs[None]
    np.testing.assert_allclose(runs["int8"], runs[None], rtol=0.05)


def state_bytes(tr):
    return sum(p.numel() * p.element_size() for p in tr.params.values()) \
        + 2 * sum(4 * p.numel() for p in tr.params.values())


def test_guided_training_is_lossless_and_offloads():
    data = [to_torch(b) for b in batches(512, 8, batch=4, seq=32)]
    plain = port_trainer(seed=5, steps=8)
    cap = int(state_bytes(plain) * 0.6)
    guided = port_trainer(seed=5, steps=8, gdt=GuidanceConfig(
        enabled=True, fast_capacity_bytes=cap, interval_steps=2,
        promotion_threshold=1024))
    plain.run(iter(data))
    out = guided.run(iter(data))
    np.testing.assert_allclose([r["loss"] for r in guided.metrics_log],
                               [r["loss"] for r in plain.metrics_log],
                               rtol=1e-5)
    assert guided.placer.slow_bytes() > 0
    assert out["transfer_bytes"] > 0
    for name, p in plain.params.items():
        assert torch.equal(guided.params[name].data, p.data), name
    # Slow groups' moments and parameters sit in the placer's slow tier.
    slow = [e for _, a, _ in guided._site_groups.values()
            for e in guided.placer.entries(a.arena_id)
            if e.kind == "pinned_host"]
    assert slow and any(e.name.startswith("adam_v/") for e in slow)


def test_sites_and_decisions_match_the_jax_trainer():
    """Same GuidanceConfig, TPU_V5E on both, bf16 weights on both (the JAX
    package's): the same sites with the same bytes, the same first-touch
    fractions, and the same interval decisions and migration totals."""
    jm = jax_model()
    jp = jax_params(jm, seed=6, dtype=jnp.bfloat16)
    data = batches(jm.cfg.vocab, 6, batch=2, seq=32)
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

    assert list(tr._site_groups) == list(jtr._site_groups)
    for key, (site, arena, _) in tr._site_groups.items():
        jsite, jarena, _ = jtr._site_groups[key]
        assert site.path == jsite.path and site.kind.value == jsite.kind.value
        assert arena.resident_bytes == jarena.resident_bytes, key
        assert arena.fast_fraction == jarena.fast_fraction, key
    assert 0 < tr.placer.fast_bytes() < tr.placer.fast_bytes() + \
        tr.placer.slow_bytes()
    assert tr.gdt.migration_count == jtr.gdt.migration_count
    assert tr.gdt.total_bytes_migrated == jtr.gdt.total_bytes_migrated

    def stream(rt):
        return [(e.interval_index, e.decision.rental_cost_ns,
                 e.decision.purchase_cost_ns, e.decision.bytes_to_move,
                 e.decision.migrate, e.migrated, e.bytes_moved,
                 e.fast_bytes_after)
                for e in rt.events if e.kind == "interval"]

    assert stream(tr.gdt) == stream(jtr.gdt) and stream(tr.gdt)


# ------------------------------------------------------------------ placer
def build(cap_bytes, first_touch=False):
    reg = SiteRegistry()
    mgr = ArenaManager(reg, promotion_threshold=1024,
                       fast_capacity_bytes=cap_bytes if first_touch else None)
    placer = TorchArenaPlacer(mgr, device="cpu")
    gdt = GuidanceRuntime(
        ArenaBackend(mgr, CLX, placer=placer), CLX,
        GuidanceConfig(fast_capacity_bytes=cap_bytes, interval_steps=1))
    return reg, mgr, placer, gdt


def test_placer_bind_and_fetch_roundtrip():
    reg, mgr, placer, _ = build(1 << 30)
    s = reg.register(["w"], SiteKind.PARAM)
    x = torch.arange(4096, dtype=F32)
    arena = mgr.allocate(s, x.numel() * 4)
    placer.bind(arena.arena_id, "w", x)
    got = placer.fetch_fast(arena.arena_id)["w"]
    assert torch.equal(got, x)
    assert placer.kind(arena.arena_id, "w") == "device"
    assert placer.transfers_bytes == 0


def test_placer_enforce_moves_the_tier():
    """Cold data first-touches into the fast tier; the hot late-comer
    spills.  Online guidance swaps their tiers once rental beats
    purchase, and values survive the moves."""
    reg, mgr, placer, gdt = build(cap_bytes=8192, first_touch=True)
    cold = reg.register(["cold"], SiteKind.PARAM)
    hot = reg.register(["hot"], SiteKind.PARAM)
    xc = torch.ones((2048,), dtype=F32)
    xh = torch.full((2048,), 2.0, dtype=F32)
    ac = mgr.allocate(cold, 8192)
    ah = mgr.allocate(hot, 8192)
    placer.bind(ac.arena_id, "w", xc)
    placer.bind(ah.arena_id, "w", xh)
    assert placer.kind(ah.arena_id, "w") == "pinned_host"
    for _ in range(6):
        mgr.touch(hot, 10_000_000)
        mgr.touch(cold, 1)
        gdt.on_step()
    assert placer.kind(ah.arena_id, "w") == "device"
    assert placer.kind(ac.arena_id, "w") == "pinned_host"
    assert torch.equal(placer.fetch_fast(ac.arena_id)["w"], xc)
    assert torch.equal(placer.fetch_fast(ah.arena_id)["w"], xh)


def test_placer_fetch_fast_transfers_slow_entries():
    reg, mgr, placer, _ = build(1 << 30)
    s = reg.register(["x"], SiteKind.OPT_STATE)
    arena = mgr.allocate(s, 4096)
    placer.bind(arena.arena_id, "m", torch.full((1024,), 3.0))
    placer._apply(arena.arena_id, 0.0)                # demote everything
    assert placer.kind(arena.arena_id, "m") == "pinned_host"
    before = placer.transfers_bytes
    got = placer.fetch_fast(arena.arena_id)["m"]
    assert placer.transfers_bytes == before + 4096   # the rental
    assert torch.all(got == 3.0)
    got += 1                          # a fetched copy, not the stored one
    assert torch.all(placer.get(arena.arena_id, "m") == 3.0)


def test_placer_writeback_preserves_tier():
    reg, mgr, placer, _ = build(1 << 30)
    s = reg.register(["x"], SiteKind.OPT_STATE)
    arena = mgr.allocate(s, 4096)
    placer.bind(arena.arena_id, "m", torch.zeros((1024,)))
    placer._apply(arena.arena_id, 0.0)
    stored = placer.get(arena.arena_id, "m")
    before = placer.transfers_bytes
    placer.writeback(arena.arena_id, {"m": torch.full((1024,), 7.0)})
    assert placer.kind(arena.arena_id, "m") == "pinned_host"
    assert placer.get(arena.arena_id, "m") is stored  # its own buffer
    assert torch.all(stored == 7.0)
    assert placer.transfers_bytes == before + 4096


def test_placer_fractional_placement_tensor_granularity():
    reg, mgr, placer, _ = build(1 << 30)
    s = reg.register(["kv"], SiteKind.KV_CACHE)
    arena = mgr.allocate(s, 4 * 4096)
    for i in range(4):
        placer.bind(arena.arena_id, f"p{i}", torch.zeros((1024,)))
    placer._apply(arena.arena_id, 0.5)
    kinds = [e.kind for e in placer.entries(arena.arena_id)]
    assert kinds == ["device", "device", "pinned_host", "pinned_host"]
    assert placer.fast_bytes() == 2 * 4096
    assert placer.slow_bytes() == 2 * 4096


# ------------------------------------------------------------ checkpoints
def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path):
    jm = jax_model()
    data = batches(jm.cfg.vocab, 2)
    jtr = JTrainer(jm, JAdamW(lr=1e-3),
                   JTrainerConfig(steps=2, log_every=1,
                                  ckpt_dir=str(tmp_path)),
                   rng=jax.random.PRNGKey(3))
    jtr.run(iter(to_jax(b) for b in data))
    jtr.save_checkpoint(2)
    m = Model(config_from_reference(jm.cfg), device="cpu")
    tr = Trainer(m, AdamW(lr=1e-3), TrainerConfig(ckpt_dir=str(tmp_path),
                                                  seed=0))
    meta = tr.restore_checkpoint()
    assert meta["step"] == 2 and int(tr.opt_state.step) == 2
    for port_state, jtree in ((tr.params, jtr.params),
                              (tr.opt_state.m, jtr.opt_state.m),
                              (tr.opt_state.v, jtr.opt_state.v)):
        got, want = flat(params_to_numpy(port_state)), flat(jtree)
        assert got.keys() == want.keys()
        for name in want:
            assert np.array_equal(bits(got[name]), bits(want[name])), name
    assert m.layers[1].attn.wq.dtype == torch.bfloat16


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    from repro.ckpt.checkpoint import restore as jrestore

    m = Model(get_smoke("llama3_2_1b"), device="cpu")
    tr = Trainer(m, AdamW(lr=1e-3),
                 TrainerConfig(steps=2, log_every=1, ckpt_dir=str(tmp_path),
                               ckpt_every=2, seed=1))
    tr.run(iter(to_torch(b) for b in batches(512, 2)))
    tree, meta = jrestore(str(tmp_path))
    assert meta["step"] == 2 and int(tree["opt_step"]) == 2
    assert str(tree["params"]["layers"]["attn"]["wq"].dtype) == "bfloat16"
    for key, port_state in (("params", tr.params), ("m", tr.opt_state.m),
                            ("v", tr.opt_state.v)):
        got, want = flat(params_to_numpy(port_state)), flat(tree[key])
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].shape == want[name].shape
            assert np.array_equal(bits(got[name]), bits(want[name])), name


def test_restore_under_guidance_keeps_the_restored_values(tmp_path):
    jm = jax_model()
    data = [to_torch(b) for b in batches(jm.cfg.vocab, 4)]
    src = port_trainer(seed=7, steps=2, ckpt_dir=str(tmp_path),
                       ckpt_every=2)
    src.run(iter(data))
    saved = {n: p.detach().clone() for n, p in src.params.items()}
    cap = int(state_bytes(src) * 0.3)
    tr = port_trainer(seed=8, steps=1, ckpt_dir=str(tmp_path),
                      gdt=GuidanceConfig(enabled=True,
                                         fast_capacity_bytes=cap,
                                         interval_steps=2,
                                         promotion_threshold=1024))
    assert tr.placer.slow_bytes() > 0
    tr.restore_checkpoint()
    tr._sync_state_from_placer()
    for n, p in tr.params.items():
        assert torch.equal(p.data, saved[n]), n


def test_async_checkpointer_keeps_the_newest_and_restores(tmp_path):
    from repro_torch.ckpt import AsyncCheckpointer, available_steps, restore

    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    trees = {}
    for step in (1, 2, 3):
        trees[step] = {"w": torch.full((3, 4), float(step)).bfloat16(),
                       "m": {"a": torch.arange(5, dtype=F32) * step},
                       "n": np.int32(step)}
        ck.save_async(step, trees[step], extra_meta={"tag": step})
    ck.wait()
    assert ck.saved == [1, 2, 3]
    assert available_steps(str(tmp_path)) == [2, 3]
    tree, meta = restore(str(tmp_path))
    assert meta == {"step": 3, "tag": 3}
    assert bits(tree["w"]).tolist() == bits(
        params_to_numpy({"w": trees[3]["w"]})["w"]).tolist()
    assert np.array_equal(tree["m"]["a"], trees[3]["m"]["a"].numpy())
    assert tree["n"] == 3


def test_param_order_is_jax_leaf_order():
    m = Model(get_smoke("llama3_2_1b"), device="cpu")
    order = jax_order(dict(m.named_parameters()))
    assert order[:4] == ["embed.tok", "final_ln.scale", "head.w",
                         "layers.0.attn.wk"]
    assert order[4] == "layers.1.attn.wk" and order[-1] == "layers.1.mlp.w_up"
    assert list(flat(params_to_numpy(dict(m.named_parameters())))) == \
        sorted(flat(params_to_numpy(dict(m.named_parameters()))),
               key=lambda p: p.split("/"))


# --------------------------------------------------------------- launcher
def test_launcher_failure_drill(tmp_path):
    """Injected failure + checkpoint restart through the real CLI."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3_2_1b", "--smoke", "--device", "cpu", "--steps", "8",
         "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "3", "--simulate-failure", "5"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "restarting from checkpoint" in proc.stdout
    assert '"final_loss"' in proc.stdout


def test_launcher_trains_under_an_hbm_budget():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3_2_1b", "--smoke", "--device", "cpu", "--steps", "4",
         "--batch", "2", "--seq", "32", "--gdt-budget-mb", "1",
         "--gdt-interval", "2"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"transfer_bytes"' in proc.stdout
