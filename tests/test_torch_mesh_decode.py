"""Decode under a model axis on the CPU: one gloo group of 4 ranks
(``_torch_decode_worker.py``, one run for the file) prefills the smoke
``llama3_2_1b``, ``granite_moe_3b_a800m`` (MoE under tp) and ``zamba2_7b``
(hybrid, a prompt of 20 >= W - 1) on the rank's blocks and decodes 8
greedy steps on the 1 x 2, 2 x 2, 1 x 4 and 1 x 1 meshes, under
two cache layouts: (a) ``DECODE_RULES``, the cache's kv heads over the
model axis, continuing the cache a tensor-parallel prefill leaves; (b) the
dry run's decode rules (``kv_seq`` over the model axis), each rank holding
its positions of every kv head, the partial attentions merged by
``merge_partials``; ``SP_DECODE_RULES`` too on 2 x 2.  The 1 x 4 mesh
splits llama's 8 heads but not its 2 kv heads (the GQA fallback) and
leaves granite's 6 heads whole, and runs llama with a window of 16 (a
ring cache of 16 slots, the prompt of 20 past it, 4 slots a rank in (b)).
The JAX package decodes the same models under a (2, 2) mesh of fake host
devices, jitted with the decode cell's shardings, in one subprocess beside
the ranks.

Against one process on every row, in float64 with the f32 islands widened:
each rank's whole logits of its rows within 1e-5 of the largest entry at
the prefill and every step, and its greedy stream equal.  The 1 x 1 mesh
is bitwise the meshless run; two runs of (b) on 2 x 2 are bitwise equal.
``merge_partials`` alone, on random partials in float64, is within 1e-12
of the unsplit softmax.  Against the JAX model, in f32, the logits of the
prefill and 4 steps fed the same tokens within 1e-4 (dense, MoE) and 1e-2
(hybrid) of the largest.  The collectives of one decode step equal their
closed form: under (a) the embedding's, attention's and the MLP's
all-reduces and the logits' gather; under (b) per layer also two gathers
over the model group (the q heads, then k and v together; none for k and v
in the GQA fallback) and one gather of the partials."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_decode_worker import (FED_STEPS, MODELS, PROMPT, RING, SEQ,
                                  STEPS, serve)
from _torch_gloo import run_jax, run_ranks
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_worker import BATCH, model_cfg, wide

LAYOUTS = {"1x2": ((1, 2), (0, 1)), "2x2": ((2, 2), (0, 1, 2, 3)),
           "1x4": ((1, 4), (0, 1, 2, 3)), "1x1": ((1, 1), (0,))}
CASES = ([(layout, rules, arch) for layout in LAYOUTS for rules in "ab"
          for arch in MODELS]
         + [("1x4", rules, "ring") for rules in "ab"]
         + [("2x2", "sp", MODELS[0])])
JAX_TOL = {"llama3_2_1b": 1e-4, "granite_moe_3b_a800m": 1e-4,
           "zamba2_7b": 1e-2}

JAX_SCRIPT = """
import os
# Compiling dominates these small programs: XLA's backend passes off.
os.environ["XLA_FLAGS"] += " --xla_backend_optimization_level=0"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs import get_smoke
from repro.dist.sharding import DEFAULT_RULES, use_rules
from repro.models import build_model
from repro.models.common import param_pspecs

inp = dict(np.load(INPUTS))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
rules = dict(DEFAULT_RULES, kv_seq="model", head_dim=None, qdh=None)
ns = lambda s: NamedSharding(mesh, s)


def nest(flat):
    tree = {}
    for key, a in flat.items():
        cur = tree
        parts = key.split("/")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = jnp.asarray(a)
    return tree


out = {}
prompts, feed = jnp.asarray(inp["prompts"]), inp["feed"]
B = prompts.shape[0]
for arch in ARCHS:
    m = build_model(dataclasses.replace(get_smoke(arch), dtype=jnp.float32))
    tree = nest({k[len(arch) + 1:]: v for k, v in inp.items()
                 if k.startswith(arch + "/")})
    with use_rules(rules), mesh:
        p_sh = jax.tree.map(ns, param_pspecs(m.param_defs(), mesh, rules))
        c_sh = jax.tree.map(ns, param_pspecs(m.cache_defs(B, SEQ), mesh,
                                             rules))
        params = jax.device_put(tree, p_sh)
        cache = jax.device_put(m.init_cache(B, SEQ), c_sh)
        lg, got = jax.jit(m.prefill)(params, {"tokens": prompts}, cache)
        # The prefill's K/V are the prompt's length: at the cache's head.
        cache = jax.device_put(jax.tree.map(
            lambda z, c: c if z.shape == c.shape else
            z.at[:, :, :c.shape[2]].set(c), m.init_cache(B, SEQ), got), c_sh)
        dec = jax.jit(m.decode, in_shardings=(
            p_sh, c_sh, ns(PartitionSpec("data")), ns(PartitionSpec())),
            out_shardings=(None, c_sh))
        logits = [np.asarray(lg)]
        for t in range(STEPS):
            lg, cache = dec(params, cache, jnp.asarray(feed[:, t:t + 1]),
                            jnp.int32(PROMPT + t))
            logits.append(np.asarray(lg))
    out[arch] = np.stack(logits)
np.savez(OUT, **out)
"""


def make_inputs():
    """Each model's whole f32 parameters (seeds 0, 1, 2), 4 prompts of 20
    tokens and the tokens the f32 runs are fed."""
    from repro_torch.models import Model

    state = {}
    for seed, arch in enumerate(MODELS):
        m = Model(model_cfg(arch), device="cpu").init(
            torch.Generator().manual_seed(seed))
        state[arch] = {n: p.detach().clone()
                       for n, p in m.state_dict().items()}
    g = torch.Generator().manual_seed(11)
    return {"state": state,
            "prompts": torch.randint(1, 512, (BATCH, PROMPT), generator=g),
            "feed": torch.randint(1, 512, (BATCH, FED_STEPS), generator=g)}


def jax_inputs(inp):
    from repro_torch.convert import params_to_numpy

    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v, np.float32)

    for arch in MODELS:
        walk(params_to_numpy(inp["state"][arch]), arch)
    flat["prompts"] = inp["prompts"].numpy().astype(np.int32)
    flat["feed"] = inp["feed"].numpy().astype(np.int32)
    return flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, every rank's results, the JAX logits): the gloo group and
    the JAX subprocess run side by side."""
    tmp = str(tmp_path_factory.mktemp("decode4"))
    inp = make_inputs()
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inp, path)
    npz = os.path.join(tmp, "inputs.npz")
    np.savez(npz, **jax_inputs(inp))
    script = (f"INPUTS = {npz!r}\nARCHS = {MODELS!r}\nSEQ = {SEQ}\n"
              f"PROMPT = {PROMPT}\nSTEPS = {FED_STEPS}\n" + JAX_SCRIPT)
    with ThreadPoolExecutor(2) as pool:
        jax_run = pool.submit(run_jax, script, tmp, 4)
        ranks = run_ranks("_torch_decode_worker.py", 4, tmp, path)
        return inp, ranks, jax_run.result()


@pytest.fixture(scope="module")
def reference(runs):
    """One process's prefill and greedy decode of every row (float64,
    widened), per model and the ring."""
    inp = runs[0]
    with wide():
        out = {arch: serve(arch, inp["state"][arch], inp["prompts"], None,
                           None) for arch in MODELS}
        out["ring"] = serve(MODELS[0], inp["state"][MODELS[0]],
                            inp["prompts"], None, None, **RING)
    return out


def rows(layout, rank):
    (data, model), members = LAYOUTS[layout]
    if layout == "1x1":
        return slice(None)
    c = members.index(rank) // model
    n = BATCH // data
    return slice(c * n, (c + 1) * n)


def close(got, want, tol=1e-5):
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("layout,rules,arch", CASES)
def test_decode_matches_one_process(runs, reference, layout, rules, arch):
    want = reference[arch]
    for r in LAYOUTS[layout][1]:
        got = runs[1][r][layout, rules, arch]
        sl = rows(layout, r)
        assert got["logits"].shape == want["logits"][:, sl].shape
        for t, (g, w) in enumerate(zip(got["logits"],
                                       want["logits"][:, sl])):
            assert close(g, w), (r, t)
        assert torch.equal(got["stream"], want["stream"][:, sl]), r


@pytest.mark.parametrize("rules", "ab")
@pytest.mark.parametrize("arch", MODELS)
def test_one_by_one_mesh_is_bitwise_the_meshless_decode(runs, reference,
                                                        rules, arch):
    want = reference[arch]
    for res in runs[1][:1]:
        got = res["1x1", rules, arch]
        assert torch.equal(got["logits"], want["logits"])
        assert torch.equal(got["stream"], want["stream"])
        assert all(v["count"] == 0 for v in got["collectives"].values())


def test_two_runs_of_the_2x2_decode_are_bitwise_equal(runs):
    for res in runs[1]:
        a, b = res["2x2", "b", MODELS[0]], res["2x2", "b again", MODELS[0]]
        assert torch.equal(a["logits"], b["logits"])
        assert torch.equal(a["stream"], b["stream"])


@pytest.mark.parametrize("split", [1, 2, 3, 7])
def test_merge_partials_is_the_unsplit_softmax(split):
    """Scores (B, K, G, S) and values (B, S, K, dh) in float64 cut into
    ``split`` runs of keys, one masked whole: each part's normalised output,
    row maximum and sum of exponentials, merged in order."""
    from repro_torch.dist.collectives import merge_partials

    g = torch.Generator().manual_seed(split)
    B, K, G, S, dh = 2, 2, 3, 28, 16
    s = torch.randn((B, K, G, S), generator=g, dtype=torch.float64) * 4
    v = torch.randn((B, S, K, dh), generator=g, dtype=torch.float64)
    s[..., :4] = -1e30                       # masked keys: a whole part
    want = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1), v)
    bounds = [0] + [4 + (S - 4) * i // split for i in range(split + 1)]
    os_, ms, ls = [], [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = s[..., lo:hi]
        m = part.amax(-1)
        e = torch.exp(part - m[..., None])
        l = e.sum(-1)
        os_.append(torch.einsum("bkgs,bskd->bkgd", e, v[:, lo:hi])
                   / l[..., None])
        ms.append(m)
        ls.append(l)
    got = merge_partials(torch.stack(os_), torch.stack(ms), torch.stack(ls))
    assert float((got - want).abs().max()) <= 1e-12
    again = merge_partials(torch.stack(os_), torch.stack(ms),
                           torch.stack(ls))
    assert torch.equal(got, again)


@pytest.mark.parametrize("arch", MODELS)
def test_2x2_decode_matches_the_jax_model_under_its_decode_shardings(
        runs, arch):
    want = torch.from_numpy(runs[2][arch]).double()
    for r, res in enumerate(runs[1]):
        got = res["2x2", "b f32", arch]["logits"].double()
        w = want[:, rows("2x2", r)]
        assert got.shape == w.shape
        err = float((got - w).abs().max())
        assert err <= JAX_TOL[arch] * float(w.abs().max()), (r, err)


def closed_form(layout, rules):
    """(all-reduce count, bytes), (all-gather count, bytes) of one decode
    step of the dense smoke model in float64 under ``layout``."""
    cfg = model_cfg(MODELS[0])
    (data, model), _ = LAYOUTS[layout]
    B, d, L = BATCH // data, cfg.d_model, cfg.n_layers
    H, K, dh, V = cfg.n_heads, cfg.kv_heads, d // cfg.n_heads, cfg.vocab
    reduce = (1 + 2 * L, (1 + 2 * L) * B * d * 8)
    count, nbytes = 1, B * V * 4                     # the f32 logits
    if rules == "b":
        count += 2 * L                               # q heads; partials
        nbytes += L * (B * H * dh * 8 + model * B * H * (dh + 2) * 8)
        if K % model == 0:                           # k and v together
            count += L
            nbytes += L * 2 * B * K * dh * 8
    return reduce, (count, nbytes)


@pytest.mark.parametrize("rules", "ab")
@pytest.mark.parametrize("layout", ["1x2", "1x4"])
def test_decode_collectives_match_the_closed_form(runs, layout, rules):
    (ar, ar_b), (ag, ag_b) = closed_form(layout, rules)
    for r in LAYOUTS[layout][1]:
        rec = runs[1][r][layout, rules, MODELS[0]]["collectives"]
        assert rec["all_reduce"]["count"] == ar, rec
        assert rec["all_reduce"]["bytes"] == ar_b, rec
        assert rec["all_gather"]["count"] == ag, rec
        assert rec["all_gather"]["bytes"] == ag_b, rec
        assert all(rec[k]["count"] == 0 for k in rec
                   if k not in ("all_reduce", "all_gather"))
