"""The xLSTM, encoder-decoder and VLM families under tensor parallelism,
and capacity dispatch under a mesh, on the CPU: one gloo group of 4 ranks
(``_torch_families_worker.py``, one run for the file) takes the smoke
``xlstm_350m`` (the mLSTM's ``d_inner`` and its decode state's key dim
over the model axis; the sLSTM's FFN width of 85 stays whole),
``seamless_m4t_medium`` (cross attention on the rank's heads) and
``phi3_vision_4_2b`` (its adapter whole) through the loss and its
gradients, a prefill and 4 greedy decode steps on the 1 x 2, 2 x 2 and
1 x 1 meshes (the encoder-decoder's decode also with its cache and
memory split by position, the dry run's decode rules), and the smoke
``granite_moe_3b_a800m`` with ``moe_dispatch="capacity"`` through two
AdamW steps on those meshes and 2 x 1 (per-row dispatch on the rank's rows, the batched products on
its block of the FFN width, one reduce of the (B, S, d) output).  The JAX
package runs the three families' loss and gradients under a (2, 2) mesh of
fake host devices in one subprocess beside them.

Against one process, in float64 with the f32 islands widened: each rank's
loss within 1e-5 relative, each gradient block (and the capacity model's
parameters after two steps) within 1e-5 of the leaf's largest entry, the
logits of the rank's rows within 1e-5 of the largest at the prefill and
every step, the greedy streams equal.  The 1 x 1 mesh is bitwise the
meshless run.  Against the JAX model under its (2, 2) mesh, in f32, at the
port's one-process parity tolerances: the loss rtol and each gradient
block in norm within 1e-4 (xLSTM), 4e-3 (encoder-decoder) and 1e-3 (VLM).
The xLSTM's collectives on 1 x 2 equal their closed form: per mLSTM layer
five reduces of the row-parallel products (q, k, v and the two gates) and
one of the norm's sum of squares and one of ``w_down`` forward, remat's
recompute of all but the last, and in the backward the input's and the
norm's reduces and the gather of the output's column gradients."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_families_worker import (CAPACITY, FAMILIES, FRONTEND, PROMPT,
                                    grads, serve, wide)
from _torch_gloo import run_jax, run_ranks
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_worker import BATCH, SEQ, make_model, model_cfg, optimizer
from _torch_tp_worker import wide as tp_wide

LAYOUTS = {"1x2": ((1, 2), (0, 1)), "2x1": ((2, 1), (2, 3)),
           "2x2": ((2, 2), (0, 1, 2, 3)), "1x1": ((1, 1), (0,))}
CASES = [(layout, arch) for layout in LAYOUTS if layout != "2x1"
         for arch in FAMILIES]
JAX_TOL = {"xlstm_350m": 1e-4, "seamless_m4t_medium": 4e-3,
           "phi3_vision_4_2b": 1e-3}
N_FRAMES = 16

JAX_SCRIPT = """
import os
# Compiling dominates these small programs: XLA's backend passes off.
os.environ["XLA_FLAGS"] += " --xla_backend_optimization_level=0"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs import get_smoke
from repro.models import build_model
from repro.models.common import param_pspecs

inp = dict(np.load(INPUTS))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


def nest(flat):
    tree = {}
    for key, a in flat.items():
        cur = tree
        parts = key.split("/")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = jnp.asarray(a)
    return tree


def flat(tree, prefix):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, prefix + "/" + k))
    return out


out = {}
for arch in ARCHS:
    m = build_model(dataclasses.replace(get_smoke(arch), dtype=jnp.float32))
    tree = nest({k[len(arch) + 1:]: v for k, v in inp.items()
                 if k.startswith(arch + "/")})
    specs = param_pspecs(m.param_defs(), mesh)
    params = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, specs)
    batch = {k[len("batch/" + arch) + 1:]: jax.device_put(
        jnp.asarray(v), NamedSharding(mesh, PartitionSpec("data")))
        for k, v in inp.items() if k.startswith("batch/" + arch + "/")}
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(m.loss))(params, batch)
    out[arch + "/loss"] = np.asarray(loss)
    out.update(flat(jax.tree.map(np.asarray, grads), arch + "/grad"))
np.savez(OUT, **out)
"""


def make_inputs():
    """Each model's whole f32 parameters (seeds 0-3), each family's batch
    of 4 x 32 tokens (ignored labels falling unevenly on two data blocks;
    the VLM's 16 patches, the encoder-decoder's 32 frames), 4 prompts of
    16 tokens and their patches or 16 frames."""
    from repro_torch.models import Model

    state = {}
    for seed, arch in enumerate(FAMILIES + (CAPACITY,)):
        m = Model(model_cfg(arch), device="cpu").init(
            torch.Generator().manual_seed(seed))
        state[arch] = {n: p.detach().clone()
                       for n, p in m.state_dict().items()}
    g = torch.Generator().manual_seed(7)
    batch, frontend = {}, {}
    for arch in FAMILIES + (CAPACITY,):
        cfg = model_cfg(arch)
        tokens = torch.randint(1, 512, (BATCH, SEQ), generator=g)
        labels = torch.randint(0, 512, (BATCH, SEQ), generator=g)
        labels[:2, :20] = -1
        labels[3, :3] = -1
        batch[arch] = {"tokens": tokens, "labels": labels}
        if arch == "phi3_vision_4_2b":
            batch[arch]["patches"] = torch.randn(
                (BATCH, cfg.frontend_tokens, cfg.d_model), generator=g)
            frontend[arch] = torch.randn(
                (BATCH, cfg.frontend_tokens, cfg.d_model), generator=g)
        elif arch == "seamless_m4t_medium":
            batch[arch]["frames"] = torch.randn((BATCH, SEQ, cfg.d_model),
                                                generator=g)
            frontend[arch] = torch.randn((BATCH, N_FRAMES, cfg.d_model),
                                         generator=g)
    return {"state": state, "batch": batch, "frontend": frontend,
            "prompts": torch.randint(1, 512, (BATCH, PROMPT), generator=g)}


def jax_inputs(inp):
    from repro_torch.convert import params_to_numpy

    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v, np.float32)

    for arch in FAMILIES:
        walk(params_to_numpy(inp["state"][arch]), arch)
        for k, v in inp["batch"][arch].items():
            flat[f"batch/{arch}/{k}"] = v.numpy()
    return flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("families4"))
    inp = make_inputs()
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inp, path)
    npz = os.path.join(tmp, "inputs.npz")
    np.savez(npz, **jax_inputs(inp))
    script = f"INPUTS = {npz!r}\nARCHS = {FAMILIES!r}\n" + JAX_SCRIPT
    with ThreadPoolExecutor(2) as pool:
        jax_run = pool.submit(run_jax, script, tmp, 4)
        ranks = run_ranks("_torch_families_worker.py", 4, tmp, path)
        return inp, ranks, jax_run.result()


@pytest.fixture(scope="module")
def reference(runs):
    """One process: each family's loss and gradients and its greedy
    decode, and the capacity model's two steps (float64, widened)."""
    inp = runs[0]
    out = {}
    with wide():
        for arch in FAMILIES:
            b = {k: v.double() if v.is_floating_point() else v
                 for k, v in inp["batch"][arch].items()}
            out["grads", arch] = grads(arch, inp["state"][arch], b, None)
            out["serve", arch] = serve(arch, inp["state"][arch],
                                       inp["prompts"],
                                       inp["frontend"].get(arch), None)
    with tp_wide():
        out["capacity"] = capacity_steps(inp["state"][CAPACITY],
                                         inp["batch"][CAPACITY])
    return out


def capacity_steps(state, batch, steps=2):
    """The meshless capacity model's reduced value-and-grad and two AdamW
    steps on the whole batch (float64)."""
    from repro_torch.convert import jax_order
    from repro_torch.train.step import make_train_step, reduced_value_and_grad

    model = make_model(CAPACITY, state, torch.float64,
                       moe_dispatch="capacity")
    named = dict(model.named_parameters())
    params = {n: named[n] for n in jax_order(named)}
    loss, g = reduced_value_and_grad(model, params, batch)
    opt = optimizer()
    step, st = make_train_step(model, opt), opt.init(params)
    losses, norms = [], []
    for _ in range(steps):
        _, st, metrics = step(params, st, batch)
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    return {"loss": loss, "grads": g, "losses": losses, "norms": norms,
            "params": {n: p.detach().clone() for n, p in params.items()}}


def block(arch, tensors, layout, rank):
    from repro_torch.dist import abstract_mesh
    from repro_torch.models import Model

    shape, members = LAYOUTS[layout]
    mesh = abstract_mesh(shape, ("data", "model"))
    pos = 0 if layout == "1x1" else members.index(rank)
    return Model(model_cfg(arch), device="meta").local_params(
        mesh, tensors, rank=pos)


def rows(layout, rank):
    (data, model), members = LAYOUTS[layout]
    if layout == "1x1":
        return slice(None)
    c = members.index(rank) // model
    return slice(c * BATCH // data, (c + 1) * BATCH // data)


def close(got, want, scale, tol=1e-5):
    return float((got - want).abs().max()) <= tol * float(scale.abs().max())


def rel(got, want, tol=1e-5):
    return abs(float(got) - float(want)) <= tol * abs(float(want))


@pytest.mark.parametrize("layout,arch", CASES)
def test_loss_and_gradients_match_one_process(runs, reference, layout,
                                              arch):
    want = reference["grads", arch]
    for r in LAYOUTS[layout][1]:
        got = runs[1][r][layout, "grads", arch]
        assert rel(got["loss"], want["loss"]), (r, float(got["loss"]))
        mine = block(arch, want["grads"], layout, r)
        assert got["grads"].keys() == want["grads"].keys()
        for n, g in got["grads"].items():
            assert g.shape == mine[n].shape, (r, n)
            assert close(g, mine[n], want["grads"][n]), (r, n)


@pytest.mark.parametrize("layout,arch", CASES + [
    (layout, "b " + FAMILIES[1]) for layout in LAYOUTS if layout != "2x1"])
def test_decode_matches_one_process(runs, reference, layout, arch):
    key, arch = ("b", arch[2:]) if arch.startswith("b ") else ("a", arch)
    want = reference["serve", arch]
    for r in LAYOUTS[layout][1]:
        got = runs[1][r][layout, key, arch]
        sl = rows(layout, r)
        for t, (g, w) in enumerate(zip(got["logits"],
                                       want["logits"][:, sl])):
            assert close(g, w, w), (r, t)
        assert torch.equal(got["stream"], want["stream"][:, sl]), r


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_capacity_dispatch_under_a_mesh_matches_one_process(
        runs, reference, layout):
    want = reference["capacity"]
    for r in LAYOUTS[layout][1]:
        got = runs[1][r][layout, "capacity", CAPACITY]
        assert rel(got["loss"], want["loss"]), r
        for a, b in zip(got["losses"] + got["norms"],
                        want["losses"] + want["norms"]):
            assert rel(a, b), r
        for key in ("grads", "params"):
            mine = block(CAPACITY, want[key], layout, r)
            for n, g in got[key].items():
                assert close(g, mine[n], want[key][n]), (key, r, n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_by_one_mesh_is_bitwise_the_meshless_run(runs, reference,
                                                     arch):
    want, served = reference["grads", arch], reference["serve", arch]
    for res in runs[1][:1]:
        got = res["1x1", "grads", arch]
        assert torch.equal(got["loss"], want["loss"])
        for n in want["grads"]:
            assert torch.equal(got["grads"][n], want["grads"][n]), n
        assert torch.equal(res["1x1", "a", arch]["logits"],
                           served["logits"])
        assert all(v["count"] == 0 for v in got["collectives"].values())


def test_xlstm_collectives_match_the_closed_form(runs):
    """1 x 2, float64: the embedding's all-reduce; per mLSTM layer its
    forward's seven (the five row-parallel products, the norm's sum of
    squares, ``w_down``), remat's recompute of the first six
    (``torch.utils.checkpoint`` stops at the last tensor the backward
    needs), and in the backward x's and the norm's, and the gather of the
    output's column gradients (``split_to_group``); the sLSTM layer's
    nothing (its FFN width does not split); and the loss's chunk as in
    ``test_torch_tp.py``: its max, sum and gold logit, recomputed, and its
    input's gradient."""
    cfg = model_cfg(FAMILIES[0])
    n_m = cfg.n_layers - cfg.n_layers // cfg.slstm_every
    B, S, d, H = BATCH, SEQ, cfg.d_model, cfg.n_heads
    di = 2 * d
    fwd = (3 * B * S * di + 2 * B * S * H + B * S) * 8    # w_down's apart
    act = B * S * d * 8
    for r in LAYOUTS["1x2"][1]:
        rec = runs[1][r]["1x2", "grads", FAMILIES[0]]["collectives"]
        ar, ag = rec["all_reduce"], rec["all_gather"]
        assert ar["count"] == 1 + n_m * (7 + 6 + 2) + 7, rec
        assert ar["bytes"] == act + n_m * (2 * fwd + act + act + B * S * 8) \
            + act + 6 * B * S * 8, rec
        assert ag["count"] == n_m and ag["bytes"] == n_m * B * S * di * 8


def jax_grads(jax_out, arch):
    from repro_torch.convert import params_from_numpy

    tree = {}
    prefix = arch + "/grad/"
    for k, v in jax_out.items():
        if not k.startswith(prefix):
            continue
        cur = tree
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_2x2_matches_the_jax_model_under_its_2x2_mesh(runs, arch):
    jax_out = runs[2]
    want = jax_grads(jax_out, arch)
    for r, res in enumerate(runs[1]):
        got = res["2x2", "f32", arch]
        np.testing.assert_allclose(float(got["loss"]),
                                   float(jax_out[arch + "/loss"]),
                                   rtol=JAX_TOL[arch])
        mine = block(arch, want, "2x2", r)
        for n, g in got["grads"].items():
            if n.endswith("slstm.norm"):       # never read: zero in both
                continue
            w = mine[n].double()
            err = float(torch.linalg.norm(g.double() - w))
            assert err <= JAX_TOL[arch] * float(torch.linalg.norm(w)), \
                (r, n, err)


def test_frontends_and_widths_are_split_as_the_rules_say(runs):
    """On 1 x 2 the mLSTM's ``w_q`` holds half of its ``d_inner`` rows and
    ``w_up`` half its columns; the VLM's adapter and the xLSTM's gates stay
    whole."""
    for r in LAYOUTS["1x2"][1]:
        g = runs[1][r]["1x2", "grads", FAMILIES[0]]["grads"]
        assert g["mlstm_layers.0.mlstm.w_q"].shape == (64, 128)
        assert g["mlstm_layers.0.mlstm.w_up"].shape == (64, 64)
        assert g["mlstm_layers.0.mlstm.b_i"].shape == (2,)
        assert g["slstm_layers.0.slstm.w_i"].shape == (64, 2, 32)
        v = runs[1][r]["1x2", "grads", FAMILIES[2]]["grads"]
        assert v["vision_adapter.w"].shape == (128, 128)
        assert FRONTEND[FAMILIES[2]] == "patches"
