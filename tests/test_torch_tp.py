"""Tensor and data parallelism of the port on the CPU: one gloo group of 4
ranks (``_torch_tp_worker.py``, one run for the file) trains the smoke
``llama3_2_1b``, ``granite_moe_3b_a800m`` (MoE under tp) and ``zamba2_7b``
(hybrid, S = 32 >= W - 1) on the 1 x 2, 2 x 1, 2 x 2, 1 x 4 and 1 x 1
meshes, each rank on its blocks; the JAX package runs the same models
under a (2, 2) mesh of fake host devices in one subprocess beside it (its
loss and gradients in an ``.npz``).  The 1 x 4 mesh splits llama's 8
heads but not its 2 kv heads (the GQA fallback) and leaves granite's 6
heads whole; the hybrid's ``ssm_heads`` and ``d_inner`` split together.

The batch's ignored labels (-1) fall unevenly on the data ranks: 40 in
the first data block, 3 in the second.  Against one process on the whole
batch, in float64 with the f32 islands widened on both sides (the ranks
sum in other orders, and in f32 the hybrid's seven random layers amplify
that round-off to 2e-3 of a leaf, as ``test_torch_hybrid_train.py``
shows against JAX): each rank's loss within 1e-5 relative, each gradient
leaf's block and the parameters after two AdamW steps within 1e-5 of the
leaf's largest entry.  The 1 x 1 mesh is bitwise the meshless step; two
runs of the 2 x 2 step are bitwise equal.  Under ep on the 2 x 2 mesh the
data reduction turns each data block's router gradient into the batch's.
Against the JAX model under its (2, 2) mesh, in f32, as the port's
one-process parity tests hold each family: the loss rtol 1e-4 and each
gradient block within 1e-4 of the JAX block in norm, the hybrid within
1e-2.  The counted collectives of the dense model's loss and backward
equal their closed form: per layer two all-reduces of B*S*d forward, two
backward and one in remat's recompute (``torch.utils.checkpoint`` stops
recomputing at the last tensor the backward needs, before the MLP's
reduce), in the GQA fallback the two whole ``wk``/``wv`` gradients, and
on 2 x 2 the data reduction's."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_gloo import run_jax, run_ranks
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_worker import (BATCH, MODELS, SEQ, WIDE_HEADS, make_model,
                              model_cfg, optimizer, wide)

LAYOUTS = {"1x2": ((1, 2), (0, 1)), "2x1": ((2, 1), (2, 3)),
           "2x2": ((2, 2), (0, 1, 2, 3)), "1x4": ((1, 4), (0, 1, 2, 3)),
           "1x1": ((1, 1), (0, 1, 2, 3))}
CASES = [(layout, arch) for layout in LAYOUTS for arch in MODELS]
JAX_TOL = {"llama3_2_1b": 1e-4, "granite_moe_3b_a800m": 1e-4,
           "zamba2_7b": 1e-2}

JAX_SCRIPT = """
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
batch = {k: jax.device_put(jnp.asarray(inp[k]),
                           NamedSharding(mesh, PartitionSpec("data")))
         for k in ("tokens", "labels")}
for arch in ARCHS:
    m = build_model(dataclasses.replace(get_smoke(arch), dtype=jnp.float32))
    tree = nest({k[len(arch) + 1:]: v for k, v in inp.items()
                 if k.startswith(arch + "/")})
    specs = param_pspecs(m.param_defs(), mesh)
    params = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, specs)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(m.loss))(params, batch)
    out[arch + "/loss"] = np.asarray(loss)
    out.update(flat(jax.tree.map(np.asarray, grads), arch + "/grad"))
np.savez(OUT, **out)
"""


def make_inputs():
    """Each model's whole f32 parameters (seeds 0, 1, 2) and one batch of
    4 x 32 tokens whose ignored labels fall unevenly on two data
    blocks."""
    from repro_torch.models import Model

    state = {}
    for seed, arch in enumerate(MODELS):
        m = Model(model_cfg(arch), device="cpu").init(
            torch.Generator().manual_seed(seed))
        state[arch] = {n: p.detach().clone()
                       for n, p in m.state_dict().items()}
    m = Model(model_cfg(MODELS[2], **WIDE_HEADS), device="cpu").init(
        torch.Generator().manual_seed(3))
    state["wide heads"] = {n: p.detach().clone()
                           for n, p in m.state_dict().items()}
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(1, 512, (BATCH, SEQ), generator=g)
    labels = torch.randint(0, 512, (BATCH, SEQ), generator=g)
    labels[:2, :20] = -1                   # 40 in the first data block
    labels[3, :3] = -1                     # 3 in the second
    return {"state": state, "batch": {"tokens": tokens, "labels": labels}}


def jax_inputs(inp):
    """The parameters as the JAX tree's flattened paths under each arch,
    and the batch, as numpy."""
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
    for k, v in inp["batch"].items():
        flat[k] = v.numpy()
    return flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, every rank's results, the JAX outputs): the gloo group and
    the JAX subprocess run side by side."""
    tmp = str(tmp_path_factory.mktemp("tp4"))
    inp = make_inputs()
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inp, path)
    npz = os.path.join(tmp, "inputs.npz")
    np.savez(npz, **jax_inputs(inp))
    script = f"INPUTS = {npz!r}\nARCHS = {MODELS!r}\n" + JAX_SCRIPT
    with ThreadPoolExecutor(2) as pool:
        jax_run = pool.submit(run_jax, script, tmp, 4)
        ranks = run_ranks("_torch_tp_worker.py", 4, tmp, path)
        return inp, ranks, jax_run.result()


def one_process(arch, state, batch, steps=2, **kw):
    """The meshless step on the whole batch in float64, the islands
    widened: loss, gradients, two AdamW steps' losses, norms and
    parameters."""
    from repro_torch.convert import jax_order
    from repro_torch.train.step import make_train_step, reduced_value_and_grad

    with wide():
        model = make_model(arch, state, torch.float64, **kw)
        named = dict(model.named_parameters())
        params = {n: named[n] for n in jax_order(named)}
        loss, grads = reduced_value_and_grad(model, params, batch)
        opt = optimizer()
        step, st = make_train_step(model, opt), opt.init(params)
        losses, norms = [], []
        for _ in range(steps):
            _, st, metrics = step(params, st, batch)
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
    return {"loss": loss, "grads": grads, "losses": losses, "norms": norms,
            "params": {n: p.detach().clone() for n, p in params.items()}}


@pytest.fixture(scope="module")
def reference(runs):
    inp = runs[0]
    return {arch: one_process(arch, inp["state"][arch], inp["batch"])
            for arch in MODELS}


def block(arch, tensors, layout, rank, **kw):
    """The blocks of whole ``tensors`` that ``rank`` holds under
    ``layout``."""
    from repro_torch.dist import abstract_mesh
    from repro_torch.models import Model

    shape, members = LAYOUTS[layout]
    mesh = abstract_mesh(shape, ("data", "model"))
    pos = 0 if layout == "1x1" else members.index(rank)
    return Model(model_cfg(arch, **kw), device="meta").local_params(
        mesh, tensors, rank=pos)


def close(got, want, scale, tol=1e-5):
    return float((got - want).abs().max()) <= tol * float(scale.abs().max())


def rel(got, want, tol=1e-5):
    return abs(float(got) - float(want)) <= tol * abs(float(want))


@pytest.mark.parametrize("layout,arch", CASES)
def test_loss_matches_one_process(runs, reference, layout, arch):
    want = reference[arch]
    for r in LAYOUTS[layout][1]:
        got = runs[1][r][layout, arch]
        assert rel(got["loss"], want["loss"]), (r, float(got["loss"]))
        for a, b in zip(got["losses"], want["losses"]):
            assert rel(a, b), r


@pytest.mark.parametrize("layout,arch", CASES)
def test_gradients_match_one_process(runs, reference, layout, arch):
    want = reference[arch]["grads"]
    for r in LAYOUTS[layout][1]:
        got = runs[1][r][layout, arch]["grads"]
        mine = block(arch, want, layout, r)
        assert got.keys() == want.keys()
        for n, g in got.items():
            assert g.shape == mine[n].shape, (r, n)
            assert close(g, mine[n], want[n]), (r, n)


@pytest.mark.parametrize("layout,arch", CASES)
def test_params_after_two_steps_match_one_process(runs, reference, layout,
                                                  arch):
    want = reference[arch]
    for r in LAYOUTS[layout][1]:
        got = runs[1][r][layout, arch]
        mine = block(arch, want["params"], layout, r)
        for n, p in got["params"].items():
            assert close(p, mine[n], want["params"][n]), (r, n)
        for a, b in zip(got["norms"], want["norms"]):
            assert rel(a, b), r


def one_prefill(arch, state, batch):
    """One process's prefill of the whole batch (float64, widened)."""
    with wide():
        model = make_model(arch, state, torch.float64)
        cache = model.init_cache(BATCH, SEQ + 4)
        return model.prefill(batch["tokens"], cache)


def cache_block(arch, cache, layout, rank):
    """The blocks of one process's whole ``cache`` that ``rank`` holds
    under ``layout`` (``Model.cache_specs``)."""
    from repro_torch.dist import abstract_mesh
    from repro_torch.dist.sharding import local_block
    from repro_torch.models import Model

    shape, members = LAYOUTS[layout]
    mesh = abstract_mesh(shape, ("data", "model"))
    specs = Model(model_cfg(arch), device="meta").cache_specs(
        BATCH, SEQ + 4, mesh)

    def walk(c, s):
        if isinstance(c, dict):
            return {k: walk(c[k], s[k]) for k in c}
        return local_block(c, s[1], mesh, rank=members.index(rank))

    return walk(cache, specs)


@pytest.mark.parametrize("layout", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", MODELS)
def test_prefill_under_a_mesh_matches_one_process(runs, layout, arch):
    """Each rank's whole last logits (of its data block's rows) and its
    cache blocks within 1e-5 of one process's largest entry; on 1 x 4
    llama's cache holds both kv heads on every rank (the fallback)."""
    inp = runs[0]
    logits, cache = one_prefill(arch, inp["state"][arch], inp["batch"])
    data = LAYOUTS[layout][0][0]
    for r in LAYOUTS[layout][1]:
        got = runs[1][r][layout + " prefill", arch]
        rows = BATCH // data
        c = LAYOUTS[layout][1].index(r) // LAYOUTS[layout][0][1]
        assert close(got["logits"], logits[c * rows:(c + 1) * rows], logits)
        want = cache_block(arch, cache, layout, r)

        def walk(g, w, whole, key=""):
            if isinstance(g, dict):
                for k in g:
                    walk(g[k], w[k], whole[k], f"{key}/{k}")
                return
            assert g.shape == w.shape, (r, key)
            assert close(g, w, whole) if whole.abs().max() > 0 else \
                torch.equal(g, w), (r, key)

        walk(got["cache"], want, cache)


def test_trainer_under_a_mesh_holds_and_updates_the_local_blocks(runs):
    """A ``Trainer`` made under the 2 x 2 mesh holds the rank's blocks and
    steps them as the step does: its losses and blocks bitwise those of
    the same two steps taken directly."""
    for res in runs[1]:
        got, want = res["2x2 trainer", MODELS[0]], res["2x2", MODELS[0]]
        assert got["losses"] == [float(x) for x in want["losses"]]
        assert got["params"].keys() == want["params"].keys()
        for n, p in got["params"].items():
            assert torch.equal(p, want["params"][n]), n


@pytest.mark.parametrize("arch", MODELS)
def test_one_by_one_mesh_is_bitwise_the_meshless_step(runs, reference,
                                                      arch):
    want = reference[arch]
    for res in runs[1]:
        got = res["1x1", arch]
        assert torch.equal(got["loss"], want["loss"])
        for key in ("losses", "norms"):
            assert all(torch.equal(a, b)
                       for a, b in zip(got[key], want[key])), key
        for n in want["grads"]:
            assert torch.equal(got["grads"][n], want["grads"][n]), n
            assert torch.equal(got["params"][n], want["params"][n]), n
        assert all(v["count"] == 0 for v in got["collectives"].values())


def test_ssm_heads_and_d_inner_split_from_one_divisor(runs):
    """Two SSM heads on a model axis of 4: ``ssm_heads`` cannot split, so
    neither does ``d_inner`` (whole on every rank, though 256 divides by
    4), while attention, the MLP and the vocab still split; the step
    matches one process as every layout does."""
    arch, kw = MODELS[2], WIDE_HEADS
    inp = runs[0]
    want = one_process(arch, inp["state"]["wide heads"], inp["batch"], **kw)
    for r in LAYOUTS["1x4"][1]:
        got = runs[1][r]["1x4 wide heads", arch]
        assert got["params"]["ssm_layers.0.ssm.w_x"].shape == (128, 256)
        assert got["params"]["ssm_layers.0.ssm.a_log"].shape == (2,)
        assert got["params"]["shared_attn.mlp.w_up"].shape == (128, 64)
        assert rel(got["loss"], want["loss"])
        for key in ("grads", "params"):
            mine = block(arch, want[key], "1x4", r, **kw)
            for n, g in got[key].items():
                assert close(g, mine[n], want[key][n]), (key, r, n)


def test_two_runs_of_the_2x2_step_are_bitwise_equal(runs):
    for res in runs[1]:
        a, b = res["2x2", MODELS[0]], res["2x2 again", MODELS[0]]
        assert all(torch.equal(x, y) for x, y in zip(a["losses"],
                                                     b["losses"]))
        for n in a["grads"]:
            assert torch.equal(a["grads"][n], b["grads"][n]), n
            assert torch.equal(a["params"][n], b["params"][n]), n


def test_uneven_ignored_labels_give_the_global_mean(runs, reference):
    """The 2 x 1 ranks' loss is the whole batch's mean NLL, which here
    differs from the mean of the two data blocks' own means."""
    from repro_torch.train.step import value_and_grad

    inp, arch = runs[0], MODELS[0]
    with wide():
        model = make_model(arch, inp["state"][arch], torch.float64)
        params = dict(model.named_parameters())
        halves = [value_and_grad(model, params, {
            k: v[i:i + 2] for k, v in inp["batch"].items()})[0]
            for i in (0, 2)]
    whole = reference[arch]["loss"]
    assert abs(float(whole) - float(sum(halves)) / 2) > 1e-3
    for r in LAYOUTS["2x1"][1]:
        assert rel(runs[1][r]["2x1", arch]["loss"], whole)


def test_ep_with_the_data_reduction_gives_the_whole_router_gradient(
        runs, reference):
    """granite under ep on the 2 x 2 mesh: every leaf's block, the
    router's whole and the expert stacks on the rank's 4 experts, within
    1e-5 of the leaf's largest entry of one process's (whose flat layer
    is ep's function)."""
    arch = MODELS[1]
    want = reference[arch]["grads"]
    for r, res in enumerate(runs[1]):
        got = res["2x2 ep", arch]["grads"]
        mine = block(arch, want, "2x2", r)
        e = (r % 2) * 4
        for n, g in got.items():
            w = (want[n][e:e + 4]
                 if n.endswith(("moe.w_gate", "moe.w_up", "moe.w_down"))
                 else mine[n])
            assert close(g, w, want[n]), (r, n)


def closed_form(layout):
    """(all-reduce count, bytes) of the dense smoke model's loss and
    backward in float64 under ``layout``, the data reduction left out."""
    cfg = model_cfg(MODELS[0])
    (data, model), _ = LAYOUTS[layout]
    B, S, d, L = BATCH // data, SEQ, cfg.d_model, cfg.n_layers
    act = B * S * d * 8
    # The embedding; per layer 2 forward, 1 recomputed, 2 backward; the
    # loss's chunk: max, sum and gold logit, recomputed, and its input's
    # gradient.
    count = 1 + 5 * L + 7
    nbytes = act * (1 + 5 * L + 1) + 6 * B * S * 8
    if cfg.kv_heads % model:       # the GQA fallback's wk and wv
        count += 2 * L
        nbytes += 2 * L * d * cfg.kv_heads * (d // cfg.n_heads) * 8
    return count, nbytes


@pytest.mark.parametrize("layout", ["1x2", "1x4"])
def test_dense_collectives_match_the_closed_form(runs, layout):
    count, nbytes = closed_form(layout)
    for r in LAYOUTS[layout][1]:
        rec = runs[1][r][layout, MODELS[0]]["collectives"]
        assert rec["all_reduce"]["count"] == count, rec
        assert rec["all_reduce"]["bytes"] == nbytes, rec
        assert rec["all_reduce"]["max_group"] == LAYOUTS[layout][0][1]
        assert all(rec[k]["count"] == 0 for k in rec if k != "all_reduce")


def test_data_reduction_collectives_on_2x2(runs):
    """On 2 x 2 the data group adds the token count (int64), the loss and
    one all-reduce a gradient leaf, of its local bytes, to the model
    group's closed form."""
    count, nbytes = closed_form("2x2")
    for res in runs[1]:
        got = res["2x2", MODELS[0]]
        rec = got["collectives"]["all_reduce"]
        grads = got["grads"]
        assert rec["count"] == count + 2 + len(grads)
        assert rec["bytes"] == nbytes + 8 + 8 + sum(
            g.numel() * 8 for g in grads.values())


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


@pytest.mark.parametrize("arch", MODELS)
def test_2x2_matches_the_jax_model_under_its_2x2_mesh(runs, arch):
    jax_out = runs[2]
    want = jax_grads(jax_out, arch)
    for r, res in enumerate(runs[1]):
        got = res["2x2 f32", arch]
        np.testing.assert_allclose(float(got["loss"]),
                                   float(jax_out[arch + "/loss"]), rtol=1e-4)
        mine = block(arch, want, "2x2", r)
        for n, g in got["grads"].items():
            w = mine[n].double()
            err = float(torch.linalg.norm(g.double() - w))
            assert err <= JAX_TOL[arch] * float(torch.linalg.norm(w)), \
                (r, n, err)
