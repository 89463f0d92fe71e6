"""The ``fsdp`` profile and zero1 moments on the CPU: one gloo group of 4
ranks (``_torch_fsdp_worker.py``, one run for the file) trains the smoke
``llama3_2_1b`` at 2 layers (the data axis divides them) and at 3 (it
does not) on the 2 x 1, 2 x 2 and 1 x 1 meshes under ``FSDP_RULES``
(every leaf's ``embed`` dim over ``data``: gathered before each use, its
gradient reduce-scattered) with zero1 moments (a layer's on the data rank
that owns it, ``AdamW.init``; its new values broadcast from there); on
2 x 2 also zero1 alone and a ``Trainer`` with ``profile="fsdp"`` and
``moments="zero1"``.  The JAX package runs the same 2-layer model under a
(2, 2) mesh of fake host devices with ``FSDP_RULES`` in one subprocess
beside it.  The batch's ignored labels fall unevenly on the data ranks.

Against one process on the whole batch, in float64 with the f32 islands
widened: each rank's loss within 1e-5 relative, each gradient block and
the parameters after two AdamW steps within 1e-5 of the leaf's largest
entry, the grad norms within 1e-5 relative.  A rank holds the moments of
its layers' leaves and of the leaves outside the stack, and every moment
where the data axis does not divide the layers.  The 1 x 1 mesh is
bitwise the meshless step; two runs of the 2 x 2 step are bitwise equal,
and the ``Trainer``'s steps bitwise the same steps taken directly.
Against the JAX model under its (2, 2) mesh, in f32: the loss rtol 1e-4
and each gradient block within 1e-4 of the JAX block in norm.  The
collectives on 2 x 1 equal their closed form: one all-gather per leaf
forward and one more per layer leaf in remat's recompute, one
reduce-scatter per leaf backward, no all-reduce of a gradient (only the
token count and the loss); zero1's update adds two all-gathers (the
parameter and its gradient, to the owner) and one broadcast per layer
leaf, and the clip's one all-reduce over the data group."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_fsdp_worker import ARCH, DEPTHS, train
from _torch_gloo import run_jax, run_ranks
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_worker import BATCH, SEQ, model_cfg, wide

# (mesh shape, the ranks that ran it).
LAYOUTS = {"2x1": ((2, 1), (0, 1)), "2x2": ((2, 2), (0, 1, 2, 3)),
           "1x1": ((1, 1), (0,))}
CASES = [(layout, L) for layout in LAYOUTS for L in DEPTHS] + [
    ("2x2 zero1", 2)]

JAX_SCRIPT = """
import os
# Compiling dominates these small programs: XLA's backend passes off.
os.environ["XLA_FLAGS"] += " --xla_backend_optimization_level=0"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs import get_smoke
from repro.dist.sharding import FSDP_RULES, use_rules
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


m = build_model(dataclasses.replace(get_smoke(ARCH), dtype=jnp.float32))
tree = nest({k[len("p/"):]: v for k, v in inp.items() if k.startswith("p/")})
with use_rules(FSDP_RULES), mesh:
    specs = param_pspecs(m.param_defs(), mesh, FSDP_RULES)
    params = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, specs)
    batch = {k: jax.device_put(jnp.asarray(inp[k]),
                               NamedSharding(mesh, PartitionSpec("data")))
             for k in ("tokens", "labels")}
    loss, grads = jax.jit(jax.value_and_grad(m.loss))(params, batch)
out = {"loss": np.asarray(loss)}
out.update(flat(jax.tree.map(np.asarray, grads), "grad"))
np.savez(OUT, **out)
"""


def make_inputs():
    """The 2- and 3-layer models' whole f32 parameters (seeds 0, 1) and one
    batch of 4 x 32 tokens whose ignored labels fall unevenly on two data
    blocks."""
    from repro_torch.models import Model

    state = {}
    for seed, L in enumerate(DEPTHS):
        m = Model(model_cfg(ARCH, n_layers=L), device="cpu").init(
            torch.Generator().manual_seed(seed))
        state[L] = {n: p.detach().clone() for n, p in m.state_dict().items()}
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(1, 512, (BATCH, SEQ), generator=g)
    labels = torch.randint(0, 512, (BATCH, SEQ), generator=g)
    labels[:2, :20] = -1
    labels[3, :3] = -1
    return {"state": state, "batch": {"tokens": tokens, "labels": labels}}


def jax_inputs(inp):
    from repro_torch.convert import params_to_numpy

    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v, np.float32)

    walk(params_to_numpy(inp["state"][2]), "p")
    for k, v in inp["batch"].items():
        flat[k] = v.numpy()
    return flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("fsdp4"))
    inp = make_inputs()
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inp, path)
    npz = os.path.join(tmp, "inputs.npz")
    np.savez(npz, **jax_inputs(inp))
    script = f"INPUTS = {npz!r}\nARCH = {ARCH!r}\n" + JAX_SCRIPT
    with ThreadPoolExecutor(2) as pool:
        jax_run = pool.submit(run_jax, script, tmp, 4)
        ranks = run_ranks("_torch_fsdp_worker.py", 4, tmp, path)
        return inp, ranks, jax_run.result()


@pytest.fixture(scope="module")
def reference(runs):
    """The meshless step on the whole batch (float64, widened)."""
    inp = runs[0]
    with wide():
        return {L: train(inp["state"][L], inp["batch"], None, n_layers=L)
                for L in DEPTHS}


def block(tensors, layout, rank, L, rules="fsdp"):
    """The blocks of whole ``tensors`` that ``rank`` holds under
    ``layout`` and the profile's rules."""
    from repro_torch.dist import DEFAULT_RULES, FSDP_RULES, abstract_mesh
    from repro_torch.models import Model

    shape, members = LAYOUTS[layout.split()[0]]
    mesh = abstract_mesh(shape, ("data", "model"))
    return Model(model_cfg(ARCH, n_layers=L), device="meta").local_params(
        mesh, tensors, FSDP_RULES if rules == "fsdp" else DEFAULT_RULES,
        rank=members.index(rank) if layout != "1x1" else 0)


def close(got, want, scale, tol=1e-5):
    return float((got - want).abs().max()) <= tol * float(scale.abs().max())


def rel(got, want, tol=1e-5):
    return abs(float(got) - float(want)) <= tol * abs(float(want))


def rules_of(layout):
    return "tp" if "zero1" in layout else "fsdp"


@pytest.mark.parametrize("layout,L", CASES)
def test_fsdp_zero1_step_matches_one_process(runs, reference, layout, L):
    want = reference[L]
    for r in LAYOUTS[layout.split()[0]][1]:
        got = runs[1][r][layout, L]
        assert rel(got["loss"], want["loss"]), (r, float(got["loss"]))
        for a, b in zip(got["losses"] + got["norms"],
                        want["losses"] + want["norms"]):
            assert rel(a, b), r
        for key in ("grads", "params"):
            mine = block(want[key], layout, r, L, rules_of(layout))
            assert got[key].keys() == want[key].keys()
            for n, g in got[key].items():
                assert g.shape == mine[n].shape, (key, r, n)
                assert close(g, mine[n], want[key][n]), (key, r, n)


@pytest.mark.parametrize("layout,L", CASES)
def test_zero1_holds_the_moments_of_the_ranks_layers(runs, layout, L):
    """With 2 layers on 2 data ranks data rank c holds layer c's moments
    and those outside the stack; with 3 every rank holds all."""
    for r in LAYOUTS[layout.split()[0]][1]:
        got = runs[1][r][layout, L]
        names = got["params"].keys()
        (data, model), members = LAYOUTS[layout.split()[0]]
        c = members.index(r) // model % data
        if layout == "1x1" or L % 2:
            assert got["moments"] == sorted(names)
        else:
            assert got["moments"] == sorted(
                n for n in names if not n.startswith("layers.")
                or n.startswith(f"layers.{c}."))


@pytest.mark.parametrize("L", DEPTHS)
def test_one_by_one_mesh_is_bitwise_the_meshless_step(runs, reference, L):
    want = reference[L]
    for res in runs[1][:1]:
        got = res["1x1", L]
        assert torch.equal(got["loss"], want["loss"])
        assert all(torch.equal(a, b) for a, b in zip(
            got["losses"] + got["norms"], want["losses"] + want["norms"]))
        for n in want["grads"]:
            assert torch.equal(got["grads"][n], want["grads"][n]), n
            assert torch.equal(got["params"][n], want["params"][n]), n
        assert all(v["count"] == 0 for v in got["collectives"].values())


def test_two_runs_and_the_trainer_are_bitwise_equal(runs):
    for res in runs[1]:
        a, b = res["2x2", 2], res["2x2 again", 2]
        t = res["2x2 trainer", 2]
        assert all(torch.equal(x, y) for x, y in zip(a["losses"],
                                                     b["losses"]))
        assert t["losses"] == [float(x) for x in a["losses"]]
        for n in a["params"]:
            assert torch.equal(a["params"][n], b["params"][n]), n
            assert torch.equal(a["grads"][n], b["grads"][n]), n
            assert torch.equal(t["params"][n], a["params"][n]), n


def test_fsdp_collectives_match_the_closed_form(runs, reference):
    """2 x 1, 2 layers: every leaf has an ``embed`` dim, so every leaf is
    gathered (whole float64 bytes) and reduce-scattered (its block's)."""
    whole = reference[2]["params"]
    layer = [n for n in whole if n.startswith("layers.")]
    nbytes = {n: t.numel() * 8 for n, t in whole.items()}
    for r in LAYOUTS["2x1"][1]:
        got = runs[1][r]["2x1", 2]
        rec, step = got["collectives"], got["step_collectives"]
        assert rec["all_gather"]["count"] == len(whole) + len(layer)
        assert rec["all_gather"]["bytes"] == sum(nbytes.values()) + sum(
            nbytes[n] for n in layer)
        assert rec["reduce_scatter"]["count"] == len(whole)
        assert rec["reduce_scatter"]["bytes"] == sum(nbytes.values()) // 2
        assert rec["all_reduce"]["count"] == 2          # count and loss
        assert rec["all_gather"]["max_group"] == 2
        assert step["all_gather"]["count"] == (rec["all_gather"]["count"]
                                               + 2 * len(layer))
        assert step["broadcast"]["count"] == len(layer)
        assert step["broadcast"]["bytes"] == sum(nbytes[n] for n in layer)
        assert step["reduce_scatter"] == rec["reduce_scatter"]
        assert step["all_reduce"]["count"] == 3         # and the clip's


def jax_grads(jax_out):
    from repro_torch.convert import params_from_numpy

    tree = {}
    for k, v in jax_out.items():
        if not k.startswith("grad/"):
            continue
        cur = tree
        parts = k[len("grad/"):].split("/")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return params_from_numpy(tree, "cpu")


def test_2x2_fsdp_matches_the_jax_model_under_its_fsdp_mesh(runs):
    jax_out = runs[2]
    want = jax_grads(jax_out)
    for r, res in enumerate(runs[1]):
        got = res["2x2 f32", 2]
        np.testing.assert_allclose(float(got["loss"]),
                                   float(jax_out["loss"]), rtol=1e-4)
        mine = block(want, "2x2", r, 2)
        for n, g in got["grads"].items():
            w = mine[n].double()
            err = float(torch.linalg.norm(g.double() - w))
            assert err <= 1e-4 * float(torch.linalg.norm(w)), (r, n, err)
