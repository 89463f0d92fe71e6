"""The four decoder configs the port took last from the JAX package's
registry (``granite_8b``, ``minitron_4b``, ``stablelm_3b`` and the
sliding-window MoE ``mixtral_8x7b``), on the CPU at their smoke widths in
f32, with the JAX package's weights carried across by
``params_from_numpy``.

Across frameworks: the configs convert field by field; the logits of every
position and the training loss equal the JAX ``Model``'s within 1e-4 (the
frameworks sum in other orders; the JAX package's own engine tests hold
logits to 1e-4 as well); greedy streams through ``LLM.generate`` equal the
JAX ``Engine``'s on a pool it never swaps into (its ``swap_in_many`` does
not run on this tree's jax), mixtral's with a prompt past its window.  The
registry, the serving and training launchers and the ``Trainer`` take every
new arch, and the registry holds all ten of the reference's archs."""

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
from repro.models.layers import lm_head as jlm_head  # noqa: E402
from repro.models.layers import rmsnorm as jrmsnorm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import SamplingParams as JSamplingParams  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
)
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import norm, project  # noqa: E402
from repro_torch.serve import LLM, SamplingParams, ServeConfig  # noqa: E402

NEW = ["granite_8b", "minitron_4b", "stablelm_3b", "mixtral_8x7b"]
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(JAX model, its f32 params, the port's f32 model with those
    weights).  The JAX weights are bf16 whatever cfg.dtype says: cast."""
    cfg = dataclasses.replace(jget_smoke(arch), remat=False,
                              dtype=jnp.float32)
    jm = build_model(cfg)
    params = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jm.init(jax.random.PRNGKey(0)))
    tm = Model(config_from_reference(cfg), device="cpu")
    tm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params),
                                         device="cpu"))
    return jm, params, tm


def tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        1, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", NEW)
def test_configs_carry_across(arch):
    assert arch in configs.ARCHS
    assert config_from_reference(jget(arch)) == configs.get(arch)
    assert config_from_reference(jget_smoke(arch)) == configs.get_smoke(arch)


def test_registry_holds_seven_archs_and_names_the_rest():
    """The registry holds all ten of the JAX package's archs (the name is
    from when it held seven): each loads, published and smoke, and
    ``Model`` builds each smoke config on the CPU; an unknown name is
    refused."""
    from repro.configs import ARCHS as JARCHS

    assert len(configs.ARCHS) == 10
    assert sorted(configs.ARCHS) == sorted(JARCHS)
    for arch in configs.ARCHS:
        assert configs.get(arch).arch == configs.get_smoke(arch).arch == arch
        assert Model(configs.get_smoke(arch), device="cpu").cfg.arch == arch
    with pytest.raises(ValueError, match="unknown architecture"):
        configs.get_smoke("not_an_arch")


def test_published_widths_of_the_new_archs():
    dh = {a: configs.get(a).resolved_head_dim for a in NEW}
    assert dh == {"granite_8b": 128, "minitron_4b": 128, "stablelm_3b": 80,
                  "mixtral_8x7b": 128}
    mix = configs.get("mixtral_8x7b")
    assert (mix.window, mix.n_experts, mix.top_k) == (4096, 8, 2)


@pytest.mark.parametrize("arch", NEW)
def test_logits_and_loss_match_jax(arch):
    jm, params, tm = pair(arch)
    cfg = jm.cfg
    # Longer than mixtral's smoke window (64), so the window bites.
    tok = tokens(cfg.vocab, 2, 80)
    x, _ = jm._trunk(params, {"tokens": jnp.asarray(tok)})
    want = jlm_head(params["head"], jrmsnorm(params["final_ln"], x))
    t = torch.from_numpy(tok)
    with torch.no_grad():
        h = norm(tm.final_ln.scale, tm(t))
        got = project(h, tm.head.w).float()
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL * scale, rtol=TOL)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    jl = float(jm.loss(params, {"tokens": jnp.asarray(tok),
                                "labels": jnp.asarray(labels)}))
    with torch.no_grad():
        tl = float(tm.loss({"tokens": t,
                            "labels": torch.from_numpy(labels)}))
    assert abs(tl - jl) <= TOL * abs(jl)


def drive(eng, prompts, n_new):
    for rid, prompt in enumerate(prompts):
        eng.add_request(rid, prompt, params=JSamplingParams(
            max_tokens=n_new))
    while eng.requests:
        eng.step()
    return [eng.finished[rid].generated for rid in range(len(prompts))]


@pytest.mark.parametrize("arch", NEW)
def test_greedy_streams_match_the_jax_engine(arch):
    jm, params, tm = pair(arch)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, jm.cfg.vocab, n)]
               for n in (9, 13, 70 if arch == "mixtral_8x7b" else 5)]
    kw = dict(max_batch=2, page_size=4, hbm_pages=64, host_pages=16,
              policy="gdt", interval_steps=4)
    jeng = JEngine(jm, params, JServeConfig(**kw))
    want = drive(jeng, prompts, 5)
    assert jeng.pool.swaps_in == 0 and jeng.pool.swaps_out == 0
    out = LLM(tm, ServeConfig(**kw)).generate(
        prompts, SamplingParams(max_tokens=5))
    assert [o.token_ids for o in out] == want


@pytest.mark.parametrize("arch", NEW)
def test_front_door_and_trainer_take_the_arch(arch):
    llm = LLM.from_arch(arch, device="cpu")
    out = llm.generate([[1, 2, 3]], SamplingParams(max_tokens=3))
    assert len(out[0].token_ids) == 3
    stats = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                               "--sessions", "2", "--rounds", "1",
                               "--max-new", "2"])
    assert stats["tokens"] > 0
    launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "32",
                       "--gdt-budget-mb", "0.05"])
