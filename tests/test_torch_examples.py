"""The port's four walkthroughs under ``examples/*_torch.py``, on the CPU
at their smoke sizes (``--device cpu``; the training walkthrough
``--tiny --steps 6``): the policy playground prints what the JAX one
prints, byte for byte; the quickstart lists the same architectures and its
first training loss is the JAX ``Trainer``'s on the same f32 weights and
batch (rtol 1e-4, the training slice's loss tolerance); the serving
walkthrough's greedy streams are equal, bit for bit, across its three
eviction policies, every policy moves pages, and its workload gives the
JAX ``LLM``'s streams on the same f32 weights; the training walkthrough's
losses are finite, it reports its tiering, and its loss curve and host
tier follow the JAX ``Trainer``'s on the same f32 weights.  Without
``--device`` each walkthrough asks for the card and, with none, raises.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import math
import os

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
CPU = ["--device", "cpu"]
NAMES = ("policy_playground_torch", "quickstart_torch",
         "serve_guided_kv_torch", "train_guided_offload_torch")


def example(name):
    """The walkthrough ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = main(argv)
    return got, out.getvalue()


def test_policy_playground_prints_what_the_jax_one_prints():
    _, ours = run(example("policy_playground_torch").main, CPU)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        example("policy_playground").main()
    assert ours == out.getvalue()
    assert "recommendation engines" in ours


@pytest.fixture(scope="module")
def quickstart():
    return run(example("quickstart_torch").main, CPU)


def test_quickstart_lists_the_jax_architectures(quickstart):
    from repro.configs import ARCHS as JARCHS

    _, out = quickstart
    assert out.splitlines()[0] == \
        f"registered architectures: {', '.join(JARCHS)}"


def test_quickstart_trains_and_generates(quickstart):
    got, out = quickstart
    assert got["steps"] == 20 and len(got["losses"]) == 4
    assert all(math.isfinite(x) for x in got["losses"])
    assert got["losses"][-1] < got["losses"][0]
    assert len(got["token_ids"]) == 8
    assert "prompt: [5, 42, 17] ->" in out


def test_quickstart_first_loss_matches_the_jax_trainer():
    """The quickstart's training (AdamW lr 1e-2, no weight decay;
    ``SyntheticLM`` seq 64, batch 8, seed 0) from the JAX model's f32
    weights, carried across by ``convert.params_from_numpy``: its first
    step's loss is the JAX ``Trainer``'s."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke as jget_smoke
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.models import build_model
    from repro.optim import AdamW as JAdamW
    from repro.train import Trainer as JTrainer
    from repro.train import TrainerConfig as JTrainerConfig
    from repro_torch.convert import config_from_reference, params_from_numpy
    from repro_torch.models import Model

    qs = example("quickstart_torch")
    jm = build_model(dataclasses.replace(jget_smoke("llama3_2_1b"),
                                         remat=False))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    opt = JAdamW(lr=1e-2, weight_decay=0.0)
    jtr = JTrainer(jm, opt, JTrainerConfig(steps=1, log_every=1, seed=0))
    jtr.params = jax.tree.map(jnp.copy, jp)      # the step donates them
    jtr.opt_state = opt.init(jtr.params)
    src = JSyntheticLM(jm.cfg.vocab, seq_len=64, global_batch=8, seed=0)
    jtr.run(iter([{k: jnp.asarray(v) for k, v in src.batch_np(0).items()}]))

    cfg = dataclasses.replace(config_from_reference(jm.cfg),
                              dtype=torch.float32)
    assert cfg == dataclasses.replace(qs.config(), dtype=torch.float32)
    model = Model(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    trainer, _ = qs.train(model, steps=1, log_every=1, params=params)
    np.testing.assert_allclose(trainer.metrics_log[0]["loss"],
                               jtr.metrics_log[0]["loss"], rtol=1e-4)


def test_serving_streams_equal_across_policies_and_pages_move():
    """The walkthrough as it runs, 12 HBM pages: greedy streams bitwise
    equal under gdt, lru and fifo, and pages moved under each.  What the
    streams hold is checked against the JAX ``LLM`` below."""
    runs, out = run(example("serve_guided_kv_torch").main, CPU)
    assert sorted(runs) == ["fifo", "gdt", "lru"]
    base = runs["gdt"]["streams"]
    assert len(base) == 9 and all(base[rid] for rid in (0, 1, 2, 3))
    for policy, r in runs.items():
        assert r["streams"] == base, policy
        s = r["stats"]
        assert s["swap_ins"] > 0 and s["swap_outs"] > 0, (policy, s)
        assert s["bytes_moved"] > 0
    assert "greedy streams equal across gdt, lru, fifo: True" in out


def test_serving_streams_follow_the_jax_llm():
    """The walkthrough's workload (``drive``) through the JAX ``LLM`` on the
    JAX smoke model's f32 weights, with every page resident: its host-tier
    gather (``repro/serve/kvcache.py:298``) fails on this tree's jax, so
    the JAX run must not swap.  The port's run of the same workload with
    every page resident gives the same streams under gdt, lru and fifo.
    The walkthrough's tiered runs (12 HBM pages) schedule differently, so
    a stream may be shorter or longer, but a greedy stream depends only on
    its prompt: each of theirs is a prefix of the JAX stream of its prompt
    (the four sessions share theirs: the longest session's)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke as jget_smoke
    from repro.models import build_model
    from repro.serve import LLM as JLLM
    from repro.serve import SamplingParams as JSamplingParams
    from repro.serve import ServeConfig as JServeConfig
    from repro_torch.convert import config_from_reference, params_from_numpy
    from repro_torch.models import Model
    from repro_torch.serve import LLM, ServeConfig

    jm = build_model(dataclasses.replace(jget_smoke("llama3_2_1b"),
                                         remat=False, dtype=jnp.float32))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    resident = dict(max_batch=2, page_size=4, hbm_pages=160, host_pages=160,
                    interval_steps=4)
    # A module of its own whose workload submits the JAX SamplingParams.
    jex = example("serve_guided_kv_torch")
    jex.SamplingParams = JSamplingParams
    jllm = JLLM(jm, jp, JServeConfig(policy="lru", **resident))
    want = jex.drive(jllm)
    assert jllm.stats()["swap_ins"] == 0 and jllm.stats()["swap_outs"] == 0
    sessions = (0, 1, 2, 3)
    assert len(want) == 9 and all(want.values())

    sv = example("serve_guided_kv_torch")
    model = Model(config_from_reference(jm.cfg), device="cpu")
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu"))
    longest = max((want[rid] for rid in sessions), key=len)
    for policy in sv.POLICIES:
        llm = LLM(model, ServeConfig(policy=policy, **resident))
        assert sv.drive(llm) == want, policy
        assert llm.stats()["swap_ins"] == 0, policy
        tiered = sv.run_policy(model, policy)
        assert tiered["stats"]["swap_ins"] > 0, policy
        got = tiered["streams"]
        assert got.keys() == want.keys()
        for rid, stream in got.items():
            ref = longest if rid in sessions else want[rid]
            assert stream and stream == ref[:len(stream)], (policy, rid)


def test_training_walkthrough_losses_and_tiering():
    got, out = run(example("train_guided_offload_torch").main,
                   CPU + ["--tiny", "--steps", "6"])
    losses = got["losses"]
    assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    assert "tiering outcome:" in out
    assert "resident on host tier:" in out
    assert got["result"]["transfer_bytes"] > 0
    assert got["slow_groups"], "the 60% budget leaves nothing on the host"


def test_training_walkthrough_follows_the_jax_trainer():
    """The walkthrough's ``--tiny`` widths in f32, 6 steps, its schedule,
    batches and guidance (60% of the state's bytes in HBM) on both sides,
    from the JAX model's weights, AdamW's eps at 1e-4 on both sides (see
    below).  The first two losses, before and after one update, within
    rtol 1e-4 (the training slice's loss tolerance); the same groups, with
    the same bytes, on the host tier.  From the third step on, AdamW at
    the walkthrough's peak rate of 3e-3 amplifies round-off by one to two
    orders of magnitude a step: a change of one weight tensor in its last
    bits moves the later losses in the third decimal, so the whole curve
    is held only within rtol 1e-2."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import GuidanceConfig as JGuidanceConfig
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.models import build_model
    from repro.optim import AdamW as JAdamW
    from repro.optim import cosine_schedule as jcosine
    from repro.train import Trainer as JTrainer
    from repro.train import TrainerConfig as JTrainerConfig
    from repro_torch.convert import config_from_reference, params_from_numpy
    from repro_torch.models import Model
    from repro_torch.models.common import count_params

    steps = 6
    tr = example("train_guided_offload_torch")
    jm = build_model(dataclasses.replace(
        example("train_guided_offload").make_config(True),
        dtype=jnp.float32))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(tr.make_config(True), dtype=torch.float32)
    assert config_from_reference(jm.cfg) == cfg
    model = Model(cfg, device="cpu")
    n = count_params(model.param_defs())
    gdt = tr.guidance(int((n * 2 + 2 * n * 4) * 0.6))

    # The JAX trainer binds what ``init`` returns to its tiers: f32 here.
    jm.init = lambda rng: jax.tree.map(jnp.copy, jp)
    # AdamW's eps at 1e-4 on both sides, as in the training slice's
    # trajectory test: at the default 1e-8 an entry whose gradient is
    # round-off takes a full step of either sign, and two f32 evaluations
    # of the same model part from the second step on.
    tr.AdamW = functools.partial(tr.AdamW, eps=1e-4)
    jtr = JTrainer(jm, JAdamW(lr=jcosine(3e-3, warmup=steps // 10,
                                         total=steps), eps=1e-4),
                   JTrainerConfig(steps=steps, log_every=1, seed=0,
                                  gdt=JGuidanceConfig(
                                      **dataclasses.asdict(gdt))))
    src = JSyntheticLM(cfg.vocab, seq_len=tr.seq_len(True), global_batch=8,
                       seed=0)
    jtr.run({k: jnp.asarray(v) for k, v in src.batch_np(i).items()}
            for i in range(steps))

    trainer, _ = tr.train(model, steps, tr.seq_len(True), gdt,
                          params=params_from_numpy(
                              jax.tree.map(np.asarray, jp), "cpu"))
    got = [m["loss"] for m in trainer.metrics_log]
    want = [m["loss"] for m in jtr.metrics_log]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-2)

    def host_groups(tr, on_host):
        return sorted((key, sum(e.nbytes for e in
                                tr.placer.entries(arena.arena_id)
                                if on_host(e)))
                      for key, (_, arena, _) in tr._site_groups.items())

    slow = host_groups(trainer, lambda e: e.kind == trainer.placer.slow_kind)
    assert slow == host_groups(
        jtr, lambda e: e.array.sharding.memory_kind == "pinned_host")
    assert any(b for _, b in slow)


@pytest.mark.parametrize("name", NAMES)
def test_walkthroughs_ask_for_the_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example(name).main([])
