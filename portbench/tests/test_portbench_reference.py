"""The plain references against the port's SMOKE models on the CPU: the
port's float32 path agrees with them to rounding, its bfloat16 path
within the serving cells' limits."""

import time

import pytest
import torch

from portbench.harness import correct, serve, train, weights as W
from portbench.reference import decoder, training

from .tiny import tiny_cell


def smoke_config(arch: str, dtype: str = "float32") -> dict:
    """A configuration file's keys for the port's SMOKE reduction of
    ``arch``."""
    from repro_torch.configs import get_smoke

    c = get_smoke(arch)
    m = {"family": c.family, "num_hidden_layers": c.n_layers,
         "hidden_size": c.d_model, "num_attention_heads": c.n_heads,
         "num_key_value_heads": c.kv_heads,
         "head_dim": c.resolved_head_dim, "intermediate_size": c.d_ff,
         "vocab_size": c.vocab, "rope_theta": c.rope_theta,
         "rms_norm_eps": 1e-6, "torch_dtype": dtype}
    if c.n_experts:
        m.update(num_local_experts=c.n_experts,
                 num_experts_per_tok=c.top_k)
    return m


@pytest.mark.parametrize("arch", ["granite_8b", "granite_moe_3b_a800m"])
def test_port_f32_logits_equal_the_reference(arch, cpu):
    """Prefill then decode through the paged engine, in float32, against
    the reference's whole-sequence logits."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.sampling import SamplingParams

    m = smoke_config(arch)
    model, weights = W.build_model(m, 2 ** 31 + 3, cpu)
    llm = LLM(model, ServeConfig(keep_logits=True, hbm_pages=32,
                                 host_pages=32, max_pages_per_seq=8))
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, m["vocab_size"], (37,), generator=g).tolist()
    h = llm.submit(prompt, SamplingParams(max_tokens=6))
    got = []
    engine = serve.engine_of(llm)
    while not h.finished:
        llm.step()
        if 0 in engine.last_logits:
            got.append(torch.from_numpy(engine.last_logits[0].copy()))
    seq = prompt + h.token_ids
    ref = decoder.logits_at(weights, m, seq[:-1],
                            range(len(prompt) - 1, len(seq) - 1))
    # The last step finishes the request, which drops its logits.
    assert len(got) == len(h.token_ids) - 1
    torch.testing.assert_close(torch.stack(got), ref[:len(got)], rtol=1e-4,
                               atol=1e-4)
    assert correct.serve_gaps(weights, m, {0: prompt}, {0: h.token_ids},
                              [0]) == [0.0] * len(h.token_ids)


@pytest.mark.parametrize("name", ["granite_8b.chat_tiered",
                                  "granite_moe_3b_a800m.chat_tiered",
                                  "granite_8b.rag_resident"])
def test_port_bf16_serving_stays_within_the_cell_limit(name, cpu):
    cell = tiny_cell(name)
    rec, drv, weights, _ = serve.run_cell(cell, 11, 1.5, False, cpu,
                                          time.perf_counter())
    rids = correct.serve_sample(drv.served, drv.greedy, 11, 400, 6)
    assert rids
    gaps = correct.serve_gaps(weights, cell["model"], drv.prompts,
                              drv.served, rids)
    limit = cell["correct"]["limits"]["max_logit_gap"]
    assert max(gaps) <= limit
    assert rec.failed == 0


def test_port_f32_training_follows_the_reference(cpu):
    """Three steps of the port's Trainer in float32 against the plain
    float32 training: every number of the check under 1e-4."""
    cell = tiny_cell("granite_moe_3b_a800m.train_4x2048")
    cell["model"] = smoke_config("granite_moe_3b_a800m")
    rec, readings, _, _ = train.run_cell(cell, 2 ** 31 + 9, 0.5, False,
                                         cpu, time.perf_counter())
    m, mix = cell["model"], cell["mix"]
    batches = [(b["tokens"], b["labels"]) for b in (
        train.batch(2 ** 31 + 9, i, m["vocab_size"], mix["batch"],
                    mix["seq"], cpu) for i in range(3))]
    ref = training.run(W.draw(m, 2 ** 31 + 9, cpu), m, batches,
                       cell["train"]["optimizer"])
    numbers = correct.train_numbers(readings, ref)
    assert max(numbers.values()) < 1e-4, numbers
