"""The check that decides ``correct`` fails what it must: the control
(the reference in float8, the precision below the configured bfloat16)
and a run whose timed path is broken underneath.  Each runs the rest of a
run, past the look for a card, on the CPU at a tiny size."""

import time

import pytest
import torch

from portbench.harness import correct, main, serve, train, weights as W
from portbench.harness.trace import clock
from portbench.reference.decoder import FP8

from .tiny import tiny_cell

SERVING = ["granite_8b.chat_tiered", "granite_moe_3b_a800m.chat_tiered",
           "granite_8b.rag_resident"]


def _run(cell, seed, cpu, finish=False):
    """A tiny run of ``cell``; with ``finish``, every request released in
    the window then runs to its end, so that the check's sample does not
    hang on how far a loaded CPU got."""
    rec, drv, weights, program = serve.run_cell(cell, seed, 1.5, False, cpu,
                                                time.perf_counter())
    if finish:
        drv.run_until(clock() + 300, release=False)
    drv.llm = None
    return rec, drv, weights


# Deep enough that float8 products move the logits as far as at the
# cells' own size; the MoE with every expert picked, since near-ties in a
# tiny router flip bfloat16 picks (the cells' own router does not: PERF.md).
CONTROL_SIZES = {"granite_8b.chat_tiered": {"num_hidden_layers": 16},
                 "granite_8b.rag_resident": {"num_hidden_layers": 16},
                 "granite_moe_3b_a800m.chat_tiered": {
                     "num_hidden_layers": 16, "num_local_experts": 8,
                     "num_experts_per_tok": 8}}


@pytest.mark.parametrize("name", SERVING)
def test_control_fails_the_limit_the_program_passes(name, cpu):
    cell = tiny_cell(name)
    cell["model"].update(CONTROL_SIZES[name])
    limits = cell["correct"]["limits"]
    _, drv, weights = _run(cell, 21, cpu, finish=True)
    rids = correct.serve_sample(drv.served, drv.greedy, 21, 400, 6)
    args = (weights, cell["model"], drv.prompts, drv.served, rids)
    program = {"max_logit_gap": max(correct.serve_gaps(*args))}
    control = {"max_logit_gap": max(correct.serve_gaps(*args,
                                                       control=FP8()))}
    assert correct.verdict(program, limits)
    assert not correct.verdict(control, limits)


@pytest.mark.parametrize("name", SERVING)
def test_a_token_altered_where_it_is_produced_fails(name, cpu, monkeypatch):
    from repro_torch.serve.engine import Engine

    decode = Engine._decode

    def altered(self, *a, **k):
        logits, nxt = decode(self, *a, **k)
        return logits, (nxt + 1) % logits.shape[-1]

    monkeypatch.setattr(Engine, "_decode", altered)
    cell = tiny_cell(name)
    _, drv, weights = _run(cell, 22, cpu)
    numbers = main.check_serve(cell, 22, drv, weights)
    assert not correct.verdict(numbers, cell["correct"]["limits"])


def test_no_greedy_request_reads_as_not_correct(cpu):
    cell = tiny_cell("granite_8b.rag_resident")
    cell["mix"]["streams"][0]["greedy_share"] = 0.0
    _, drv, weights = _run(cell, 23, cpu)
    numbers = main.check_serve(cell, 23, drv, weights)
    assert not correct.verdict(numbers, cell["correct"]["limits"])


def test_an_empty_set_of_limits_is_not_correct():
    assert not correct.verdict({"x": 0.0}, {})


def test_training_check_catches_a_state_left_unchanged():
    ref = {"losses": [10.0, 9.9, 9.8],
           "grad_norms": {"a": 1.0, "b": 2.0, "c": 0.5},
           "change_norms": {"a": 0.1, "b": 0.2, "c": 0.05}}
    stuck = dict(ref, change_norms={"a": 0.0, "b": 0.0, "c": 0.0})
    assert set(correct.train_numbers(ref, ref).values()) == {0.0}
    assert correct.train_numbers(stuck, ref)["change_gap"] == 1.0


def test_training_leaves_moved_by_round_off_are_left_out():
    ref = {"losses": [1.0], "grad_norms": {"a": 1.0, "b": 1.0, "k": 1e-7},
           "change_norms": {"a": 0.1, "b": 0.1, "k": 0.1}}
    prog = dict(ref, change_norms={"a": 0.1, "b": 0.1, "k": 0.0})
    assert correct.train_numbers(prog, ref)["change_gap"] == 0.0


def _train_check(cell, seed, cpu):
    """A training run's set-up on the CPU, then the benchmark's check."""
    rec, readings, program, weights = train.run_cell(
        cell, seed, 0.0, False, cpu, time.perf_counter())
    return main.check_train(cell, seed, readings, cpu)


def test_training_control_fails_the_limits_the_program_passes(cpu):
    from portbench.reference import training

    cell = tiny_cell("granite_moe_3b_a800m.train_4x2048")
    limits = cell["correct"]["limits"]
    seed = 2 ** 31 + 31
    _, readings, _, _ = train.run_cell(cell, seed, 0.0, False, cpu,
                                       time.perf_counter())
    m, mix = cell["model"], cell["mix"]
    batches = [(b["tokens"], b["labels"]) for b in (
        train.batch(seed, i, m["vocab_size"], mix["batch"], mix["seq"], cpu)
        for i in range(cell["train"]["check_steps"]))]
    start = W.draw(m, seed, cpu)
    ref = training.run(start, m, batches, cell["train"]["optimizer"])
    control = training.run(start, m, batches, cell["train"]["optimizer"],
                           prec=FP8())
    assert correct.verdict(correct.train_numbers(readings, ref), limits)
    assert not correct.verdict(correct.train_numbers(control, ref), limits)


def test_a_training_step_that_leaves_its_state_unchanged_fails(
        cpu, monkeypatch):
    from repro_torch.optim.adamw import AdamW

    def unchanged(self, grads, state, params, *a, **k):
        return params, state, torch.zeros(())

    monkeypatch.setattr(AdamW, "update", unchanged)
    cell = tiny_cell("granite_moe_3b_a800m.train_4x2048")
    numbers = _train_check(cell, 2 ** 31 + 32, cpu)
    assert numbers["change_gap"] == 1.0
    assert not correct.verdict(numbers, cell["correct"]["limits"])


def test_half_of_each_training_batch_left_out_fails(cpu, monkeypatch):
    from repro_torch.train.trainer import Trainer

    run = Trainer.run

    def half(self, batches, *a, **k):
        return run(self, [{n: t[:t.shape[0] // 2] for n, t in b.items()}
                          for b in batches], *a, **k)

    monkeypatch.setattr(Trainer, "run", half)
    cell = tiny_cell("granite_moe_3b_a800m.train_4x2048")
    numbers = _train_check(cell, 2 ** 31 + 33, cpu)
    assert not correct.verdict(numbers, cell["correct"]["limits"])
