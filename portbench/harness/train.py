"""The training driver: one ``repro_torch.train.Trainer`` built in set-up,
driven through its first steps (the steps the reference follows), then
through the window, one ``Trainer.run`` call a step, which waits for the
step's loss on the host.

A step's batch is ``batch`` rows of ``seq + 1`` token ids drawn on the
device from (seed, step): tokens are the first ``seq``, labels the last."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import trace, weights as W
from .trace import clock


def batch(seed: int, step: int, vocab: int, rows: int, seq: int, device):
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1000003 + step) % (1 << 63))
    t = torch.randint(0, vocab, (rows, seq + 1), generator=gen,
                      device=device, dtype=torch.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def build(cell: Dict, seed: int, device):
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import Trainer, TrainerConfig

    m = cell["model"]
    model, weights = W.build_model(m, seed, device)
    o = cell["train"]["optimizer"]
    opt = AdamW(lr=float(o["lr"]), b1=float(o["b1"]), b2=float(o["b2"]),
                eps=float(o["eps"]), weight_decay=float(o["weight_decay"]),
                grad_clip=float(o["grad_clip"]))
    trainer = Trainer(model, opt, TrainerConfig(steps=1, log_every=0),
                      params=weights)
    return trainer, weights


def step(trainer, b) -> float:
    """One step through the trainer's own loop; its loss on the host."""
    return float(trainer.run([b])["final_loss"])


def train_patches(trainer, spans: trace.Spans) -> List:
    return [(trainer.opt, "update", spans.wrap("optimizer"))]


def profile_patches(trainer, calls: trace.Calls, marks) -> List:
    import repro_torch.kernels.ops as ops
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.kernels.moe_gemm import GroupedFFN

    def ffn_info(x, w_gate, w_up, w_down, group_sizes, group_experts=None):
        return {"rows": x.shape[0], "d": w_gate.shape[1],
                "f": w_gate.shape[2], "item": x.element_size(),
                "sizes": group_sizes, "experts": group_experts,
                "n_weights": w_gate.shape[0]}

    def latest(kind):
        # A backward reads no saved tensor here (checkpointing lets them be
        # unpacked once): its shapes are those of the latest forward of its
        # kind, since every layer of the stack runs the same shapes.
        return next((dict(info) for k, info in reversed(calls.log)
                     if k == kind), None)

    def ffn_bwd_info(ctx, dy):
        return latest("grouped_ffn")

    def flash_info(q, k, v, causal=True, window=None):
        return {"q": tuple(q.shape), "k": tuple(k.shape), "causal": causal,
                "item": q.element_size()}

    def flash_bwd_info(ctx, dout):
        return latest("flash")

    return [
        (ops, "moe_grouped_ffn", calls.record("grouped_ffn", ffn_info)),
        (GroupedFFN, "backward", calls.record("grouped_ffn_bwd",
                                              ffn_bwd_info)),
        (ops, "flash_attention", calls.record("flash", flash_info)),
        (FlashAttention, "backward", calls.record("flash_bwd",
                                                  flash_bwd_info)),
        (trainer, "step_fn", calls.record("train_step", lambda *a: {})),
        (trainer.opt, "update", trace.marking(marks, "optimizer")),
        (trainer, "step_fn", trace.marking(marks, "train step")),
    ]


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0
               ) -> Dict[str, float]:
    return {n: float(t.float().norm()) * scale for n, t in tensors.items()}


def run_cell(cell: Dict, seed: int, seconds: float, traced: bool, device,
             t_process: float, parts=(0.5, 0.25, 0.25)):
    """Set up (the first steps, recorded for the check), then the window.
    Returns (record, readings of the first steps)."""
    from . import record

    m, tc = cell["model"], cell["train"]
    rows, seq = int(cell["mix"]["batch"]), int(cell["mix"]["seq"])
    vocab = m["vocab_size"]
    n_check = int(tc["check_steps"])
    trainer, weights = build(cell, seed, device)
    b1 = float(tc["optimizer"]["b1"])
    losses, grads = [], {}
    for i in range(n_check):
        losses.append(step(trainer, batch(seed, i, vocab, rows, seq, device)))
        if i == 0:
            grads = leaf_norms(trainer.opt_state.m, 1.0 / (1.0 - b1))
    start = W.draw(m, seed, device)
    change = {n: float((trainer.params[n].float() - start[n].float()).norm())
              for n in trainer.params}
    del start
    readings = {"losses": losses, "grad_norms": grads,
                "change_norms": change}
    trace.reset_peak(device)
    w0 = clock()
    rec = record.Record(kind="train", cell=cell, model=m,
                        setup_s=w0 - t_process)
    shares = parts if traced else (1.0,)
    ends = [w0 + seconds * sum(shares[:i + 1]) for i in range(len(shares))]
    k = n_check

    def steps_until(t_end):
        nonlocal k
        while clock() < t_end:
            b = batch(seed, k, vocab, rows, seq, device)
            t_a = clock()
            step(trainer, b)
            rec.steps.append((t_a, clock(), rows * seq))
            k += 1

    steps_until(ends[0])
    rec.window = (w0, rec.steps[-1][1] if rec.steps else clock())
    if traced:
        spans = trace.Spans()
        tb = clock()
        with trace.patched(train_patches(trainer, spans)):
            steps_until(ends[1])
        rec.spans, rec.spans_wall = spans, clock() - tb
        calls, marks = trace.Calls(), []
        with trace.patched(profile_patches(trainer, calls, marks)):
            rec.device = trace.profiled(
                lambda: steps_until(clock() + seconds * shares[2]),
                calls, marks)
    rec.memory_peak_bytes = trace.peak_bytes(device)
    rec.attempted = len(rec.steps)
    rec.failed = 0
    rec.batch_rows, rec.seq = rows, seq
    return rec, readings, trainer, weights
