"""The metric readers' arithmetic on recorded fixtures, and the work
formulas against hand-counted shapes."""

import pytest
import torch

from portbench.harness import catalog, record, serve, trace
from portbench.metrics import _common as C
from portbench.metrics import work


def read(name, rec):
    return catalog.metric_module(name).read(rec)


def serve_record():
    """Two requests in a window [10, 20]: one due at 10 with tokens at
    11, 11.5, 12.5; one due at 15 with tokens at 16, 16.25; one due at
    21 (outside) with a token at 22."""
    recs = [serve.Due(1, 10.0, "x", [11.0, 11.5, 12.5], 10.1),
            serve.Due(2, 15.0, "x", [16.0, 16.25], 15.3),
            serve.Due(3, 21.0, "x", [22.0], 21.0)]
    return record.Record(
        kind="serve", window=(10.0, 20.0), records=recs,
        token_times=[11.0, 11.5, 12.5, 16.0, 16.25, 22.0],
        lateness=[(10.0, 10.1), (15.0, 15.3), (21.0, 21.0)],
        step_walls=[(11.0, 0.5), (12.5, 1.0), (16.0, 0.25), (22.0, 9.0)],
        stats0={"bytes_moved": 100, "admissions": 1,
                "admission_wait_steps": 2},
        stats1={"bytes_moved": 1100, "admissions": 3,
                "admission_wait_steps": 8},
        setup_s=42.0, drain_end=30.0, model={}, cell={})


def test_end_to_end_serving_readers():
    rec = serve_record()
    assert read("gen_tokens_per_s", rec) == pytest.approx(5 / 10.0)
    # ttft of the two due in the window: 1000 and 1000 ms.
    assert read("ttft_p90_ms", rec) == pytest.approx(1000.0)
    # gaps 500, 1000, 250 ms: nearest-rank p98 of three is the largest.
    assert read("itl_p98_ms", rec) == pytest.approx(1000.0)
    assert read("itl_p95_ms.chat", rec) == pytest.approx(1000.0)
    assert read("setup_s", rec) == 42.0


def test_per_layer_serving_readers():
    rec = serve_record()
    assert read("arrival_lateness_ms.chat", rec) == pytest.approx(300.0)
    assert read("admission_wait_steps.rag", rec) == pytest.approx(3.0)
    assert read("kv_bytes_per_token.chat", rec) == pytest.approx(200.0)
    assert read("engine_step_ms.rag", rec) == pytest.approx(
        (500 + 1000 + 250) / 3)
    # Nothing traced: the span and device readers read nothing.
    for name in ("decode_ms_per_step.chat", "migration_share.chat",
                 "guidance_ms_per_step.chat", "device_idle.chat",
                 "mfu.chat", "paged_decode_roofline.chat",
                 "prefill_ms_per_ktok.rag"):
        assert read(name, rec) is None


def test_a_request_without_a_token_counts_to_the_drain_end():
    rec = serve_record()
    rec.records[1].tokens = []
    assert sorted(C.ttft_ms(rec)) == pytest.approx([1000.0, 15000.0])


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert C.percentile(v, 90) == 90
    assert C.percentile(v, 95) == 95
    assert C.percentile([3.0], 90) == 3.0
    assert C.percentile([], 90) is None


def test_span_readers():
    sp = trace.Spans()
    sp.total = {"decode": 0.3, "guidance": 0.5, "migration.exchange": 0.2,
                "migration.swap_in": 0.1, "prefill": 2.0}
    sp.calls = {"decode": 3, "guidance": 5, "migration.exchange": 2,
                "migration.swap_in": 1, "prefill": 1}
    sp.nested = {("guidance", "migration.swap_in"): 0.1}
    sp.notes = {"prefill_tokens": 4000}
    rec = record.Record(spans=sp, spans_wall=2.0)
    assert read("decode_ms_per_step.chat", rec) == pytest.approx(100.0)
    assert read("guidance_ms_per_step.chat", rec) == pytest.approx(80.0)
    assert read("migration_share.chat", rec) == pytest.approx(15.0)
    assert read("prefill_ms_per_ktok.rag", rec) == pytest.approx(500.0)


def test_outermost_leaves_out_nested_spans():
    sp = trace.Spans()
    sp.total = {"a": 1.0, "b": 0.4}
    sp.nested = {("a", "b"): 0.4}
    assert sp.outermost(("a", "b")) == pytest.approx(1.0)


def test_paged_decode_work_by_hand():
    # Two live rows of 17 and 32 tokens, one inactive; H 4, K 2, dh 8,
    # pages of 16, bf16.
    fl, nb = work.paged_decode([17, 32, 0], 4, 2, 8, 16, 2)
    assert fl == 4 * 4 * 8 * (17 + 32)
    # q and out: 2 * H * dh * 2 B a row; pages 2 + 2 of K and V.
    assert nb == 2 * (2 * 4 * 8 * 2) + 4 * (2 * 16 * 2 * 8 * 2)


def test_paged_prefill_work_by_hand():
    fl, nb = work.paged_prefill(3, 16, 4, 2, 8, 16, 2)
    assert fl == 4 * 4 * 8 * (17 + 18 + 19)
    assert nb == 2 * 3 * 4 * 8 * 2 + 2 * (2 * 16 * 2 * 8 * 2)


def test_grouped_ffn_work_by_hand():
    # Groups of 5, 0 and 3 rows: 8 rows, two experts used; d 4, f 6.
    fl, nb = work.grouped_ffn(8, 2, 4, 6, 2)
    assert fl == 6 * 8 * 4 * 6
    assert nb == 2 * 8 * 4 * 2 + 2 * 3 * 4 * 6 * 2
    fl, nb = work.grouped_ffn_bwd(8, 2, 3, 4, 6, 2)
    assert fl == 16 * 8 * 4 * 6
    assert nb == 3 * 8 * 4 * 2 + (2 + 3) * 3 * 4 * 6 * 2


def test_flash_work_by_hand():
    fl, nb = work.flash(2, 8, 8, 4, 2, 16, True, 2, backward=False)
    assert fl == 2 * 2 * 4 * 8 * 8 * 16
    q, kv, lse = 2 * 8 * 4 * 16 * 2, 2 * 8 * 2 * 16 * 2, 2 * 4 * 8 * 4
    assert nb == 2 * q + 2 * kv + lse
    fl_b, nb_b = work.flash(2, 8, 8, 4, 2, 16, True, 2, backward=True)
    assert fl_b == 2.5 * fl and nb_b == 4 * q + 4 * kv + lse


def test_model_flops_by_hand():
    m = {"hidden_size": 8, "num_attention_heads": 2,
         "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
         "vocab_size": 10, "num_hidden_layers": 3}
    n = 3 * (8 * 2 * 4 * 2 + 8 * 1 * 4 * 2 + 3 * 8 * 16) + 8 * 10
    assert work.active_params(m) == n
    assert work.serve_flops(m, [5, 7]) == 2 * n * 2 + 4 * 3 * 2 * 4 * 12
    assert work.train_flops(m, 2, 4) == 6 * n * 8 + 3 * 3 * 2 * 2 * 2 * 16 * 4
    moe = dict(m, num_local_experts=4, num_experts_per_tok=2)
    assert work.active_params(moe) == 3 * (
        8 * 2 * 4 * 2 + 8 * 1 * 4 * 2 + 2 * 3 * 8 * 16 + 8 * 4) + 8 * 10


def _slice(calls, events, window=1.0):
    return trace.DeviceSlice(events=events, window_s=window,
                             busy_s=trace._busy(events), host_marks=[],
                             calls=calls)


def test_paged_rooflines_match_launches_in_order():
    m = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 8, "num_hidden_layers": 2}
    calls = [("decode_pass", {"lengths": torch.tensor([17, 32]),
                              "mask": [True, False]}),
             ("prefill_pass", {"n_real": 3, "start": 16})]
    k = "void paged_attention_mma<128>(...)"
    events = [(k, 0.0, 1e-6), (k, 1e-6, 2e-6), ("gemm", 2e-6, 3e-6),
              (k, 3e-6, 5e-6), (k, 5e-6, 7e-6)]
    rec = record.Record(model=m, cell={"serve": {"page_size": 16}},
                        device=_slice(calls, events))
    dec = work.least_s(*work.paged_decode([17, 0], 4, 2, 8, 16, 2))
    pre = work.least_s(*work.paged_prefill(3, 16, 4, 2, 8, 16, 2))
    assert read("paged_decode_roofline.chat", rec) == pytest.approx(
        100 * 2 * dec / 2e-6)
    assert read("paged_prefill_roofline.rag", rec) == pytest.approx(
        100 * 2 * pre / 4e-6)
    # A launch count that does not match the calls reads nothing.
    rec.device = _slice(calls, events[:3])
    assert read("paged_decode_roofline.chat", rec) is None


def test_idle_and_mfu_from_the_slice():
    events = [("a", 0.0, 0.2), ("b", 0.1, 0.3), ("c", 0.5, 0.6)]
    rec = record.Record(device=_slice([], events, window=1.0))
    assert rec.device.busy_s == pytest.approx(0.4)
    assert read("device_idle.chat", rec) == pytest.approx(60.0)
    assert C.mfu(989e12 * 0.5, rec) == pytest.approx(50.0)


def test_breakdown_attributes_idle_gaps_to_the_innermost_phase():
    sl = trace.DeviceSlice(
        events=[("k1", 0.0, 1.0), ("k2", 2.0, 2.5), ("k1", 4.0, 4.5)],
        window_s=5.0, busy_s=2.0,
        host_marks=[(0.5, 3.5, "decode"), (1.2, 1.8, "prefill")],
        calls=[])
    b = trace.breakdown(sl)
    assert b["device_ops"][0] == ["k1", 1.5]
    assert dict((n, s) for n, s in b["idle_gaps"]) == pytest.approx(
        {"prefill": 1.0, "decode": 1.5})


def test_a_traced_training_run_patches_and_restores_the_trainer(cpu):
    """The port's optimizer is a frozen dataclass: its span goes into the
    instance's dictionary and leaves it again, as the kernels' do on their
    classes."""
    from repro_torch.kernels.flash_attention import FlashAttention

    from portbench.harness import train

    from .tiny import tiny_cell

    trainer, _ = train.build(tiny_cell("granite_moe_3b_a800m.train_4x2048"),
                             7, cpu)
    backward = FlashAttention.backward
    patches = (train.train_patches(trainer, trace.Spans())
               + train.profile_patches(trainer, trace.Calls(), []))
    with trace.patched(patches):
        assert "update" in vars(trainer.opt)
        assert FlashAttention.backward is not backward
    assert "update" not in vars(trainer.opt)
    assert FlashAttention.backward is backward
