"""Cells, configurations, mixes and metrics are found by name: a copy of
the benchmark gains a cell file and a metric file, and both are taken up
with no file that was there edited."""

import hashlib
import importlib.util
import json
import os
import shutil

import pytest

from portbench.harness import catalog

BENCH_DIR = os.path.dirname(catalog.ROOT)


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pyc"):
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _load_catalog(root):
    spec = importlib.util.spec_from_file_location(
        "copied_catalog", os.path.join(root, "portbench", "harness",
                                       "catalog.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_new_cell_and_metric_are_taken_up_without_edits(tmp_path):
    root = str(tmp_path)
    shutil.copytree(catalog.ROOT, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(BENCH_DIR, "BENCHMARK.json"), root)
    before = _digests(os.path.join(root, "portbench"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "workloads", "granite_8b.chat_small.json"),
              "w") as f:
        json.dump({"config": "granite_8b", "traffic": "chat_tiered",
                   "driver": "serve", "chips": 1, "why": "a test cell",
                   "traffic_params": {"sessions": {
                       "count": 2, "max_context": 512,
                       "prompt": {"kind": "choice", "values": [64],
                                  "weights": [1]},
                       "turn_tokens": {"kind": "choice", "values": [4],
                                       "weights": [1]},
                       "think_s": {"kind": "exponential", "mean": 1.0}}},
                   "serve": {"hbm_pages": 64}, "correct": {"limits": {}}},
                  f)
    with open(os.path.join(pb, "metrics", "steps_in_window.chat.py"),
              "w") as f:
        f.write('UNIT = "steps"\nBETTER = "higher"\n'
                'SOURCE = "host_clock"\nLAYER = "engine step loop"\n'
                'MOVES = "gen_tokens_per_s"\n\n\ndef read(rec):\n'
                '    return len(rec.step_walls) or None\n')
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "granite_8b.chat_small",
                               "config": "granite_8b",
                               "traffic": "chat_tiered", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({
        "name": "gen_tokens_per_s", "unit": "tokens/s", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["granite_8b.chat_small"]})
    bench["per_layer"].append({
        "name": "steps_in_window.chat", "unit": "steps",
        "better": "higher", "source": "host_clock",
        "layer": "engine step loop", "moves": "gen_tokens_per_s",
        "workloads": ["granite_8b.chat_small"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    cat = _load_catalog(root)
    assert "granite_8b.chat_small" in cat.cells()
    assert "steps_in_window.chat" in cat.metric_names()
    cell = cat.cell("granite_8b.chat_small")
    assert cell["mix"]["sessions"]["count"] == 2
    assert cell["model"]["hidden_size"] == 4096
    names = [m["name"] for m in cat.metrics_for(
        cat.benchmark(root), "granite_8b.chat_small", trace=True)]
    assert names == ["steps_in_window.chat"]
    e2e = [m["name"] for m in cat.metrics_for(
        cat.benchmark(root), "granite_8b.chat_small", trace=False)]
    assert sorted(e2e) == ["gen_tokens_per_s", "setup_s"]

    class Rec:
        step_walls = [(1.0, 0.1)] * 3

    assert cat.metric_module("steps_in_window.chat").read(Rec()) == 3
    after = _digests(pb)
    changed = {k for k in before if before[k] != after.get(k)}
    assert not changed
    assert set(after) - set(before) == {
        os.path.join("workloads", "granite_8b.chat_small.json"),
        os.path.join("metrics", "steps_in_window.chat.py")}


def test_every_benchmark_entry_has_its_files():
    bench = catalog.benchmark(BENCH_DIR)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(BENCH_DIR, c["file"]))
    for w in bench["workloads"]:
        cell = catalog.cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = catalog.metric_module(m["name"])
        assert mod.UNIT == m["unit"] and mod.BETTER == m["better"]
        assert mod.SOURCE == m["source"]
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_reports_setup_another_metric_and_a_layer(trace):
    bench = catalog.benchmark(BENCH_DIR)
    for w in bench["workloads"]:
        names = [m["name"] for m in catalog.metrics_for(bench, w["name"],
                                                        trace)]
        if trace:
            assert names
        else:
            assert "setup_s" in names and len(names) >= 2
