"""Files found by name.

A cell is ``workloads/<cell>.json``; it names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``).
Every metric, end to end or per layer, is ``metrics/<name>.py``.  Which
metrics a run reports comes from ``BENCHMARK.json`` at the checkout's root,
so a later change adds a cell or a metric by adding files and entries,
never by editing one that is there."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(*parts: str) -> Dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def cell(name: str) -> Dict:
    """The cell file with its configuration and traffic mix resolved: the
    mix's parameters, with the cell's ``traffic_params`` over them and its
    ``stream_params`` over each open-loop stream's."""
    c = _json("workloads", f"{name}.json")
    c["name"] = name
    c["model"] = _json("configs", f"{c['config']}.json")
    mix = _json("traffic", f"{c['traffic']}.json")
    mix.update(c.get("traffic_params", {}))
    for st in mix.get("streams", []):
        st.update(c.get("stream_params", {}))
    c["mix"] = mix
    return c


def benchmark(root: str = ".") -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_for(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The entries of ``BENCHMARK.json`` this cell reports: its end-to-end
    metrics in a run without tracing, its per-layer metrics in a traced
    one.  A metric without a ``workloads`` list is reported where the
    end-to-end metric it moves is (per layer) or everywhere (end to end)."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def metric_module(name: str):
    """``metrics/<name>.py`` loaded from its path (a name may hold dots)."""
    path = os.path.join(ROOT, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cells() -> List[str]:
    return sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "workloads"))
                  if f.endswith(".json"))


def metric_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "metrics"))
                  if f.endswith(".py") and f != "work.py"
                  and not f.startswith("_"))
