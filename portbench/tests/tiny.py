"""Tiny cells built from the real cell files, every width cut so that a
run takes seconds on the CPU."""

import copy


def tiny_model(m: dict) -> dict:
    m = copy.deepcopy(m)
    m.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=96,
             vocab_size=256)
    if m.get("num_local_experts"):
        m.update(num_local_experts=8, num_experts_per_tok=2,
                 intermediate_size=32)
    return m


def tiny_cell(name: str) -> dict:
    """The cell ``name`` at a size the CPU runs in seconds."""
    from portbench.harness import catalog

    cell = catalog.cell(name)
    cell["model"] = tiny_model(cell["model"])
    mix = cell["mix"]
    if "warm_in_s" in mix:
        mix["warm_in_s"] = 0.2
    if mix.get("sessions"):
        mix["sessions"].update(
            count=4, max_context=256,
            prompt={"kind": "choice", "values": [40, 72],
                    "weights": [0.5, 0.5]},
            think_s={"kind": "exponential", "mean": 0.2})
    for st in mix.get("streams", []):
        st.update(rate_per_s=2.0,
                  prompt={"kind": "uniform", "low": 30, "high": 90})
    if "serve" in cell:
        cell["serve"].update(hbm_pages=12, host_pages=64, max_batch=4,
                             max_pages_per_seq=20)
    if "batch" in mix:
        mix.update(batch=2, seq=32)
    return cell
