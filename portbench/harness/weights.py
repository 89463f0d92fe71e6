"""Random weights drawn on the device from ``--seed``, in the type they
are served in, in a few large calls.

The benchmark owns the weights: it draws every leaf of a dense or MoE
decoder from its configuration file, hands the same tensors to the port's
``Model`` (``load_into``) and to the plain reference, and can draw them
again bit for bit (the reference of a training cell starts from the
weights before the first step).  The names are the port's state-dict
names, so that the port can take the tensors without a copy.

Statistics: norm scales 1; the embedding N(0, 1); the router, every
projection and the head N(0, 1/fan_in), fan_in being the width each
product sums over (d for q, k, v, gate, up, router and head; H * dh for
the attention's output; the FFN width for down), so that every block adds
about unit variance to the residual stream and the logits have unit
spread.  Leaves of one standard deviation lie side by side in one flat
buffer per dtype: one ``normal_`` per buffer, one ``mul_`` per group."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def leaves(m: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, group, std) of every leaf of configuration ``m``;
    group is ``norm``, ``embed``, ``bf16`` or ``router`` (f32)."""
    d, L = m["hidden_size"], m["num_hidden_layers"]
    H, K = m["num_attention_heads"], m["num_key_value_heads"]
    dh = m.get("head_dim") or d // H
    f, V = m["intermediate_size"], m["vocab_size"]
    E = m.get("num_local_experts", 0)
    out = [("embed.tok", (V, d), "embed", 1.0)]
    for i in range(L):
        p = f"layers.{i}."
        out += [(p + "ln1.scale", (d,), "norm", 1.0),
                (p + "attn.wq", (d, H, dh), "bf16", d ** -0.5),
                (p + "attn.wk", (d, K, dh), "bf16", d ** -0.5),
                (p + "attn.wv", (d, K, dh), "bf16", d ** -0.5),
                (p + "attn.wo", (H, dh, d), "bf16", (H * dh) ** -0.5),
                (p + "ln2.scale", (d,), "norm", 1.0)]
        if E:
            out += [(p + "moe.router", (d, E), "router", d ** -0.5),
                    (p + "moe.w_gate", (E, d, f), "bf16", d ** -0.5),
                    (p + "moe.w_up", (E, d, f), "bf16", d ** -0.5),
                    (p + "moe.w_down", (E, f, d), "bf16", f ** -0.5)]
        else:
            out += [(p + "mlp.w_gate", (d, f), "bf16", d ** -0.5),
                    (p + "mlp.w_up", (d, f), "bf16", d ** -0.5),
                    (p + "mlp.w_down", (f, d), "bf16", f ** -0.5)]
    out += [("final_ln.scale", (d,), "norm", 1.0),
            ("head.w", (d, V), "bf16", d ** -0.5)]
    return out


def draw(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``m`` as a view of one flat buffer of the configured
    dtype (the router: one f32 buffer), drawn from ``seed`` with a
    generator on ``device``."""
    spec = leaves(m)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    out: Dict[str, torch.Tensor] = {}
    # The main buffer: groups ordered (std, then name order) so that each
    # standard deviation is one contiguous range.
    bf = [s for s in spec if s[2] != "router"]
    order = sorted(range(len(bf)), key=lambda i: (bf[i][2] == "norm",
                                                  -bf[i][3], i))
    total = sum(math.prod(bf[i][1]) for i in order)
    flat = torch.empty(total, dtype=getattr(torch, m["torch_dtype"]),
                       device=device)
    flat.normal_(generator=gen)
    off, runs = 0, []
    for i in order:
        name, shape, group, std = bf[i]
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        key = "norm" if group == "norm" else std
        if runs and runs[-1][0] == key:
            runs[-1][2] = off + n
        else:
            runs.append([key, off, off + n])
        off += n
    for key, a, b in runs:
        if key == "norm":
            flat[a:b].fill_(1.0)
        elif key != 1.0:
            flat[a:b].mul_(key)
    rt = [s for s in spec if s[2] == "router"]
    if rt:
        n_r = sum(math.prod(s[1]) for s in rt)
        rflat = torch.empty(n_r, dtype=torch.float32, device=device)
        rflat.normal_(generator=gen).mul_(rt[0][3])
        off = 0
        for name, shape, _, _ in rt:
            n = math.prod(shape)
            out[name] = rflat[off:off + n].view(shape)
            off += n
    return out


def load_into(model, weights: Dict[str, torch.Tensor], device) -> None:
    """Point every parameter of ``model`` (built on the ``meta`` device)
    at the benchmark's tensor of the same name, without a copy, and move
    the model to ``device``."""
    names = [n for n, _ in model.named_parameters()]
    missing = set(names) ^ set(weights)
    if missing:
        raise ValueError(f"weights and model disagree on {sorted(missing)}")
    for name in names:
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        w = weights[name]
        if tuple(w.shape) != tuple(getattr(mod, leaf).shape):
            raise ValueError(f"{name}: drew {tuple(w.shape)}, the model "
                             f"holds {tuple(getattr(mod, leaf).shape)}")
        mod._parameters[leaf] = torch.nn.Parameter(w, requires_grad=False)
    model.device = torch.device(device)


def model_config(m: Dict):
    """The port's ``ModelConfig`` for configuration file ``m``."""
    from repro_torch.models.config import ModelConfig

    E = m.get("num_local_experts", 0)
    return ModelConfig(
        arch=m.get("name", "bench"), family=m["family"],
        n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"], kv_heads=m["num_key_value_heads"],
        head_dim=m.get("head_dim"), d_ff=m["intermediate_size"],
        vocab=m["vocab_size"], rope_theta=float(m["rope_theta"]),
        n_experts=E, top_k=m.get("num_experts_per_tok", 0),
        dtype=getattr(torch, m["torch_dtype"]))


def build_model(m: Dict, seed: int, device):
    """(port model, weights): the model built on ``meta`` and pointed at
    weights drawn on ``device``."""
    from repro_torch.models.transformer import Model

    model = Model(model_config(m), device="meta")
    weights = draw(m, seed, device)
    load_into(model, weights, device)
    return model, weights
