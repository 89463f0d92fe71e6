"""Plain float32 forward of the dense and MoE decoders of the benchmark's
configurations, layer by layer, so that it fits beside nothing else.

One layer: x += Wo . attn(rope(Wq . n1(x)), rope(Wk . n1(x)), Wv . n1(x));
x += ffn(n2(x)), with n(x) = x / sqrt(mean(x^2) + eps) * scale, causal
grouped-query attention scaled by 1/sqrt(dh) (query head h reads key head
h // (H / K)), rotary embedding on the two halves of each head
(theta^(-2i/dh)), and ffn = (silu(x Wg) * (x Wu)) Wd, or for the MoE the
softmax over all experts' router logits, the top k kept and renormalised,
each token's picked experts' ffn summed with those weights.  Logits are
n_f(x) . Whead.  This is what the port computes (its configuration file
lists where that departs from the published model).

``Precision`` rounds the inputs of every product (the weights', the
router's and attention's): ``F32`` leaves them alone; ``FP8`` rounds them
to float8 e4m3 and, in training, the gradients that flow back through them
to e5m2, one scale per tensor (the control that decides the limits)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32


class Precision:
    name = "f32"

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t


def _fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` with a per-tensor scale (amax
    over the type's largest value ``top``), held in float32."""
    s = top / t.abs().amax().clamp(min=1e-30)
    return (t * s).to(dtype).to(F32) / s


class _RoundFP8(torch.autograd.Function):
    """Rounds a product's operand to e4m3 on the way in and the gradient
    that comes back for it to e5m2, the usual pair for float8 training, so
    that the backward products take float8 operands too."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t.detach(), torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class FP8(Precision):
    """Every product's operands in float8 (one scale per tensor): e4m3
    forward, e5m2 for the gradients backward; float32 storage and
    accumulation."""

    name = "fp8"

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundFP8.apply(t)


F32_PRECISION = Precision()


def sizes(m: Dict):
    d, H, K = (m["hidden_size"], m["num_attention_heads"],
               m["num_key_value_heads"])
    return d, H, K, m.get("head_dim") or d // H


def mm(x: torch.Tensor, w: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec(x) @ prec(w.to(F32))


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        scale.to(F32)


def rotary(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, dh) rotated by position: the two halves of each head as
    the real and imaginary parts."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.to(F32)[:, None] * inv[None, :]
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def attend(q, k, v, q_pos, prec: Precision = F32_PRECISION,
           block: int = 512) -> torch.Tensor:
    """Causal GQA: q (Sq, H, dh) at positions q_pos; k, v (Sk, K, dh) at
    positions 0..Sk-1.  Query rows in blocks of ``block``."""
    Sq, H, dh = q.shape
    Sk, K = k.shape[0], k.shape[1]
    G = H // K
    kk = prec(k.repeat_interleave(G, dim=1).transpose(0, 1))  # (H, Sk, dh)
    vv = prec(v.repeat_interleave(G, dim=1).transpose(0, 1))
    kpos = torch.arange(Sk, device=q.device)
    out = []
    for a in range(0, Sq, block):
        qb = q[a:a + block].transpose(0, 1)                 # (H, b, dh)
        s = prec(qb) @ kk.transpose(1, 2) / dh ** 0.5       # (H, b, Sk)
        mask = kpos[None, :] <= q_pos[a:a + block, None]
        s = s.masked_fill(~mask[None], float("-inf"))
        out.append((prec(torch.softmax(s, dim=-1)) @ vv).transpose(0, 1))
    return torch.cat(out, dim=0)


def ffn(lw: Dict[str, torch.Tensor], h: torch.Tensor, m: Dict,
        prec: Precision) -> torch.Tensor:
    if "moe.router" not in lw:
        g = mm(h, lw["mlp.w_gate"], prec)
        u = mm(h, lw["mlp.w_up"], prec)
        return mm(F.silu(g) * u, lw["mlp.w_down"], prec)
    k = m["num_experts_per_tok"]
    probs = torch.softmax(mm(h, lw["moe.router"], prec), dim=-1)
    top, idx = torch.topk(probs, k, dim=-1)
    top = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(m["num_local_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = h[rows]
        g = mm(xe, lw["moe.w_gate"][e], prec)
        u = mm(xe, lw["moe.w_up"][e], prec)
        ye = mm(F.silu(g) * u, lw["moe.w_down"][e], prec)
        y = y.index_add(0, rows, ye * top[rows, slot][:, None])
    return y


def layer_weights(weights: Dict[str, torch.Tensor], i: int
                  ) -> Dict[str, torch.Tensor]:
    p = f"layers.{i}."
    return {n[len(p):]: t for n, t in weights.items() if n.startswith(p)}


def layer(lw, x, pos, m: Dict, prec: Precision) -> torch.Tensor:
    d, H, K, dh = sizes(m)
    eps, theta = float(m["rms_norm_eps"]), float(m["rope_theta"])
    S = x.shape[0]
    h = rms(x, lw["ln1.scale"], eps)
    q = mm(h, lw["attn.wq"].reshape(d, H * dh), prec).reshape(S, H, dh)
    k = mm(h, lw["attn.wk"].reshape(d, K * dh), prec).reshape(S, K, dh)
    v = mm(h, lw["attn.wv"].reshape(d, K * dh), prec).reshape(S, K, dh)
    o = attend(rotary(q, pos, theta), rotary(k, pos, theta), v, pos, prec)
    x = x + mm(o.reshape(S, H * dh), lw["attn.wo"].reshape(H * dh, d), prec)
    return x + ffn(lw, rms(x, lw["ln2.scale"], eps), m, prec)


@torch.no_grad()
def logits_at(weights: Dict[str, torch.Tensor], m: Dict,
              tokens: Sequence[int], at: Sequence[int],
              prec: Precision = F32_PRECISION,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """Float32 logits (len(at), vocab) of the sequence ``tokens`` at the
    positions ``at`` (the logits that predict token at + 1)."""
    dev = device or weights["embed.tok"].device
    t = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    x = weights["embed.tok"][t].to(F32)
    pos = torch.arange(len(tokens), device=dev)
    for i in range(m["num_hidden_layers"]):
        x = layer(layer_weights(weights, i), x, pos, m, prec)
    sel = x[torch.as_tensor(list(at), dtype=torch.long, device=dev)]
    h = rms(sel, weights["final_ln.scale"], float(m["rms_norm_eps"]))
    return mm(h, weights["head.w"], prec)


def gaps(ref_logits: torch.Tensor, chosen: Sequence[int]) -> List[float]:
    """By how much each chosen token's reference logit lies below the
    reference's best at its position."""
    c = torch.as_tensor(list(chosen), dtype=torch.long,
                        device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    return (best - ref_logits.gather(1, c[:, None])[:, 0]).tolist()
