"""The decoder of the port (``repro/models/transformer.py``, dense, MoE and
hybrid families).

Parameters keep the JAX package's layouts, so the reference's weights load
unchanged (``repro_torch.convert``): ``wq (d,H,dh)``, ``wk``/``wv``
``(d,K,dh)``, ``wo (H,dh,d)``, ``w_gate``/``w_up (d,f)``, ``w_down (f,d)``,
``embed.tok (vocab,d)``, ``head.w (d,vocab)``; an MoE layer holds
``moe.router (d,E)`` in f32 whatever ``cfg.dtype`` is, ``moe.w_gate``/
``moe.w_up (E,d,f)`` and ``moe.w_down (E,f,d)`` in place of ``mlp``.  The
serving engine (``serve/engine.py``) drives the layers itself under
``torch.no_grad``.  ``forward`` and ``loss`` are the training pass of every
family (``repro/models/transformer.py`` ``_dense_body``,
``_run_hybrid_stack``, ``_trunk``, ``loss``): whole-tensor layers, every
attention through the flash kernels, every MoE layer through
``models.moe.moe`` (the grouped-FFN forward and backward kernels), every
Mamba2 layer through ``models.ssm.ssm_forward`` (the SSD forward and
backward kernels), each decoder or Mamba2 layer under
``torch.utils.checkpoint`` when ``cfg.remat`` (the hybrid family's shared
block outside it, as in the JAX package).  Routing is per token, so the
recompute under remat picks the experts the first forward picked.

The hybrid family (zamba2: Mamba2 layers with one shared attention+MLP
block after every ``attn_every`` of them) holds ``ssm_layers.<i>.ln`` and
``ssm_layers.<i>.ssm`` (``models/ssm.py``) and ``shared_attn.{ln1, attn,
ln2, mlp}``.

Every family serves through a contiguous cache: ``init_cache``,
``prefill`` and ``decode`` (``cache_defs``, ``_prefill_attn``,
``_prefill_hybrid``, ``decode``).  The dense and MoE families' prefill
runs every attention through the flash forward kernel (with the config's
window) and every MoE layer through ``moe`` (the grouped-expert kernel);
their decode is plain torch (``attention_decode``, or
``attention_decode_ring`` over a ring cache of ``window`` slots, where
position p lives in slot p % window) with ``moe_decode``, which routes as
prefill does.  The hybrid family's prefill runs every Mamba2 intra-chunk
block through the SSD kernel and every shared-attention prefill through
the flash forward kernel.  The paged ``Engine`` serves the dense and MoE
families, as the JAX engine does.

Parameters are made with ``requires_grad=False``, so serving builds no
autograd graph.  Training hands ``loss`` its own leaves (``params``: the
state-dict names mapped to tensors that require grad, as
``train.step.value_and_grad`` makes them), so the module's own tensors
never need to be trainable.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..kernels import ops
from .config import ModelConfig
from .layers import (attention, attention_decode, chunked_lm_loss, norm,
                     param, project, rope, rope_freqs, swiglu)
from .moe import CAPACITY_NOT_PORTED, MoEConfig, moe, moe_decode
from .ssm import SSM, SSMConfig, ssm_decode, ssm_forward

_NOT_PORTED = {
    "xlstm": "ROADMAP.md queue A item 10 (other families)",
    "encdec": "ROADMAP.md queue A item 10 (other families)",
    "vlm": "ROADMAP.md queue A item 10 (other families)",
}


class RMSNorm(nn.Module):
    def __init__(self, d: int, device, dtype):
        super().__init__()
        self.scale = param((d,), device, dtype)


class Attention(nn.Module):
    def __init__(self, d: int, H: int, K: int, dh: int, device, dtype):
        super().__init__()
        self.wq = param((d, H, dh), device, dtype)
        self.wk = param((d, K, dh), device, dtype)
        self.wv = param((d, K, dh), device, dtype)
        self.wo = param((H, dh, d), device, dtype)


class MLP(nn.Module):
    def __init__(self, d: int, f: int, device, dtype):
        super().__init__()
        self.w_gate = param((d, f), device, dtype)
        self.w_up = param((d, f), device, dtype)
        self.w_down = param((f, d), device, dtype)


class MoE(nn.Module):
    """Expert weights and the router, which stays f32 (``moe_defs``)."""

    def __init__(self, mc: MoEConfig, device, dtype):
        super().__init__()
        E, d, f = mc.padded_experts, mc.d_model, mc.d_ff
        self.router = param((d, E), device, torch.float32)
        self.w_gate = param((E, d, f), device, dtype)
        self.w_up = param((E, d, f), device, dtype)
        self.w_down = param((E, f, d), device, dtype)


class DecoderLayer(nn.Module):
    """rmsnorm, GQA attention, rmsnorm, then a SwiGLU ``mlp`` (dense) or
    ``moe`` (given ``moe_cfg``)."""

    def __init__(self, cfg: ModelConfig, device, dtype,
                 moe_cfg: Optional[MoEConfig] = None):
        super().__init__()
        d, dh = cfg.d_model, cfg.resolved_head_dim
        self.ln1 = RMSNorm(d, device, dtype)
        self.attn = Attention(d, cfg.n_heads, cfg.kv_heads, dh, device,
                              dtype)
        self.ln2 = RMSNorm(d, device, dtype)
        if moe_cfg is None:
            self.mlp = MLP(d, cfg.d_ff, device, dtype)
        else:
            self.moe = MoE(moe_cfg, device, dtype)


class HybridLayer(nn.Module):
    """One Mamba2 layer of the hybrid family: rmsnorm, then the block."""

    def __init__(self, cfg: ModelConfig, ssm_cfg: SSMConfig, device, dtype):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device, dtype)
        self.ssm = SSM(ssm_cfg, device, dtype)


class SharedBlock(nn.Module):
    """The hybrid family's shared attention+MLP block (one parameter set,
    applied after every ``attn_every`` Mamba2 layers)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, device, dtype)
        self.attn = Attention(d, cfg.n_heads, cfg.kv_heads,
                              cfg.resolved_head_dim, device, dtype)
        self.ln2 = RMSNorm(d, device, dtype)
        self.mlp = MLP(d, cfg.d_ff, device, dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, device, dtype):
        super().__init__()
        self.tok = param((vocab, d), device, dtype)


class Head(nn.Module):
    def __init__(self, d: int, vocab: int, device, dtype):
        super().__init__()
        self.w = param((d, vocab), device, dtype)


class Model(nn.Module):
    """Decoder-only LM: embed -> n_layers x (rmsnorm, GQA attention,
    rmsnorm, SwiGLU or MoE) -> rmsnorm -> head; or, for the hybrid family,
    embed -> Mamba2 layers with the shared block after every
    ``attn_every`` of them -> rmsnorm -> head.  Parameters are created on
    ``device`` (the card unless the caller asks for the CPU) in
    ``cfg.dtype`` (the MoE router and the SSM's ``dt_bias``, ``a_log`` and
    ``D`` in f32), uninitialised until ``init`` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        cfg.validate()
        if cfg.family not in ("dense", "moe", "hybrid"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: "
                f"{_NOT_PORTED.get(cfg.family, 'ROADMAP.md queue A')} "
                f"brings it")
        self.moe_cfg: Optional[MoEConfig] = None
        if cfg.family == "moe":
            if cfg.moe_dispatch != "dropless":
                raise NotImplementedError(CAPACITY_NOT_PORTED)
            self.moe_cfg = MoEConfig(
                d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
                top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                dispatch=cfg.moe_dispatch, parallelism=cfg.moe_parallelism,
                ep_axis_size=cfg.moe_ep_axis_size)
        self.cfg = cfg
        self.device = resolve_device(device)
        dev, dt = self.device, cfg.dtype
        self.ssm_cfg: Optional[SSMConfig] = None
        self.embed = Embed(cfg.vocab, cfg.d_model, dev, dt)
        if cfg.family == "hybrid":
            self.ssm_cfg = SSMConfig(
                d_model=cfg.d_model, d_inner=cfg.d_inner,
                head_dim=cfg.ssm_head_dim, state_dim=cfg.ssm_state)
            self.ssm_layers = nn.ModuleList(
                HybridLayer(cfg, self.ssm_cfg, dev, dt)
                for _ in range(cfg.n_layers))
            self.shared_attn = SharedBlock(cfg, dev, dt)
        else:
            self.layers = nn.ModuleList(
                DecoderLayer(cfg, dev, dt, self.moe_cfg)
                for _ in range(cfg.n_layers))
        self.final_ln = RMSNorm(cfg.d_model, dev, dt)
        self.head = Head(cfg.d_model, cfg.vocab, dev, dt)

    @property
    def head_dim(self) -> int:
        return self.cfg.resolved_head_dim

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "Model":
        """Random weights with the reference's statistics
        (``repro/models/common.py`` ``_leaf_init``): norm scales, the SSM's
        ``D`` and ``norm`` are ones, its ``dt_bias`` and ``a_log`` zeros,
        its ``conv_x`` N(0, 0.5^2), the embedding is N(0, 0.02), every other
        matrix N(0, 1/fan_in) with
        fan_in = shape[-2] (for the JAX package's layer-stacked leaves that
        is the per-layer shape's [-2] too: d for the router, ``w_gate`` and
        ``w_up``, f for ``w_down``).  Drawn in f32 from ``generator``, then
        cast to each parameter's own dtype (the router stays f32); the bits
        differ from JAX's."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "D", "norm"):
                p.fill_(1.0)
                continue
            if leaf in ("dt_bias", "a_log"):
                p.zero_()
                continue
            if name == "embed.tok":
                std = 0.02
            elif leaf == "conv_x":
                std = 0.5
            else:
                fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
                std = 1.0 / math.sqrt(max(fan_in, 1))
            w = torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32)
            p.copy_((w * std).to(p.dtype))
        return self

    # ============================================================ training
    def _freqs(self, device) -> torch.Tensor:
        """The rope frequencies on ``device``, made once: a copy from host
        memory in every forward pass would wait for the card."""
        cache = self.__dict__.setdefault("_freqs_cache", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = rope_freqs(self.head_dim, self.cfg.rope_theta,
                                    device)
        return cache[key]

    def _layer_params(self, params: Mapping[str, torch.Tensor],
                      i: int) -> Dict:
        """Layer i's tensors of a state-dict-named mapping, nested as the
        JAX layer tree is."""
        pre = f"layers.{i}."
        out = {
            "ln1": params[pre + "ln1.scale"],
            "attn": {w: params[f"{pre}attn.{w}"]
                     for w in ("wq", "wk", "wv", "wo")},
            "ln2": params[pre + "ln2.scale"],
        }
        if self.moe_cfg is not None:
            out["moe"] = SimpleNamespace(**{
                w: params[f"{pre}moe.{w}"]
                for w in ("router", "w_gate", "w_up", "w_down")})
        else:
            out["mlp"] = {w: params[f"{pre}mlp.{w}"]
                          for w in ("w_gate", "w_up", "w_down")}
        return out

    def _dense_body(self, lp: Mapping, x: torch.Tensor,
                    positions: torch.Tensor,
                    freqs: torch.Tensor) -> torch.Tensor:
        h = x + attention(lp["attn"], norm(lp["ln1"], x), positions, freqs,
                          window=self.cfg.window)
        if self.moe_cfg is not None:
            return h + moe(lp["moe"], norm(lp["ln2"], h), self.moe_cfg)
        return h + swiglu(lp["mlp"], norm(lp["ln2"], h))

    def _ssm_layer(self, params: Mapping[str, torch.Tensor], i: int):
        """Mamba2 layer i's norm scale and block tensors of a
        state-dict-named mapping, the block as ``ssm_forward`` reads it."""
        pre = f"ssm_layers.{i}."
        return params[pre + "ln.scale"], SimpleNamespace(**{
            w: params[f"{pre}ssm.{w}"]
            for w, _ in self.ssm_layers[i].ssm.named_parameters()})

    def _ssm_body(self, ln: torch.Tensor, lp: SimpleNamespace,
                  x: torch.Tensor) -> torch.Tensor:
        return x + ssm_forward(lp, norm(ln, x), self.ssm_cfg)

    def _shared_body(self, sp: Mapping, x: torch.Tensor,
                     positions: torch.Tensor,
                     freqs: torch.Tensor) -> torch.Tensor:
        h = x + attention(sp["attn"], norm(sp["ln1"], x), positions, freqs,
                          window=self.cfg.window)
        return h + swiglu(sp["mlp"], norm(sp["ln2"], h))

    def _run_hybrid_stack(self, P: Mapping[str, torch.Tensor],
                          x: torch.Tensor, positions: torch.Tensor,
                          freqs: torch.Tensor) -> torch.Tensor:
        """The hybrid trunk (``_run_hybrid_stack``): each segment's Mamba2
        layers, each under ``checkpoint`` when ``cfg.remat``, then the
        shared block, outside it."""
        sp = self._shared(P)
        for layers, j in self._segments():
            for i in layers:
                ln, lp = self._ssm_layer(P, i)
                if self.cfg.remat:
                    x = checkpoint(self._ssm_body, ln, lp, x,
                                   use_reentrant=False)
                else:
                    x = self._ssm_body(ln, lp, x)
            if j is not None:
                x = self._shared_body(sp, x, positions, freqs)
        return x

    def forward(self, tokens: torch.Tensor,
                params: Optional[Mapping[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """The trunk: tokens (B, S) -> hidden (B, S, d) after the layer
        stack (before the final norm).  ``params`` maps state-dict names to
        the tensors to use (default: the module's own)."""
        P = dict(self.named_parameters()) if params is None else params
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        freqs = self._freqs(tokens.device)
        x = F.embedding(tokens.long(), P["embed.tok"])
        if self.ssm_cfg is not None:
            return self._run_hybrid_stack(P, x, positions, freqs)
        for i in range(self.cfg.n_layers):
            lp = self._layer_params(P, i)
            if self.cfg.remat:
                x = checkpoint(self._dense_body, lp, x, positions, freqs,
                               use_reentrant=False)
            else:
                x = self._dense_body(lp, x, positions, freqs)
        return x

    def loss(self, batch: Mapping[str, torch.Tensor],
             params: Optional[Mapping[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        """Mean next-token CE of ``batch`` (``tokens``, ``labels`` (B, S),
        label -1 ignored) as an f32 scalar."""
        P = dict(self.named_parameters()) if params is None else params
        x = self.forward(batch["tokens"], P)
        x = norm(P["final_ln.scale"], x)
        return chunked_lm_loss(P["head.w"], x, batch["labels"])

    # ============================================================= serving
    def init_cache(self, batch: int, seq: int) -> Dict:
        """The contiguous cache of ``batch`` rows and ``seq`` positions
        (``cache_defs``), zeros on the model's device.  ``kv`` {``k``,
        ``v``} (n, B, S, K, dh) in ``cfg.dtype``, where S is ``seq``, or
        ``min(seq, window)`` for a windowed arch (a ring: decode at
        position p writes slot p % window); n is ``n_layers``, or
        ``n_layers // attn_every`` for the hybrid family, whose cache also
        holds ``conv`` (L, B, W-1, d_inner) in ``cfg.dtype`` and ``ssm``
        (L, B, H, N, P) in f32."""
        cfg = self.cfg
        if cfg.window is not None:
            seq = min(seq, cfg.window)
        n_kv = (cfg.n_layers if self.ssm_cfg is None
                else cfg.n_layers // cfg.attn_every)
        kv_shape = (n_kv, batch, seq, cfg.kv_heads, self.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        cache = {"kv": {"k": zeros(kv_shape, cfg.dtype),
                        "v": zeros(kv_shape, cfg.dtype)}}
        sc = self.ssm_cfg
        if sc is not None:
            cache["conv"] = zeros((cfg.n_layers, batch, sc.conv_width - 1,
                                   cfg.d_inner), cfg.dtype)
            cache["ssm"] = zeros((cfg.n_layers, batch, sc.n_heads,
                                  sc.state_dim, sc.head_dim), torch.float32)
        return cache

    def _segments(self):
        """(layer range, shared-block index or None) in order: each full
        segment of ``attn_every`` Mamba2 layers is followed by the shared
        block, whose K/V go to cache slot j; the remainder layers have
        none."""
        k = self.cfg.attn_every
        n_seg, rem = divmod(self.cfg.n_layers, k)
        out = [(range(j * k, (j + 1) * k), j) for j in range(n_seg)]
        if rem:
            out.append((range(n_seg * k, self.cfg.n_layers), None))
        return out

    def _shared(self, params: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Dict:
        """The shared block's tensors, nested as the JAX tree is: from
        ``params`` (state-dict names) or the module's own."""
        if params is None:
            params = {f"shared_attn.{n}": t
                      for n, t in self.shared_attn.named_parameters()}
        pre = "shared_attn."
        return {"ln1": params[pre + "ln1.scale"],
                "ln2": params[pre + "ln2.scale"],
                "attn": {w: params[f"{pre}attn.{w}"]
                         for w in ("wq", "wk", "wv", "wo")},
                "mlp": {w: params[f"{pre}mlp.{w}"]
                        for w in ("w_gate", "w_up", "w_down")}}

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits (B, vocab) of x (B, d) after the final norm."""
        return project(norm(self.final_ln.scale, x), self.head.w).to(
            torch.float32)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Dict):
        """Consume prompts ``tokens`` (B, S) and fill ``cache`` (from
        ``init_cache``) in place; returns (f32 logits (B, vocab) of the last
        position, cache).  The dense and MoE families write each layer's
        roped K/V at the head of the cache, which holds at least S
        positions, or, for a windowed arch whose prompt is longer than the
        window, the last ``window`` of them at their ring slots
        (``_prefill_attn``).  The hybrid family writes each Mamba2 layer's
        conv and SSM state and each shared application's K/V at the head of
        its slot; S must be at most the SSD chunk or a multiple of it."""
        if self.ssm_cfg is None:
            return self._prefill_attn(tokens, cache)
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        freqs = self._freqs(tokens.device)
        x = self.embed.tok[tokens.long()]
        sp = self._shared()
        for layers, j in self._segments():
            for i in layers:
                lp = self.ssm_layers[i]
                out, conv, ssm = ssm_forward(lp.ssm, norm(lp.ln.scale, x),
                                             self.ssm_cfg, return_state=True)
                x = x + out
                cache["conv"][i] = conv.to(cache["conv"].dtype)
                cache["ssm"][i] = ssm
            if j is None:
                continue
            h = norm(sp["ln1"], x)
            q = rope(project(h, sp["attn"]["wq"]), positions, freqs)
            k = rope(project(h, sp["attn"]["wk"]), positions, freqs)
            v = project(h, sp["attn"]["wv"])
            cache["kv"]["k"][j, :, :S] = k.to(cache["kv"]["k"].dtype)
            cache["kv"]["v"][j, :, :S] = v.to(cache["kv"]["v"].dtype)
            o = ops.flash_attention(q, k, v, causal=True,
                                    window=self.cfg.window)
            x = x + project(o, sp["attn"]["wo"], k=2)
            x = x + swiglu(sp["mlp"], norm(sp["ln2"], x))
        return self._logits(x[:, -1]), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Dict, pos: int):
        """One step for every row: ``tokens`` (B,) or (B, 1) at position
        ``pos`` (the same for all rows).  Updates ``cache`` in place and
        returns (f32 logits (B, vocab), cache).  A windowed arch's cache of
        at most ``window`` positions is a ring (``attention_decode_ring``),
        as in the JAX package."""
        if self.ssm_cfg is None:
            return self._decode_attn(tokens, cache, pos)
        x = self.embed.tok[tokens.reshape(-1, 1).long()]        # (B,1,d)
        freqs = self._freqs(x.device)
        sp = self._shared()
        for layers, j in self._segments():
            for i in layers:
                lp = self.ssm_layers[i]
                y, conv, ssm = ssm_decode(lp.ssm, norm(lp.ln.scale, x),
                                          cache["conv"][i], cache["ssm"][i],
                                          self.ssm_cfg)
                x = x + y
                cache["conv"][i] = conv
                cache["ssm"][i] = ssm
            if j is None:
                continue
            x = x + attention_decode(sp["attn"], norm(sp["ln1"], x),
                                     cache["kv"]["k"][j],
                                     cache["kv"]["v"][j], pos, freqs,
                                     window=self.cfg.window)
            x = x + swiglu(sp["mlp"], norm(sp["ln2"], x))
        return self._logits(x[:, 0]), cache

    def _decoder_layer(self, i: int):
        """Layer i's tensors nested as the JAX layer tree is (the module's
        own)."""
        return self._layer_params(dict(self.layers[i].named_parameters(
            prefix=f"layers.{i}")), i)

    def _ffn(self, lp: Mapping, h: torch.Tensor, decode: bool = False
             ) -> torch.Tensor:
        if self.moe_cfg is None:
            return swiglu(lp["mlp"], h)
        return (moe_decode if decode else moe)(lp["moe"], h, self.moe_cfg)

    def _prefill_attn(self, tokens: torch.Tensor, cache: Dict):
        """The dense and MoE prefill (``_prefill_attn``): each layer's
        attention through the flash forward with the config's window, its
        roped K/V into the cache; past the window (S > W) only the last W
        positions are kept, position p at slot p % W, so decode continues
        on the ring."""
        cfg = self.cfg
        B, S = tokens.shape
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        W = cfg.window
        ring = W is not None and S > W
        want = W if ring else S
        if (ck.shape[2] != W) if ring else (ck.shape[2] < S):
            raise ValueError(
                f"prefill of {S} positions needs a cache of "
                f"{'exactly' if ring else 'at least'} {want} positions, got "
                f"{ck.shape[2]} (init_cache(batch, seq) with seq >= {S})")
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        slots = (torch.arange(S - W, S, device=tokens.device) % W
                 if ring else None)
        freqs = self._freqs(tokens.device)
        x = self.embed.tok[tokens.long()]
        for i in range(cfg.n_layers):
            lp = self._decoder_layer(i)
            h = norm(lp["ln1"], x)
            q = rope(project(h, lp["attn"]["wq"]), positions, freqs)
            k = rope(project(h, lp["attn"]["wk"]), positions, freqs)
            v = project(h, lp["attn"]["wv"])
            if ring:
                ck[i][:, slots] = k[:, S - W:].to(ck.dtype)
                cv[i][:, slots] = v[:, S - W:].to(cv.dtype)
            else:
                ck[i, :, :S] = k.to(ck.dtype)
                cv[i, :, :S] = v.to(cv.dtype)
            o = ops.flash_attention(q, k, v, causal=True, window=W)
            x = x + project(o, lp["attn"]["wo"], k=2)
            x = x + self._ffn(lp, norm(lp["ln2"], x))
        return self._logits(x[:, -1]), cache

    def _decode_attn(self, tokens: torch.Tensor, cache: Dict, pos: int):
        """The dense and MoE branch of ``decode``: a ring cache
        (``attention_decode_ring``) when the arch has a window and the cache
        holds at most that many positions, else attention over positions <=
        pos (and inside the window)."""
        cfg = self.cfg
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        ring = cfg.window is not None and ck.shape[2] <= cfg.window
        x = self.embed.tok[tokens.reshape(-1, 1).long()]        # (B,1,d)
        freqs = self._freqs(x.device)
        for i in range(cfg.n_layers):
            lp = self._decoder_layer(i)
            x = x + attention_decode(lp["attn"], norm(lp["ln1"], x), ck[i],
                                     cv[i], pos, freqs, window=cfg.window,
                                     ring=ring)
            x = x + self._ffn(lp, norm(lp["ln2"], x), decode=True)
        return self._logits(x[:, 0]), cache
