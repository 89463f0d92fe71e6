"""The model of the port (``repro/models/transformer.py``): every family
of the JAX package, dense, MoE, hybrid, xLSTM, encoder-decoder and VLM.

Parameters keep the JAX package's layouts, so the reference's weights load
unchanged (``repro_torch.convert``): ``wq (d,H,dh)``, ``wk``/``wv``
``(d,K,dh)``, ``wo (H,dh,d)``, ``w_gate``/``w_up (d,f)``, ``w_down (f,d)``,
``embed.tok (vocab,d)``, ``head.w (d,vocab)``; an MoE layer holds
``moe.router (d,E)`` in f32 whatever ``cfg.dtype`` is, ``moe.w_gate``/
``moe.w_up (E,d,f)`` and ``moe.w_down (E,f,d)`` in place of ``mlp``.  The
serving engine (``serve/engine.py``) drives the layers itself under
``torch.no_grad``.  ``forward`` and ``loss`` are the training pass of every
family (``repro/models/transformer.py`` ``_dense_body``,
``_run_hybrid_stack``, ``_run_xlstm_stack``, ``_encode``,
``_run_decoder_encdec``, ``_trunk``, ``loss``): whole-tensor layers, every
attention through the flash kernels, every MoE layer through
``models.moe.moe`` (the grouped-FFN forward and backward kernels), every
Mamba2 layer through ``models.ssm.ssm_forward`` (the SSD forward and
backward kernels), each decoder, encoder, Mamba2 or mLSTM layer under
``torch.utils.checkpoint`` when ``cfg.remat`` (the hybrid family's shared
block and the sLSTM layers outside it, as in the JAX package).  Routing is
per token, so the recompute under remat picks the experts the first forward
picked.

The hybrid family (zamba2: Mamba2 layers with one shared attention+MLP
block after every ``attn_every`` of them) holds ``ssm_layers.<i>.ln`` and
``ssm_layers.<i>.ssm`` (``models/ssm.py``) and ``shared_attn.{ln1, attn,
ln2, mlp}``.  The xLSTM family holds ``mlstm_layers.<i>.{ln, mlstm}`` and
``slstm_layers.<j>.{ln, slstm}`` (``models/xlstm.py``): segments of
``slstm_every - 1`` mLSTM layers, each followed by one sLSTM layer, then
the remaining mLSTM layers.  The encoder-decoder family (seamless) holds
``audio_adapter.w``, ``enc_layers.<i>.{ln1, attn, ln2, mlp}`` and
``dec_layers.<i>.{ln1, attn, lnx, xattn, ln2, mlp}``: the batch's
``frames`` (B, Se, d) go through the adapter and the encoder, whose
self-attention is causal, as the reference's ``_mask`` makes it whatever
``_encode`` asks; each decoder layer attends causally to the tokens, then
unmasked to the encoder's output (cross attention, no rope).  The VLM
family (phi3-vision) is the dense decoder with ``vision_adapter.w``: the
batch's ``patches`` (B, P, d) go through the adapter and stand before the
token embeddings, at positions 0..P-1, and carry no loss.

Every family serves through a contiguous cache: ``init_cache``,
``prefill`` and ``decode`` (``cache_defs``, ``_prefill_attn``,
``_prefill_hybrid``, ``_prefill_xlstm``, ``decode``).  The dense, MoE and
VLM families' prefill runs every attention through the flash forward kernel
(with the config's window) and every MoE layer through ``moe`` (the
grouped-expert kernel, or under ``moe_dispatch="capacity"`` batched
products); their decode is plain torch (``attention_decode``,
or ``attention_decode_ring`` over a ring cache of ``window`` slots, where
position p lives in slot p % window) with ``moe_decode``, which routes as
prefill does.  The hybrid family's prefill runs every Mamba2 intra-chunk
block through the SSD kernel and every shared-attention prefill through
the flash forward kernel.  The encoder-decoder's prefill runs the encoder
and every decoder self- and cross-attention through the flash forward; its
decode is plain torch (``attention_decode``, ``cross_attention_decode``).
The xLSTM family is plain torch throughout.  The paged ``Engine`` serves
the dense and MoE families, as the JAX engine does.

Parameters are made with ``requires_grad=False``, so serving builds no
autograd graph.  Training hands ``loss`` its own leaves (``params``: the
state-dict names mapped to tensors that require grad, as
``train.step.value_and_grad`` makes them), so the module's own tensors
never need to be trainable.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..kernels import ops
from .config import ModelConfig
from .layers import (attention, attention_decode, chunked_lm_loss,
                     cross_attention_decode, norm, param, project, rope,
                     rope_freqs, swiglu)
from .moe import MoEConfig, moe, moe_decode
from .ssm import SSM, SSMConfig, ssm_decode, ssm_forward
from .xlstm import (MLSTM, SLSTM, XLSTMConfig, mlstm_decode, mlstm_parallel,
                    slstm_decode, slstm_forward)

FAMILIES = ("dense", "moe", "hybrid", "xlstm", "encdec", "vlm")
# The sLSTM state's cache leaves, in the order of its (c, n, h, m) tuple.
SLSTM_STATE = ("sc", "sn", "sh", "sm")


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


class Adapter(nn.Module):
    """The stub frontend's learned projection (``vision_adapter`` or
    ``audio_adapter``): ``w`` (d, d)."""

    def __init__(self, d: int, device, dtype):
        super().__init__()
        self.w = param((d, d), device, dtype)


class EncoderLayer(nn.Module):
    """One encoder layer of the encoder-decoder family: rmsnorm, self
    attention, rmsnorm, SwiGLU."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, device, dtype)
        self.attn = Attention(d, cfg.n_heads, cfg.kv_heads,
                              cfg.resolved_head_dim, device, dtype)
        self.ln2 = RMSNorm(d, device, dtype)
        self.mlp = MLP(d, cfg.d_ff, device, dtype)


class EncDecLayer(nn.Module):
    """One decoder layer of the encoder-decoder family: rmsnorm, causal self
    attention, rmsnorm, cross attention over the encoder's output, rmsnorm,
    SwiGLU."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, H, K = cfg.d_model, cfg.n_heads, cfg.kv_heads
        dh = cfg.resolved_head_dim
        self.ln1 = RMSNorm(d, device, dtype)
        self.attn = Attention(d, H, K, dh, device, dtype)
        self.lnx = RMSNorm(d, device, dtype)
        self.xattn = Attention(d, H, K, dh, device, dtype)
        self.ln2 = RMSNorm(d, device, dtype)
        self.mlp = MLP(d, cfg.d_ff, device, dtype)


class MLSTMLayer(nn.Module):
    """One mLSTM layer of the xLSTM family: rmsnorm, then the block."""

    def __init__(self, cfg: ModelConfig, xl_cfg: XLSTMConfig, device, dtype):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device, dtype)
        self.mlstm = MLSTM(xl_cfg, device, dtype)


class SLSTMLayer(nn.Module):
    """One sLSTM layer of the xLSTM family: rmsnorm, then the block."""

    def __init__(self, cfg: ModelConfig, xl_cfg: XLSTMConfig, device, dtype):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device, dtype)
        self.slstm = SLSTM(xl_cfg, device, dtype)


def _layer_tree(params: Mapping[str, torch.Tensor], prefix: str,
                layer: nn.Module) -> Dict:
    """``layer``'s tensors of a state-dict-named mapping (names under
    ``prefix``), nested as the JAX layer tree is: a norm gives its scale,
    any other block a dict of its tensors."""
    out = {}
    for name, child in layer.named_children():
        if isinstance(child, RMSNorm):
            out[name] = params[f"{prefix}{name}.scale"]
        else:
            out[name] = {w: params[f"{prefix}{name}.{w}"]
                         for w, _ in child.named_parameters()}
    return out


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, device, dtype):
        super().__init__()
        self.tok = param((vocab, d), device, dtype)


class Head(nn.Module):
    def __init__(self, d: int, vocab: int, device, dtype):
        super().__init__()
        self.w = param((d, vocab), device, dtype)


class Model(nn.Module):
    """The language model of every family: embed -> the family's layer
    stack -> rmsnorm -> head (module docstring).  Parameters are created on
    ``device`` (the card unless the caller asks for the CPU) in
    ``cfg.dtype`` (the MoE router, the SSM's ``dt_bias``, ``a_log`` and
    ``D`` and the xLSTM gates in f32), uninitialised until ``init`` or
    ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        cfg.validate()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; expected one "
                             f"of {FAMILIES}")
        self.moe_cfg: Optional[MoEConfig] = None
        if cfg.family == "moe":
            self.moe_cfg = MoEConfig(
                d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
                top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                dispatch=cfg.moe_dispatch, parallelism=cfg.moe_parallelism,
                ep_axis_size=cfg.moe_ep_axis_size)
        self.cfg = cfg
        self.device = resolve_device(device)
        dev, dt = self.device, cfg.dtype
        self.ssm_cfg: Optional[SSMConfig] = None
        self.xl_cfg: Optional[XLSTMConfig] = None
        self.embed = Embed(cfg.vocab, cfg.d_model, dev, dt)
        if cfg.family == "hybrid":
            self.ssm_cfg = SSMConfig(
                d_model=cfg.d_model, d_inner=cfg.d_inner,
                head_dim=cfg.ssm_head_dim, state_dim=cfg.ssm_state)
            self.ssm_layers = nn.ModuleList(
                HybridLayer(cfg, self.ssm_cfg, dev, dt)
                for _ in range(cfg.n_layers))
            self.shared_attn = SharedBlock(cfg, dev, dt)
        elif cfg.family == "xlstm":
            self.xl_cfg = XLSTMConfig(d_model=cfg.d_model,
                                      n_heads=cfg.n_heads)
            n_m, n_s = self._xlstm_counts()
            self.mlstm_layers = nn.ModuleList(
                MLSTMLayer(cfg, self.xl_cfg, dev, dt) for _ in range(n_m))
            if n_s:
                self.slstm_layers = nn.ModuleList(
                    SLSTMLayer(cfg, self.xl_cfg, dev, dt)
                    for _ in range(n_s))
        elif cfg.family == "encdec":
            self.audio_adapter = Adapter(cfg.d_model, dev, dt)
            self.enc_layers = nn.ModuleList(
                EncoderLayer(cfg, dev, dt) for _ in range(cfg.enc_layers))
            self.dec_layers = nn.ModuleList(
                EncDecLayer(cfg, dev, dt) for _ in range(cfg.n_layers))
        else:
            self.layers = nn.ModuleList(
                DecoderLayer(cfg, dev, dt, self.moe_cfg)
                for _ in range(cfg.n_layers))
            if cfg.family == "vlm":
                self.vision_adapter = Adapter(cfg.d_model, dev, dt)
        self.final_ln = RMSNorm(cfg.d_model, dev, dt)
        self.head = Head(cfg.d_model, cfg.vocab, dev, dt)

    @property
    def head_dim(self) -> int:
        return self.cfg.resolved_head_dim

    @property
    def unread_leaves(self) -> frozenset:
        """The parameters that ``loss`` never reads: the sLSTM layers'
        ``norm``, which the reference declares and never uses."""
        if self.cfg.family != "xlstm":
            return frozenset()
        return frozenset(f"slstm_layers.{j}.slstm.norm"
                         for j in range(self._xlstm_counts()[1]))

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "Model":
        """Random weights with the reference's statistics
        (``repro/models/common.py`` ``_leaf_init``): norm scales, the SSM's
        ``D`` and ``norm`` and the xLSTM blocks' ``norm`` are ones, the
        SSM's ``dt_bias`` and ``a_log`` zeros, the mLSTM's ``b_f`` ones and
        every other xLSTM bias ``b_*`` zeros, the SSM's ``conv_x`` N(0,
        0.5^2), the sLSTM's recurrent ``r_*`` N(0, 0.3^2), the embedding
        N(0, 0.02), every other matrix N(0, 1/fan_in) with
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
            if leaf in ("dt_bias", "a_log") or leaf.startswith("b_"):
                p.fill_(1.0 if name.endswith(".mlstm.b_f") else 0.0)
                continue
            if name == "embed.tok":
                std = 0.02
            elif leaf == "conv_x":
                std = 0.5
            elif leaf.startswith("r_"):
                std = 0.3
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
        JAX layer tree is (the MoE block as ``moe`` reads it)."""
        out = _layer_tree(params, f"layers.{i}.", self.layers[i])
        if self.moe_cfg is not None:
            out["moe"] = SimpleNamespace(**out["moe"])
        return out

    def _dense_body(self, lp: Mapping, x: torch.Tensor,
                    positions: torch.Tensor,
                    freqs: torch.Tensor) -> torch.Tensor:
        h = x + attention(lp["attn"], norm(lp["ln1"], x), positions, freqs,
                          window=self.cfg.window)
        if self.moe_cfg is not None:
            return h + moe(lp["moe"], norm(lp["ln2"], h), self.moe_cfg)
        return h + swiglu(lp["mlp"], norm(lp["ln2"], h))

    def _norm_block(self, params: Mapping[str, torch.Tensor], stack: str,
                    i: int):
        """Layer i of ``stack`` (``ssm_layers``, ``mlstm_layers``,
        ``slstm_layers``: a norm, then one block) of a state-dict-named
        mapping: its norm scale and its block's tensors, the block as
        ``models.ssm`` or ``models.xlstm`` reads it."""
        tree = _layer_tree(params, f"{stack}.{i}.", getattr(self, stack)[i])
        ln = tree.pop("ln")
        (block,) = tree.values()
        return ln, SimpleNamespace(**block)

    def _ssm_body(self, ln: torch.Tensor, lp: SimpleNamespace,
                  x: torch.Tensor) -> torch.Tensor:
        return x + ssm_forward(lp, norm(ln, x), self.ssm_cfg)

    def _attn_mlp_body(self, lp: Mapping, x: torch.Tensor,
                       positions: torch.Tensor,
                       freqs: torch.Tensor) -> torch.Tensor:
        """An attention+MLP block (the hybrid family's shared block, an
        encoder layer): rmsnorm, causal self-attention, rmsnorm, SwiGLU."""
        h = x + attention(lp["attn"], norm(lp["ln1"], x), positions, freqs,
                          window=self.cfg.window)
        return h + swiglu(lp["mlp"], norm(lp["ln2"], h))

    def _run_hybrid_stack(self, P: Mapping[str, torch.Tensor],
                          x: torch.Tensor, positions: torch.Tensor,
                          freqs: torch.Tensor) -> torch.Tensor:
        """The hybrid trunk (``_run_hybrid_stack``): each segment's Mamba2
        layers, each under ``checkpoint`` when ``cfg.remat``, then the
        shared block, outside it."""
        sp = self._shared(P)
        for layers, j in self._segments():
            for i in layers:
                ln, lp = self._norm_block(P, "ssm_layers", i)
                x = self._remat(self._ssm_body, ln, lp, x)
            if j is not None:
                x = self._attn_mlp_body(sp, x, positions, freqs)
        return x

    def _xlstm_counts(self) -> Tuple[int, int]:
        """(mLSTM layers, sLSTM layers): one sLSTM layer per
        ``slstm_every``."""
        L, k = self.cfg.n_layers, self.cfg.slstm_every
        n_s = L // k if k else 0
        return L - n_s, n_s

    def _xlstm_segments(self):
        """(mLSTM layer range, sLSTM index or None) in order: each segment
        of ``slstm_every - 1`` mLSTM layers is followed by sLSTM layer j;
        the remaining mLSTM layers have none (``_run_xlstm_stack``)."""
        n_m, n_s = self._xlstm_counts()
        per = self.cfg.slstm_every - 1 if n_s else n_m
        out = [(range(j * per, (j + 1) * per), j) for j in range(n_s)]
        if n_s * per < n_m:
            out.append((range(n_s * per, n_m), None))
        return out

    def _mlstm_body(self, ln: torch.Tensor, lp: SimpleNamespace,
                    x: torch.Tensor) -> torch.Tensor:
        return x + mlstm_parallel(lp, norm(ln, x), self.xl_cfg)

    def _run_xlstm_stack(self, P: Mapping[str, torch.Tensor],
                         x: torch.Tensor) -> torch.Tensor:
        """The xLSTM trunk (``_run_xlstm_stack``): each mLSTM layer under
        ``checkpoint`` when ``cfg.remat``, each sLSTM layer outside it."""
        for layers, j in self._xlstm_segments():
            for i in layers:
                ln, lp = self._norm_block(P, "mlstm_layers", i)
                x = self._remat(self._mlstm_body, ln, lp, x)
            if j is not None:
                ln, sp = self._norm_block(P, "slstm_layers", j)
                y, _ = slstm_forward(sp, norm(ln, x), self.xl_cfg)
                x = x + y
        return x

    def _remat(self, body, *args):
        """``body(*args)``, under ``checkpoint`` when ``cfg.remat``."""
        if self.cfg.remat:
            return checkpoint(body, *args, use_reentrant=False)
        return body(*args)

    def _adapt(self, frontend: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A stub frontend's embeddings (B, P, d) through its adapter ``w``,
        in the adapter's dtype (the JAX package's batches carry them in
        ``cfg.dtype``)."""
        return project(frontend.to(w.dtype), w)

    def encode(self, frames: torch.Tensor,
               params: Optional[Mapping[str, torch.Tensor]] = None
               ) -> torch.Tensor:
        """The encoder-decoder's encoder (``_encode``): frames (B, Se, d)
        -> the encoder's output (B, Se, d), each layer under ``checkpoint``
        when ``cfg.remat``.  Its self-attention is causal: the reference's
        ``_mask`` never reads the ``causal=False`` that ``_encode`` sets."""
        P = dict(self.named_parameters()) if params is None else params
        x = self._adapt(frames, P["audio_adapter.w"])
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        freqs = self._freqs(x.device)
        for i, layer in enumerate(self.enc_layers):
            lp = _layer_tree(P, f"enc_layers.{i}.", layer)
            x = self._remat(self._attn_mlp_body, lp, x, positions, freqs)
        return x

    def _encdec_body(self, lp: Mapping, x: torch.Tensor,
                     positions: torch.Tensor, freqs: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
        h = x + attention(lp["attn"], norm(lp["ln1"], x), positions, freqs,
                          window=self.cfg.window)
        h = h + attention(lp["xattn"], norm(lp["lnx"], h), positions, freqs,
                          kv_x=enc_out)
        return h + swiglu(lp["mlp"], norm(lp["ln2"], h))

    def _frontend(self, patches: Optional[torch.Tensor],
                  frames: Optional[torch.Tensor], need: bool) -> None:
        """Refuses a frontend input the family does not take, and, with
        ``need``, a missing one it does: ``patches`` for the VLM,
        ``frames`` for the encoder-decoder."""
        fam = self.cfg.family
        if patches is not None and fam != "vlm":
            raise ValueError(f"family {fam!r} takes no patches (the VLM's "
                             f"image embeddings)")
        if frames is not None and fam != "encdec":
            raise ValueError(f"family {fam!r} takes no frames (the "
                             f"encoder-decoder's audio embeddings)")
        if fam == "encdec" and frames is None:
            raise ValueError("the encoder-decoder family needs frames (B, "
                             "Se, d): the audio frontend's embeddings")
        if need and fam == "vlm" and patches is None:
            raise ValueError("the VLM family needs patches (B, P, d): the "
                             "vision frontend's embeddings")

    def _embed_inputs(self, P: Mapping[str, torch.Tensor],
                      tokens: torch.Tensor,
                      patches: Optional[torch.Tensor]) -> torch.Tensor:
        """The token embeddings, after the VLM's adapted patches when
        given."""
        x = F.embedding(tokens.long(), P["embed.tok"])
        if patches is None:
            return x
        xp = self._adapt(patches, P["vision_adapter.w"]).to(x.dtype)
        return torch.cat([xp, x], dim=1)

    def forward(self, tokens: torch.Tensor,
                params: Optional[Mapping[str, torch.Tensor]] = None,
                patches: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The trunk (``_trunk``): tokens (B, T) -> hidden (B, S, d) after
        the layer stack (before the final norm).  ``params`` maps
        state-dict names to the tensors to use (default: the module's
        own).  The VLM family takes ``patches`` (B, P, d), S = P + T; the
        encoder-decoder ``frames`` (B, Se, d), S = T."""
        P = dict(self.named_parameters()) if params is None else params
        self._frontend(patches, frames, need=True)
        x = self._embed_inputs(P, tokens, patches)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        fam = self.cfg.family
        if fam == "xlstm":
            return self._run_xlstm_stack(P, x)
        freqs = self._freqs(x.device)
        if fam == "hybrid":
            return self._run_hybrid_stack(P, x, positions, freqs)
        if fam == "encdec":
            enc_out = self.encode(frames, P)
            for i, layer in enumerate(self.dec_layers):
                lp = _layer_tree(P, f"dec_layers.{i}.", layer)
                x = self._remat(self._encdec_body, lp, x, positions, freqs,
                                enc_out)
            return x
        for i in range(self.cfg.n_layers):
            lp = self._layer_params(P, i)
            x = self._remat(self._dense_body, lp, x, positions, freqs)
        return x

    def loss(self, batch: Mapping[str, torch.Tensor],
             params: Optional[Mapping[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        """Mean next-token CE of ``batch`` (``tokens``, ``labels`` (B, T),
        label -1 ignored; the VLM's ``patches``, the encoder-decoder's
        ``frames``) as an f32 scalar.  The VLM's patch positions carry no
        loss (their labels are -1)."""
        P = dict(self.named_parameters()) if params is None else params
        patches = batch.get("patches")
        x = self.forward(batch["tokens"], P, patches=patches,
                         frames=batch.get("frames"))
        x = norm(P["final_ln.scale"], x)
        labels = batch["labels"]
        if patches is not None:
            pad = labels.new_full((labels.shape[0], patches.shape[1]), -1)
            labels = torch.cat([pad, labels], dim=1)
        return chunked_lm_loss(P["head.w"], x, labels)

    # ============================================================= serving
    def init_cache(self, batch: int, seq: int) -> Dict:
        """The contiguous cache of ``batch`` rows and ``seq`` positions
        (``cache_defs``), zeros on the model's device.  ``kv`` {``k``,
        ``v``} (n, B, S, K, dh) in ``cfg.dtype``, where S is ``seq``, or
        ``min(seq, window)`` for a windowed arch (a ring: decode at
        position p writes slot p % window); n is ``n_layers``, or
        ``n_layers // attn_every`` for the hybrid family, whose cache also
        holds ``conv`` (L, B, W-1, d_inner) in ``cfg.dtype`` and ``ssm``
        (L, B, H, N, P) in f32.  The encoder-decoder's also holds the
        encoder memory ``xk``/``xv`` (L, B, S, K, dh), which ``prefill``
        replaces by the frames' own length.  The xLSTM family's holds no
        ``kv``: ``C`` (n_m, B, H, dh, dh) and ``n`` (n_m, B, H, dh) per
        mLSTM layer and ``sc``/``sn``/``sh``/``sm`` (n_s, B, H, d/H) per
        sLSTM layer, all f32."""
        cfg = self.cfg
        if cfg.window is not None:
            seq = min(seq, cfg.window)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if cfg.family == "xlstm":
            n_m, n_s = self._xlstm_counts()
            H, dh = self.xl_cfg.n_heads, self.xl_cfg.head_dim
            cache = {"C": zeros((n_m, batch, H, dh, dh), torch.float32),
                     "n": zeros((n_m, batch, H, dh), torch.float32)}
            for name in SLSTM_STATE if n_s else ():
                cache[name] = zeros((n_s, batch, H, cfg.d_model // H),
                                    torch.float32)
            return cache
        n_kv = (cfg.n_layers if self.ssm_cfg is None
                else cfg.n_layers // cfg.attn_every)
        kv_shape = (n_kv, batch, seq, cfg.kv_heads, self.head_dim)
        cache = {"kv": {"k": zeros(kv_shape, cfg.dtype),
                        "v": zeros(kv_shape, cfg.dtype)}}
        if cfg.family == "encdec":
            cache["xk"] = zeros(kv_shape, cfg.dtype)
            cache["xv"] = zeros(kv_shape, cfg.dtype)
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
            params = dict(self.shared_attn.named_parameters(
                prefix="shared_attn"))
        return _layer_tree(params, "shared_attn.", self.shared_attn)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits (B, vocab) of x (B, d) after the final norm."""
        return project(norm(self.final_ln.scale, x), self.head.w).to(
            torch.float32)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Dict,
                patches: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None):
        """Consume prompts ``tokens`` (B, T) and fill ``cache`` (from
        ``init_cache``) in place; returns (f32 logits (B, vocab) of the last
        position, cache).  The dense, MoE and VLM families write each
        layer's roped K/V at the head of the cache, which holds at least S
        positions, or, for a windowed arch whose prompt is longer than the
        window, the last ``window`` of them at their ring slots
        (``_prefill_attn``).  The VLM takes optional ``patches`` (B, P, d):
        without them it is ``_prefill_attn`` on the tokens, as the JAX
        package's prefill is; with them the adapted patches stand before
        the tokens, as in its ``_trunk``, S = P + T, and decode continues
        at position S.  The encoder-decoder takes ``frames`` (B, Se, d),
        writes the decoder's self-attention K/V in place and sets ``xk``/
        ``xv`` to the encoder memory (L, B, Se, K, dh).  The hybrid family
        writes each Mamba2 layer's conv and SSM state and each shared
        application's K/V at the head of its slot; the xLSTM family each
        layer's final state.  Those two need S at most their chunk (128)
        or a multiple of it."""
        self._frontend(patches, frames, need=False)
        fam = self.cfg.family
        if fam == "xlstm":
            return self._prefill_xlstm(tokens, cache)
        if fam == "encdec":
            return self._prefill_encdec(tokens, frames, cache)
        if fam != "hybrid":
            P = dict(self.named_parameters())
            return self._prefill_attn(self._embed_inputs(P, tokens, patches),
                                      cache)
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
        as in the JAX package.  The encoder-decoder attends its encoder
        memory ``xk``/``xv`` after each self-attention
        (``cross_attention_decode``); the xLSTM family steps each layer's
        state and ignores ``pos``."""
        fam = self.cfg.family
        if fam == "xlstm":
            return self._decode_xlstm(tokens, cache)
        if fam == "encdec":
            return self._decode_encdec(tokens, cache, pos)
        if fam != "hybrid":
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

    def _check_prompt(self, S: int, slots: int, ring: bool) -> None:
        want = self.cfg.window if ring else S
        if (slots != want) if ring else (slots < S):
            raise ValueError(
                f"prefill of {S} positions needs a cache of "
                f"{'exactly' if ring else 'at least'} {want} positions, got "
                f"{slots} (init_cache(batch, seq) with seq >= {S})")

    def _prefill_attn(self, x: torch.Tensor, cache: Dict):
        """The dense, MoE and VLM prefill (``_prefill_attn``) of the
        embedded prompt x (B, S, d): each layer's attention through the
        flash forward with the config's window, its roped K/V into the
        cache; past the window (S > W) only the last W positions are kept,
        position p at slot p % W, so decode continues on the ring."""
        cfg = self.cfg
        S = x.shape[1]
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        W = cfg.window
        ring = W is not None and S > W
        self._check_prompt(S, ck.shape[2], ring)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        slots = (torch.arange(S - W, S, device=x.device) % W
                 if ring else None)
        freqs = self._freqs(x.device)
        for i in range(cfg.n_layers):
            lp = self._decoder_layer(i)
            x = self._self_attn_prefill(lp, x, ck[i], cv[i], positions,
                                        freqs, slots)
            x = x + self._ffn(lp, norm(lp["ln2"], x))
        return self._logits(x[:, -1]), cache

    def _self_attn_prefill(self, lp: Mapping, x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor,
                           positions: torch.Tensor, freqs: torch.Tensor,
                           slots: Optional[torch.Tensor]) -> torch.Tensor:
        """x plus layer ``lp``'s causal self-attention over the prompt x
        (B, S, d) through the flash forward with the config's window, its
        roped K/V written into the layer's cache ``ck``/``cv`` (B, slots,
        K, dh): at the head, or, given the ring's ``slots`` (S > W), only
        the last W positions, position p at slot p % W."""
        S, W = x.shape[1], self.cfg.window
        h = norm(lp["ln1"], x)
        q = rope(project(h, lp["attn"]["wq"]), positions, freqs)
        k = rope(project(h, lp["attn"]["wk"]), positions, freqs)
        v = project(h, lp["attn"]["wv"])
        if slots is not None:
            ck[:, slots] = k[:, S - W:].to(ck.dtype)
            cv[:, slots] = v[:, S - W:].to(cv.dtype)
        else:
            ck[:, :S] = k.to(ck.dtype)
            cv[:, :S] = v.to(cv.dtype)
        o = ops.flash_attention(q, k, v, causal=True, window=W)
        return x + project(o, lp["attn"]["wo"], k=2)

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

    def _own_tree(self, stack: str, i: int) -> Dict:
        """Layer i of ``stack`` (``enc_layers``, ``dec_layers``), the
        module's own tensors nested as the JAX layer tree is."""
        layer = getattr(self, stack)[i]
        return _layer_tree(dict(layer.named_parameters()), "", layer)

    def _prefill_encdec(self, tokens: torch.Tensor, frames: torch.Tensor,
                        cache: Dict):
        """The encoder-decoder branch of ``_prefill_attn``: the encoder over
        ``frames``, then each decoder layer's ``_self_attn_prefill`` (its
        K/V into the cache at the head) and its cross attention through the flash forward over the encoder's output,
        whose K/V become ``xk``/``xv`` at the frames' length Se (what the
        JAX package's prefill returns)."""
        cfg = self.cfg
        S = tokens.shape[1]
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        self._check_prompt(S, ck.shape[2], False)
        enc_out = self.encode(frames)
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        freqs = self._freqs(tokens.device)
        x = self.embed.tok[tokens.long()]
        xks, xvs = [], []
        for i in range(cfg.n_layers):
            lp = self._own_tree("dec_layers", i)
            x = self._self_attn_prefill(lp, x, ck[i], cv[i], positions,
                                        freqs, None)
            hx = norm(lp["lnx"], x)
            xk = project(enc_out, lp["xattn"]["wk"])
            xv = project(enc_out, lp["xattn"]["wv"])
            xks.append(xk.to(ck.dtype))
            xvs.append(xv.to(cv.dtype))
            o = ops.flash_attention(project(hx, lp["xattn"]["wq"]), xk, xv,
                                    causal=False)
            x = x + project(o, lp["xattn"]["wo"], k=2)
            x = x + swiglu(lp["mlp"], norm(lp["ln2"], x))
        cache["xk"] = torch.stack(xks)
        cache["xv"] = torch.stack(xvs)
        return self._logits(x[:, -1]), cache

    def _decode_encdec(self, tokens: torch.Tensor, cache: Dict, pos: int):
        """The encoder-decoder branch of ``decode``: per decoder layer,
        ``attention_decode`` over the self-attention cache at ``pos``, then
        ``cross_attention_decode`` over every row of ``xk``/``xv``, then
        the SwiGLU."""
        cfg = self.cfg
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        x = self.embed.tok[tokens.reshape(-1, 1).long()]        # (B,1,d)
        freqs = self._freqs(x.device)
        for i in range(cfg.n_layers):
            lp = self._own_tree("dec_layers", i)
            x = x + attention_decode(lp["attn"], norm(lp["ln1"], x), ck[i],
                                     cv[i], pos, freqs, window=cfg.window)
            x = x + cross_attention_decode(lp["xattn"], norm(lp["lnx"], x),
                                           cache["xk"][i], cache["xv"][i])
            x = x + swiglu(lp["mlp"], norm(lp["ln2"], x))
        return self._logits(x[:, 0]), cache

    def _prefill_xlstm(self, tokens: torch.Tensor, cache: Dict):
        """``_prefill_xlstm``: the xLSTM trunk with each layer's final
        state into the cache (mLSTM i: ``C``/``n`` [i]; sLSTM j:
        ``sc``/``sn``/``sh``/``sm`` [j]).  S must be at most the mLSTM
        chunk (128) or a multiple of it."""
        x = self.embed.tok[tokens.long()]
        for layers, j in self._xlstm_segments():
            for i in layers:
                lp = self.mlstm_layers[i]
                out, C, n = mlstm_parallel(lp.mlstm, norm(lp.ln.scale, x),
                                           self.xl_cfg, return_state=True)
                x = x + out
                cache["C"][i] = C
                cache["n"][i] = n
            if j is None:
                continue
            sp = self.slstm_layers[j]
            y, state = slstm_forward(sp.slstm, norm(sp.ln.scale, x),
                                     self.xl_cfg)
            x = x + y
            for name, t in zip(SLSTM_STATE, state):
                cache[name][j] = t
        return self._logits(x[:, -1]), cache

    def _decode_xlstm(self, tokens: torch.Tensor, cache: Dict):
        """``_decode_xlstm``: one step of every mLSTM layer
        (``mlstm_decode``) and sLSTM layer (``slstm_decode``) from the
        cached states, written back in place."""
        x = self.embed.tok[tokens.reshape(-1, 1).long()]        # (B,1,d)
        for layers, j in self._xlstm_segments():
            for i in layers:
                lp = self.mlstm_layers[i]
                y, C, n = mlstm_decode(lp.mlstm, norm(lp.ln.scale, x),
                                       cache["C"][i], cache["n"][i],
                                       self.xl_cfg)
                x = x + y
                cache["C"][i] = C
                cache["n"][i] = n
            if j is None:
                continue
            sp = self.slstm_layers[j]
            state = tuple(cache[name][j] for name in SLSTM_STATE)
            y, state = slstm_decode(sp.slstm, norm(sp.ln.scale, x), state,
                                    self.xl_cfg)
            x = x + y
            for name, t in zip(SLSTM_STATE, state):
                cache[name][j] = t
        return self._logits(x[:, 0]), cache
