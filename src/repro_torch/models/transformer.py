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

Under a mesh (``dist.sharding.use_mesh``) ``forward``, ``loss``,
``prefill`` and ``decode`` compute on each rank's local blocks: ``shard_``
(or ``local_params``) cuts them by ``shardings``, which are the JAX
package's ``param_pspecs`` under the ambient rules, with ``d_inner``
following ``ssm_heads`` in a Mamba2 block, and records the layout (``tp``,
a ``TPLayout``) that the model hands its layers.  Every family runs
tensor-parallel over the ``model`` axis (``models.layers``, ``models.moe``
with either dispatch, ``models.ssm``, ``models.xlstm``); a rank's batch is
its data block, and ``loss`` is its NLL over the token count it is given
(``train.step`` passes the data ranks' global count).  Under the ``fsdp``
profile (``FSDP_RULES``) a parameter's ``embed`` dim is split over the
data axis and gathered where it is read (``Gathered``, ``fsdp``), inside a
layer's remat region.  A cache under a mesh is the rank's blocks
(``init_cache``): its kv heads (``DECODE_RULES``) or, where ``kv_seq``
splits, its positions of every kv head, whose decode merges the ranks'
partial attentions (``layers.attention_decode``, ``_seq_split``).

Parameters are made with ``requires_grad=False``, so serving builds no
autograd graph.  Training hands ``loss`` its own leaves (``params``: the
state-dict names mapped to tensors that require grad, as
``train.step.value_and_grad`` makes them), so the module's own tensors
never need to be trainable.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..dist.collectives import gather_from_group, gather_shards, group_size
from ..dist.sharding import (NO_TP, AbstractMesh, PartitionSpec, Rules,
                             TPLayout, active_mesh, axis_group, axis_rank,
                             data_ways, entry_axes, local_block,
                             logical_to_pspec, spec_shards, tp_layout)
from ..kernels import ops
from .common import (ArrayDef, LeafSharding, leaf_axes, module_defs,
                     param_shardings, tree_map)
from .config import ModelConfig, ShapeConfig
from .layers import (NO_SPLIT, SeqSplit, attention, attention_decode,
                     attention_out, chunked_lm_loss, cross_attention_decode,
                     cross_attention_qkv, embed_tokens, kv_for_cache, norm,
                     param, project, rope_freqs, self_attention_qkv, swiglu,
                     write_positions)
from .moe import MoEConfig, moe, moe_decode
from .ssm import SSM, SSMConfig, ssm_decode, ssm_forward
from .xlstm import (MLSTM, SLSTM, XLSTMConfig, mlstm_decode, mlstm_parallel,
                    slstm_decode, slstm_forward)

FAMILIES = ("dense", "moe", "hybrid", "xlstm", "encdec", "vlm")
# The sLSTM state's cache leaves, in the order of its (c, n, h, m) tuple.
SLSTM_STATE = ("sc", "sn", "sh", "sm")
# The logical axes of a KV cache leaf (``repro/models/transformer.py``).
KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")


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


def fsdp_dims(shardings: Mapping) -> Dict[str, int]:
    """Per parameter split over the ``data`` axis (the ``fsdp`` profile's
    ``embed``), the dim its shards lie along; a layout that splits the
    layer stack or splits a dim over a data axis jointly with another
    raises (zero1 splits the moments' layer stack, never the
    parameters')."""
    out = {}
    for name, sh in shardings.items():
        if sh.layer_split:
            raise ValueError(f"the rules split the layer stack of "
                             f"{name}: only the moments' may split "
                             f"(zero1, AdamW.init)")
        for dim, entry in enumerate(sh.spec):
            axes = entry_axes(entry)
            if not {"pod", "data"} & set(axes):
                continue
            if axes != ("data",):
                raise ValueError(f"{name} splits dim {dim} over {axes}: "
                                 f"the parameter gather runs over 'data' "
                                 f"alone")
            out[name] = dim
    return out


class Gathered(Mapping):
    """The parameters as the layers read them under the ``fsdp`` profile:
    a tensor split over the data axis (``dims``: name -> dim) is
    all-gathered over ``group`` each time it is read
    (``dist.collectives.gather_shards``: its gradient reduce-scattered),
    any other returned as it is."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 dims: Mapping[str, int], group):
        self._params, self._dims, self._group = params, dims, group

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self._params[name]
        dim = self._dims.get(name)
        return t if dim is None else gather_shards(t, dim, self._group)

    def __iter__(self) -> Iterator[str]:
        return iter(self._params)

    def __len__(self) -> int:
        return len(self._params)


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

    # The layout the layers compute on, the whole parameter defs, and the
    # parameters the fsdp profile gathers over the data group (name ->
    # dim): set by ``shard_``.
    tp: TPLayout = NO_TP
    _whole_defs: Optional[Dict] = None
    fsdp: Mapping[str, int] = {}
    _fsdp_group = None

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

    # ================================================================ mesh
    def logical_sizes(self) -> Dict[str, int]:
        """The whole size of every logical axis of the parameters that the
        layers name, for their layout (``dist.sharding.TPLayout``)."""
        cfg = self.cfg
        out = {"embed": cfg.d_model, "heads": cfg.n_heads,
               "kv_heads": cfg.kv_heads, "head_dim": self.head_dim,
               "mlp": cfg.d_ff, "vocab": cfg.vocab}
        if self.moe_cfg is not None:
            out["experts"] = self.moe_cfg.padded_experts
        if self.ssm_cfg is not None:
            out["d_inner"] = self.ssm_cfg.d_inner
            out["ssm_heads"] = self.ssm_cfg.n_heads
        if self.xl_cfg is not None:
            out["d_inner"] = self.xl_cfg.d_inner
        return out

    def shardings(self, mesh, rules: Optional[Rules] = None
                  ) -> Dict[str, LeafSharding]:
        """Per parameter name, how it lies on ``mesh``: the JAX package's
        specs (``models.common.param_shardings``) under ``rules`` (default:
        the ambient ones), except that a Mamba2 block's ``d_inner`` dims
        split only where its ``ssm_heads`` do, so that a rank's channels
        are its heads' (``models.ssm``)."""
        out = param_shardings(self.param_defs(), mesh, rules)
        sc = self.ssm_cfg
        if sc is None or spec_shards(logical_to_pspec(
                ("ssm_heads",), (sc.n_heads,), mesh, rules), mesh) > 1:
            return out
        for name, sh in out.items():
            if ".ssm." not in name:
                continue
            axes = leaf_axes("ssm/" + name.rsplit(".", 1)[-1])
            out[name] = dataclasses.replace(sh, spec=PartitionSpec(*(
                None if a == "d_inner" else e
                for a, e in zip(axes, sh.spec))))
        return out

    def local_params(self, mesh, tensors: Mapping[str, torch.Tensor],
                     rules: Optional[Rules] = None,
                     rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """This rank's block of each whole tensor of ``tensors`` (named as
        the parameters are) on ``mesh`` (on an ``AbstractMesh``, rank
        ``rank``'s, default 0).  A layout that splits the layer stack
        raises (``fsdp_dims``)."""
        sh = self.shardings(mesh, rules)
        fsdp_dims(sh)
        out = {}
        for name, t in tensors.items():
            s = sh[name]
            out[name] = (local_block(t, s.spec, mesh, rank=rank or 0)
                         if isinstance(mesh, AbstractMesh) else s.local(t))
        return out

    @torch.no_grad()
    def shard_(self, mesh=None, rules: Optional[Rules] = None) -> "Model":
        """Replace every parameter by this rank's block on ``mesh``
        (default: the ambient one), in place: what ``prefill``, ``decode``
        and a ``Trainer`` under the mesh read), and record the layout the
        layers compute on (``tp``) and the parameters the fsdp profile
        gathers (``fsdp``)."""
        mesh = active_mesh() if mesh is None else mesh
        defs = self.param_defs()
        named = dict(self.named_parameters())
        local = self.local_params(mesh, {n: p.data for n, p in named.items()},
                                  rules)
        for name, p in named.items():
            p.data = local[name]
        self._whole_defs = defs
        self.tp = tp_layout(self.logical_sizes(), mesh, rules)
        self.fsdp = fsdp_dims(self.shardings(mesh, rules))
        self._fsdp_group = axis_group(mesh, "data") if self.fsdp else None
        return self

    def _view(self, params: Optional[Mapping[str, torch.Tensor]] = None
              ) -> Mapping[str, torch.Tensor]:
        """The parameters the layers read: ``params`` (state-dict names;
        default the module's own), under the fsdp profile through
        ``Gathered``.  Training reads a layer's inside its remat region,
        so the recompute gathers again."""
        P = dict(self.named_parameters()) if params is None else params
        if not self.fsdp or isinstance(P, Gathered):
            return P
        return Gathered(P, self.fsdp, self._fsdp_group)

    def _seq_split(self, cache_k: torch.Tensor) -> SeqSplit:
        """How the KV cache block ``cache_k`` (n, B, S, K, dh) splits its
        positions under the ambient mesh and rules: resolved on the whole
        sizes ``init_cache`` (or ``prefill``, for the encoder memory)
        recorded for the block's (B, S)."""
        mesh = active_mesh()
        if mesh is None:
            return NO_SPLIT
        n, B, S, _, dh = cache_k.shape
        whole = self.__dict__.get("_cache_sizes", {}).get((B, S))
        Bw, Sw = whole or (B * data_ways(mesh), S)
        seq = self._resolve_split(mesh, (n, Bw, Sw, dh))
        if whole is None and seq.group is not None:
            raise ValueError(f"a KV cache block of {S} positions whose "
                             f"kv_seq splits: decode reads the layout "
                             f"init_cache made")
        return seq

    def _resolve_split(self, mesh, shape: Tuple[int, int, int, int]
                       ) -> SeqSplit:
        """The ``SeqSplit`` of a KV leaf of whole (n, B, S, dh) on ``mesh``
        under the ambient rules."""
        n, B, S, dh = shape
        spec = logical_to_pspec(KV_AXES, (n, B, S, self.cfg.kv_heads, dh),
                                mesh)
        axes = entry_axes(spec[2])
        if not axes:
            return NO_SPLIT
        if len(axes) != 1:
            raise ValueError(f"kv_seq split jointly over {axes}: a decode "
                             f"step merges over one axis")
        (axis,) = axes
        return SeqSplit(axis_group(mesh, axis), axis_rank(mesh, axis),
                        axis == "model")

    def _memory_split(self, cache_k: torch.Tensor,
                      Se: int) -> Tuple[SeqSplit, int]:
        """(layout, positions a block holds) of the encoder memory of
        ``Se`` positions that ``prefill`` writes beside the KV cache block
        ``cache_k``: laid out as a KV leaf, its whole sizes recorded."""
        mesh = active_mesh()
        if mesh is None:
            return NO_SPLIT, Se
        n, B, S, _, dh = cache_k.shape
        Bw = self.__dict__.get("_cache_sizes", {}).get(
            (B, S), (B * data_ways(mesh), S))[0]
        seq = self._resolve_split(mesh, (n, Bw, Se, dh))
        blk = Se // _ways(seq)
        self._record_cache((B, blk), (Bw, Se))
        return seq, blk

    def _record_cache(self, block: Tuple[int, int],
                      whole: Tuple[int, int]) -> None:
        self.__dict__.setdefault("_cache_sizes", {})[block] = whole

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
                          window=self.cfg.window, tp=self.tp)
        if self.moe_cfg is not None:
            return h + moe(lp["moe"], norm(lp["ln2"], h), self.moe_cfg,
                           tp=self.tp)
        return h + swiglu(lp["mlp"], norm(lp["ln2"], h), self.tp)

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
        return x + ssm_forward(lp, norm(ln, x), self.ssm_cfg, tp=self.tp)

    def _attn_mlp_body(self, lp: Mapping, x: torch.Tensor,
                       positions: torch.Tensor,
                       freqs: torch.Tensor) -> torch.Tensor:
        """An attention+MLP block (the hybrid family's shared block, an
        encoder layer): rmsnorm, causal self-attention, rmsnorm, SwiGLU."""
        h = x + attention(lp["attn"], norm(lp["ln1"], x), positions, freqs,
                          window=self.cfg.window, tp=self.tp)
        return h + swiglu(lp["mlp"], norm(lp["ln2"], h), self.tp)

    def _ssm_layer(self, P: Mapping[str, torch.Tensor], i: int,
                   x: torch.Tensor) -> torch.Tensor:
        return self._ssm_body(*self._norm_block(P, "ssm_layers", i), x)

    def _run_hybrid_stack(self, P: Mapping[str, torch.Tensor],
                          x: torch.Tensor, positions: torch.Tensor,
                          freqs: torch.Tensor) -> torch.Tensor:
        """The hybrid trunk (``_run_hybrid_stack``): each segment's Mamba2
        layers, each under ``checkpoint`` when ``cfg.remat``, then the
        shared block, outside it."""
        sp = self._shared(P)
        for layers, j in self._segments():
            for i in layers:
                x = self._remat(self._ssm_layer, P, i, x)
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

    def _mlstm_layer(self, P: Mapping[str, torch.Tensor], i: int,
                     x: torch.Tensor) -> torch.Tensor:
        ln, lp = self._norm_block(P, "mlstm_layers", i)
        return x + mlstm_parallel(lp, norm(ln, x), self.xl_cfg, tp=self.tp)

    def _run_xlstm_stack(self, P: Mapping[str, torch.Tensor],
                         x: torch.Tensor) -> torch.Tensor:
        """The xLSTM trunk (``_run_xlstm_stack``): each mLSTM layer under
        ``checkpoint`` when ``cfg.remat``, each sLSTM layer outside it."""
        for layers, j in self._xlstm_segments():
            for i in layers:
                x = self._remat(self._mlstm_layer, P, i, x)
            if j is not None:
                ln, sp = self._norm_block(P, "slstm_layers", j)
                y, _ = slstm_forward(sp, norm(ln, x), self.xl_cfg,
                                     tp=self.tp)
                x = x + y
        return x

    def _remat(self, body, *args):
        """``body(*args)``, under ``checkpoint`` when ``cfg.remat``.  A
        body given the parameters' mapping reads its layer's tensors
        inside, so the fsdp profile's gathers run again in the
        recompute."""
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
        P = self._view(params)
        x = self._adapt(frames, P["audio_adapter.w"])
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        freqs = self._freqs(x.device)
        for i in range(len(self.enc_layers)):
            x = self._remat(self._encoder_layer, P, i, x, positions, freqs)
        return x

    def _encoder_layer(self, P: Mapping[str, torch.Tensor], i: int,
                       x: torch.Tensor, positions: torch.Tensor,
                       freqs: torch.Tensor) -> torch.Tensor:
        lp = _layer_tree(P, f"enc_layers.{i}.", self.enc_layers[i])
        return self._attn_mlp_body(lp, x, positions, freqs)

    def _encdec_layer(self, P: Mapping[str, torch.Tensor], i: int,
                      x: torch.Tensor, positions: torch.Tensor,
                      freqs: torch.Tensor,
                      enc_out: torch.Tensor) -> torch.Tensor:
        lp = _layer_tree(P, f"dec_layers.{i}.", self.dec_layers[i])
        h = x + attention(lp["attn"], norm(lp["ln1"], x), positions, freqs,
                          window=self.cfg.window, tp=self.tp)
        h = h + attention(lp["xattn"], norm(lp["lnx"], h), positions, freqs,
                          kv_x=enc_out, tp=self.tp)
        return h + swiglu(lp["mlp"], norm(lp["ln2"], h), self.tp)

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
        x = embed_tokens(P["embed.tok"], tokens, self.tp)
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
        P = self._view(params)
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
            enc_out = self.encode(frames, params)
            for i in range(len(self.dec_layers)):
                x = self._remat(self._encdec_layer, P, i, x, positions,
                                freqs, enc_out)
            return x
        for i in range(self.cfg.n_layers):
            x = self._remat(self._dense_layer, P, i, x, positions, freqs)
        return x

    def _dense_layer(self, P: Mapping[str, torch.Tensor], i: int,
                     x: torch.Tensor, positions: torch.Tensor,
                     freqs: torch.Tensor) -> torch.Tensor:
        return self._dense_body(self._layer_params(P, i), x, positions,
                                freqs)

    def loss(self, batch: Mapping[str, torch.Tensor],
             params: Optional[Mapping[str, torch.Tensor]] = None,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean next-token CE of ``batch`` (``tokens``, ``labels`` (B, T),
        label -1 ignored; the VLM's ``patches``, the encoder-decoder's
        ``frames``) as an f32 scalar: the NLL sum over the count of
        non-ignored labels, or over ``count`` when given (the trainer's
        data-parallel loss divides a rank's NLL by the global count).  The
        VLM's patch positions carry no loss (their labels are -1)."""
        P = dict(self.named_parameters()) if params is None else params
        patches = batch.get("patches")
        x = self.forward(batch["tokens"], P, patches=patches,
                         frames=batch.get("frames"))
        P = self._view(P)
        labels = batch["labels"]
        if patches is not None:
            pad = labels.new_full((labels.shape[0], patches.shape[1]), -1)
            labels = torch.cat([pad, labels], dim=1)
        x = norm(P["final_ln.scale"], x)
        return chunked_lm_loss(P["head.w"], x, labels, count=count,
                               tp=self.tp)

    # ============================================================= serving
    def param_defs(self) -> Dict:
        """The ``ArrayDef`` tree of the parameters, keyed as the JAX
        package's tree is (``models.common.module_defs``): the shapes,
        logical axes and dtypes of ``repro/models/transformer.py``
        ``param_defs``, a layer stack's leaves with their leading
        ``layers`` axis: the whole shapes, after ``shard_`` too."""
        if self._whole_defs is not None:
            return self._whole_defs
        return module_defs(dict(self.named_parameters()),
                           self.cfg.moe_parallelism)

    def cache_defs(self, batch: int, seq: int) -> Dict:
        """The contiguous cache's ``ArrayDef`` tree for ``batch`` rows and
        ``seq`` positions (``repro/models/transformer.py`` ``cache_defs``).
        ``kv`` {``k``, ``v``} (n, B, S, K, dh) in ``cfg.dtype``, where S is
        ``seq``, or ``min(seq, window)`` for a windowed arch (a ring: decode
        at position p writes slot p % window); n is ``n_layers``, or
        ``n_layers // attn_every`` for the hybrid family, whose cache also
        holds ``conv`` (L, B, W-1, d_inner) in ``cfg.dtype`` and ``ssm``
        (L, B, H, N, P) in f32.  The encoder-decoder's also holds the
        encoder memory ``xk``/``xv`` (L, B, S, K, dh), which ``prefill``
        replaces by the frames' own length.  The xLSTM family's holds no
        ``kv``: ``C`` (n_m, B, H, dh, dh) and ``n`` (n_m, B, H, dh) per
        mLSTM layer and ``sc``/``sn``/``sh``/``sm`` (n_s, B, H, d/H) per
        sLSTM layer, all f32."""
        cfg = self.cfg
        f32 = torch.float32
        if cfg.window is not None:
            seq = min(seq, cfg.window)
        if cfg.family == "xlstm":
            n_m, n_s = self._xlstm_counts()
            H, dh = self.xl_cfg.n_heads, self.xl_cfg.head_dim
            out = {"C": ArrayDef((n_m, batch, H, dh, dh),
                                 ("layers", "batch", None, "d_inner", None),
                                 f32),
                   "n": ArrayDef((n_m, batch, H, dh),
                                 ("layers", "batch", None, "d_inner"), f32)}
            for name in SLSTM_STATE if n_s else ():
                out[name] = ArrayDef((n_s, batch, H, cfg.d_model // H),
                                     ("layers", "batch", None, None), f32)
            return out
        n_kv = (cfg.n_layers if self.ssm_cfg is None
                else cfg.n_layers // cfg.attn_every)
        kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        kv = ArrayDef((n_kv, batch, seq, cfg.kv_heads, self.head_dim),
                      kv_axes, cfg.dtype)
        out = {"kv": {"k": kv, "v": kv}}
        if cfg.family == "encdec":
            out["xk"] = out["xv"] = kv
        sc = self.ssm_cfg
        if sc is not None:
            out["conv"] = ArrayDef(
                (cfg.n_layers, batch, sc.conv_width - 1, cfg.d_inner),
                ("layers", "batch", None, "d_inner"), cfg.dtype)
            out["ssm"] = ArrayDef(
                (cfg.n_layers, batch, sc.n_heads, sc.state_dim,
                 sc.head_dim), ("layers", "batch", "ssm_heads", None, None),
                f32)
        return out

    def cache_specs(self, batch: int, seq: int, mesh,
                    rules: Optional[Rules] = None) -> Dict:
        """Each leaf of ``cache_defs(batch, seq)`` (``batch`` the global
        rows) with its ``PartitionSpec`` on ``mesh`` under ``rules``
        (default: the ambient ones): (ArrayDef, spec) pairs, ``d_inner``
        split only where ``ssm_heads`` is, as ``shardings`` splits the
        parameters."""
        sc = self.ssm_cfg
        heads = sc is not None and spec_shards(logical_to_pspec(
            ("ssm_heads",), (sc.n_heads,), mesh, rules), mesh) > 1

        def one(d):
            spec = logical_to_pspec(d.axes, d.shape, mesh, rules)
            if sc is not None and not heads:
                spec = PartitionSpec(*(None if a == "d_inner" else e
                                       for a, e in zip(d.axes, spec)))
            return d, spec

        return tree_map(one, self.cache_defs(batch, seq))

    def init_cache(self, batch: int, seq: int,
                   whole_batch: Optional[int] = None) -> Dict:
        """The contiguous cache of ``cache_defs``: zeros on the model's
        device.  Under a mesh ``batch`` is the rank's rows (``whole_batch``
        the global rows, default ``batch`` times the data ways) and the
        cache its blocks (``cache_specs``), as ``prefill`` there fills
        them; the whole sizes of its KV blocks are recorded, for
        ``decode`` to read their layout."""
        mesh = active_mesh()
        if mesh is None:
            return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                                  device=self.device),
                            self.cache_defs(batch, seq))

        def block(pair):
            d, spec = pair
            shape = [n // spec_shards((e,), mesh) if e is not None else n
                     for n, e in zip(d.shape, tuple(spec) + (None,) * (
                         len(d.shape) - len(spec)))]
            return torch.zeros(shape, dtype=d.dtype, device=self.device)

        B = batch * data_ways(mesh) if whole_batch is None else whole_batch
        out = tree_map(block, self.cache_specs(B, seq, mesh))
        if "kv" in out:
            k = out["kv"]["k"]
            W = self.cfg.window
            self._record_cache((k.shape[1], k.shape[2]),
                               (B, seq if W is None else min(seq, W)))
        return out

    def input_specs(self, shape: ShapeConfig) -> Dict:
        """Stand-ins on the ``meta`` device for every input of the step the
        shape exercises (``repro/models/transformer.py`` ``input_specs``):
        train/prefill a batch dict (the encoder-decoder's ``frames`` (B, S,
        d), the VLM's ``patches`` (B, P, d) before S - P tokens, and
        ``labels`` for training); decode ``tokens`` (B, 1), ``pos`` () and
        the ``cache``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def meta(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            batch: Dict = {}
            n_tok = S
            if cfg.family == "encdec":
                batch["frames"] = meta((B, S, cfg.d_model), cfg.dtype)
            elif cfg.family == "vlm":
                n_tok = S - cfg.frontend_tokens
                batch["patches"] = meta((B, cfg.frontend_tokens,
                                         cfg.d_model), cfg.dtype)
            batch["tokens"] = meta((B, n_tok))
            if shape.kind == "train":
                batch["labels"] = meta((B, n_tok))
            return batch
        return {"tokens": meta((B, 1)), "pos": meta(()),
                "cache": tree_map(lambda d: meta(d.shape, d.dtype),
                                  self.cache_defs(B, S))}

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

    def _shared(self, P: Mapping[str, torch.Tensor]) -> Dict:
        """The shared block's tensors of ``P`` (state-dict names), nested
        as the JAX tree is."""
        return _layer_tree(P, "shared_attn.", self.shared_attn)

    def _logits(self, P: Mapping[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
        """f32 logits (B, vocab) of x (B, d) after the final norm: whole on
        every rank, the vocab blocks gathered under tensor parallelism."""
        logits = project(norm(P["final_ln.scale"], x), P["head.w"]).to(
            torch.float32)
        return gather_from_group(logits, self.tp.over("vocab"))

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
        or a multiple of it.  Under a mesh ``tokens`` are the rank's data
        block, the parameters and ``cache`` its blocks (``shard_``,
        ``init_cache``), and the logits are whole: each family runs
        tensor-parallel on the rank's heads, widths and channels, and the
        cache blocks take what the ambient rules give the rank (its kv
        heads, or, where ``kv_seq`` splits, its positions of every kv
        head; an mLSTM state its rows of the key dim)."""
        self._frontend(patches, frames, need=False)
        P = self._view()
        fam = self.cfg.family
        if fam == "xlstm":
            return self._prefill_xlstm(P, tokens, cache)
        if fam == "encdec":
            return self._prefill_encdec(P, tokens, frames, cache)
        if fam != "hybrid":
            return self._prefill_attn(P, self._embed_inputs(P, tokens,
                                                            patches), cache)
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        freqs = self._freqs(tokens.device)
        x = embed_tokens(P["embed.tok"], tokens, self.tp)
        sp = self._shared(P)
        seq = self._seq_split(cache["kv"]["k"])
        for layers, j in self._segments():
            for i in layers:
                ln, lp = self._norm_block(P, "ssm_layers", i)
                out, conv, ssm = ssm_forward(lp, norm(ln, x), self.ssm_cfg,
                                             return_state=True, tp=self.tp)
                x = x + out
                cache["conv"][i] = conv.to(cache["conv"].dtype)
                cache["ssm"][i] = ssm
            if j is None:
                continue
            x = self._self_attn_prefill(sp, x, cache["kv"]["k"][j],
                                        cache["kv"]["v"][j], positions,
                                        freqs, False, seq)
            x = x + swiglu(sp["mlp"], norm(sp["ln2"], x), self.tp)
        return self._logits(P, x[:, -1]), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Dict, pos: int):
        """One step for every row: ``tokens`` (B,) or (B, 1) at position
        ``pos`` (the same for all rows).  Updates ``cache`` in place and
        returns (f32 logits (B, vocab), cache).  A windowed arch's cache of
        at most ``window`` positions is a ring (``attention_decode_ring``),
        as in the JAX package.  The encoder-decoder attends its encoder
        memory ``xk``/``xv`` after each self-attention
        (``cross_attention_decode``); the xLSTM family steps each layer's
        state and ignores ``pos``.  Under a mesh the rows are the rank's
        data block and ``cache`` its blocks (``init_cache``, ``prefill``):
        tensor-parallel as ``prefill``, its KV blocks of the rank's kv
        heads (``DECODE_RULES``) or of its positions (``kv_seq`` split:
        the partial attentions merged, ``attention_decode``)."""
        P = self._view()
        fam = self.cfg.family
        if fam == "xlstm":
            return self._decode_xlstm(P, tokens, cache)
        if fam == "encdec":
            return self._decode_encdec(P, tokens, cache, pos)
        if fam != "hybrid":
            return self._decode_attn(P, tokens, cache, pos)
        x = embed_tokens(P["embed.tok"], tokens.reshape(-1, 1), self.tp)
        freqs = self._freqs(x.device)
        sp = self._shared(P)
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        seq = self._seq_split(ck)
        for layers, j in self._segments():
            for i in layers:
                ln, lp = self._norm_block(P, "ssm_layers", i)
                y, conv, ssm = ssm_decode(lp, norm(ln, x), cache["conv"][i],
                                          cache["ssm"][i], self.ssm_cfg,
                                          tp=self.tp)
                x = x + y
                cache["conv"][i] = conv
                cache["ssm"][i] = ssm
            if j is None:
                continue
            x = x + attention_decode(sp["attn"], norm(sp["ln1"], x), ck[j],
                                     cv[j], pos, freqs,
                                     window=self.cfg.window, tp=self.tp,
                                     seq=seq)
            x = x + swiglu(sp["mlp"], norm(sp["ln2"], x), self.tp)
        return self._logits(P, x[:, 0]), cache

    def _ffn(self, lp: Mapping, h: torch.Tensor, decode: bool = False
             ) -> torch.Tensor:
        if self.moe_cfg is None:
            return swiglu(lp["mlp"], h, self.tp)
        if decode:
            return moe_decode(lp["moe"], h, self.moe_cfg, tp=self.tp)
        return moe(lp["moe"], h, self.moe_cfg, tp=self.tp)

    def _check_prompt(self, S: int, slots: int, ring: bool) -> None:
        want = self.cfg.window if ring else S
        if (slots != want) if ring else (slots < S):
            raise ValueError(
                f"prefill of {S} positions needs a cache of "
                f"{'exactly' if ring else 'at least'} {want} positions, got "
                f"{slots} (init_cache(batch, seq) with seq >= {S})")

    def _prefill_attn(self, P: Mapping[str, torch.Tensor], x: torch.Tensor,
                      cache: Dict):
        """The dense, MoE and VLM prefill (``_prefill_attn``) of the
        embedded prompt x (B, S, d): each layer's attention through the
        flash forward with the config's window, its roped K/V into the
        cache; past the window (S > W) only the last W positions are kept,
        position p at slot p % W, so decode continues on the ring."""
        cfg = self.cfg
        S = x.shape[1]
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        seq = self._seq_split(ck)
        W = cfg.window
        ring = W is not None and S > W
        self._check_prompt(S, ck.shape[2] * _ways(seq), ring)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        freqs = self._freqs(x.device)
        for i in range(cfg.n_layers):
            lp = self._layer_params(P, i)
            x = self._self_attn_prefill(lp, x, ck[i], cv[i], positions,
                                        freqs, ring, seq)
            x = x + self._ffn(lp, norm(lp["ln2"], x))
        return self._logits(P, x[:, -1]), cache

    def _self_attn_prefill(self, lp: Mapping, x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor,
                           positions: torch.Tensor, freqs: torch.Tensor,
                           ring: bool, seq: SeqSplit) -> torch.Tensor:
        """x plus layer ``lp``'s causal self-attention over the prompt x
        (B, S, d) through the flash forward with the config's window, its
        roped K/V written into the layer's cache ``ck``/``cv`` (B, slots,
        K, dh): at the head, or, on a ``ring`` (S > W), only the last W
        positions, position p at slot p % W.  Under tensor parallelism on
        the rank's heads (``self_attention_qkv``): the cache block holds
        the kv heads the rank holds, or, where ``seq`` splits its
        positions over the model axis, its positions of every kv head."""
        S, W = x.shape[1], self.cfg.window
        h = norm(lp["ln1"], x)
        group, q, k, v, read = self_attention_qkv(lp["attn"], h, positions,
                                                  freqs, self.tp)
        kk, vv = kv_for_cache(k, v, self.tp, seq)
        if ring:
            slots = [p % W for p in range(S - W, S)]
            kk, vv = kk[:, S - W:], vv[:, S - W:]
        else:
            slots = range(S)
        write_positions(ck, kk, slots, seq)
        write_positions(cv, vv, slots, seq)
        if read is not None:
            k, v = k[:, :, read], v[:, :, read]
        o = ops.flash_attention(q, k, v, causal=True, window=W)
        return x + attention_out(lp["attn"], o, group)

    def _decode_attn(self, P: Mapping[str, torch.Tensor],
                     tokens: torch.Tensor, cache: Dict, pos: int):
        """The dense and MoE branch of ``decode``: a ring cache
        (``attention_decode_ring``) when the arch has a window and the cache
        holds at most that many positions, else attention over positions <=
        pos (and inside the window)."""
        cfg = self.cfg
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        seq = self._seq_split(ck)
        ring = (cfg.window is not None
                and ck.shape[2] * _ways(seq) <= cfg.window)
        x = embed_tokens(P["embed.tok"], tokens.reshape(-1, 1), self.tp)
        freqs = self._freqs(x.device)
        for i in range(cfg.n_layers):
            lp = self._layer_params(P, i)
            x = x + attention_decode(lp["attn"], norm(lp["ln1"], x), ck[i],
                                     cv[i], pos, freqs, window=cfg.window,
                                     ring=ring, tp=self.tp, seq=seq)
            x = x + self._ffn(lp, norm(lp["ln2"], x), decode=True)
        return self._logits(P, x[:, 0]), cache

    def _prefill_encdec(self, P: Mapping[str, torch.Tensor],
                        tokens: torch.Tensor, frames: torch.Tensor,
                        cache: Dict):
        """The encoder-decoder branch of ``_prefill_attn``: the encoder over
        ``frames``, then each decoder layer's ``_self_attn_prefill`` (its
        K/V into the cache at the head) and its cross attention through
        the flash forward over the encoder's output, whose K/V become
        ``xk``/``xv`` at the frames' length Se (what the JAX package's
        prefill returns): under a mesh the rank's block of them, as the
        KV cache's."""
        cfg = self.cfg
        S = tokens.shape[1]
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        seq = self._seq_split(ck)
        self._check_prompt(S, ck.shape[2] * _ways(seq), False)
        enc_out = self.encode(frames, P)
        mseq, Se_blk = self._memory_split(ck, enc_out.shape[1])
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        freqs = self._freqs(tokens.device)
        x = embed_tokens(P["embed.tok"], tokens, self.tp)
        xks, xvs = [], []
        lo = mseq.rank * Se_blk
        for i in range(cfg.n_layers):
            lp = _layer_tree(P, f"dec_layers.{i}.", self.dec_layers[i])
            x = self._self_attn_prefill(lp, x, ck[i], cv[i], positions,
                                        freqs, False, seq)
            hx = norm(lp["lnx"], x)
            group, q, xk, xv, read = cross_attention_qkv(lp["xattn"], hx,
                                                         enc_out, self.tp)
            mk, mv = kv_for_cache(xk, xv, self.tp, mseq)
            xks.append(mk[:, lo:lo + Se_blk].to(ck.dtype))
            xvs.append(mv[:, lo:lo + Se_blk].to(cv.dtype))
            if read is not None:
                xk, xv = xk[:, :, read], xv[:, :, read]
            o = ops.flash_attention(q, xk, xv, causal=False)
            x = x + attention_out(lp["xattn"], o, group)
            x = x + swiglu(lp["mlp"], norm(lp["ln2"], x), self.tp)
        cache["xk"] = torch.stack(xks)
        cache["xv"] = torch.stack(xvs)
        return self._logits(P, x[:, -1]), cache

    def _decode_encdec(self, P: Mapping[str, torch.Tensor],
                       tokens: torch.Tensor, cache: Dict, pos: int):
        """The encoder-decoder branch of ``decode``: per decoder layer,
        ``attention_decode`` over the self-attention cache at ``pos``, then
        ``cross_attention_decode`` over every row of ``xk``/``xv``, then
        the SwiGLU."""
        cfg = self.cfg
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        seq, mseq = self._seq_split(ck), self._seq_split(cache["xk"])
        x = embed_tokens(P["embed.tok"], tokens.reshape(-1, 1), self.tp)
        freqs = self._freqs(x.device)
        for i in range(cfg.n_layers):
            lp = _layer_tree(P, f"dec_layers.{i}.", self.dec_layers[i])
            x = x + attention_decode(lp["attn"], norm(lp["ln1"], x), ck[i],
                                     cv[i], pos, freqs, window=cfg.window,
                                     tp=self.tp, seq=seq)
            x = x + cross_attention_decode(lp["xattn"], norm(lp["lnx"], x),
                                           cache["xk"][i], cache["xv"][i],
                                           tp=self.tp, seq=mseq)
            x = x + swiglu(lp["mlp"], norm(lp["ln2"], x), self.tp)
        return self._logits(P, x[:, 0]), cache

    def _state_rows(self, state: torch.Tensor,
                    block: torch.Tensor) -> torch.Tensor:
        """The rank's block of a whole mLSTM state (C (B, H, dh, dh) or n
        (B, H, dh)): its rows of the key dim (dim 2) where the cache's
        block splits it."""
        n = block.shape[2]
        if n == state.shape[2]:
            return state
        return state[:, :, self.tp.rank * n:(self.tp.rank + 1) * n]

    def _prefill_xlstm(self, P: Mapping[str, torch.Tensor],
                       tokens: torch.Tensor, cache: Dict):
        """``_prefill_xlstm``: the xLSTM trunk with each layer's final
        state into the cache (mLSTM i: ``C``/``n`` [i]; sLSTM j:
        ``sc``/``sn``/``sh``/``sm`` [j]).  S must be at most the mLSTM
        chunk (128) or a multiple of it."""
        x = embed_tokens(P["embed.tok"], tokens, self.tp)
        for layers, j in self._xlstm_segments():
            for i in layers:
                ln, lp = self._norm_block(P, "mlstm_layers", i)
                out, C, n = mlstm_parallel(lp, norm(ln, x), self.xl_cfg,
                                           return_state=True, tp=self.tp)
                x = x + out
                cache["C"][i] = self._state_rows(C, cache["C"][i])
                cache["n"][i] = self._state_rows(n, cache["n"][i])
            if j is None:
                continue
            ln, sp = self._norm_block(P, "slstm_layers", j)
            y, state = slstm_forward(sp, norm(ln, x), self.xl_cfg,
                                     tp=self.tp)
            x = x + y
            for name, t in zip(SLSTM_STATE, state):
                cache[name][j] = t
        return self._logits(P, x[:, -1]), cache

    def _decode_xlstm(self, P: Mapping[str, torch.Tensor],
                      tokens: torch.Tensor, cache: Dict):
        """``_decode_xlstm``: one step of every mLSTM layer
        (``mlstm_decode``) and sLSTM layer (``slstm_decode``) from the
        cached states, written back in place."""
        x = embed_tokens(P["embed.tok"], tokens.reshape(-1, 1), self.tp)
        for layers, j in self._xlstm_segments():
            for i in layers:
                ln, lp = self._norm_block(P, "mlstm_layers", i)
                y, C, n = mlstm_decode(lp, norm(ln, x), cache["C"][i],
                                       cache["n"][i], self.xl_cfg,
                                       tp=self.tp)
                x = x + y
                cache["C"][i] = C
                cache["n"][i] = n
            if j is None:
                continue
            ln, sp = self._norm_block(P, "slstm_layers", j)
            state = tuple(cache[name][j] for name in SLSTM_STATE)
            y, state = slstm_decode(sp, norm(ln, x), state, self.xl_cfg,
                                    tp=self.tp)
            x = x + y
            for name, t in zip(SLSTM_STATE, state):
                cache[name][j] = t
        return self._logits(P, x[:, 0]), cache


def _ways(seq: SeqSplit) -> int:
    """How many blocks a cache's positions split into."""
    return 1 if seq.group is None else group_size(seq.group)
