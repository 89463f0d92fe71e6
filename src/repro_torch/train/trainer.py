"""Training loop with the paper's online guidance wired in
(``repro/train/trainer.py``).

The Trainer owns:
  * the train step (``train.step``) over the model's parameters and the
    AdamW moments, both on the card,
  * the guidance runtime: every parameter and moment group is an
    allocation site, keyed exactly as the JAX trainer keys it (depth-3
    names of the JAX tree: ``params/layers/attn``, ``adam_m/layers/mlp``,
    ``params/embed/tok``, ...), so the arenas, their bytes and the
    runtime's decisions are the JAX trainer's.  An arena's entries are the
    port's per-layer tensors in JAX's leaf order, the layer index inside
    (``params/layers/attn/wk/0`` .. ``/15``, then ``wo``, ...).  The static
    access model charges each group's traffic per step; at the decision
    interval ``GuidanceRuntime`` (over an ``ArenaBackend`` and a
    ``TorchArenaPlacer``) may move groups between HBM and pinned host
    memory under an HBM budget,
  * checkpoint save and restore (``ckpt``, the JAX layout).

Offload execution model (DESIGN.md Sec. 4): compute runs on tensors on
the card.  Slow-tier groups are fetched before the step and written back
after; that per-step transfer is the rental the ski-rental controller
weighs against migration.  Between steps a slow-tier parameter's
``.data`` and a slow-tier moment are the placer's pinned host buffers, so
their HBM is free.

The parameters are the model's own (``model.named_parameters()`` in JAX's
leaf order): the optimizer updates them in place, and placement swaps
their ``.data``.  A Trainer made under ``dist.sharding.use_mesh`` holds
the rank's blocks (``Model.shard_``) and runs every step under that mesh,
so the step's data-parallel reduction and tensor parallelism apply; its
batches are the rank's data blocks (``data.ShardedLoader``).  Its
``profile`` (``"fsdp"``: ``FSDP_RULES``, every leaf's ``embed`` dim over
the data axis, gathered before use) and ``moments`` (``"zero1"``: a
layer's moments on the data rank that owns it, ``train.step.zero1_layout``)
are the JAX dry run's ``--profile`` and ``--moments``; without a mesh they
change nothing.  Checkpoints of a mesh of more than one rank are not
written from local blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch

from ..convert import jax_order, jax_path, params_from_numpy, params_to_numpy
from ..core import (
    H100,
    ArenaBackend,
    ArenaManager,
    GuidanceConfig,
    GuidanceRuntime,
    HardwareModel,
    SiteKind,
    SiteRegistry,
)
from ..core.placement import TorchArenaPlacer
from ..dist.sharding import (DEFAULT_RULES, FSDP_RULES, active_mesh,
                             mesh_sizes, use_mesh, use_rules)
from ..models.transformer import Model
from ..optim.adamw import AdamW, AdamWState
from .step import StepConfig, make_train_step, zero1_layout

_TREES = ("params", "adam_m", "adam_v")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0                 # 0 = off
    ckpt_dir: Optional[str] = None
    gdt: Optional[GuidanceConfig] = None  # None = tiering disabled
    step: StepConfig = dataclasses.field(default_factory=StepConfig)
    # Param-init seed when no generator is passed to the Trainer; not
    # defaulted, so no run silently shares one init stream.
    seed: Optional[int] = None
    # Under a mesh: the parameter layout ("tp": DEFAULT_RULES, "fsdp":
    # FSDP_RULES) and the moments' ("tp": as the parameters, "zero1": a
    # layer's on its data rank).
    profile: str = "tp"
    moments: str = "tp"


class Trainer:
    def __init__(self, model: Model, opt: AdamW, cfg: TrainerConfig,
                 hw: HardwareModel = H100,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None):
        """``params``: a state dict to start from (the JAX package's
        weights through ``convert.params_from_numpy``) instead of a random
        init from ``generator`` or ``cfg.seed``."""
        self.model = model
        self.opt = opt
        self.cfg = cfg
        self.hw = hw
        self.device = model.device
        if params is not None:
            model.load_state_dict(params)
        else:
            if generator is None:
                if cfg.seed is None:
                    raise ValueError(
                        "Trainer needs randomness it can attribute: pass "
                        "generator=torch.Generator(device).manual_seed(seed)"
                        ", params=..., or set TrainerConfig.seed")
                generator = torch.Generator(
                    device=self.device).manual_seed(cfg.seed)
            model.init(generator)
        if cfg.profile not in ("tp", "fsdp") or cfg.moments not in (
                "tp", "zero1"):
            raise ValueError(f"profile {cfg.profile!r} (tp | fsdp), moments "
                             f"{cfg.moments!r} (tp | zero1)")
        self.rules = FSDP_RULES if cfg.profile == "fsdp" else DEFAULT_RULES
        self.mesh = active_mesh()
        layout = None
        if self.mesh is not None:
            model.shard_(self.mesh, self.rules)
            if cfg.moments == "zero1":
                layout = zero1_layout(model, self.mesh, self.rules)
        named = dict(model.named_parameters())
        self.params: Dict[str, torch.nn.Parameter] = {
            n: named[n] for n in jax_order(named)}
        self.opt_state = opt.init(self.params, layout)
        self.step_fn = make_train_step(model, opt, cfg.step)
        self.metrics_log: list = []

        # ---- paper integration: sites + arenas + controller ----
        self.registry = SiteRegistry()
        gdt_cfg = cfg.gdt if cfg.gdt is not None else GuidanceConfig(
            enabled=False)
        self.arenas = ArenaManager(
            self.registry,
            promotion_threshold=gdt_cfg.promotion_threshold,
            fast_capacity_bytes=(gdt_cfg.fast_capacity_bytes or None)
            if gdt_cfg.enabled else None,
        )
        self.placer = TorchArenaPlacer(self.arenas, device=self.device)
        # The shared Algorithm-1 controller over the real-tensor backend.
        self.gdt = GuidanceRuntime(
            ArenaBackend(self.arenas, hw, placer=self.placer), hw, gdt_cfg)
        self.runtime = self.gdt
        # key -> (site, arena, [(entry name, tree, state-dict name)])
        self._site_groups: Dict[str, Tuple[Any, Any, List]] = {}
        if gdt_cfg.enabled:
            self._register_state()

    # ------------------------------------------------------- live state
    def _get(self, tree: str, name: str) -> torch.Tensor:
        if tree == "params":
            return self.params[name]
        return (self.opt_state.m if tree == "adam_m"
                else self.opt_state.v)[name]

    def _set(self, tree: str, name: str, t: torch.Tensor) -> None:
        if tree == "params":
            self.params[name].data = t
        else:
            (self.opt_state.m if tree == "adam_m"
             else self.opt_state.v)[name] = t

    # ------------------------------------------------------------- sites
    def _register_state(self):
        """Register depth-3 groups of the JAX trees as sites and bind their
        tensors; then point the live state at what the placer holds, so
        first-touch spills leave HBM at once."""
        kinds = {"params": SiteKind.PARAM, "adam_m": SiteKind.OPT_STATE,
                 "adam_v": SiteKind.OPT_STATE}
        for tree in _TREES:
            groups: Dict[str, list] = {}
            for name in self.params:
                if tree != "params" and name not in self.opt_state.m:
                    continue                # zero1: another rank's layer
                path, layer = jax_path(name)
                parts = [tree] + path.split("/")
                key = "/".join(parts[: self.registry.context_depth])
                entry = "/".join(parts) + (
                    "" if layer is None else f"/{layer}")
                groups.setdefault(key, []).append((entry, tree, name))
            for key, members in groups.items():
                site = self.registry.register(key.split("/"), kinds[tree])
                nbytes = sum(self._get(t, n).numel()
                             * self._get(t, n).element_size()
                             for _, t, n in members)
                arena = self.arenas.allocate(site, nbytes)
                if arena is None:
                    continue
                for entry, t, n in members:
                    self.placer.bind(arena.arena_id, entry, self._get(t, n))
                self._site_groups[key] = (site, arena, members)
        self._point_at_placer()

    def _point_at_placer(self):
        for _, arena, members in self._site_groups.values():
            stored = {e.name: e.tensor
                      for e in self.placer.entries(arena.arena_id)}
            for entry, tree, name in members:
                self._set(tree, name, stored[entry])

    def _charge_access_model(self):
        """Static per-step access model: params read fwd+bwd (+written),
        moments read+written once (DESIGN.md Sec. 2)."""
        for site, arena, _ in self._site_groups.values():
            weight = 3 if site.kind == SiteKind.PARAM else 2
            self.arenas.touch(site, weight * arena.resident_bytes)

    # -------------------------------------------------- placer <-> state
    def _sync_state_from_placer(self):
        """Fetch every group to the card for the step (slow ones pay the
        rental)."""
        for _, arena, members in self._site_groups.values():
            fetched = self.placer.fetch_fast(arena.arena_id)
            for entry, tree, name in members:
                self._set(tree, name, fetched[entry])

    def _sync_state_to_placer(self):
        """Write the step's results back into the placer (slow groups pay
        the other half of the rental), then point the live state at the
        placer's tensors so tier state carries to the next step."""
        for _, arena, members in self._site_groups.values():
            self.placer.writeback(arena.arena_id, {
                entry: self._get(tree, name)
                for entry, tree, name in members})
        self._point_at_placer()

    # -------------------------------------------------------------- loop
    def run(self, batches: Iterable[Mapping[str, torch.Tensor]]
            ) -> Dict[str, Any]:
        gdt_on = self.gdt.config.enabled
        it = iter(batches)
        t0 = time.perf_counter()
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(self.cfg.steps):
            batch = next(it)
            if gdt_on:
                self._sync_state_from_placer()
            with contextlib.ExitStack() as ctx:
                if self.mesh is not None:
                    ctx.enter_context(use_rules(self.rules))
                    ctx.enter_context(use_mesh(self.mesh))
                _, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
            if gdt_on:
                self._sync_state_to_placer()
                self._charge_access_model()
                self.gdt.on_step()
            if self.cfg.log_every and (i + 1) % self.cfg.log_every == 0:
                self.metrics_log.append(
                    {k: float(v) for k, v in metrics.items()})
            if (self.cfg.ckpt_every and self.cfg.ckpt_dir
                    and (i + 1) % self.cfg.ckpt_every == 0):
                self.save_checkpoint(int(metrics["step"]))
        wall = time.perf_counter() - t0
        out = {"wall_seconds": wall,
               "final_loss": float(metrics["loss"]),
               "steps": self.cfg.steps}
        if gdt_on:
            out["migrations"] = self.gdt.migration_count
            out["bytes_migrated"] = self.gdt.total_bytes_migrated
            out["transfer_bytes"] = self.placer.transfers_bytes
        return out

    # ------------------------------------------------------- checkpoints
    def _whole_state(self, what: str) -> None:
        if any(s > 1 for s in mesh_sizes(self.mesh).values()):
            raise ValueError(f"{what} of a Trainer on a mesh of more than "
                             f"one rank: its tensors are the rank's blocks")

    def save_checkpoint(self, step: int):
        """The JAX trainer's tree: ``params``, ``m``, ``v`` layer-stacked,
        ``opt_step``."""
        from ..ckpt.checkpoint import save

        self._whole_state("a checkpoint")
        save(self.cfg.ckpt_dir, step,
             {"params": params_to_numpy(self.params),
              "m": params_to_numpy(self.opt_state.m),
              "v": params_to_numpy(self.opt_state.v),
              "opt_step": self.opt_state.step.numpy()})

    def restore_checkpoint(self, step: Optional[int] = None):
        """Load a checkpoint (written by either package).  With guidance
        on, the restored values are written into the placer too, so the
        next step's fetch does not bring back the values it held."""
        from ..ckpt.checkpoint import restore

        self._whole_state("a restore")
        tree, meta = restore(self.cfg.ckpt_dir, step)
        params = params_from_numpy(tree["params"], self.device)
        with torch.no_grad():
            for name, p in self.params.items():
                p.data = params[name].to(p.dtype)
        m = params_from_numpy(tree["m"], self.device)
        v = params_from_numpy(tree["v"], self.device)
        self.opt_state = AdamWState(
            torch.tensor(int(tree["opt_step"]), dtype=torch.int32),
            {n: m[n] for n in self.params}, {n: v[n] for n in self.params})
        if self._site_groups:
            self._sync_state_to_placer()
        return meta
