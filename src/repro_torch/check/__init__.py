"""repro_torch.check — the port's static contract linter.

The port carries hard contracts that example-based tests can only
spot-check: bitwise-deterministic streams (prefill == decode, tiered ==
resident, N replicas == 1), every kernel launch checked and counted,
seeded generators only, collectives only through the counted wrappers,
and the PagedKVPool acquire/copy_page/release_request protocol.  This
package enforces them statically, over the port's Python and its CUDA
sources, the way ``repro.check`` does for the JAX package:

    python -m repro_torch.check src/repro_torch examples/*_torch.py \
        [--format json]

Exit code == number of findings (capped at 255), so a gate is a bare
invocation.

Rules (ids and contracts are ``repro.check``'s, restated for torch and
CUDA where the JAX form names JAX):

  DET01  nondeterminism reaching the device: index/scatter accumulations,
         CUDA atomics and PTX reductions, host randomness or set
         iteration under an autograd Function / nn.Module forward
  DET02  generator discipline: global-generator draws, hardcoded
         Generator().manual_seed(<literal>) fallbacks, a generator
         reseeded to one seed in a loop
  KRN01  kernel launch contract: cudaGetLastError after each launch,
         int extern "C" entries, wrapper results tested and raised,
         launches counted in LAUNCHES, no silent fallback
  KV01   PagedKVPool protocol: acquire without release, mutation of
         shared pages without copy_page, free on a held request page
  SPMD01 collectives only through dist/collectives.py, each bound to a
         group, peers and perms covering the ring
  SCHED01 unseeded or global-state randomness in serve/ or ft/
  FT01   wall-clock calls in serve/ or ft/ (inject the clock)
  EXC01  broad except that swallows without re-raise or logging
  CHK00  linter hygiene: unparsable file, malformed suppression

Suppressions are inline and must carry a reason:

    # check: disable=EXC01 -- capability probe; None is the contract
    // check: disable=DET01 -- (in a .cu source)

either on the finding's line or on a comment line directly above it.
A suppression without a reason is itself a CHK00 finding.

Directories named ``check_fixtures`` (the known-bad rule fixtures) and
``build`` (the kernels' nvcc outputs) are skipped during traversal;
explicitly listed files are always checked.
"""

from .runner import iter_source_files, load_module, run_check
from .registry import CudaModule, Module, Rule, all_rules, get_rule, register
from .report import Finding, render_json, render_text

__all__ = [
    "CudaModule",
    "Finding",
    "Module",
    "Rule",
    "all_rules",
    "get_rule",
    "iter_source_files",
    "load_module",
    "register",
    "render_json",
    "render_text",
    "run_check",
]
