"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``src/repro_torch``.  It needs a
CUDA device (as many as the cell asks for) and fails without one; it
never falls back to the CPU.  With ``--trace 0`` the line's metrics are
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``BENCHMARK.json``).  The check of the outputs runs after the window; its
numbers are the last lines on standard error and the last key of the
line."""

from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock (the kernel's
    start time in /proc), or now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return now - min(max(age, 0.0), 60.0)
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    T_PROCESS = process_start()
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # The checkout's caches, at fixed paths inside it (the port builds its
    # kernels in its own fixed src/repro_torch/kernels/build).
    CACHE = os.path.join(ROOT, "portbench", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from portbench.harness.main import main

    sys.exit(main(sys.argv[1:], T_PROCESS))
