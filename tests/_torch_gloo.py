"""Run a worker script as the ranks of a gloo group on the CPU: one
subprocess a rank, joined through a ``FileStore`` under the test's
temporary directory, each with its own time limit, so a stuck rendezvous
fails its test and nothing else.  A worker is called as

    python WORKER STORE_FILE WORLD RANK OUT_DIR [ARGS...]

and saves what it got to ``OUT_DIR/rank<r>.pt``."""

import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RANK_TIMEOUT = 240          # seconds for one rank's whole run


def run_ranks(worker, world, tmp, *args, timeout=RANK_TIMEOUT):
    """Run ``world`` ranks of ``worker`` (a file beside this one) to the
    end in ``tmp``; each rank's saved results.  A rank's output goes to a
    file (a full pipe could stall it inside a collective)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, worker),
         os.path.join(tmp, "store"), str(world), str(r), tmp,
         *map(str, args)], env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, p in enumerate(procs):
        with open(os.path.join(tmp, f"rank{r}.log")) as f:
            assert p.returncode == 0, f"rank {r} of {world}:\n{f.read()}"
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def join_group(store_file, world, rank):
    """Initialise the default gloo group of a worker rank."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)


def run_jax(script, tmp, devices, timeout=600):
    """Run ``script`` (Python source) in a subprocess that sees ``devices``
    fake XLA host devices, with ``OUT`` naming an ``.npz`` under ``tmp``
    for it to write; its arrays."""
    import numpy as np

    out = os.path.join(tmp, "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    proc = subprocess.run([sys.executable, "-c", f"OUT = {out!r}\n" + script],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}
