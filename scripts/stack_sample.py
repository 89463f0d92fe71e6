"""Run a Python script under a stack sampler and say where its wall time
went.

    python3 scripts/stack_sample.py --out chiprun_out/smoke -- chip_smoke.py

A thread records the main thread's stack every ``--interval`` seconds
(0.5 by default; the script itself runs unslowed).  At exit it writes
``<out>.txt`` and ``<out>.json``: the seconds in which each function of
the script was on the stack, and for each innermost line of the script
the first function it called outside it.  The script runs in this
process as ``__main__`` with the remaining arguments, from the current
directory; its exit code is this one's.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--interval", type=float, default=0.5)
    ap.add_argument("--out", default="stack_sample")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    target = os.path.abspath(a.script)
    main_id = threading.get_ident()
    inclusive = collections.Counter()
    edges = collections.Counter()
    stop = threading.Event()
    samples = [0]

    def sample() -> None:
        while not stop.wait(a.interval):
            frame = sys._current_frames().get(main_id)
            stack = []
            while frame is not None:
                stack.append((frame.f_code.co_filename, frame.f_code.co_name,
                              frame.f_lineno))
                frame = frame.f_back
            stack.reverse()
            samples[0] += 1
            seen, last = set(), None
            for i, (path, name, _) in enumerate(stack):
                if os.path.abspath(path) == target:
                    if name not in seen:
                        inclusive[name] += 1
                        seen.add(name)
                    last = i
            if last is None:
                continue
            _, name, line = stack[last]
            if last + 1 < len(stack):
                path, callee, _ = stack[last + 1]
                edges[f"{name}:{line} -> {os.path.basename(path)}:"
                      f"{callee}"] += 1
            else:
                edges[f"{name}:{line} (self)"] += 1

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    sys.argv = [a.script] + a.args
    rc = 0
    try:
        runpy.run_path(a.script, run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                      else 1)
    finally:
        stop.set()
        thread.join()
        with open(a.out + ".json", "w") as fh:
            json.dump({"interval": a.interval, "samples": samples[0],
                       "inclusive": inclusive.most_common(),
                       "edges": edges.most_common()}, fh, indent=0)
        with open(a.out + ".txt", "w") as fh:
            fh.write(f"{samples[0]} samples, {a.interval} s apart\n")
            for name, n in inclusive.most_common(80):
                fh.write(f"{n * a.interval:8.1f} s  {name}\n")
            fh.write("\n")
            for edge, n in edges.most_common(120):
                fh.write(f"{n * a.interval:8.1f} s  {edge}\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
