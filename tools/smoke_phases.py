#!/usr/bin/env python3
"""Chosen phases of ``chip_smoke.py`` in one process on the card, or one
model's ``train_fq`` ladder, with the host's CPU named.

Each name is a phase (``phase_<name>`` of ``chip_smoke.py``: ``build``,
``train_transformer``, ...) or ``train_fq:<model>`` (``kws``, ``darknet``,
``resnet20``, ``resnet32``: that model's ladder as ``train_fq`` runs it).
They run in the order given, in one process, TF32 off as ``chip_smoke.py``
sets it; a failure is printed and the next name runs. Each ends with a
``== <name> passed|FAILED: <s> s`` line; the exit code is 1 if any failed.
Two names in one process show what an earlier phase leaves behind for a
later one: ``train_transformer train_fq:darknet`` against
``train_fq:darknet`` alone.

``--deterministic`` runs them under cuDNN's deterministic algorithms and
``torch.use_deterministic_algorithms(True, warn_only=True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``), so that a card step repeats run to
run; an op with no deterministic kernel warns. ``chip_smoke.py`` itself
runs without it.

Run on a CUDA machine from the repo root::

    python3 tools/smoke_phases.py --deterministic train_transformer \\
        train_fq:darknet
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="+")
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args(argv)
    if args.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if not torch.cuda.is_available():
        print("smoke_phases: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with open("/proc/cpuinfo") as f:
        cpus = [line.split(":", 1)[1].strip() for line in f
                if line.startswith("model name")]
    print(f"host: {cpus[0] if cpus else '?'} x {len(cpus)}; "
          f"{C.nvidia_smi()}; torch {torch.__version__}; deterministic "
          f"{args.deterministic}", flush=True)
    failed = 0
    for name in args.names:
        t0 = time.perf_counter()
        try:
            if name.startswith("train_fq:"):
                C.train_model(torch, dev, name.split(":", 1)[1],
                              C.nvidia_smi())
            elif name == "build":
                C.phase_build(torch)
            else:
                getattr(C, f"phase_{name}")(torch, dev)
            torch.cuda.synchronize()
            ok = "passed"
        except Exception:
            traceback.print_exc(file=sys.stdout)
            ok, failed = "FAILED", failed + 1
        print(f"== {name} {ok}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
