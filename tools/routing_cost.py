#!/usr/bin/env python3
"""Host cost of an eager kernel call and of an LM decode step, to compare
two trees of the port (say a commit and its parent) on one card.

Times, on the host clock with the card synchronized at the end of each
round, the median over ``--rounds`` rounds of:

* one eager call of K2 (``kernels.fq_matmul.fq_matmul``) at the integer
  LM's decode shape, M = 8 rows (8 slots), K = N = d_model = 64, int8
  requant;
* one eager decode step of ``models.fq_lm`` at 8 slots (the island
  constants derived once, as the batcher derives them), on the full-width
  seeded stand-in ``FQLMConfig()``.

Prints one JSON line with the tree, the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and the two times. Separate processes differ by up to ~50% on one
host, so a tree whose wrappers route on ``device.tracing`` (the port since
its analysis slice) also times, in the same process, rounds alternating
with that check replaced by a constant (``*_nocheck``), and the check
alone (``check_us``, a call). Run on a CUDA machine::

    python3 tools/routing_cost.py --src src
    python3 tools/routing_cost.py --src <parent checkout>/src
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

ROUNDS = 8     # rounds a mode, medians reported
CALLS = 2000   # K2 calls a round
STEPS = 50     # decode steps a round (a prompt of 8, max_seq 128)


def _round_ms(torch, fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default="src",
                    help="the tree's src directory (default %(default)s)")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch

    from repro_torch.kernels.fq_matmul import fq_matmul
    from repro_torch.models import fq_lm

    if not torch.cuda.is_available():
        raise SystemExit("routing_cost: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    cfg, qcfg = fq_lm.FQLMConfig(), fq_lm.LM_QCFG

    a = torch.randint(-127, 128, (8, cfg.d_model), generator=gen,
                      dtype=torch.int8).to(dev)
    b = torch.randint(-127, 128, (cfg.d_model, cfg.d_model), generator=gen,
                      dtype=torch.int8).to(dev)
    s = torch.tensor(0.01, device=dev)

    def k2():
        return fq_matmul(a, b, s, n_out=127, lo=-127)

    params = fq_lm.standin_params(gen, cfg, device=dev)
    stack = fq_lm.convert_int(params, cfg, qcfg)
    consts = fq_lm.island_consts(stack)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 8)).astype(
        np.int32)).to(dev)
    tok = toks[:, -1:].contiguous()

    def steps():
        """A round of decode steps from a fresh prefill of the prompt (the
        prefill untimed): every round decodes the same positions."""
        _, caches = fq_lm.int_prefill(stack, toks, qcfg, cfg,
                                      max_len=cfg.max_seq, consts=consts)
        return _round_ms(torch, lambda: fq_lm.int_decode_step(
            stack, caches, tok, qcfg, cfg, inplace=True, consts=consts),
            STEPS)

    for _ in range(5):   # warm up: build, load, first launches
        k2()
    steps()
    wrappers = [sys.modules[f"repro_torch.kernels.{m}"]
                for m in ("fq_matmul", "fq_conv")]
    checked = getattr(wrappers[0], "tracing", None)
    out = {"src": args.src, "nvidia_smi": smi, "torch": torch.__version__}
    modes = [("", checked)]
    if checked is not None:
        modes.append(("_nocheck", lambda: False))
    times = {label: ([], []) for label, _ in modes}
    for r in range(ROUNDS):   # the modes' rounds interleaved, ABBA
        for label, fn in (modes if r % 2 == 0 else modes[::-1]):
            if checked is not None:
                for w in wrappers:
                    w.tracing = fn
            times[label][0].append(_round_ms(torch, k2, CALLS))
            times[label][1].append(steps())
    if checked is not None:
        for w in wrappers:
            w.tracing = checked
        # the check alone, a call
        out["check_us"] = statistics.median(
            _round_ms(torch, checked, CALLS * 50) * 1e3
            for _ in range(ROUNDS))
    for label, (k2_ms, step_ms) in times.items():
        out[f"k2_m8_eager_ms{label}"] = statistics.median(k2_ms)
        out[f"k2_m8_eager_ms{label}_rounds"] = k2_ms
        out[f"decode_step_slots8_ms{label}"] = statistics.median(step_ms)
        out[f"decode_step_slots8_ms{label}_rounds"] = step_ms
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
