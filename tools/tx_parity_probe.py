#!/usr/bin/env python3
"""Decode parity of ``chip_smoke.py``'s ``serve_transformer`` phase at full
width, over several seeds, with planted int8-KV faults.

For each params seed of ``--seeds`` (minitron-4b at full width and depth,
``make_params`` on the card, converted to int8 serving codes as the phase
converts them) and each of the first ``--prompts`` prompts the phase draws
(128 tokens), it runs prefill(125) + 3 decode steps against forward over the
128 tokens and prints, each x max|logit| of forward's:

* ``bf16``: the served model (``chip_smoke.TX_RTOL``'s reading);
* ``f32``: the same weights with float32 activations and caches
  (``TX_RTOL_F32``'s);
* ``kv8_bf16`` and ``kv8_f32``: the same with ``kv_bits=8``
  (``TX_KV8_GUARD``'s);

and the same ``kv8`` readings with each planted fault of ``--faults`` in
place (set at run time around ``models.attention``; nothing is edited):

* ``k2x``: K of KV head 0 dequantized at twice its scale;
* ``v2x``: V of KV head 0 dequantized at twice its scale;
* ``floor``: the int8 codes rounded down instead of half-even.

With ``--batcher`` it also serves the first 4 prompts (32 new tokens each)
through ``ContinuousBatcher`` on 4 slots and runs ``generate`` at B=1 on
prompt 0, in bf16 and in float32, and prints the tokens they agree for.
The last line is a JSON object of every reading.

Run on a CUDA machine from the repo root (~40 s a seed)::

    python3 tools/tx_parity_probe.py --seeds 0 1 2 --prompts 4 --batcher
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402

FAULTS = ("k2x", "v2x", "floor")


@contextlib.contextmanager
def planted(torch, fault):
    """``models.attention`` with ``fault`` in its int8 KV path."""
    from repro_torch.models import attention as A
    q8, dq8 = A._q8, A._dq8
    calls = [0]

    def dq8_head0_2x(codes, scale, dtype):
        # decode_attention dequantizes K, then V
        is_v = calls[0] % 2 == 1
        calls[0] += 1
        if is_v == (fault == "v2x"):
            scale = scale.clone()
            scale[..., 0] *= 2
        return dq8(codes, scale, dtype)

    def q8_floor(x):
        _, scale = q8(x)
        codes = torch.floor(torch.div(x.float(), scale[..., None]))
        return codes.to(torch.int8), scale

    if fault in ("k2x", "v2x"):
        A._dq8 = dq8_head0_2x
    elif fault == "floor":
        A._q8 = q8_floor
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        A._q8, A._dq8 = q8, dq8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--faults", nargs="*", default=list(FAULTS),
                    choices=FAULTS)
    ap.add_argument("--batcher", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serve.batching import ContinuousBatcher, Request
    from repro_torch.serve.decode import generate

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(f"tx_parity_probe on {smi}", flush=True)
    arch = get_arch(cs.TX_ARCH)
    cfg, q = arch.model, arch.qcfg
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
    n_pre = cs.TX_PROMPT - cs.TX_DECODE
    record = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        with torch.no_grad():
            sp = T.quantize_params_for_serving(T.make_params(
                torch.Generator(device=dev).manual_seed(seed), cfg,
                device=dev), bits_w=arch.serve_bits_w)
            sp32 = tree.map(lambda x: x.float() if x.dtype == torch.bfloat16
                            else x, sp)
            # the phase's prompts: default_rng(SEED + 31), 8 x 128
            prompts = np.random.default_rng(cs.SEED + 31).integers(
                0, cfg.vocab, (max(cs.TX_REQUESTS, args.prompts),
                               cs.TX_PROMPT)).astype(np.int32)
            for j in range(args.prompts):
                toks = torch.from_numpy(prompts[j:j + 1]).to(dev)

                def run(p, c):
                    lg, caches = T.prefill(p, {"tokens": toks[:, :n_pre]},
                                           c, q, max_len=cs.TX_MAX_LEN)
                    out = [lg[0, -1]]
                    for i in range(n_pre, cs.TX_PROMPT):
                        lg, caches = T.decode_step(p, caches,
                                                   toks[:, i:i + 1], c, q)
                        out.append(lg[0, -1])
                    return torch.stack(out).float()

                want = T.forward(sp, {"tokens": toks}, cfg, q)[0][
                    0, n_pre - 1:].float()
                want32 = T.forward(sp32, {"tokens": toks}, cfg32, q)[0][
                    0, n_pre - 1:].float()

                def ratio(got, w):
                    err, top, _ = cs.tx_compare(torch, got, w, 1.0)
                    return err / top

                row = {"seed": seed, "prompt": j,
                       "bf16": ratio(run(sp, cfg), want),
                       "f32": ratio(run(sp32, cfg32), want32)}
                for fault in [None] + args.faults:
                    tag = "" if fault is None else f"_{fault}"
                    with planted(torch, fault):
                        row[f"kv8_bf16{tag}"] = ratio(run(
                            sp, dataclasses.replace(cfg, kv_bits=8)), want)
                        row[f"kv8_f32{tag}"] = ratio(run(
                            sp32, dataclasses.replace(cfg32, kv_bits=8)),
                            want32)
                record.append(row)
                print(f"seed {seed} prompt {j}: " + ", ".join(
                    f"{k} {v:.5g}" for k, v in row.items()
                    if k not in ("seed", "prompt")), flush=True)
            if args.batcher:
                slots = max(cs.TX_SLOTS)
                toks = torch.from_numpy(prompts[:1]).to(dev)
                agree = {}
                for name, p, c in (("bf16", sp, cfg), ("f32", sp32, cfg32)):
                    out = ContinuousBatcher(
                        p, c, q, slots=slots, max_len=cs.TX_MAX_LEN).run(
                        [Request(rid=i, prompt=prompts[i].tolist(),
                                 max_new=cs.TX_NEW) for i in range(slots)])
                    single = generate(p, c, q, {"tokens": toks},
                                      max_new=cs.TX_NEW,
                                      max_len=cs.TX_MAX_LEN)[0].tolist()
                    agree[name] = next(
                        (i for i, (x, y) in enumerate(zip(single, out[0]))
                         if x != y), cs.TX_NEW)
                record.append({"seed": seed, "batcher_agree": agree})
                print(f"seed {seed} batcher (4 slots) against generate at "
                      f"B=1, request 0: tokens agree for {agree} of "
                      f"{cs.TX_NEW}", flush=True)
        del sp, sp32
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    rows = [r for r in record if "bf16" in r]
    for key in rows[0]:
        if key in ("seed", "prompt"):
            continue
        vals = [r[key] for r in rows]
        print(f"{key}: min {min(vals):.5g} max {max(vals):.5g} over "
              f"{len(vals)}", flush=True)
    print(json.dumps({"device": smi, "rows": record}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
