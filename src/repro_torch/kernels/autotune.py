"""The port's autotune table for the conv tile policy, measured on the card.

    python -m repro_torch.kernels.autotune            # measure and print
    python -m repro_torch.kernels.autotune --record   # ... and write the table

Counterpart of the reference's ``benchmarks/autotune_conv.py``, for the one
knob the CUDA kernel reads: ``bc``, the block of input channels, which K3
runs as split-K (:func:`.fq_conv.pick_blocks`). For every table key
(kh, kw, stride, weight_format) of the models' integer convs (DarkNet-19 at
224 x 224, request batches 1 and 8; KWS at 1, 8 and 64; int8, ternary and
int4 weights) it times K3 at each of the key's unpooled shapes (pooled convs
never split) as a CUDA-graph replay, under each candidate policy:

  * ``fallback``: no ``bc`` in the entry, so :func:`.fq_conv.split_fallback`
    picks one per shape (the SM-filling split);
  * ``cap <c>`` for c in CAPS: ``bc`` = the largest divisor of Cin at most
    c, the table's rule for an entry's ``bc``;
  * ``no split``: ``bc`` = Cin, written as the cap of the largest Cin.

The policy with the least device time summed over the key's shapes wins;
its entry carries its ``bc`` (none for the fallback), the summed times of
every candidate and the card's name and power limit. Packed keys fix
``bc`` to cin_p, so their entry holds no knob: it marks the key measured,
with its time. ``--record`` writes the JSON document that
:func:`.fq_conv.load_autotune_table` reads (``--out``, by default the
table beside ``fq_conv.py``), stamped backend ``cuda``. It needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.quant import n_levels, pack_im2col_codes
from . import _build, fq_conv

CAPS = (64, 128, 256, 512)
FORMATS = ("int8", "ternary", "int4")
DARKNET_BATCHES = (1, 8)
KWS_BATCHES = (1, 8, 64)
SEED = 0


def conv_shapes() -> Dict[Tuple[int, int, int, str], List[dict]]:
    """{int8 key: [shape]} of the models' unpooled integer convs: each
    shape (batch, h, w, cin, cout, kh, kw, padding, dilation) as a dict."""
    from ..models import darknet, kws
    out: Dict[Tuple[int, int, int, str], List[dict]] = {}
    cfg = darknet.DarkNetConfig()
    convs = [c for c in cfg.layers if c != "M"]
    side = 224
    for step in darknet.layer_plan(cfg):
        if step[0] == "pool":
            side //= 2
        elif step[0] == "conv":
            ci, ks, pooled = int(step[1][4:]), step[2], step[3]
            if not pooled:
                for b in DARKNET_BATCHES:
                    out.setdefault((ks, ks, 1, "int8"), []).append(dict(
                        batch=b, h=side, w=side, cin=convs[ci - 1][1],
                        cout=convs[ci][1], kh=ks, kw=ks,
                        padding=(ks // 2, ks // 2), dilation=(1, 1)))
            if pooled:
                side //= 2
    kcfg = kws.KWSConfig()
    t, cin = kcfg.seq_len, kcfg.embed
    for d in kcfg.dilations:
        for b in KWS_BATCHES:
            out.setdefault((kcfg.ksize, 1, 1, "int8"), []).append(dict(
                batch=b, h=t, w=1, cin=cin, cout=kcfg.filters, kh=kcfg.ksize,
                kw=1, padding=(0, 0), dilation=(d, 1)))
        t, cin = t - d * (kcfg.ksize - 1), kcfg.filters
    return out


def device_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    replayed ``replays`` times between two events, after a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def candidate_bc(policy: str, shape: dict, sms: int) -> int:
    """The ``bc`` that ``policy`` gives ``shape`` (int8 weights)."""
    cin = shape["cin"]
    if policy == "fallback":
        ho = fq_conv.conv_out_size(shape["h"], shape["kh"], 1,
                                   shape["padding"][0], shape["dilation"][0])
        wo = fq_conv.conv_out_size(shape["w"], shape["kw"], 1,
                                   shape["padding"][1], shape["dilation"][1])
        return fq_conv.split_fallback(m=shape["batch"] * ho * wo, cin=cin,
                                      cout=shape["cout"], kh=shape["kh"],
                                      kw=shape["kw"], sms=sms)
    if policy == "no split":
        return cin
    return fq_conv._divisor_at_most(cin, int(policy.split()[1]))


def _operands(shape: dict, fmt: str, dev, rng):
    taps, cin = shape["kh"] * shape["kw"], shape["cin"]
    a = torch.from_numpy(rng.integers(
        0, n_levels(4) + 1,
        size=(shape["batch"], shape["h"], shape["w"], cin)).astype(
            np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(
        -1, 2, size=(taps * cin, shape["cout"])).astype(np.int8))
    if fmt != "int8":
        w = pack_im2col_codes(w, taps, fmt)
    return a, w.to(dev), torch.tensor(np.float32(0.02), device=dev)


def conv_ms(shape: dict, fmt: str, bc, dev, rng) -> float:
    """K3's device time at ``shape`` with weights of ``fmt`` and cin block
    ``bc`` (None: packed, fixed), every knob explicit."""
    a, w, s = _operands(shape, fmt, dev, rng)
    kw = dict(kh=shape["kh"], kw=shape["kw"], padding=shape["padding"],
              dilation=shape["dilation"], n_out=n_levels(4), lo=0,
              weight_format=fmt, bho=1, bco=1, bc=bc)
    return device_ms(lambda: fq_conv.fq_conv2d(a, w, s, **kw))


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def measure(dev) -> list:
    """The table's entries, measured on ``dev``; prints one line a key."""
    rng = np.random.default_rng(SEED)
    sms = _build.sm_count(dev)
    entries = []
    for (kh, kw, stride, _), shapes in sorted(conv_shapes().items()):
        max_cin = max(s["cin"] for s in shapes)
        policies = ["fallback"] + [f"cap {c}" for c in CAPS] + ["no split"]
        times: Dict[Tuple[int, int], float] = {}   # (shape, bc) -> ms
        totals = {}
        for p in policies:
            total = 0.0
            for i, shape in enumerate(shapes):
                bc = candidate_bc(p, shape, sms)
                if (i, bc) not in times:
                    times[(i, bc)] = conv_ms(shape, "int8", bc, dev, rng)
                total += times[(i, bc)]
            totals[p] = total
        best = min(policies, key=lambda p: (totals[p], policies.index(p)))
        entry = {"kh": kh, "kw": kw, "stride": stride, "format": "int8",
                 "policy": best, "ms": totals[best],
                 "candidates_ms": totals, "shapes": len(shapes)}
        if best != "fallback":
            entry["bc"] = (max_cin if best == "no split"
                           else int(best.split()[1]))
        entries.append(entry)
        print(f"autotune ({kh}, {kw}, {stride}, int8): {len(shapes)} shapes; "
              + " ".join(f"{p}={t:.5f}" for p, t in totals.items())
              + f" ms; best {best}", flush=True)
        for fmt in FORMATS[1:]:
            total = sum(conv_ms(s, fmt, None, dev, rng) for s in shapes)
            entries.append({"kh": kh, "kw": kw, "stride": stride,
                            "format": fmt, "policy": "fixed bc = cin_p",
                            "ms": total, "shapes": len(shapes)})
            print(f"autotune ({kh}, {kw}, {stride}, {fmt}): {len(shapes)} "
                  f"shapes, bc fixed to cin_p: {total:.5f} ms", flush=True)
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", action="store_true",
                    help="write the table (else only print the sweep)")
    ap.add_argument("--out", default=fq_conv.AUTOTUNE_TABLE_PATH,
                    help="where --record writes the table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("autotune: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", fq_conv.AutotuneMissWarning)
        entries = measure(dev)
    smi = nvidia_smi()
    doc = {"format": 1, "backend": "cuda",
           "generated_by": fq_conv.AUTOTUNE_SCRIPT,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "note": ("bc is the cin block K3 runs as split-K (a cap: the "
                    "largest divisor of cin at most bc); an entry without "
                    "bc keeps the H100 fallback; ms: K3 device time summed "
                    "over the key's unpooled model shapes, CUDA-graph "
                    "replays"),
           "entries": entries}
    print(f"autotune: {len(entries)} entries on {smi}", flush=True)
    if args.record:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"autotune: wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
