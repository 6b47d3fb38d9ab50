#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which must pass:

1. build: compiles the hand-written kernels K1-K3 from
   ``src/repro_torch/kernels/csrc`` with nvcc (one process per source, in
   parallel) and prints the build time and ptxas' register report;
2. kernels: holds each kernel bit-exact against its plain PyTorch version on
   the card at every shape the KWS serving path gives it (request batches
   1, 8 and 64), and times kernel, plain version and, where one exists, a
   PyTorch library call of the same work, each as the device time of one
   call replayed from a CUDA graph;
3. serve: builds the full-width KWS integer stack with the port's own
   ``kws.init -> to_fq -> s_out = 0.1 -> sync_handoff -> convert_int`` from
   a seed and answers request batches of 1, 8 and 64 through
   ``kws.int_serve_fn`` with both conv impls, with every launch counter set
   to 0 just before and read just after. It checks fused == im2col, the GPU
   integer core bit-exact with the port's CPU run given the same entry
   codes, and the logits against the CPU run.

It imports nothing of JAX or of the JAX package ``repro``. The second-to-
last lines are the ``{"kernels": [...]}`` record and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the rest of the repo beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCHES = (1, 8, 64)
S_OUT = 0.1
ATOL_LOGITS = 1e-5       # the reference's own eager-vs-jit logit tolerance
MAX_FLIP_FRACTION = 1e-4  # entry codes flipped by FP-embedding sum order

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12

REPLACES = {
    "quantize_codes": "src/repro/kernels/quantize.py:25",
    "fq_matmul": "src/repro/kernels/fq_matmul.py:115",
    "fq_conv2d": "src/repro/kernels/fq_conv.py:385",
}
SOURCES = {
    "quantize_codes": "src/repro_torch/kernels/csrc/quantize.cu",
    "fq_matmul": "src/repro_torch/kernels/csrc/fq_matmul.cu",
    "fq_conv2d": "src/repro_torch/kernels/csrc/fq_conv.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def device_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
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


def eager_ms(torch, fn, reps: int = 50) -> float:
    """Wall time of one eager call, host launch cost included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_profile(torch, fn, reps: int = 10):
    """(wall ms, device-busy ms, device ops) per ``fn()`` from torch.profiler:
    the summed durations of the device-side events (kernels and copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.end - e.time_range.start for e in dev)
    return wall * 1e3 / reps, busy_us / 1e3 / reps, len(dev) / reps


def bound(bytes_moved: float, ops: float, ops_per_s: float):
    """(least ms, what bounds it) from bytes over HBM and ops over peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_abs_err(torch, got, want) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    return float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build(torch):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    out = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s wall ({len(_build.SOURCES)} nvcc processes in "
          f"parallel) into {os.path.relpath(out, ROOT)}", flush=True)
    for name in _build.SOURCES:
        log = out / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if re.search(r"Used \d+ registers", line):
                    print(f"  ptxas {name}: {line.strip()}")
    return secs


def kws_layer_shapes(cfg):
    """(t_in, cin, dilation, t_out) of each conv on the main path."""
    out, t, cin = [], cfg.seq_len, cfg.embed
    for d in cfg.dilations:
        t_out = t - d * (cfg.ksize - 1)
        out.append((t, cin, d, t_out))
        t, cin = t_out, cfg.filters
    return out


def phase_kernels(torch, dev):
    """Parity and timing of K1-K3 at every main-path shape."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core.quant import n_levels
    from repro_torch.kernels import ref
    from repro_torch.kernels.fq_conv import fq_conv1d
    from repro_torch.kernels.fq_matmul import fq_matmul
    from repro_torch.kernels.quantize import quantize_codes
    from repro_torch.models.kws import KWSConfig

    cfg = KWSConfig()
    rng = np.random.default_rng(SEED)
    n = n_levels(4)
    rows = {k: [] for k in REPLACES}

    def codes(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(
            np.int8)).to(dev)

    def record(name, batch, shape, got, want, fn, plain, lib, bytes_, ops,
               peak):
        err = max_abs_err(torch, got, want)
        b_ms, b_by = bound(bytes_, ops, peak)
        row = {"batch": batch, "shape": shape, "err": err,
               "ms": device_ms(torch, fn), "plain_ms": device_ms(torch, plain),
               "library_ms": None if lib is None else device_ms(torch, lib),
               "eager_ms": eager_ms(torch, fn), "bound_ms": b_ms,
               "bound_by": b_by, "bytes": bytes_, "ops": ops, "peak": peak}
        rows[name].append(row)
        lib_s = ("-" if row["library_ms"] is None
                 else f"{row['library_ms']:.5f}")
        print(f"  {name:14s} B={batch:<3d} {str(shape):24s} "
              f"max_abs_err={err:g} ms={row['ms']:.5f} "
              f"plain_ms={row['plain_ms']:.5f} library_ms={lib_s} "
              f"eager_ms={row['eager_ms']:.5f} bound_ms={b_ms:.6f} "
              f"({b_by})", flush=True)
        if err != 0.0:
            raise AssertionError(f"{name} {shape}: kernel != plain version "
                                 f"(max abs err {err})")

    # the plain version's float64 accumulator is exact on the card too
    a = codes((64, 2048), -127, 127)
    b = codes((2048, 32), -127, 127)
    want = (a.cpu().to(torch.int32) @ b.cpu().to(torch.int32))
    if not torch.equal(ref.int_accumulate(a, b).cpu(), want):
        raise AssertionError("float64 accumulator not exact on the card")
    print("  int_accumulate: float64 product of int8 extremes (K=2048) "
          "equals the int32 CPU product", flush=True)

    print("kernel parity (bit-exact vs plain on the card) and device times:",
          flush=True)
    for batch in BATCHES:
        # K1: the entry quantizer on the (B*T, embed) BN output
        x = torch.from_numpy((rng.standard_normal(
            (batch * cfg.seq_len, cfg.embed)) * 1.5).astype(np.float32)).to(dev)
        inv = torch.tensor(np.float32(0.8), device=dev)
        got = quantize_codes(x, inv, n=n, b=0.0)
        want = ref.ref_quantize_codes(x, inv, n=n, b=0.0)
        record("quantize_codes", batch, tuple(x.shape), got, want,
               lambda: quantize_codes(x, inv, n=n, b=0.0),
               lambda: ref.ref_quantize_codes(x, inv, n=n, b=0.0), None,
               x.numel() * 5 + 4, x.numel() * 5, FP32_OPS_PER_S)
        for t, cin, dil, t_out in kws_layer_shapes(cfg):
            a3 = codes((batch, t, cin), 0, n)
            w = codes((cfg.ksize * cin, cfg.filters), -1, 1)
            s = torch.tensor(np.float32(0.05), device=dev)
            m, k, nn = batch * t_out, cfg.ksize * cin, cfg.filters
            ops = 2 * m * k * nn
            # K3: the fused conv on the (B, T, Cin) codes
            kw = dict(ksize=cfg.ksize, dilation=dil, n_out=n, lo=0)
            got = fq_conv1d(a3, w, s, **kw)
            want = ref.ref_fq_conv2d(a3.unsqueeze(2), w, s, kh=cfg.ksize,
                                     kw=1, dilation=(dil, 1), n_out=n,
                                     lo=0).squeeze(2)
            xf = a3.float().transpose(1, 2).contiguous()
            wf = w.float().reshape(cfg.ksize, cin, nn).permute(2, 1, 0) \
                .contiguous()
            record("fq_conv2d", batch, (batch, t, cin, dil), got, want,
                   lambda: fq_conv1d(a3, w, s, **kw),
                   lambda: ref.ref_fq_conv2d(a3.unsqueeze(2), w, s,
                                             kh=cfg.ksize, kw=1,
                                             dilation=(dil, 1), n_out=n,
                                             lo=0),
                   lambda: F.conv1d(xf, wf, dilation=dil),
                   a3.numel() + w.numel() + m * nn + 4, ops, INT8_OPS_PER_S)
            # K2: the im2col GEMM of the same layer
            pa = torch.cat([a3[:, i * dil: i * dil + t_out]
                            for i in range(cfg.ksize)], -1).reshape(m, k)
            got = fq_matmul(pa, w, s, n_out=n, lo=0)
            want = ref.ref_fq_matmul(pa, w, s, n_out=n, lo=0)
            int_mm_ok = m > 16 and k % 8 == 0 and nn % 8 == 0
            record("fq_matmul", batch, (m, k, nn), got, want,
                   lambda: fq_matmul(pa, w, s, n_out=n, lo=0),
                   lambda: ref.ref_fq_matmul(pa, w, s, n_out=n, lo=0),
                   (lambda: torch._int_mm(pa, w)) if int_mm_ok else None,
                   pa.numel() + w.numel() + m * nn + 4, ops, INT8_OPS_PER_S)

    # off the KWS path: the dequant epilogue, lo < 0, and a strided, padded,
    # dilated 2-D conv, held against the plain versions once each
    from repro_torch.kernels.fq_conv import fq_conv2d
    a = codes((300, 135), -7, 7)
    b = codes((135, 45), -127, 127)
    s = torch.tensor(np.float32(1.3e-3), device=dev)
    extra = [max_abs_err(torch, fq_matmul(a, b, s, epilogue="dequant"),
                         ref.ref_fq_matmul(a, b, s, epilogue="dequant")),
             max_abs_err(torch, fq_matmul(a, b, s, n_out=7, lo=-7),
                         ref.ref_fq_matmul(a, b, s, n_out=7, lo=-7))]
    x4 = codes((2, 19, 23, 70), 0, 15)
    w4 = codes((9 * 70, 67), -7, 7)
    for epi in ("requant", "dequant"):
        kw = dict(kh=3, kw=3, stride=(2, 2), padding=(1, 1), dilation=(2, 2),
                  epilogue=epi, n_out=15, lo=-15)
        extra.append(max_abs_err(torch, fq_conv2d(x4, w4, s, **kw),
                                 ref.ref_fq_conv2d(x4, w4, s, **kw)))
    torch.cuda.synchronize()
    print(f"  off-path epilogue / conv2d checks: max_abs_err={max(extra):g}",
          flush=True)
    if max(extra) != 0.0:
        raise AssertionError("off-path kernel checks disagree with plain")
    rows["fq_matmul"][0]["extra_err"] = max(extra[:2])
    rows["fq_conv2d"][0]["extra_err"] = max(extra[2:])
    return rows


def phase_serve(torch, dev):
    """The main path: the port's KWS integer serving, both conv impls."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import fq_layers as fql
    from repro_torch.core import integer_inference as ii
    from repro_torch.core.quant import QuantConfig, RELU_BOUND
    from repro_torch.models import kws

    cfg = kws.KWSConfig()
    qcfg = QuantConfig(2, 4, 4, fq=True)
    params, state = kws.init(torch.Generator().manual_seed(SEED), cfg,
                             device=dev)
    params = kws.to_fq(params, state, cfg)
    names = kws.conv_names(cfg)
    for name in names:
        params[name] = {**params[name],
                        "s_out": torch.tensor(S_OUT, device=dev)}
    params = ii.sync_handoff(params, names)
    stack = kws.convert_int(params, state, qcfg, cfg)
    stack_cpu = stack.to("cpu")
    rng = np.random.default_rng(SEED + 1)
    requests = {b: rng.standard_normal((b, cfg.seq_len, cfg.n_mfcc))
                .astype(np.float32) for b in BATCHES}
    serve = {impl: kws.int_serve_fn(stack, qcfg, cfg, impl=impl)
             for impl in ("fused", "im2col")}

    # -- the main path, counted ------------------------------------------
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    logits = {(b, impl): fn(requests[b]) for b in BATCHES
              for impl, fn in serve.items()}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print("kernels: " + " ".join(f"{k}={v}" for k, v in counts.items()),
          flush=True)
    n_req, n_conv = len(BATCHES), len(names)
    expect = {"quantize_codes": 2 * n_req, "fq_matmul": n_req * n_conv,
              "fq_conv2d": n_req * n_conv}
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != expected {expect}")

    # -- checks (these launches are not counted) -------------------------
    def entry(ip, x):
        h = fql.dense(ip["embed"], x)
        h, _ = fql.batchnorm(ip["embed_bn"][0], ip["embed_bn"][1], h)
        return ii.entry_codes(h, ip["entry"], qcfg, b_in=RELU_BOUND)

    total_flips = total_codes = 0
    for b in BATCHES:
        lf, li = logits[(b, "fused")], logits[(b, "im2col")]
        if lf.shape != (b, cfg.num_classes) or not torch.isfinite(lf).all():
            raise AssertionError(f"B={b}: logits {tuple(lf.shape)} not finite "
                                 "of the expected shape")
        if not torch.equal(lf, li):
            raise AssertionError(f"B={b}: fused and im2col logits differ")
        x = torch.from_numpy(requests[b])
        codes_gpu = entry(stack, x.to(dev))
        core = {impl: kws.int_core(stack, codes_gpu, qcfg, cfg, impl=impl)
                for impl in ("fused", "im2col")}
        if not torch.equal(core["fused"], core["im2col"]):
            raise AssertionError(f"B={b}: fused and im2col codes differ")
        core_cpu = kws.int_core(stack_cpu, codes_gpu.cpu(), qcfg, cfg)
        if not torch.equal(core["fused"].cpu(), core_cpu):
            raise AssertionError(f"B={b}: GPU int_core codes != CPU run")
        codes_cpu = entry(stack_cpu, x)
        flipped = codes_gpu.cpu() != codes_cpu
        total_flips += int(flipped.sum())
        total_codes += flipped.numel()
        logits_cpu = kws.int_apply(stack_cpu, x, qcfg, cfg)
        diff = (lf.cpu() - logits_cpu).abs().amax(dim=1)
        clean = ~flipped.reshape(b, -1).any(dim=1)
        worst_clean = float(diff[clean].max()) if clean.any() else 0.0
        worst_flip = float(diff[~clean].max()) if (~clean).any() else 0.0
        hist = torch.bincount(core["fused"].flatten().to(torch.int64),
                              minlength=8).tolist()
        print(f"serve B={b}: fused == im2col (codes and logits); GPU int_core "
              f"== CPU int_core; entry codes flipped vs CPU "
              f"{int(flipped.sum())}/{flipped.numel()}; max |logit diff| "
              f"{worst_clean:.3g} on {int(clean.sum())} unflipped requests, "
              f"{worst_flip:.3g} on {int((~clean).sum())} with flips; "
              f"output code histogram 0..7 {hist}", flush=True)
        if worst_clean > ATOL_LOGITS:
            raise AssertionError(f"B={b}: logits off the CPU run by "
                                 f"{worst_clean} > {ATOL_LOGITS}")
    frac = total_flips / total_codes
    print(f"serve: entry codes flipped by FP-embedding sum order (cuBLAS vs "
          f"CPU): {total_flips} of {total_codes} ({frac:.2e})", flush=True)
    if frac > MAX_FLIP_FRACTION:
        raise AssertionError(f"flip fraction {frac} > {MAX_FLIP_FRACTION}")

    # -- request latency (host clock around synchronised calls) ----------
    latency = {}
    for b in BATCHES:
        for impl, fn in serve.items():
            latency[(b, impl)] = eager_ms(torch, lambda: fn(requests[b]),
                                          reps=20)
            print(f"serve latency B={b} {impl}: {latency[(b, impl)]:.4f} ms "
                  "per request batch (host clock, eager, synchronised)",
                  flush=True)
    # -- device busy share (torch.profiler; a measurement, not a check) ---
    for b in (BATCHES[0], BATCHES[-1]):
        for impl, fn in serve.items():
            try:
                wall, busy, n_ops = device_profile(
                    torch, lambda: fn(requests[b]))
            except RuntimeError as e:
                print(f"serve profile B={b} {impl}: not measured ({e})")
                continue
            share = f"{busy / wall:.4f}" if busy else "not measured"
            print(f"serve profile B={b} {impl}: wall {wall:.4f} ms, device "
                  f"busy {busy:.4f} ms per request batch, busy share {share}, "
                  f"{n_ops:g} device ops per request (profiled)", flush=True)
    return counts, latency


def kernels_record(rows, counts):
    """One entry per kernel: the work of one int_apply at the largest
    batch (K1 once, K2 and K3 once per conv layer), summed."""
    out = []
    for name in REPLACES:
        top = [r for r in rows[name] if r["batch"] == max(BATCHES)]
        t_bytes = sum(r["bytes"] for r in top) / HBM_BYTES_PER_S
        t_ops = sum(r["ops"] / r["peak"] for r in top)
        libs = [r["library_ms"] for r in top]
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max(max(r["err"] for r in rows[name]),
                               rows[name][0].get("extra_err", 0.0)),
            "ms": sum(r["ms"] for r in top),
            "plain_ms": sum(r["plain_ms"] for r in top),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (None if any(v is None for v in libs)
                           else sum(libs)),
            "eager_ms": sum(r["eager_ms"] for r in top),
        })
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}: run it "
             "from a checkout of the repo")
    sys.path.insert(0, src)

    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        fail("float32 matmul must run at 'highest' precision (no TF32)")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    failed = []
    results = {}
    for name, phase in (("build", lambda: phase_build(torch)),
                        ("kernels", lambda: phase_kernels(torch, dev)),
                        ("serve", lambda: phase_serve(torch, dev))):
        print(f"== phase {name}", flush=True)
        try:
            results[name] = phase()
            torch.cuda.synchronize()
        except Exception:  # report every phase, then fail as a whole
            traceback.print_exc(file=sys.stdout)
            failed.append(name)
            if name == "build":
                break
    if failed:
        fail(f"phases failed: {', '.join(failed)}")

    counts, _ = results["serve"]
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    record = kernels_record(results["kernels"], counts)
    print(f"kernels record: launches from the serve phase; times per "
          f"int_apply at request batch {max(BATCHES)} (quantize_codes once, "
          f"fq_matmul and fq_conv2d once per conv layer, summed)")
    print(json.dumps({"kernels": record}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
