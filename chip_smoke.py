#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which must pass:

1. build: compiles the hand-written kernels K1-K3b from
   ``src/repro_torch/kernels/csrc`` with nvcc (one process per source, in
   parallel) and prints the build time and ptxas' register report;
2. kernels_kws: holds K1-K3 bit-exact against their plain PyTorch versions
   on the card at every shape the KWS serving path gives them (request
   batches 1, 8 and 64), and times kernel, plain version and, where one
   exists, a PyTorch library call of the same work, each as the device time
   of one call replayed from a CUDA graph;
3. kernels_darknet: the same for K1, K2, K3 and K3b (the fused max-pool
   epilogue) at every shape DarkNet-19's integer path gives them at
   224 x 224 (request batches 1 and 8), plus K3b at odd off-path shapes.
   K3 runs each conv under the tile policy (``kernels.fq_conv.pick_blocks``:
   the port's autotune table, then the H100 fallback), which splits the
   reduction of DarkNet's under-filled late convs (split-K);
3a. kernels_k1: K1 bit-exact against its plain version at odd lengths and
   at views on every float offset from a 16-byte boundary, and the launch
   floor it is read against: an empty kernel's device time as a CUDA-graph
   replay (one block, and K1's grid at KWS B=64 and DarkNet B=8);
3b. kernels_split: every DarkNet-19 conv at 224 x 224, B 1 and 8, as an
   unpooled K3 at the policy's split and at split 1, bit-exact against the
   plain version clean, dequant and noisy at mac_chunks 1 and 4, with a
   line a layer (split, blocks, stages, K3 ms at split 1 and at the chosen
   split, the bound); each split conv is one launch, its blocks reducing
   the split slices in a thread-block cluster; the policy's splits and a
   split of 16 (two slices a block) are also held bit-exact as CUDA-graph
   replays; the split convs of the fused path are timed into the record
   (``fq_conv2d_splitk``). serve_darknet then checks that the main path ran
   as many split launches as the policy picks, and serve_batcher that the
   replayed graphs show the split kernel;
4. serve_kws: builds the full-width KWS integer stack with the port's own
   ``kws.init -> to_fq -> s_out = 0.1 -> sync_handoff -> convert_int`` from
   a seed and answers request batches of 1, 8 and 64 through
   ``kws.int_serve_fn`` with both conv impls, with every launch counter set
   to 0 just before and read just after. It checks fused == im2col, the GPU
   integer core bit-exact with the port's CPU run given the same entry
   codes, and the logits against the CPU run;
5. serve_darknet: builds the full-width DarkNet-19 integer stack from a
   seed with a live per-layer calibration (:func:`darknet_live_stack`) and
   answers 224 x 224 request batches of 1 and 8 through
   ``darknet.int_serve_fn`` three ways (fused: K3 + K3b; fused without pool
   fusion: K3 + code pool; im2col: K2 + code pool), counted the same way.
   It checks the three identical, the exact launch counts, the GPU integer
   core against the port's CPU run, the logits against the CPU run, the
   entry codes flipped by conv0's sum order, and that no layer's output
   codes are all zero;
6. kernels_packed: K5, the packed-weight prologue, in K2, K3 and K3b: each
   held bit-exact against its plain version for ternary and int4 weights
   at every KWS and DarkNet shape above (K2 with ``pack_codes`` weights),
   plus off-path shapes (ragged cin 5 and 45, K not a multiple of the pack
   factor, dequant, lo < 0, a 3 x 3 pool), and timed beside its int8 twin;
7. kernels_noise: K4, the ADC-noise epilogue, in K2, K3 and K3b. It first
   checks the port's threefry on the card against two values taken from
   ``jax.random`` (jax 0.9), then holds each noisy kernel bit-exact against
   its plain version for int8, int4 and ternary weights at mac_chunks 1 and
   4, at every KWS and DarkNet shape above and at off-path shapes (ragged
   cin, odd N, a 3 x 3 pool, lo < 0, dequant), and times it beside the
   clean kernel on the same operands at the record batches (K3b at every
   DarkNet batch);
8. kernels_tc: the int8 tensor-core (wgmma) tile loop of K2, K3 and K3b
   off the paths: both A loaders (16-byte cp.async, byte gather) and every
   edge (M past a tile, K = 80, N of 16, 48 and 1000, Cin 16 and 48
   strided and dilated, ragged K and Cin, packed K tails, a misaligned A
   view; for K3b pools 2 x 2, 3 x 3 and 2 x 3 on window counts that are
   not multiples of 16 or 64) in every format, clean and noisy at each
   mac_chunks, requant and dequant, bit-exact against the plain versions,
   with the vector-loader launches counted against the shapes. Every
   counted serve run below also checks that each DarkNet K2 / K3 / K3b
   launch took the vector loader and each KWS launch the byte loader
   (``kernels (...)`` lines, "vector");
9. serve_kws and serve_darknet also build the ternary (``weight_format=
   "auto"``) and int4 stacks from the same params and serve the same
   requests with every conv impl, each format counted in a run of its own.
   They check packed fused == packed im2col == int8 fused (codes and
   logits), that the fused path launched only packed K3 / K3b, that fused
   DarkNet runs as many device ops as with int8 weights, the digests, and
   print the weight bytes on the device;
10. serve_kws and serve_darknet then serve the same requests again with the
   paper's §4.4 noise (Table 7's noisiest condition, a fixed key) at
   mac_chunks 1 and 4, from every format under every conv impl, each
   (format, chunks) counted in a run of its own. They check the impls
   identical (codes and logits), the GPU integer core against the port's
   CPU run given the same entry codes and key (codes that differ are
   counted: the normal draws are not bit-exact across devices), that every
   conv launch was noisy and the fused path launched only K3 / K3b, and
   that the noise moved the logits; they time noisy serving;
11. serve_batcher: CNN serving through
   ``repro_torch.serve.cnn_batching.CNNBatcher`` (``max_batch=8``,
   ``max_wait_ticks=2``, ``max_inflight=4``): a seeded Poisson trace with
   bursts (the reference benchmark's mixed arrivals, rate 6 a tick) of
   full-width KWS clips of 100-220 frames on the ladder (140, 180) and of
   DarkNet-19 images 128-288 a side on the ladder (160, 224), served four
   ways (sync, dispatch-ahead, dispatch-ahead on 2 lanes, all int8; and
   dispatch-ahead ternary), each counted in a run of its own (graph
   kernels count at capture). It fails unless every request is served
   once, every clean flush replayed a CUDA graph and equals the eager
   ``int_serve_fn`` on its padded batch bit for bit, the four ways agree
   request for request, at most ``n_signatures`` graphs a lane were
   captured, every DarkNet launch took the vector loader, and a profiled
   replay shows K1, K3 and (DarkNet) K3b. It times the warm trace (requests
   per second, latency and wait-tick percentiles), one flush against the
   eager call on the same batch, the pinned copies, and runs a KWS noise
   canary (eager noisy flushes, one ``fold_in`` key each) against the eager
   noisy ``int_serve_fn``;
11a. serve_lm: the integer LM (``repro_torch.models.fq_lm``) at the
   reference's full width ``FQLMConfig()`` (vocab 256, d_model 64, 4 heads /
   2 KV heads, 4 layers, d_ff 128, max_len 128), its seeded stand-in built
   with the port's ``init_params -> standin_params -> convert_int``. It
   checks that no projection's output codes are all zero; holds K1, K2
   (clean and K4 at mac_chunks 1 and 4; signed codes, lo = -127) at every
   LM shape (M = 1, 4, 8, 16, 64) and the port-only attention island
   kernel (``csrc/lm_island.cu``: its int8 re-entry codes, every launch
   on the 16-byte row loader) at decode and prefill shapes bit-exact
   against their plain versions; checks prefill(T) + decode == prefill(T +
   1, full) bit for bit on the card (caches and logits); serves 12
   staggered requests (prompts of 1-24 tokens, one EOS taken from a
   trajectory) through ``serve.batching.ContinuousBatcher`` at slots 1, 4
   and 8, each run counted (K1 once a forward, K2 24, the island 4, noisy
   0, nothing else), tokens identical to ``int_generate`` on the card and
   on the CPU; and ``int_core`` on the card equal to the CPU's (clean: bit
   for bit; noisy c1 / c4: at most MAX_FLIP_FRACTION of codes apart). It
   prints ms a decode step and tokens/s at each slot count, prefill ms at
   T = 16 and 64, the profiled busy share and device ops of a decode step,
   each K2 shape's and the island's ms beside bound, plain version and
   library call (``torch._int_mm`` where it takes the shape; SDPA on the
   dequantized floats), the KV bytes a slot, and fails past 60 s;
11b. serve_transformer: the float transformer zoo
   (``repro_torch.models.transformer``), which reaches no TPU-kernel
   counterpart (the K1-K5 and island counters must read 0 across it).
   minitron-4b (``configs.get_arch("minitron-4b").model``: 32 layers,
   d_model 3072, 24 / 8 heads, d_ff 9216, vocab 256000, bf16) from seed
   SEED on the card, converted by ``quantize_params_for_serving(bits_w=8)``;
   it checks prefill(125) + 3 decode steps against forward over 128 tokens
   (TX_RTOL x max|logit| in bf16, greedy tokens equal where forward's top-2
   margin passes the bound; the same weights with float32 activations
   within the reference's 2e-2), the int8 KV cache (each layer's decode
   attention within the reference's int8-KV tolerance; the logits under a
   gross-error guard), serves 8 greedy requests of 128 tokens, 32 new each,
   through ``ContinuousBatcher``'s float default on 4 slots (max_len 256),
   holds request 0 against forward over its own tokens (each token greedy
   within the bound) and, on the float32 copy of the same served weights,
   the batcher's tokens for request 0 equal to ``generate`` at B=1 (in bf16
   the GEMMs of M = 4 and M = 1 round apart at near-ties), and prints
   weight and KV bytes, ms a decode step at slots 1 and 4, prefill ms at
   T=128, the profiled busy share and device ops of a step, peak memory
   and the weight-read bound (the codes, scales, norms and one embedding
   row a slot); a 2-layer float32 cut of
   the served model card against CPU (1e-4 x max|logit|, TF32 off); and
   all ten archs' smoke configs card against CPU from one set of params
   (forward, prefill + decode within 1e-4 x max|logit|, quantizer codes
   that round otherwise pinned and counted, all rounding ties; greedy
   ``generate`` tokens equal; the batcher's tokens equal ``generate``'s,
   the MoE archs' the CPU batcher's; minitron's int8 KV logits within
   0.05). It fails past 90 s. minitron-4b runs at TX_LAYERS = 16 of its
   32 layers (full width), which keeps the run's phases within 1,100 s;
11c. train_transformer: the float zoo trained, again no TPU-kernel
   counterpart (the counters read 0 across it). minicpm-2b uncut
   (``get_arch("minicpm-2b").model``: 40 layers, d_model 2304, 36 / 36
   heads, d_ff 5760, vocab 122,753, tied, bf16, remat on) from seed SEED
   through the launcher's own path (``launch.train.TrainRun``: AdamW,
   weight decay 0.1, WSD at lr 1e-3), 6 steps on B=8 x 256 bigram
   batches with float32 moments, then 6 from the same params with int8
   moments: every step's loss, global norm and params finite, the params
   unmoved by step 0 (lr 0) and moved by every later step, the int8
   codes int8 and their scales positive; it prints ms a step, tokens/s,
   peak memory, the busy share and device ops of one profiled step and
   the matmul bound (8 N tokens FLOP at the bf16 peak). Then the model
   cut to 2 layers in float32 (remat off) trains a ``make_train_step``
   step (grad_accum 1) on the card, repeated on
   the CPU from the card's params and state (the CPU's quantizers pinned
   to the card's inputs; the code flips that are not rounding ties at
   most TRAIN_TX_MAX_FLIPS of the values, ties counted): loss within
   1e-5, each gradient within 1e-3 relative L2 (a log-scale within C_S M
   + 2 D), the params after the update within 1e-3 (a log-scale within 2
   lr: Adam steps it by lr times its gradient's sign); and 2 steps + save
   + restore + 2 steps equal 4 straight steps bit for bit. It fails past
   90 s;
12. train_fq: float FQ training, which reaches no TPU-kernel counterpart
   (the K1-K5 counters must read 0 across it). Full-width KWS (B=64, 140
   frames), DarkNet-19 (224 x 224, B=8) and the paper's CIFAR ResNets
   (``configs.paper_nets``: ResNet-20, B=128, and ResNet-32, B=32, on 32 x
   32 x 3 images in [-1, 1]) from seed SEED each run a short
   gradual-quantization ladder through ``gradual.run_ladder`` and the
   port's training entry points: KWS and DarkNet FP; Q (KWS W2A4, DarkNet
   W2A5); BN folded by ``to_fq`` and ranges set by ``calibrate`` (3
   iterations on the batch), then FQ W2A4; FQ under Table 7's noisiest
   condition. ResNet-20 the first and last stages of Table 1's ladder
   (``LADDERS["cifar10"]``: FP, Q W2A2; stem and head FP). ResNet-32 the
   first, the last but one and the last of Table 6's (FP; Q W2A5, its
   weight scales seeded at TRAIN_SW_PERCENTILE; FQ W2A5 after ``to_fq`` +
   ``calibrate``) and FQ W2A5 under the noisiest condition. Each stage
   takes 3 steps of SGD (Nesterov 0.9, weight decay 5e-4, cosine from
   TRAIN_LR: 0.05, ResNet-32 0.01), every stage after the first
   distilling from the best so far.
   Each step is repeated on the CPU from a copy of the card's params; the
   CPU's quantizer inputs whose code or clip class differ from the card's
   are counted and pinned to the card's, and the CPU's backward below the
   head starts from the card's head gradient (the head gradient is held on
   its own, within its Lipschitz bound). It fails unless loss, logits and
   gradients are finite; logits, loss, gradients and the updated params
   agree with the CPU's within the bounds stated at TRAIN_* (a log-scale's
   with its terms' forward difference at the card's inputs); the fold and
   calibration agree; every quantized layer's w, s_w, s_in and s_out get a
   gradient in each FQ stage; and a backward of the ladder's last stage
   with ``cudnn.allow_tf32 = True`` set globally gives the gradients of
   the run with it False bit for bit. It runs under cuDNN's deterministic
   algorithms, so that each call trains the same steps. It prints each
   stage's step time (host clock, mean of 5), profiled busy share and top
   device ops, and peak memory, beside the card's name and power limit.

13. train_qat: deploy-QAT, whose training forward is the deployed integer
   path (K1, K3, K3b; K4 under noise) and whose backward is the float
   FQ/STE surrogate. Full-width KWS (B=64, 140 frames) and DarkNet-19
   (224 x 224, B=8) from seed SEED, BN folded by ``to_fq`` (DarkNet's
   e^{s_w} at the 99th percentile of |w|) and ranges set by ``calibrate``,
   each train ``QAT_STEPS`` ``QATFinetune`` steps on a synthetic training
   set (``data.synthetic``), clean and then under Table 7's noisiest
   condition (mac_chunks 1), softmax cross-entropy, SGD at QAT_LR, the
   gradients clipped to a global norm of 1. It fails unless (a)
   ``qat_apply`` equals ``int_apply`` of ``sync_handoff`` + ``convert_int``
   of the same params bit for bit, clean and noisy with one key, at
   mac_chunks 1 and 4 (KWS) and 2 (DarkNet, both ``fuse_pool``); (b) one
   training step launches K1 once, K3 7 / 13 times and K3b 0 / 4 times,
   K2 never, every conv launch noisy under noise; (c) a step's value and
   gradients on the card agree with the CPU's from the card's params (the
   CPU taking the card's entry codes, its own counted): integer codes
   equal (clean) or within MAX_FLIP_FRACTION (noisy), logits, loss and
   gradients within train_fq's bounds, the surrogate's discrete choices
   pinned and bounded with ``repro_torch.taps`` (train_fq's limits, code
   flips that are float32 rounding ties at a half-LSB boundary counted as
   ties: ``check_flips``), every stale inner s_in's
   gradient exactly 0; (d) a finetune advanced 1 + 2 steps equals one run
   of 3 bit for bit under ``cudnn.deterministic``; (e) the trained params,
   synced and rederived into the deployed stack, serve the logits of
   ``qat_apply`` with the same key. It prints each model and condition's
   step time (host clock, mean of 5), profiled busy share and device ops,
   peak memory and the kernels' device time in one QAT forward against
   ``int_apply``'s, beside the card's name and power limit; its launches
   join the record as ``train_qat_<model>`` entries.

14. fleet: the fleet control plane (``repro_torch.serve.fleet``) runs the
   reference's fleet demo incident (``benchmarks/fleet_demo.py``: its
   fault plan, SLOs, batcher settings and schedule, 8 clean ticks, Table 7's
   noisiest condition on KWS, 40 more ticks, 2 KWS requests a tick and one
   DarkNet request every 3rd) over full-width KWS (140 frames, 45 filters;
   built as serve_kws builds it, then pretrained clean with
   ``QATFinetuneJob`` as the demo pretrains it; served on 2 replica lanes
   of the card, each its own device copy) and DarkNet-19 at 224 x 224
   (``darknet_live_stack``). The KWS canary breaches, a background
   ``QATFinetuneJob`` retrains (4 noise draws a step) and the retrained
   stack hot-swaps in. It fails unless both audits hold exactly once and
   within the SLO with none lost, the breach comes after the drift and a
   swap after the breach, flush faults fired, ``trace.replay`` of the
   incident on the card is bit-exact, the first swapped stack's digest is
   the CPU's ``rederive`` of the same synced params, every clean flush
   replayed a CUDA graph, K1, K3, K3b and K4 launched (K2 not), and the
   phase took at most 120 s. It prints the breach, retrain and swap ticks,
   the generations (the reference's demo flaps), the canary medians per
   era, requests/s, the mean ms of a tick, canary, retrain step and swap,
   and the busy share over the profiled replay, beside the card's name and
   power limit; its launches join the record as ``fleet`` entries.

It imports nothing of JAX or of the JAX package ``repro``. The second-to-
last lines are the ``{"kernels": [...]}`` record (one entry per kernel and
path) and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repo beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import re
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCHES = (1, 8, 64)       # KWS request batches
DN_BATCHES = (1, 8)        # DarkNet request batches
DN_SIZE = 224              # DarkNet image side, the reference's full size
DN_CALIB = 2               # images of the live calibration
S_OUT = 0.1
ATOL_LOGITS = 1e-5       # the reference's own eager-vs-jit logit tolerance
DN_RTOL_LOGITS = 1e-4    # x max|logit|: a float32 head over 1,024 channels
MAX_FLIP_FRACTION = 1e-4  # entry codes flipped by FP-edge sum order
QUANTILE = 0.99          # the live calibration's percentile

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
# the clock of the float32 peak: 67e12 = 132 SMs x 128 lanes x 2 x 1.98 GHz
SM_CLOCKS_PER_S = 132 * 1.98e9
# peak rate of each type of work, in operations per second: the tensor
# cores' int8 MACs and bf16 FLOPs, and float32 outside them (data sheet);
# then per SM and
# clock (CUDA programming guide, arithmetic throughput, compute capability
# 9.0): 64 lanes of the integer ALU pipe (shifts, logic, IADD3), 64 of
# IMAD on the fmaheavy pipe, 16 int-to-float conversions, and 128
# instructions dispatched (4 schedulers x 32 threads), whatever their pipe
PEAKS = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12,
         "alu": 64 * SM_CLOCKS_PER_S, "imad": 64 * SM_CLOCKS_PER_S,
         "i2f": 16 * SM_CLOCKS_PER_S, "dispatch": 128 * SM_CLOCKS_PER_S}
# float32 adds and multiplies share the 128 fma lanes (fmaheavy and
# fmalite) with IMAD, and dispatch with everything: they bound nothing alone

REPLACES = {
    "quantize_codes": "src/repro/kernels/quantize.py:25",
    "fq_matmul": "src/repro/kernels/fq_matmul.py:115",
    "fq_conv2d": "src/repro/kernels/fq_conv.py:385",
    "fq_conv2d_pool": "src/repro/kernels/fq_conv.py:356",
    # K3 split-K: fq_conv2d's reduction over kh * kw * Cin / bc cin blocks
    # (its bc knob, fq_conv.py:20), cut across the blocks of a cluster
    "fq_conv2d_splitk": "src/repro/kernels/fq_conv.py:385",
    # port-only: the integer LM's attention island, plain jnp in the
    # reference (fq_lm._attention)
    "lm_island": "src/repro/models/fq_lm.py:202",
}
SOURCES = {
    "quantize_codes": "src/repro_torch/kernels/csrc/quantize.cu",
    "fq_matmul": "src/repro_torch/kernels/csrc/fq_matmul.cu",
    "fq_conv2d": "src/repro_torch/kernels/csrc/fq_conv.cu",
    "fq_conv2d_pool": "src/repro_torch/kernels/csrc/fq_conv.cu",
    "fq_conv2d_splitk": "src/repro_torch/kernels/csrc/fq_conv.cu",
    "lm_island": "src/repro_torch/kernels/csrc/lm_island.cu",
}
PATH_KERNELS = {"kws": ("quantize_codes", "fq_matmul", "fq_conv2d"),
                "darknet": ("quantize_codes", "fq_matmul", "fq_conv2d",
                            "fq_conv2d_pool")}
# K3's split-K, where the tile policy's cin block bc is below Cin (DarkNet's
# late convs), one cluster launch a conv; its kernel as the profiler names
# it
SPLIT_KERNELS = ("fq_conv2d_splitk",)
SPLIT_GRAPH_KERNELS = ("fq_conv_splitk_kernel",)
SPLIT_WIDE = 16            # a split past the cluster's 8 blocks
# K5, the packed prologue, in each kernel that takes weights
PACKED_FORMATS = ("ternary", "int4")
PACKED_REPLACES = {"fq_matmul": "src/repro/kernels/fq_matmul.py:86",
                   "fq_conv2d": "src/repro/kernels/fq_conv.py:330",
                   "fq_conv2d_pool": "src/repro/kernels/fq_conv.py:330"}
# K2, K3 and K3b run on the int8 tensor-core (wgmma) tile loop, which
# also holds K5, the packed prologue
TC_KERNELS = ("fq_matmul", "fq_conv2d", "fq_conv2d_pool")
TC_LOOP = "src/repro_torch/kernels/csrc/igemm_tc.cuh"
# K4, the ADC-noise epilogue, in each kernel that has an epilogue
NOISE_REPLACES = {"fq_matmul": "src/repro/kernels/fq_matmul.py:98",
                  "fq_conv2d": "src/repro/kernels/fq_conv.py:342",
                  "fq_conv2d_pool": "src/repro/kernels/fq_conv.py:342"}
NOISE_EPILOGUE = "src/repro_torch/kernels/csrc/noise.cuh"
CHUNKS = (1, 4)            # mac_chunks of the noisy runs
NOISE_KEY = 5              # PRNGKey of the noisy serving runs
# the field's instructions per conv/GEMM output element and chunk
# (noise.cuh), counting only what depends on the output index (the seed's
# hash, one per chunk, is the same for every output): 13 hashes of 3
# shifts, 3 xors and 2 wrapping multiplies; the index xor; 12 salted adds
# and 12 ">> 8"; 12 int-to-float conversions; 12 float adds, the 2^-24
# multiply, the -6 add and the add to the chunk sum
FIELD_PER_CHUNK = {"alu": 13 * 6 + 1 + 12 + 12, "imad": 13 * 2, "i2f": 12,
                   "fadd": 12 + 3}


def field_work(outputs: int, chunks: int) -> dict:
    """{type of work: instructions} of the noise field over ``outputs``
    output elements at ``chunks`` chunks. Once per output besides: the
    index (one IMAD), f32(acc) (one I2F), the sigma / K multiply and the
    add to f32(acc), less the first chunk's add to the sum."""
    n = {k: outputs * chunks * v for k, v in FIELD_PER_CHUNK.items()}
    n["imad"] += outputs
    n["i2f"] += outputs
    n["fadd"] += outputs
    return {"alu": n["alu"], "imad": n["imad"], "i2f": n["i2f"],
            "dispatch": sum(n.values())}
# reference values from jax 0.9 (jax_threefry_partitionable on)
THREEFRY_SPLIT0 = [2724472204, 3573582090]   # split(PRNGKey(5), 3)[0]
THREEFRY_SEED2 = 4107458132                  # bits(split(PRNGKey(5), 3)[2])
# the packed kernels the serving paths launch (K2 takes packed weights only
# off the model path: the im2col oracle unpacks first)
PACKED_PATH_KERNELS = {
    "kws": tuple(f"fq_conv2d_{f}" for f in PACKED_FORMATS),
    "darknet": tuple(f"{k}_{f}" for f in PACKED_FORMATS
                     for k in ("fq_conv2d", "fq_conv2d_pool"))}


def variant(name: str):
    """"fq_conv2d_pool_ternary_noisy_c4" -> ("fq_conv2d_pool", "ternary",
    4); a clean kernel has chunks None, an int8 one format "int8"."""
    m = re.fullmatch(r"(.*?)(?:_(ternary|int4))?(?:_noisy_c(\d+))?", name)
    return (m.group(1), m.group(2) or "int8",
            int(m.group(3)) if m.group(3) else None)


def base_kernel(name: str) -> str:
    """"fq_conv2d_pool_ternary" -> "fq_conv2d_pool"; int8 names unchanged."""
    return variant(name)[0]


def noisy_name(kernel: str, fmt: str, chunks: int) -> str:
    return (kernel + ("" if fmt == "int8" else f"_{fmt}")
            + f"_noisy_c{chunks}")


def fail(msg: str) -> None:
    for f in (sys.stdout, sys.stderr):
        print(f"chip_smoke: FAIL: {msg}", file=f, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    from repro_torch.kernels.autotune import nvidia_smi as smi
    return smi()


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def device_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    replayed ``replays`` times between two events, after a warm-up
    (``repro_torch.kernels.autotune.device_ms``, which the table's sweep
    uses too)."""
    from repro_torch.kernels.autotune import device_ms as timed
    return timed(fn, calls, replays)


def replayed(torch, fn):
    """``fn()``'s output as a CUDA graph captures and replays it (after a
    warm-up call on a side stream), for checks against the eager call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return out.clone()


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


# the host's calls that launch one device op each (kernels, copies, sets)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def device_profile(torch, fn, reps: int = 10, top: int = 6,
                   launched: bool = False):
    """(wall ms, device-busy ms, device ops, [(name, ms)] of the ``top``
    device-side names by time) per ``fn()`` from torch.profiler: the summed
    durations of the device-side events (kernels and copies). With
    ``launched`` the device ops are counted from the host's launch calls,
    which the profiler records in full; it can miss the first few
    device-side events of a profile."""
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
    by_name = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0)
                           + e.time_range.end - e.time_range.start)
    busy_us = sum(by_name.values())
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ops = (sum(e.name in LAUNCH_CALLS for e in prof.events()) if launched
           else len(dev))
    return (wall * 1e3 / reps, busy_us / 1e3 / reps, ops / reps,
            [(n, us / 1e3 / reps) for n, us in names])


def bound(bytes_moved: float, work: dict) -> tuple:
    """(least ms, what bounds it) from bytes over HBM and, for each type of
    work in ``work`` ({type: count}, a key of PEAKS), its count over its
    peak rate. The types run on separate units (dispatch bounds them all
    together), so the slowest one bounds the operations."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(n / PEAKS[kind] for kind, n in work.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_abs_err(torch, got, want) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    return float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0


def a_loader_of(torch, name, fn):
    """The A loader ("vector" or "byte") that one more ``fn()`` of K2, K3
    or K3b (the tensor-core loop) takes, read off the vector counter; None
    for the other kernels."""
    from repro_torch import kernels
    base = base_kernel(name)
    if base not in kernels.VECTOR:
        return None
    key = f"{base}_vector"
    before = kernels.vector_launch_counts()[key]
    fn()
    torch.cuda.synchronize()
    return ("vector" if kernels.vector_launch_counts()[key] > before
            else "byte")


class Rows:
    """Parity and timing rows of one path's kernels, one per shape."""

    def __init__(self, torch, path, names=None):
        self.torch, self.path = torch, path
        self.rows = {k: [] for k in (names or PATH_KERNELS[path])}
        self.extra_err = {}

    def record(self, name, batch, shape, got, want, fn, plain, lib, bytes_,
               ops, kind, layer=None, twin=None, extra_work=None,
               plain_calls=20):
        """``ops`` operations of type ``kind`` (a key of PEAKS). ``twin``:
        the int8 kernel on the same work, timed beside a packed one, or the
        clean kernel beside a noisy one. ``extra_work``: {type: count} of
        other types of work (the noise field's); ``plain_calls``: fewer
        calls to time a slow plain version."""
        torch = self.torch
        err = max_abs_err(torch, got, want)
        loader = a_loader_of(torch, name, fn)
        work = {kind: ops, **(extra_work or {})}
        b_ms, b_by = bound(bytes_, work)
        row = {"batch": batch, "shape": shape, "layer": layer, "err": err,
               "ms": device_ms(torch, fn),
               "plain_ms": device_ms(torch, plain, calls=plain_calls,
                                     replays=5 if plain_calls >= 20 else 1),
               "library_ms": None if lib is None else device_ms(torch, lib),
               "eager_ms": eager_ms(torch, fn), "bound_ms": b_ms,
               "bound_by": b_by, "bytes": bytes_, "work": work,
               "loader": loader}
        twin_key = "clean_ms" if variant(name)[2] else "int8_ms"
        if twin is not None:
            row[twin_key] = device_ms(torch, twin)
        self.rows[name].append(row)
        lib_s = ("-" if row["library_ms"] is None
                 else f"{row['library_ms']:.5f}")
        twin_s = ("" if twin is None
                  else f" {twin_key}={row[twin_key]:.5f}")
        load_s = "" if loader is None else f" loader={loader}"
        print(f"  {self.path:7s} {name:14s} B={batch:<3d} {str(shape):26s} "
              f"max_abs_err={err:g}{load_s} ms={row['ms']:.5f}{twin_s} "
              f"plain_ms={row['plain_ms']:.5f} library_ms={lib_s} "
              f"eager_ms={row['eager_ms']:.5f} bound_ms={b_ms:.6f} "
              f"({b_by})", flush=True)
        if err != 0.0:
            raise AssertionError(f"{name} {shape}: kernel != plain version "
                                 f"(max abs err {err})")


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


def phase_kernels_kws(torch, dev):
    """Parity and timing of K1-K3 at every KWS main-path shape."""
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
    out = Rows(torch, "kws")
    record = out.record

    def codes(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(
            np.int8)).to(dev)

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
               x.numel() * 5 + 4, x.numel() * 5, "fp32")
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
                   a3.numel() + w.numel() + m * nn + 4, ops, "int8")
            # K2: the im2col GEMM of the same layer
            pa = torch.cat([a3[:, i * dil: i * dil + t_out]
                            for i in range(cfg.ksize)], -1).reshape(m, k)
            got = fq_matmul(pa, w, s, n_out=n, lo=0)
            want = ref.ref_fq_matmul(pa, w, s, n_out=n, lo=0)
            record("fq_matmul", batch, (m, k, nn), got, want,
                   lambda: fq_matmul(pa, w, s, n_out=n, lo=0),
                   lambda: ref.ref_fq_matmul(pa, w, s, n_out=n, lo=0),
                   int_mm(torch, pa, w),
                   pa.numel() + w.numel() + m * nn + 4, ops, "int8")

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
    out.extra_err = {"fq_matmul": max(extra[:2]), "fq_conv2d": max(extra[2:])}
    return out


def int_mm(torch, a, b):
    """``torch._int_mm(a, b)`` as a library yardstick of K2, or None where
    it does not take the shape (M > 16, K and N multiples of 8)."""
    m, k = a.shape
    if m <= 16 or k % 8 or b.shape[1] % 8:
        return None
    return lambda: torch._int_mm(a, b)


def darknet_int_layers(cfg, size):
    """(name, side, cin, cout, ksize, pooled) of each integer conv, in plan
    order, for a ``size`` x ``size`` image."""
    from repro_torch.models import darknet
    plan = darknet.layer_plan(cfg)
    convs = [l for l in cfg.layers if l != "M"]
    side, out = size, []
    for step in plan:
        if step[0] == "pool":
            side //= 2
        elif step[0] == "conv":
            ci = int(step[1][4:])
            out.append((step[1], side, convs[ci - 1][1], convs[ci][1],
                        step[2], step[3]))
            if step[3]:
                side //= 2
    return out


def phase_kernels_darknet(torch, dev):
    """Parity and timing of K1, K2, K3 and K3b at every shape of DarkNet-19's
    integer path at 224 x 224, plus K3b at odd off-path shapes."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core.quant import n_levels
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fq_conv import fq_conv2d
    from repro_torch.kernels.fq_matmul import fq_matmul
    from repro_torch.kernels.quantize import quantize_codes
    from repro_torch.models.darknet import DarkNetConfig

    cfg = DarkNetConfig()
    rng = np.random.default_rng(SEED + 2)
    n = n_levels(4)
    out = Rows(torch, "darknet")
    record = out.record

    def codes(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(
            np.int8)).to(dev)

    layers = darknet_int_layers(cfg, DN_SIZE)
    entry_side, entry_c = layers[0][1], layers[0][2]
    for batch in DN_BATCHES:
        x = torch.from_numpy((rng.standard_normal(
            (batch * entry_side * entry_side, entry_c)) * 1.5).astype(
                np.float32)).to(dev)
        inv = torch.tensor(np.float32(0.8), device=dev)
        record("quantize_codes", batch, tuple(x.shape),
               quantize_codes(x, inv, n=n, b=0.0),
               ref.ref_quantize_codes(x, inv, n=n, b=0.0),
               lambda: quantize_codes(x, inv, n=n, b=0.0),
               lambda: ref.ref_quantize_codes(x, inv, n=n, b=0.0), None,
               x.numel() * 5 + 4, x.numel() * 5, "fp32")
        for name, side, cin, cout, ks, pooled in layers:
            a = codes((batch, side, side, cin), 0, n)
            w = codes((ks * ks * cin, cout), -1, 1)
            s = torch.tensor(np.float32(0.02), device=dev)
            m, k = batch * side * side, ks * ks * cin
            ops_ = 2 * m * k * cout
            kw = dict(kh=ks, kw=ks, padding=(ks // 2, ks // 2), n_out=n, lo=0)
            xf = a.float().permute(0, 3, 1, 2)
            wf = w.float().reshape(ks, ks, cin, cout).permute(3, 2, 0, 1) \
                .contiguous()
            conv = (lambda xf=xf, wf=wf, ks=ks:
                    F.conv2d(xf, wf, padding=ks // 2))
            shape = (batch, side, side, cin, cout, ks)
            # K3: the fused conv (every layer; 13 on the fused path)
            record("fq_conv2d", batch, shape, fq_conv2d(a, w, s, **kw),
                   ref.ref_fq_conv2d(a, w, s, **kw),
                   lambda a=a, w=w, s=s, kw=kw: fq_conv2d(a, w, s, **kw),
                   lambda a=a, w=w, s=s, kw=kw: ref.ref_fq_conv2d(a, w, s,
                                                                  **kw),
                   conv, a.numel() + w.numel() + m * cout + 4, ops_,
                   "int8", layer=name)
            if pooled:
                # K3b: the conv with the fused 2 x 2 max-pool epilogue
                pk = dict(kw, pool=(2, 2))
                record("fq_conv2d_pool", batch, shape,
                       fq_conv2d(a, w, s, **pk), ref.ref_fq_conv2d(a, w, s,
                                                                   **pk),
                       lambda a=a, w=w, s=s, pk=pk: fq_conv2d(a, w, s, **pk),
                       lambda a=a, w=w, s=s, pk=pk: ref.ref_fq_conv2d(
                           a, w, s, **pk),
                       lambda conv=conv: F.max_pool2d(conv(), 2),
                       a.numel() + w.numel() + m // 4 * cout + 4, ops_,
                       "int8", layer=name)
            # K2: the im2col GEMM of the same layer
            pa = ops._im2col_2d(a, ks, 1, ks // 2)[0].reshape(m, k)
            record("fq_matmul", batch, (m, k, cout),
                   fq_matmul(pa, w, s, n_out=n, lo=0),
                   ref.ref_fq_matmul(pa, w, s, n_out=n, lo=0),
                   lambda pa=pa, w=w, s=s: fq_matmul(pa, w, s, n_out=n, lo=0),
                   lambda pa=pa, w=w, s=s: ref.ref_fq_matmul(pa, w, s,
                                                             n_out=n, lo=0),
                   int_mm(torch, pa, w),
                   pa.numel() + w.numel() + m * cout + 4, ops_,
                   "int8", layer=name)
            # the same library call with the weights stored column-major
            # (cuBLASLt's int8 tensor-core kernels take A row-major, B
            # column-major): a measurement beside the yardstick, no check
            lib_cm = int_mm(torch, pa, w.t().contiguous().t())
            try:
                cm_ms = "-" if lib_cm is None else device_ms(torch, lib_cm)
            except RuntimeError as e:
                cm_ms = f"not measured ({e})"
            out.rows["fq_matmul"][-1]["library_cm_ms"] = cm_ms
            print(f"  darknet torch._int_mm B={batch} {(m, k, cout)} with "
                  f"column-major weights: ms="
                  f"{cm_ms if isinstance(cm_ms, str) else f'{cm_ms:.5f}'}",
                  flush=True)

    # K3b off the path: odd Ho / Wo, pool 2 and 3 (and a non-square pool on
    # a strided, dilated conv), requant with lo < 0 and dequant
    x5 = codes((2, 13, 15, 40), 0, 7)
    w5 = codes((9 * 40, 70), -7, 7)
    s5 = torch.tensor(np.float32(0.0131), device=dev)
    errs = []
    for pool, stride, dil in (((2, 2), 1, 1), ((3, 3), 1, 1),
                              ((2, 3), 2, 2)):
        for epi, lo in (("requant", -n), ("requant", 0), ("dequant", 0)):
            kw = dict(kh=3, kw=3, stride=(stride, stride), padding=(1, 1),
                      dilation=(dil, dil), pool=pool, epilogue=epi, n_out=n,
                      lo=lo)
            errs.append(max_abs_err(torch, fq_conv2d(x5, w5, s5, **kw),
                                    ref.ref_fq_conv2d(x5, w5, s5, **kw)))
    torch.cuda.synchronize()
    print(f"  off-path K3b checks (2, 13, 15, 40) -> 70, pools 2x2, 3x3, "
          f"2x3: max_abs_err={max(errs):g}", flush=True)
    if max(errs) != 0.0:
        raise AssertionError("off-path K3b checks disagree with plain")
    out.extra_err = {"fq_conv2d_pool": max(errs)}
    return out


def phase_kernels_k1(torch, dev):
    """K1 at its edges against the plain version: odd lengths and views at
    every float offset from a 16-byte boundary (the scalar head, the vector
    body with 16- or 1-byte stores, the tail), and the launch floor: an
    empty kernel's device time as a CUDA-graph replay, one block of 32
    threads and K1's own grid at KWS B=64 and DarkNet B=8."""
    import numpy as np
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.quantize import (BLOCKS_PER_SM, PER_THREAD,
                                              THREADS, launch_floor,
                                              quantize_codes)
    rng = np.random.default_rng(SEED + 7)
    inv = torch.tensor(np.float32(0.8), device=dev)
    errs = []
    for n, offset in ((1, 0), (17, 1), (4097, 2), (1_000_003, 3),
                      (64 * 140 * 100 + 5, 1), (8 * 112 * 112 * 32, 2)):
        flat = torch.from_numpy((rng.standard_normal(n + offset) * 1.5)
                                .astype(np.float32)).to(dev)
        x = flat[offset:]
        errs.append(max_abs_err(torch, quantize_codes(x, inv, n=7, b=0.0),
                                ref.ref_quantize_codes(x, inv, n=7, b=0.0)))
    rows = torch.from_numpy((rng.standard_normal((64 * 140, 100)) * 1.5)
                            .astype(np.float32)).to(dev)[1:]
    errs.append(max_abs_err(torch, quantize_codes(rows, inv, n=7, b=-1.0),
                            ref.ref_quantize_codes(rows, inv, n=7, b=-1.0)))
    torch.cuda.synchronize()
    print(f"  K1 edges (n 1, 17, 4097, 1000003, KWS B=64 + 5 and DarkNet "
          f"B=8 at float offsets 0-3, and KWS B=64 rows from row 1): "
          f"max_abs_err={max(errs):g}", flush=True)
    if max(errs) != 0.0:
        raise AssertionError("K1 at its edges != plain version")
    sms = _build.sm_count(dev)
    floor = {}
    for label, n in (("one block of 32", 0), ("K1's grid at KWS B=64",
                                               64 * 140 * 100),
                     ("K1's grid at DarkNet B=8", 8 * 112 * 112 * 32)):
        blocks = (min(-(-n // (PER_THREAD * THREADS)), BLOCKS_PER_SM * sms)
                  if n else 1)
        threads = THREADS if n else 32
        floor[label] = (blocks, device_ms(
            torch, lambda b=blocks, t=threads: launch_floor(dev, b, t)))
    print("  launch floor, an empty kernel replayed from a CUDA graph: " +
          "; ".join(f"{k} ({b} blocks) ms={v:.5f}" for k, (b, v)
                    in floor.items()), flush=True)
    return {"extra_err": max(errs), "floor": floor}


def policy_split(torch, dev, side, cin, cout, ks, batch) -> int:
    """The split (Cin / bc) that K3's tile policy picks for an unpooled
    DarkNet conv at request batch ``batch``."""
    from repro_torch.kernels import _build, fq_conv
    bc = fq_conv.pick_blocks(ho=side, wo=side, cin=cin, cout=cout, kh=ks,
                             kw=ks, stride=(1, 1), batch=batch,
                             sms=_build.sm_count(dev))[2]
    return cin // bc


def phase_kernels_split(torch, dev):
    """K3's split-K at every DarkNet-19 conv at 224 x 224, B 1 and 8, each
    as the unpooled K3 (the fused path's 13 convs; the pooled 4 run so on
    the way without pool fusion): bit-exact against the plain version at
    the tile policy's split and at split 1, clean, dequant and noisy at
    mac_chunks 1 and 4; a line a layer with its blocks, stages, split, K3
    device time at split 1 and at the chosen split, and its bound. The
    policy's splits and SPLIT_WIDE (two slices a cluster block) are also
    held as CUDA-graph replays at B=1. Where the fused path runs a split
    (unpooled, split > 1) the split conv gets a record row."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core.quant import n_levels
    from repro_torch.kernels import ref
    from repro_torch.kernels.fq_conv import fq_conv2d
    from repro_torch.models.darknet import DarkNetConfig

    cfg = DarkNetConfig()
    rng = np.random.default_rng(SEED + 8)
    n = n_levels(4)
    out = Rows(torch, "darknet", SPLIT_KERNELS)
    seed = torch.tensor(THREEFRY_SEED2, dtype=torch.uint32, device=dev)
    layers, errs = [], []
    for batch in DN_BATCHES:
        for name, side, cin, cout, ks, pooled in darknet_int_layers(
                cfg, DN_SIZE):
            a = torch.from_numpy(rng.integers(0, n + 1, size=(
                batch, side, side, cin)).astype(np.int8)).to(dev)
            w = torch.from_numpy(rng.integers(-1, 2, size=(
                ks * ks * cin, cout)).astype(np.int8)).to(dev)
            s = torch.tensor(np.float32(0.02), device=dev)
            kw = dict(kh=ks, kw=ks, padding=(ks // 2, ks // 2), n_out=n,
                      lo=0)
            split = policy_split(torch, dev, side, cin, cout, ks, batch)
            bc = cin // split
            wide = (cin // SPLIT_WIDE if split > 1 and batch == 1
                    and cin % (16 * SPLIT_WIDE) == 0 else None)
            for extra in ({}, dict(epilogue="dequant"),
                          *(dict(noise_sigma_acc=torch.div(
                              torch.full_like(s, 1.5), s), noise_seed=seed,
                              mac_chunks=c) for c in CHUNKS)):
                want = ref.ref_fq_conv2d(a, w, s, **kw, **extra)
                for b_ in sorted({bc, cin} | ({wide} if wide else set())):
                    errs.append(max_abs_err(
                        torch, fq_conv2d(a, w, s, bc=b_, **kw, **extra),
                        want))
                    if b_ != cin and batch == 1:
                        errs.append(max_abs_err(torch, replayed(
                            torch, lambda b_=b_, extra=extra: fq_conv2d(
                                a, w, s, bc=b_, **kw, **extra)), want))
            if max(errs) != 0.0:
                raise AssertionError(f"{name} B={batch}: K3 at split "
                                     f"{split} or 1 != plain version")
            m, k = batch * side * side, ks * ks * cin
            tiles = -(-m // 64) * -(-cout // 64)
            ms1 = device_ms(torch, lambda: fq_conv2d(a, w, s, bc=cin, **kw))
            ms_s = ms1 if split == 1 else device_ms(
                torch, lambda: fq_conv2d(a, w, s, bc=bc, **kw))
            bytes_, ops_ = a.numel() + w.numel() + m * cout + 4, 2 * m * k * cout
            b_ms, b_by = bound(bytes_, {"int8": ops_})
            row = dict(layer=name, batch=batch, side=side, cin=cin, cout=cout,
                       ks=ks, pooled=pooled, split=split, blocks=tiles * split,
                       stages=-(-k // split // 64), stages1=-(-k // 64),
                       ms1=ms1, ms_split=ms_s, bound_ms=b_ms)
            layers.append(row)
            print(f"  split darknet {name} B={batch} ({side}x{side}, {cin}->"
                  f"{cout}, {ks}x{ks}{', pooled on the fused path' if pooled else ''}): "
                  f"split {split} (bc {bc}), blocks {tiles} -> {tiles * split}"
                  f", stages {row['stages1']} -> {row['stages']}; K3 ms split 1 "
                  f"{ms1:.5f}, chosen {ms_s:.5f}; bound_ms {b_ms:.6f} ({b_by})",
                  flush=True)
            if split == 1 or pooled:
                continue
            xf = a.float().permute(0, 3, 1, 2)
            wf = w.float().reshape(ks, ks, cin, cout).permute(3, 2, 0, 1) \
                .contiguous()
            shape = (batch, side, side, cin, cout, ks)
            out.record("fq_conv2d_splitk", batch, shape,
                       fq_conv2d(a, w, s, bc=bc, **kw),
                       ref.ref_fq_conv2d(a, w, s, **kw),
                       lambda: fq_conv2d(a, w, s, bc=bc, **kw),
                       lambda: ref.ref_fq_conv2d(a, w, s, **kw),
                       lambda: F.conv2d(xf, wf, padding=ks // 2), bytes_,
                       ops_, "int8", layer=name)
    torch.cuda.synchronize()
    for batch in DN_BATCHES:
        on = [r for r in layers if r["batch"] == batch and not r["pooled"]]
        print(f"  split darknet B={batch}: the fused path's 13 unpooled K3, "
              f"{sum(r['split'] > 1 for r in on)} split: K3 ms summed at split "
              f"1 {sum(r['ms1'] for r in on):.5f}, at the chosen splits "
              f"{sum(r['ms_split'] for r in on):.5f}", flush=True)
    print(f"  split darknet: every conv at its split and at split 1, clean, "
          f"dequant, noisy c1 / c4, eager and (B=1, the policy's splits and "
          f"split {SPLIT_WIDE}) as CUDA-graph replays: max_abs_err="
          f"{max(errs):g}", flush=True)
    out.layers = layers
    return out


def phase_kernels_packed(torch, dev):
    """K5: parity and timing of K2, K3 and K3b on packed (ternary, int4)
    weights at every KWS and DarkNet main-path shape, each beside its int8
    twin on the same codes, plus off-path shapes."""
    import numpy as np
    from repro_torch.core import quant
    from repro_torch.core.quant import n_levels
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fq_conv import fq_conv1d, fq_conv2d
    from repro_torch.kernels.fq_matmul import fq_matmul
    from repro_torch.models.darknet import DarkNetConfig
    from repro_torch.models.kws import KWSConfig

    rng = np.random.default_rng(SEED + 4)
    n = n_levels(4)

    def codes(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(
            np.int8)).to(dev)

    def names(path):
        return [f"{k}_{f}" for f in PACKED_FORMATS
                for k in PATH_KERNELS[path] if k in PACKED_REPLACES]

    out = {"kws": Rows(torch, "kws", names("kws")),
           "darknet": Rows(torch, "darknet", names("darknet"))}
    print("packed-weight kernels (bit-exact vs plain on the card), device "
          "times beside the int8 kernel on the same codes:", flush=True)
    cfg = KWSConfig()
    record = out["kws"].record
    for fmt in PACKED_FORMATS:
        r = quant.format_range(fmt)
        for batch in BATCHES:
            for t, cin, dil, t_out in kws_layer_shapes(cfg):
                a3 = codes((batch, t, cin), 0, n)
                w = codes((cfg.ksize * cin, cfg.filters), -r, r)
                wp = quant.pack_im2col_codes(w, cfg.ksize, fmt)
                s = torch.tensor(np.float32(0.05), device=dev)
                m, k, nn = batch * t_out, cfg.ksize * cin, cfg.filters
                ops_ = 2 * m * k * nn
                kw = dict(ksize=cfg.ksize, dilation=dil, n_out=n, lo=0)
                rk = dict(kh=cfg.ksize, kw=1, dilation=(dil, 1), n_out=n,
                          lo=0, weight_format=fmt)
                record(f"fq_conv2d_{fmt}", batch, (batch, t, cin, dil),
                       fq_conv1d(a3, wp, s, weight_format=fmt, **kw),
                       ref.ref_fq_conv2d(a3.unsqueeze(2), wp, s, **rk)
                       .squeeze(2),
                       lambda: fq_conv1d(a3, wp, s, weight_format=fmt, **kw),
                       lambda: ref.ref_fq_conv2d(a3.unsqueeze(2), wp, s,
                                                 **rk),
                       None, a3.numel() + wp.numel() + m * nn + 4, ops_,
                       "int8", twin=lambda: fq_conv1d(a3, w, s, **kw))
                pa = torch.cat([a3[:, i * dil: i * dil + t_out]
                                for i in range(cfg.ksize)], -1).reshape(m, k)
                bp = quant.pack_codes(w, fmt)
                mk = dict(n_out=n, lo=0)
                record(f"fq_matmul_{fmt}", batch, (m, k, nn),
                       fq_matmul(pa, bp, s, weight_format=fmt, **mk),
                       ref.ref_fq_matmul(pa, bp, s, weight_format=fmt, **mk),
                       lambda: fq_matmul(pa, bp, s, weight_format=fmt, **mk),
                       lambda: ref.ref_fq_matmul(pa, bp, s,
                                                 weight_format=fmt, **mk),
                       None, pa.numel() + bp.numel() + m * nn + 4, ops_,
                       "int8", twin=lambda: fq_matmul(pa, w, s, **mk))

    dcfg = DarkNetConfig()
    layers = darknet_int_layers(dcfg, DN_SIZE)
    record = out["darknet"].record
    for fmt in PACKED_FORMATS:
        r = quant.format_range(fmt)
        for batch in DN_BATCHES:
            for name, side, cin, cout, ks, pooled in layers:
                a = codes((batch, side, side, cin), 0, n)
                w = codes((ks * ks * cin, cout), -r, r)
                wp = quant.pack_im2col_codes(w, ks * ks, fmt)
                s = torch.tensor(np.float32(0.02), device=dev)
                m, k = batch * side * side, ks * ks * cin
                ops_ = 2 * m * k * cout
                kw = dict(kh=ks, kw=ks, padding=(ks // 2, ks // 2), n_out=n,
                          lo=0)
                pk = dict(kw, weight_format=fmt)
                shape = (batch, side, side, cin, cout, ks)
                record(f"fq_conv2d_{fmt}", batch, shape,
                       fq_conv2d(a, wp, s, **pk),
                       ref.ref_fq_conv2d(a, wp, s, **pk),
                       lambda a=a, wp=wp, s=s, pk=pk: fq_conv2d(a, wp, s,
                                                                **pk),
                       lambda a=a, wp=wp, s=s, pk=pk: ref.ref_fq_conv2d(
                           a, wp, s, **pk),
                       None, a.numel() + wp.numel() + m * cout + 4, ops_,
                       "int8", layer=name,
                       twin=lambda a=a, w=w, s=s, kw=kw: fq_conv2d(a, w, s,
                                                                   **kw))
                if pooled:
                    pp = dict(pk, pool=(2, 2))
                    p8 = dict(kw, pool=(2, 2))
                    record(f"fq_conv2d_pool_{fmt}", batch, shape,
                           fq_conv2d(a, wp, s, **pp),
                           ref.ref_fq_conv2d(a, wp, s, **pp),
                           lambda a=a, wp=wp, s=s, pp=pp: fq_conv2d(
                               a, wp, s, **pp),
                           lambda a=a, wp=wp, s=s, pp=pp: ref.ref_fq_conv2d(
                               a, wp, s, **pp),
                           None, a.numel() + wp.numel() + m // 4 * cout + 4,
                           ops_, "int8", layer=name,
                           twin=lambda a=a, w=w, s=s, p8=p8: fq_conv2d(
                               a, w, s, **p8))
                pa = ops._im2col_2d(a, ks, 1, ks // 2)[0].reshape(m, k)
                bp = quant.pack_codes(w, fmt)
                mk = dict(n_out=n, lo=0)
                record(f"fq_matmul_{fmt}", batch, (m, k, cout),
                       fq_matmul(pa, bp, s, weight_format=fmt, **mk),
                       ref.ref_fq_matmul(pa, bp, s, weight_format=fmt, **mk),
                       lambda pa=pa, bp=bp, s=s: fq_matmul(
                           pa, bp, s, weight_format=fmt, **mk),
                       lambda pa=pa, bp=bp, s=s: ref.ref_fq_matmul(
                           pa, bp, s, weight_format=fmt, **mk),
                       None, pa.numel() + bp.numel() + m * cout + 4, ops_,
                       "int8", layer=name,
                       twin=lambda pa=pa, w=w, s=s: fq_matmul(pa, w, s, **mk))

    # off the paths: ragged cin (5, 45: the reduction runs over taps x
    # cin_p with the pad channels masked), a strided dilated conv, pools
    # 2x2 and 3x3, K2 with K not a multiple of the factor, dequant, lo < 0
    s = torch.tensor(np.float32(0.0131), device=dev)
    epis = (("requant", -n), ("requant", 0), ("dequant", 0))
    for fmt in PACKED_FORMATS:
        r = quant.format_range(fmt)
        conv_errs, mm_errs = [], []
        for cin in (5, 45):
            x = codes((2, 13, 15, cin), 0, n)
            w = codes((9 * cin, 70), -r, r)
            wp = quant.pack_im2col_codes(w, 9, fmt)
            for pool, stride, dil in ((None, 1, 1), (None, 2, 2),
                                      ((2, 2), 1, 1), ((3, 3), 1, 1),
                                      ((2, 3), 2, 2)):
                for epi, lo in epis:
                    kw = dict(kh=3, kw=3, stride=(stride, stride),
                              padding=(1, 1), dilation=(dil, dil), pool=pool,
                              epilogue=epi, n_out=n, lo=lo)
                    got = fq_conv2d(x, wp, s, weight_format=fmt, **kw)
                    conv_errs += [
                        max_abs_err(torch, got, ref.ref_fq_conv2d(
                            x, wp, s, weight_format=fmt, **kw)),
                        max_abs_err(torch, got, fq_conv2d(x, w, s, **kw))]
            a3 = codes((3, 40, cin), 0, n)
            w1 = codes((3 * cin, 45), -r, r)
            w1p = quant.pack_im2col_codes(w1, 3, fmt)
            got = fq_conv1d(a3, w1p, s, ksize=3, dilation=4, n_out=n,
                            weight_format=fmt)
            conv_errs.append(max_abs_err(torch, got, ops.fq_conv1d_int(
                a3, w1p, s, ksize=3, dilation=4, n_out=n, impl="im2col",
                weight_format=fmt)))
        for k in (13, 135, 257):
            a = codes((300, k), -n, n)
            b = codes((k, 45), -r, r)
            bp = quant.pack_codes(b, fmt)
            for epi, lo in epis:
                kw = dict(epilogue=epi, n_out=n, lo=lo)
                got = fq_matmul(a, bp, s, weight_format=fmt, **kw)
                mm_errs += [max_abs_err(torch, got, ref.ref_fq_matmul(
                    a, bp, s, weight_format=fmt, **kw)),
                    max_abs_err(torch, got, fq_matmul(a, b, s, **kw))]
        torch.cuda.synchronize()
        print(f"  off-path {fmt} checks: K3/K3b at cin 5 and 45 (strided, "
              f"dilated, pools 2x2, 3x3, 2x3, lo={-n} and 0, dequant; against "
              f"plain and int8) max_abs_err={max(conv_errs):g}; K2 at K 13, "
              f"135, 257 max_abs_err={max(mm_errs):g}", flush=True)
        if max(conv_errs + mm_errs) != 0.0:
            raise AssertionError(f"off-path {fmt} kernel checks disagree")
        for path in out:
            out[path].extra_err[f"fq_matmul_{fmt}"] = max(mm_errs)
            out[path].extra_err[f"fq_conv2d_{fmt}"] = max(conv_errs)
            out[path].extra_err[f"fq_conv2d_pool_{fmt}"] = max(conv_errs)
    for path, rows in out.items():
        for name, all_rows in rows.rows.items():
            ratio = (sum(r["ms"] for r in all_rows)
                     / sum(r["int8_ms"] for r in all_rows))
            print(f"  {path} {name}: summed over {len(all_rows)} shapes, "
                  f"packed / int8 device time {ratio:.4f}", flush=True)
    return out


def rows_batch(path: str) -> int:
    """The request batch whose per-int_apply sums go into the record."""
    return max(BATCHES) if path == "kws" else max(DN_BATCHES)


def phase_kernels_noise(torch, dev):
    """K4: the port's threefry on the card against the reference values;
    then K2, K3 and K3b with the ADC-noise epilogue held bit-exact against
    their plain versions for int8, int4 and ternary weights at mac_chunks 1
    and 4, at every KWS and DarkNet main-path shape (timed beside the clean
    kernel on the same operands at the record batches), plus off-path
    shapes."""
    import numpy as np
    from repro_torch.core import prng, quant
    from repro_torch.core.noise import TABLE7_CONDITIONS, derive_seed
    from repro_torch.core.quant import n_levels
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fq_conv import fq_conv1d, fq_conv2d
    from repro_torch.kernels.fq_matmul import fq_matmul
    from repro_torch.models.darknet import DarkNetConfig
    from repro_torch.models.kws import KWSConfig

    keys = prng.split(prng.PRNGKey(5, device=dev), 3)
    split0, seed2 = keys[0].tolist(), int(derive_seed(keys[2]))
    print(f"  threefry on the card: split(PRNGKey(5), 3)[0] = {split0}, "
          f"derive_seed(split(PRNGKey(5), 3)[2]) = {seed2}; jax 0.9: "
          f"{THREEFRY_SPLIT0}, {THREEFRY_SEED2}", flush=True)
    if split0 != THREEFRY_SPLIT0 or seed2 != THREEFRY_SEED2:
        raise AssertionError("threefry on the card != jax.random")

    rng = np.random.default_rng(SEED + 5)
    n = n_levels(4)
    seed = derive_seed(keys[1])
    sigma_mac = TABLE7_CONDITIONS[-1].sigma_mac

    def codes(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(
            np.int8)).to(dev)

    def noise(s, chunks):
        """sigma in accumulator units, folded as noisy_operands folds it."""
        return dict(noise_sigma_acc=torch.div(torch.full_like(s, sigma_mac),
                                              s),
                    noise_seed=seed, mac_chunks=chunks)

    names = {path: [noisy_name(k, f, c) for f in ("int8",) + PACKED_FORMATS
                    for c in CHUNKS for k in PATH_KERNELS[path]
                    if k in NOISE_REPLACES]
             for path in ("kws", "darknet")}
    out = {path: Rows(torch, path, names[path]) for path in names}

    def check(path, name, batch, shape, got, fn, plain, twin, bytes_, ops_,
              outputs, chunks, layer=None):
        """Parity at every batch; timed beside the clean twin at the
        record batch, and K3b at every batch."""
        rows = out[path]
        if (batch == rows_batch(path)
                or base_kernel(name) == "fq_conv2d_pool"):
            rows.record(name, batch, shape, got, plain(), fn, plain, None,
                        bytes_ + 8, ops_, "int8", layer=layer,
                        twin=twin, extra_work=field_work(outputs, chunks),
                        plain_calls=2)
            return
        err = max_abs_err(torch, got, plain())
        rows.extra_err[name] = max(rows.extra_err.get(name, 0.0), err)
        if err != 0.0:
            raise AssertionError(f"{name} {shape} B={batch}: noisy kernel != "
                                 f"plain version (max abs err {err})")

    print("noisy kernels (K4; bit-exact vs plain on the card), device times "
          "beside the clean kernel on the same operands:", flush=True)
    cfg = KWSConfig()
    for fmt in ("int8",) + PACKED_FORMATS:
        r = quant.format_range(fmt)
        for batch in BATCHES:
            for t, cin, dil, t_out in kws_layer_shapes(cfg):
                a3 = codes((batch, t, cin), 0, n)
                w = codes((cfg.ksize * cin, cfg.filters), -r, r)
                wp = (w if fmt == "int8"
                      else quant.pack_im2col_codes(w, cfg.ksize, fmt))
                s = torch.tensor(np.float32(0.05), device=dev)
                m, k, nn = batch * t_out, cfg.ksize * cin, cfg.filters
                pa = torch.cat([a3[:, i * dil: i * dil + t_out]
                                for i in range(cfg.ksize)], -1).reshape(m, k)
                bp = w if fmt == "int8" else quant.pack_codes(w, fmt)
                for chunks in CHUNKS:
                    nz = noise(s, chunks)
                    kw = dict(ksize=cfg.ksize, dilation=dil, n_out=n, lo=0,
                              weight_format=fmt)
                    rk = dict(kh=cfg.ksize, kw=1, dilation=(dil, 1), n_out=n,
                              lo=0, weight_format=fmt)
                    check("kws", noisy_name("fq_conv2d", fmt, chunks), batch,
                          (batch, t, cin, dil),
                          fq_conv1d(a3, wp, s, **kw, **nz),
                          lambda: fq_conv1d(a3, wp, s, **kw, **nz),
                          lambda: ref.ref_fq_conv2d(
                              a3.unsqueeze(2), wp, s, **rk, **nz).squeeze(2),
                          lambda: fq_conv1d(a3, wp, s, **kw),
                          a3.numel() + wp.numel() + m * nn + 4,
                          2 * m * k * nn, m * nn, chunks)
                    mk = dict(n_out=n, lo=0, weight_format=fmt)
                    check("kws", noisy_name("fq_matmul", fmt, chunks), batch,
                          (m, k, nn), fq_matmul(pa, bp, s, **mk, **nz),
                          lambda: fq_matmul(pa, bp, s, **mk, **nz),
                          lambda: ref.ref_fq_matmul(pa, bp, s, **mk, **nz),
                          lambda: fq_matmul(pa, bp, s, **mk),
                          pa.numel() + bp.numel() + m * nn + 4,
                          2 * m * k * nn, m * nn, chunks)

    dcfg = DarkNetConfig()
    for fmt in ("int8",) + PACKED_FORMATS:
        r = quant.format_range(fmt)
        for batch in DN_BATCHES:
            for name, side, cin, cout, ks, pooled in darknet_int_layers(
                    dcfg, DN_SIZE):
                a = codes((batch, side, side, cin), 0, n)
                w = codes((ks * ks * cin, cout), -r, r)
                wp = (w if fmt == "int8"
                      else quant.pack_im2col_codes(w, ks * ks, fmt))
                bp = w if fmt == "int8" else quant.pack_codes(w, fmt)
                s = torch.tensor(np.float32(0.02), device=dev)
                m, k = batch * side * side, ks * ks * cin
                ops_ = 2 * m * k * cout
                pa = ops._im2col_2d(a, ks, 1, ks // 2)[0].reshape(m, k)
                shape = (batch, side, side, cin, cout, ks)
                for chunks in CHUNKS:
                    nz = noise(s, chunks)
                    kw = dict(kh=ks, kw=ks, padding=(ks // 2, ks // 2),
                              n_out=n, lo=0, weight_format=fmt)
                    check("darknet", noisy_name("fq_conv2d", fmt, chunks),
                          batch, shape, fq_conv2d(a, wp, s, **kw, **nz),
                          lambda: fq_conv2d(a, wp, s, **kw, **nz),
                          lambda: ref.ref_fq_conv2d(a, wp, s, **kw, **nz),
                          lambda: fq_conv2d(a, wp, s, **kw),
                          a.numel() + wp.numel() + m * cout + 4, ops_,
                          m * cout, chunks, layer=name)
                    if pooled:
                        pk = dict(kw, pool=(2, 2))
                        check("darknet",
                              noisy_name("fq_conv2d_pool", fmt, chunks),
                              batch, shape, fq_conv2d(a, wp, s, **pk, **nz),
                              lambda: fq_conv2d(a, wp, s, **pk, **nz),
                              lambda: ref.ref_fq_conv2d(a, wp, s, **pk,
                                                        **nz),
                              lambda: fq_conv2d(a, wp, s, **pk),
                              a.numel() + wp.numel() + m // 4 * cout + 4,
                              ops_, m * cout, chunks, layer=name)
                    mk = dict(n_out=n, lo=0, weight_format=fmt)
                    check("darknet", noisy_name("fq_matmul", fmt, chunks),
                          batch, (m, k, cout),
                          fq_matmul(pa, bp, s, **mk, **nz),
                          lambda: fq_matmul(pa, bp, s, **mk, **nz),
                          lambda: ref.ref_fq_matmul(pa, bp, s, **mk, **nz),
                          lambda: fq_matmul(pa, bp, s, **mk),
                          pa.numel() + bp.numel() + m * cout + 4, ops_,
                          m * cout, chunks, layer=name)

    # off the paths: ragged cin (5, 45), odd N (67), strided and dilated
    # convs, pools 2x2, 3x3 and 2x3, lo < 0, dequant; K2 at ragged K and N
    s = torch.tensor(np.float32(0.0131), device=dev)
    epis = (("requant", -n), ("requant", 0), ("dequant", 0))
    errs = {}
    for fmt in ("int8",) + PACKED_FORMATS:
        r = quant.format_range(fmt)
        for chunks in CHUNKS:
            nz = noise(s, chunks)
            conv_errs, mm_errs = [], []
            for cin in (5, 45):
                x = codes((2, 13, 15, cin), 0, n)
                w = codes((9 * cin, 67), -r, r)
                wp = (w if fmt == "int8"
                      else quant.pack_im2col_codes(w, 9, fmt))
                for pool, stride, dil in ((None, 1, 1), (None, 2, 2),
                                          ((2, 2), 1, 1), ((3, 3), 1, 1),
                                          ((2, 3), 2, 2)):
                    for epi, lo in epis:
                        kw = dict(kh=3, kw=3, stride=(stride, stride),
                                  padding=(1, 1), dilation=(dil, dil),
                                  pool=pool, epilogue=epi, n_out=n, lo=lo,
                                  weight_format=fmt, **nz)
                        conv_errs.append(max_abs_err(
                            torch, fq_conv2d(x, wp, s, **kw),
                            ref.ref_fq_conv2d(x, wp, s, **kw)))
            for k in (13, 135, 257):
                a = codes((300, k), -n, n)
                b = codes((k, 67), -r, r)
                bp = b if fmt == "int8" else quant.pack_codes(b, fmt)
                for epi, lo in epis:
                    kw = dict(epilogue=epi, n_out=n, lo=lo,
                              weight_format=fmt, **nz)
                    mm_errs.append(max_abs_err(
                        torch, fq_matmul(a, bp, s, **kw),
                        ref.ref_fq_matmul(a, bp, s, **kw)))
            torch.cuda.synchronize()
            errs[(fmt, chunks)] = (max(conv_errs), max(mm_errs))
            for path in out:
                for k, e in (("fq_conv2d", conv_errs),
                             ("fq_conv2d_pool", conv_errs),
                             ("fq_matmul", mm_errs)):
                    name = noisy_name(k, fmt, chunks)
                    if name in out[path].rows:
                        out[path].extra_err[name] = max(
                            out[path].extra_err.get(name, 0.0), max(e))
    print("  off-path noisy checks (cin 5 and 45, N 67, strided, dilated, "
          "pools 2x2, 3x3, 2x3, lo=-7 and 0, dequant; K2 at K 13, 135, 257): "
          + " ".join(f"{f} c{c} K3/K3b={e[0]:g} K2={e[1]:g}"
                     for (f, c), e in errs.items()), flush=True)
    if any(max(e) != 0.0 for e in errs.values()):
        raise AssertionError("off-path noisy kernel checks disagree")
    for path, rows in out.items():
        for name, all_rows in rows.rows.items():
            all_rows = [r for r in all_rows if r["batch"] == rows_batch(path)]
            ratio = (sum(r["ms"] for r in all_rows)
                     / sum(r["clean_ms"] for r in all_rows))
            print(f"  {path} {name}: summed over {len(all_rows)} shapes at "
                  f"B={rows_batch(path)}, noisy / clean device time "
                  f"{ratio:.4f}", flush=True)
    return out


def phase_kernels_tc(torch, dev):
    """The tensor-core tile loop of K2, K3 and K3b off the paths: both A
    loaders and every edge (M past a 64-row tile, K = 80 past a 64-code
    stage, N of 16, 48 and 1000, Cin 16 and 48 strided and dilated, ragged
    K and Cin, int4 and ternary with a K tail, a misaligned A view; K3b's
    pools 2 x 2, 3 x 3 and 2 x 3 on window counts that are not multiples of
    16 or 64) in every format, clean and noisy at each mac_chunks, requant
    (lo < 0 and 0) and dequant, each held bit-exact against its plain
    version. The launches that took the vector loader are counted against
    the shapes that call for it. Returns {record name: max abs err} for the
    record."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import prng, quant
    from repro_torch.core.noise import TABLE7_CONDITIONS, derive_seed
    from repro_torch.core.quant import n_levels
    from repro_torch.kernels import ref
    from repro_torch.kernels.fq_conv import a_loader as conv_loader
    from repro_torch.kernels.fq_conv import fq_conv2d
    from repro_torch.kernels.fq_matmul import a_loader as matmul_loader
    from repro_torch.kernels.fq_matmul import fq_matmul

    rng = np.random.default_rng(SEED + 6)
    n = n_levels(4)
    seed = derive_seed(prng.split(prng.PRNGKey(5, device=dev), 3)[1])
    sigma_mac = TABLE7_CONDITIONS[-1].sigma_mac

    def codes(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(
            np.int8)).to(dev)

    # (M, K, N): vector loader at K % 16 == 0, byte loader otherwise
    mm_shapes = [(100, 80, 16), (130, 80, 48), (200, 128, 1000),
                 (3 * 64 + 5, 4608, 64), (130, 135, 48), (37, 13, 5),
                 (130, 257, 1000)]
    # (B, H, W, Cin, Cout, k, stride, dilation, padding)
    conv_shapes = [(2, 17, 13, 16, 64, 3, 2, 2, 1),
                   (2, 17, 13, 48, 1000, 3, 2, 2, 2),
                   (3, 9, 11, 32, 48, 1, 1, 1, 0),
                   (2, 17, 13, 45, 48, 3, 2, 2, 1)]
    # K3b: (B, H, W, Cin, Cout, k, stride, dilation, padding, pool); the
    # pooled windows Mp are 84, 24, 390, 40 and 84, none a multiple of 16
    # or 64; Cin 45 gathers bytes, the rest take the vector loader
    pool_shapes = [(2, 13, 15, 16, 64, 3, 1, 1, 1, (2, 2)),
                   (2, 17, 13, 48, 1000, 3, 2, 2, 2, (2, 2)),
                   (3, 40, 30, 16, 48, 3, 1, 2, 2, (3, 3)),
                   (2, 19, 23, 48, 64, 3, 2, 1, 1, (2, 3)),
                   (2, 15, 13, 45, 48, 3, 1, 1, 1, (2, 2))]
    mm_ops = [(codes((m, k), -n, n), k, nn) for m, k, nn in mm_shapes]
    flat = codes((130 * 80 + 1,), -n, n)
    mm_ops.append((flat[1:].view(130, 80), 80, 48))   # misaligned: byte
    conv_ops = [(codes(shape[:4], 0, n), shape) for shape in conv_shapes]
    pool_ops = [(codes(shape[:4], 0, n), shape) for shape in pool_shapes]
    flat = codes((2 * 13 * 15 * 32 + 1,), 0, n)       # misaligned: byte
    pool_ops.append((flat[1:].view(2, 13, 15, 32),
                     (2, 13, 15, 32, 64, 3, 1, 1, 1, (2, 2))))
    s = torch.tensor(np.float32(0.0131), device=dev)
    epis = (("requant", -n), ("requant", 0), ("dequant", 0))
    errs = {}
    print("tensor-core loop off the paths (bit-exact vs plain on the card): "
          f"K2 at {mm_shapes} and a misaligned (130, 80) view, K3 at "
          f"{conv_shapes} (B, H, W, Cin, Cout, k, stride, dilation, pad), "
          f"K3b at {pool_shapes} (..., pool) and a misaligned (2, 13, 15, "
          "32) view", flush=True)
    for fmt in ("int8",) + PACKED_FORMATS:
        r = quant.format_range(fmt)
        mm_w = [codes((k, nn), -r, r) for _, k, nn in mm_ops]
        conv_w = [codes((sh[5] ** 2 * sh[3], sh[4]), -r, r)
                  for _, sh in conv_ops]
        pool_w = [codes((sh[5] ** 2 * sh[3], sh[4]), -r, r)
                  for _, sh in pool_ops]
        if fmt != "int8":
            mm_w = [quant.pack_codes(w, fmt) for w in mm_w]
            conv_w = [quant.pack_im2col_codes(w, sh[5] ** 2, fmt)
                      for w, (_, sh) in zip(conv_w, conv_ops)]
            pool_w = [quant.pack_im2col_codes(w, sh[5] ** 2, fmt)
                      for w, (_, sh) in zip(pool_w, pool_ops)]
        for chunks in (None,) + CHUNKS:
            nz = {} if chunks is None else dict(
                noise_sigma_acc=torch.div(torch.full_like(s, sigma_mac), s),
                noise_seed=seed, mac_chunks=chunks)
            mm_errs, conv_errs, pool_errs = [], [], []
            want_vec = dict.fromkeys(kernels.vector_launch_counts(), 0)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            for epi, lo in epis:
                kw = dict(epilogue=epi, n_out=n, lo=lo, weight_format=fmt,
                          **nz)
                for (a, k, _), w in zip(mm_ops, mm_w):
                    mm_errs.append(max_abs_err(
                        torch, fq_matmul(a, w, s, **kw),
                        ref.ref_fq_matmul(a, w, s, **kw)))
                    want_vec["fq_matmul_vector"] += (
                        matmul_loader(k, a.data_ptr()) == "vector")
                for (x, sh), w in zip(conv_ops, conv_w):
                    ks, st, dl, pd = sh[5:]
                    ck = dict(kw, kh=ks, kw=ks, stride=(st, st),
                              dilation=(dl, dl), padding=(pd, pd))
                    conv_errs.append(max_abs_err(
                        torch, fq_conv2d(x, w, s, **ck),
                        ref.ref_fq_conv2d(x, w, s, **ck)))
                    want_vec["fq_conv2d_vector"] += (
                        conv_loader(sh[3], x.data_ptr()) == "vector")
                for (x, sh), w in zip(pool_ops, pool_w):
                    ks, st, dl, pd, pool = sh[5:]
                    ck = dict(kw, kh=ks, kw=ks, stride=(st, st),
                              dilation=(dl, dl), padding=(pd, pd), pool=pool)
                    pool_errs.append(max_abs_err(
                        torch, fq_conv2d(x, w, s, **ck),
                        ref.ref_fq_conv2d(x, w, s, **ck)))
                    want_vec["fq_conv2d_pool_vector"] += (
                        conv_loader(sh[3], x.data_ptr()) == "vector")
            torch.cuda.synchronize()
            vec = kernels.vector_launch_counts()
            label = f"{fmt} " + ("clean" if chunks is None
                                 else f"noisy c{chunks}")
            launched = kernels.launch_counts()
            print(f"  {label}: K2 max_abs_err={max(mm_errs):g}, K3 "
                  f"max_abs_err={max(conv_errs):g}, K3b max_abs_err="
                  f"{max(pool_errs):g}; launches "
                  f"{launched['fq_matmul']} K2 "
                  f"({vec['fq_matmul_vector']} vector), "
                  f"{launched['fq_conv2d']} K3 "
                  f"({vec['fq_conv2d_vector']} vector) and "
                  f"{launched['fq_conv2d_pool']} K3b "
                  f"({vec['fq_conv2d_pool_vector']} vector)", flush=True)
            if max(mm_errs + conv_errs + pool_errs) != 0.0:
                raise AssertionError(f"tensor-core loop {label}: kernel != "
                                     "plain version")
            if vec != want_vec or not all(
                    0 < want_vec[f"{k}_vector"] < len(ops_) * len(epis)
                    for k, ops_ in (("fq_matmul", mm_ops),
                                    ("fq_conv2d", conv_ops),
                                    ("fq_conv2d_pool", pool_ops))):
                raise AssertionError(f"{label}: vector launches {vec} != "
                                     f"{want_vec}, or one loader unused")
            for k, e in (("fq_matmul", mm_errs), ("fq_conv2d", conv_errs),
                         ("fq_conv2d_pool", pool_errs)):
                name = (noisy_name(k, fmt, chunks) if chunks else
                        k + ("" if fmt == "int8" else f"_{fmt}"))
                errs[name] = max(e)
    return errs


def weight_bytes(stack) -> int:
    """Bytes of the integer layers' weight codes, as stored."""
    return sum(stack[n]["w_codes"].numel() * stack[n]["w_codes"]
               .element_size() for n in stack.layer_names)


def counted(torch, kernels, fn):
    """(result, launch counts, packed launch counts) of ``fn()`` with every
    counter set to 0 just before it and read just after."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, kernels.launch_counts(), kernels.packed_launch_counts()


def launch_line(label, counts, packed):
    on = " ".join(f"{k}={v}" for k, v in packed.items() if v)
    return (f"kernels ({label}): " + " ".join(f"{k}={v}"
                                            for k, v in counts.items())
            + f" (packed {on or 'none'})")


def loaders(kernels, path, counts):
    """" (vector fq_matmul_vector=N fq_conv2d_vector=M ...)" of the counted
    run just ended: every DarkNet K2 / K3 / K3b launch took the tensor-core
    loop's vector A loader (Cin and K multiples of 16), every KWS one the
    byte loader (cin 100 and 45, K 300 and 135); raises otherwise."""
    vec = kernels.vector_launch_counts()
    want = {f"{k}_vector": counts[k] if path == "darknet" else 0
            for k in kernels.VECTOR}
    if vec != want:
        raise AssertionError(f"{path}: vector-loader launches {vec} != "
                             f"{want}")
    return " (vector " + " ".join(f"{k}={v}" for k, v in vec.items()) + ")"


def phase_serve_kws(torch, dev):
    """The KWS path: the port's KWS integer serving, both conv impls."""
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

    # -- the KWS path, counted --------------------------------------------
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    logits = {(b, impl): fn(requests[b]) for b in BATCHES
              for impl, fn in serve.items()}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print("kernels (kws): " + " ".join(f"{k}={v}" for k, v in counts.items())
          + loaders(kernels, "kws", counts), flush=True)
    n_req, n_conv = len(BATCHES), len(names)
    expect = {"quantize_codes": 2 * n_req, "fq_matmul": n_req * n_conv,
              "fq_conv2d": n_req * n_conv, "fq_conv2d_pool": 0,
              "lm_island": 0}
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
        print(f"serve kws B={b}: fused == im2col (codes and logits); GPU "
              f"int_core == CPU int_core; entry codes flipped vs CPU "
              f"{int(flipped.sum())}/{flipped.numel()}; max |logit diff| "
              f"{worst_clean:.3g} on {int(clean.sum())} unflipped requests, "
              f"{worst_flip:.3g} on {int((~clean).sum())} with flips; "
              f"output code histogram 0..7 {hist}", flush=True)
        if worst_clean > ATOL_LOGITS:
            raise AssertionError(f"B={b}: logits off the CPU run by "
                                 f"{worst_clean} > {ATOL_LOGITS}")
    frac = total_flips / total_codes
    print(f"serve kws: entry codes flipped by FP-embedding sum order (cuBLAS "
          f"vs CPU): {total_flips} of {total_codes} ({frac:.2e})", flush=True)
    if frac > MAX_FLIP_FRACTION:
        raise AssertionError(f"flip fraction {frac} > {MAX_FLIP_FRACTION}")
    serve_timing(torch, "kws", serve, requests, (BATCHES[0], BATCHES[-1]))

    # -- the packed stacks, each format counted in a run of its own -------
    stacks = {"int8": stack}
    for fmt in ("auto", "int4"):
        st = kws.convert_int(params, state, qcfg, cfg, weight_format=fmt)
        stacks[st.specs[0].weight_format] = st
    ways = {impl: dict(impl=impl) for impl in serve}
    result, packed_serve = serve_packed(
        torch, kws, "kws", stacks, ways, requests, logits, expect,
        lambda x: entry(stack, x.to(dev)), qcfg, cfg)
    check_stacks(torch, ii, "kws", stacks, {n: params[n] for n in names})
    serve_timing(torch, "kws ternary", packed_serve["ternary"], requests,
                 (BATCHES[0], BATCHES[-1]))

    # -- noise (§4.4), each format and mac_chunks counted on its own ------
    noisy, timed = serve_noisy(
        torch, kws, "kws", stacks, ways, requests, logits, expect,
        lambda x: entry(stack, x.to(dev)), qcfg, cfg, lambda *_: True)
    for chunks, fns in timed.items():
        serve_timing(torch, f"kws noisy c{chunks}", fns, requests,
                     (BATCHES[0], BATCHES[-1]),
                     profile_reps=NOISY_PROFILE_REPS)
    return {"int8": counts, **result, "noisy": noisy}


def serve_packed(torch, model, path, stacks, ways, requests, logits, expect,
                 entry, qcfg, cfg):
    """Serve the int8 run's requests from each packed stack every way, each
    format counted in a run of its own: the same launches as int8 with
    every K3 / K3b launch packed, and codes and logits equal to int8
    fused. Returns ({format: counts}, {format: {way: serve fn}})."""
    from repro_torch import kernels
    result, fns_of = {}, {}
    for fmt in PACKED_FORMATS:
        st = stacks[fmt]
        fns = fns_of[fmt] = {way: model.int_serve_fn(st, qcfg, cfg, **kw)
                             for way, kw in ways.items()}
        got, c, pc = counted(torch, kernels, lambda: {
            (b, way): fn(requests[b]) for b in requests
            for way, fn in fns.items()})
        print(launch_line(f"{path}, {fmt}", c, pc)
              + loaders(kernels, path, c), flush=True)
        want_pc = dict.fromkeys(pc, 0)
        for k in ("fq_conv2d", "fq_conv2d_pool"):
            if expect[k]:
                want_pc[f"{k}_{fmt}"] = expect[k]
        if c != expect or pc != want_pc:
            raise AssertionError(f"{fmt} launch counts {c} {pc} != expected "
                                 f"{expect} {want_pc}")
        result[fmt] = {**c, **pc}
        for b in requests:
            codes = entry(torch.from_numpy(requests[b]))
            want = model.int_core(stacks["int8"], codes, qcfg, cfg,
                                  impl="fused")
            for way, kw in ways.items():
                if not torch.equal(got[(b, way)], logits[(b, "fused")]):
                    raise AssertionError(f"B={b}: {fmt} {way} logits != "
                                         "int8 fused")
                if not torch.equal(model.int_core(st, codes, qcfg, cfg, **kw),
                                   want):
                    raise AssertionError(f"B={b}: {fmt} {way} codes != "
                                         "int8 fused")
        print(f"serve {path} {fmt}: B={tuple(requests)}: " + " == ".join(
            f"{fmt} {way}" for way in ways) + " == int8 fused (codes and "
            "logits)", flush=True)
    return result, fns_of


def serve_noisy(torch, model, path, stacks, ways, requests, clean, expect,
                entry, qcfg, cfg, cpu_check):
    """Serve the same requests with the §4.4 noise (Table 7's noisiest
    condition, key PRNGKey(NOISE_KEY)) from every format under every way,
    at each mac_chunks in CHUNKS, each (format, chunks) counted in a run
    of its own. Checks: every conv launch noisy, the same launches as the
    clean run; the ways identical (codes and logits); the GPU integer core
    against the port's CPU run where ``cpu_check(fmt, chunks, batch)``,
    given the same entry codes and key (differing codes counted, failed
    above MAX_FLIP_FRACTION); one
    fused int_apply launches only noisy K3 / K3b; the noise moved the
    logits. Returns ({noisy kernel name: launches}, {chunks: int8 serve fns
    with the noise bound})."""
    from repro_torch import kernels
    from repro_torch.core import prng
    from repro_torch.core.noise import TABLE7_CONDITIONS
    cond = TABLE7_CONDITIONS[-1]
    key = prng.PRNGKey(NOISE_KEY)
    launches, timed = {}, {}
    flips = total = 0
    for fmt, st in stacks.items():
        st_cpu = st.to("cpu")
        for chunks in CHUNKS:
            fns = {way: model.int_serve_fn(st, qcfg, cfg, mac_chunks=chunks,
                                           **kw) for way, kw in ways.items()}
            got, c, pc = counted(torch, kernels, lambda: {
                (b, way): fn(requests[b], noise=cond, rng=key)
                for b in requests for way, fn in fns.items()})
            nc = kernels.noisy_launch_counts()
            print(launch_line(f"{path}, {fmt}, noisy c{chunks}", c, pc)
                  + " noisy " + " ".join(f"{k}={v}" for k, v in nc.items())
                  + loaders(kernels, path, c), flush=True)
            want_nc = {f"{k}_noisy": expect[k] for k in kernels.NOISY}
            if c != expect or nc != want_nc:
                raise AssertionError(f"{fmt} c{chunks}: launch counts {c} "
                                     f"{nc} != expected {expect} {want_nc}")
            for k in kernels.NOISY:
                if not expect[k]:
                    continue
                if fmt == "int8":
                    launches[noisy_name(k, fmt, chunks)] = c[k]
                elif k != "fq_matmul":   # the im2col oracle unpacks
                    launches[noisy_name(k, fmt, chunks)] = pc[f"{k}_{fmt}"]
                    if pc[f"{k}_{fmt}"] != expect[k]:
                        raise AssertionError(f"{fmt} {k}: {pc} not all "
                                             "packed")
            for b in requests:
                lf = got[(b, "fused")]
                if not torch.isfinite(lf).all():
                    raise AssertionError(f"B={b}: noisy logits not finite")
                if torch.equal(lf, clean[(b, "fused")]):
                    raise AssertionError(f"B={b} {fmt} c{chunks}: the noise "
                                         "did not move the logits")
                codes = entry(torch.from_numpy(requests[b]))
                core = {way: model.int_core(st, codes, qcfg, cfg, noise=cond,
                                            rng=key, mac_chunks=chunks, **kw)
                        for way, kw in ways.items()}
                for way in ways:
                    if not torch.equal(got[(b, way)], lf):
                        raise AssertionError(f"B={b} {fmt} c{chunks}: {way} "
                                             "noisy logits != fused")
                    if not torch.equal(core[way], core["fused"]):
                        raise AssertionError(f"B={b} {fmt} c{chunks}: {way} "
                                             "noisy codes != fused")
                if cpu_check(fmt, chunks, b):
                    t0 = time.perf_counter()
                    core_cpu = model.int_core(st_cpu, codes.cpu(), qcfg, cfg,
                                              noise=cond, rng=key,
                                              mac_chunks=chunks)
                    n_diff = int((core["fused"].cpu() != core_cpu).sum())
                    flips += n_diff
                    total += core_cpu.numel()
                    print(f"serve {path} {fmt} noisy c{chunks} B={b}: "
                          + " == ".join(ways) + " (codes and logits); GPU "
                          f"int_core vs CPU int_core: {n_diff} of "
                          f"{core_cpu.numel()} codes differ (CPU run "
                          f"{time.perf_counter() - t0:.1f} s)", flush=True)
            _, c1, _ = counted(torch, kernels, lambda: fns["fused"](
                requests[max(requests)], noise=cond, rng=key))
            nc1 = kernels.noisy_launch_counts()
            if (c1["fq_matmul"] or any(nc1[f"{k}_noisy"] != c1[k]
                                       for k in ("fq_conv2d",
                                                 "fq_conv2d_pool"))):
                raise AssertionError(f"one fused noisy int_apply: {c1} "
                                     f"{nc1}, expected only noisy K3 / K3b")
            if fmt == "int8":
                timed[chunks] = {"fused": lambda x, fn=fns["fused"]: fn(
                    x, noise=cond, rng=key)}
    frac = flips / total
    print(f"serve {path} noisy: GPU vs CPU int_core, same entry codes and "
          f"key: {flips} of {total} codes differ ({frac:.2e}); every conv "
          "launch noisy; one fused int_apply launched only noisy K3 / K3b",
          flush=True)
    if frac > MAX_FLIP_FRACTION:
        raise AssertionError(f"noisy GPU/CPU code difference {frac} > "
                             f"{MAX_FLIP_FRACTION}")
    return launches, timed


def check_stacks(torch, ii, path, stacks, layer_params):
    """Weight bytes on the device per format; the digests of the formats
    differ, and rederive on unchanged params keeps the ternary digest."""
    nbytes = {f: weight_bytes(st) for f, st in stacks.items()}
    digests = {f: ii.stack_digest(st) for f, st in stacks.items()}
    again = ii.stack_digest(stacks["ternary"].rederive(layer_params))
    print(f"serve {path}: integer weight bytes on the device: " + ", ".join(
        f"{f} {v} ({v / nbytes['int8']:.4f} of int8)"
        for f, v in nbytes.items()) + "; stack_digest " + ", ".join(
        f"{f} {d}" for f, d in digests.items())
        + f"; ternary rederive(unchanged params) {again}", flush=True)
    if len(set(digests.values())) != len(digests):
        raise AssertionError(f"{path}: formats share a digest {digests}")
    if again != digests["ternary"]:
        raise AssertionError(f"{path}: rederive changed the digest")


# Requests profiled a noisy serve_timing run: 2, not device_profile's 10. A
# noisy request launches ~5,900 (KWS) / ~14,700 (DarkNet) device ops and the
# profiler's host costs ~0.5 ms an event, so 10 took ~4 minutes of the
# smoke run's 1,200 s once the fleet phase joined it.
NOISY_PROFILE_REPS = 2


def serve_timing(torch, path, serve, requests, profiled, profile_reps=10):
    """Request latency on the host clock, and the profiled device busy
    share over ``profile_reps`` requests (a measurement, not a check)."""
    for b in requests:
        for impl, fn in serve.items():
            ms = eager_ms(torch, lambda: fn(requests[b]), reps=20)
            print(f"serve {path} latency B={b} {impl}: {ms:.4f} ms per "
                  "request batch (host clock, eager, synchronised)",
                  flush=True)
    for b in profiled:
        for impl, fn in serve.items():
            try:
                wall, busy, n_ops, names = device_profile(
                    torch, lambda: fn(requests[b]), reps=profile_reps)
            except RuntimeError as e:
                print(f"serve {path} profile B={b} {impl}: not measured ({e})")
                continue
            share = f"{busy / wall:.4f}" if busy else "not measured"
            print(f"serve {path} profile B={b} {impl}: wall {wall:.4f} ms, "
                  f"device busy {busy:.4f} ms per request batch, busy share "
                  f"{share}, {n_ops:g} device ops per request (profiled); "
                  "most device time: " + "; ".join(
                      re.sub(r"^void |\(anonymous namespace\)::", "", n)[:56]
                      + f" {ms:.4f} ms" for n, ms in names),
                  flush=True)


def q99_positive(torch, a):
    """The QUANTILE-th quantile of the positive entries of ``a``, by
    ``kthvalue`` (``torch.quantile`` refuses more than 2^24 elements)."""
    pos = a[a > 0].flatten().float()
    if pos.numel() == 0:
        raise AssertionError("no positive values to calibrate on")
    k = max(1, math.ceil(QUANTILE * pos.numel()))
    return pos.kthvalue(k).values


def darknet_live_stack(torch, cfg, qcfg, calib, device):
    """:func:`darknet_live_params` -> convert_int: (stack, liveness)."""
    from repro_torch.models import darknet
    params, state, live = darknet_live_params(torch, cfg, qcfg, calib,
                                              device)
    return darknet.convert_int(params, state, qcfg, cfg), live


def darknet_live_params(torch, cfg, qcfg, calib, device):
    """The port's own DarkNet params from seed SEED, calibrated live on the
    float images ``calib``: init -> to_fq; conv1's s_in covers the QUANTILE
    of the positive pre-entry activations; then per integer conv, in plan
    order, s_out = s_in + s_w + log(q(acc > 0) / (n_a n_w)) from the exact
    int32 accumulator of the current codes, handed off to the next layer's
    s_in, and the layer runs to give the next codes.

    The uniform recipe (one s_out for every layer) leaves the full-width net
    dead: a uniform s_out cancels out of every inner rescale, and the codes
    are all 0 from conv12 or conv13 on.

    Returns (params, state, {layer: share of nonzero output codes on
    ``calib``}).
    """
    from repro_torch.core import fq_layers as fql
    from repro_torch.core import integer_inference as ii
    from repro_torch.core.quant import (QuantConfig, RELU_BOUND,
                                        WEIGHT_BOUND, n_levels,
                                        quantize_to_int)
    from repro_torch.kernels import ops
    from repro_torch.models import darknet

    params, state = darknet.init(torch.Generator().manual_seed(SEED), cfg,
                                 device=device)
    params = darknet.to_fq(params, state, cfg)
    n_a, n_w = n_levels(qcfg.bits_a), n_levels(qcfg.bits_w)
    plan = darknet.layer_plan(cfg)
    split = darknet._split_plan(plan)
    h = calib.to(device)
    for step in plan[:split]:
        h = (fql.fq_conv2d(params["conv0"], h, QuantConfig(fq=qcfg.fq))
             if step[0] == "fp_conv" else ops.maxpool2d(h))
    s_in = torch.log(q99_positive(torch, h))
    codes = ii.entry_codes(h, {"s_in": s_in}, qcfg, b_in=RELU_BOUND)
    one = torch.ones((), dtype=torch.float32, device=device)
    live = {}
    for step in plan[split:]:
        if step[0] == "pool":
            codes = ii.int_maxpool2d(codes)
            continue
        _, name, ks, pooled = step
        p = {**params[name], "s_in": s_in}
        w_codes = quantize_to_int(p["w"], p["s_w"], bits=qcfg.bits_w,
                                  b=WEIGHT_BOUND)
        acc = ops.fq_conv2d_int(codes, w_codes.reshape(-1, w_codes.shape[-1])
                                .contiguous(), one, ksize=ks,
                                padding=ks // 2, epilogue="dequant")
        p["s_out"] = s_in + p["s_w"] + torch.log(q99_positive(torch, acc)
                                                 / (n_a * n_w))
        params[name] = p
        run = ii.int_conv2d_pool if pooled else ii.int_conv2d
        codes = run(ii.convert_layer(p, qcfg, name=name), codes, ksize=ks,
                    padding=ks // 2)
        live[name] = float((codes != 0).double().mean())
        s_in = p["s_out"]
    return params, state, live


def phase_serve_darknet(torch, dev):
    """The DarkNet path: full-width DarkNet-19 integer serving at 224 x 224,
    three ways."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import fq_layers as fql
    from repro_torch.core import integer_inference as ii
    from repro_torch.core.quant import QuantConfig, RELU_BOUND
    from repro_torch.kernels import ops
    from repro_torch.models import darknet

    cfg = darknet.DarkNetConfig()
    qcfg = QuantConfig(2, 4, 4, fq=True)
    rng = np.random.default_rng(SEED + 3)
    calib = torch.from_numpy(rng.standard_normal(
        (DN_CALIB, DN_SIZE, DN_SIZE, cfg.in_channels)).astype(np.float32))
    t0 = time.perf_counter()
    params, state, live = darknet_live_params(torch, cfg, qcfg, calib, dev)
    stack = darknet.convert_int(params, state, qcfg, cfg)
    print(f"serve darknet: live stack from seed {SEED} calibrated on "
          f"{DN_CALIB} images in {time.perf_counter() - t0:.1f} s; nonzero "
          "output codes per layer on them: " + " ".join(
              f"{k}={v:.3f}" for k, v in live.items()), flush=True)
    stack_cpu = stack.to("cpu")
    requests = {b: rng.standard_normal(
        (b, DN_SIZE, DN_SIZE, cfg.in_channels)).astype(np.float32)
        for b in DN_BATCHES}
    ways = {"fused": dict(impl="fused"),
            "fused_nopool": dict(impl="fused", fuse_pool=False),
            "im2col": dict(impl="im2col")}
    serve = {way: darknet.int_serve_fn(stack, qcfg, cfg, **kw)
             for way, kw in ways.items()}

    # -- the DarkNet path, counted ---------------------------------------
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    logits = {(b, way): fn(requests[b]) for b in DN_BATCHES
              for way, fn in serve.items()}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    split = kernels.split_launch_counts()
    print("kernels (darknet): " + " ".join(f"{k}={v}"
                                           for k, v in counts.items())
          + loaders(kernels, "darknet", counts) + " (split-K " + " ".join(
              f"{k}={v}" for k, v in split.items()) + ")", flush=True)
    plan = darknet.layer_plan(cfg)
    n_conv = sum(s[0] == "conv" for s in plan)
    n_pooled = sum(s[0] == "conv" and s[3] for s in plan)
    n_req = len(DN_BATCHES)
    expect = {"quantize_codes": 3 * n_req, "fq_matmul": n_req * n_conv,
              "fq_conv2d": n_req * ((n_conv - n_pooled) + n_conv),
              "fq_conv2d_pool": n_req * n_pooled, "lm_island": 0}
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
    # the tile policy's splits: fused runs the unpooled convs as K3, the way
    # without pool fusion every conv; a split conv is one cluster launch
    layers = darknet_int_layers(cfg, DN_SIZE)
    splits = {b: [policy_split(torch, dev, side, cin, cout, ks, b) > 1
                  for _, side, cin, cout, ks, _ in layers] for b in DN_BATCHES}
    fused_splits = {b: sum(sp for sp, l in zip(splits[b], layers)
                           if not l[5]) for b in DN_BATCHES}
    n_split = sum(fused_splits[b] + sum(splits[b]) for b in DN_BATCHES)
    if split != dict.fromkeys(SPLIT_KERNELS, n_split) or not n_split:
        raise AssertionError(f"split-K launches {split} != {n_split} each, "
                             "as the tile policy picks")

    # -- checks (these launches are not counted) -------------------------
    def entry(ip, x):
        h = x
        for step in plan[:darknet._split_plan(plan)]:
            h = (fql.fq_conv2d(ip["conv0"], h, QuantConfig(fq=qcfg.fq))
                 if step[0] == "fp_conv" else ops.maxpool2d(h))
        return ii.entry_codes(h, ip["entry"], qcfg, b_in=RELU_BOUND)

    total_flips = total_codes = 0
    for b in DN_BATCHES:
        lf = logits[(b, "fused")]
        if lf.shape != (b, cfg.num_classes) or not torch.isfinite(lf).all():
            raise AssertionError(f"B={b}: logits {tuple(lf.shape)} not finite "
                                 "of the expected shape")
        if not float(lf.abs().max()) > 0:
            raise AssertionError(f"B={b}: all logits are 0")
        for way in ways:
            if not torch.equal(lf, logits[(b, way)]):
                raise AssertionError(f"B={b}: {way} logits != fused")
        x = torch.from_numpy(requests[b])
        codes_gpu = entry(stack, x.to(dev))
        core = {way: darknet.int_core(stack, codes_gpu, qcfg, cfg, **kw)
                for way, kw in ways.items()}
        for way in ways:
            if not torch.equal(core["fused"], core[way]):
                raise AssertionError(f"B={b}: {way} codes != fused")
        msg = ""
        if b == DN_BATCHES[0]:
            t0 = time.perf_counter()
            core_cpu = darknet.int_core(stack_cpu, codes_gpu.cpu(), qcfg, cfg)
            if not torch.equal(core["fused"].cpu(), core_cpu):
                raise AssertionError(f"B={b}: GPU int_core codes != CPU run")
            msg = (f"GPU int_core == CPU int_core ({time.perf_counter() - t0:.1f}"
                   " s on the CPU); ")
        codes_cpu = entry(stack_cpu, x)
        flipped = codes_gpu.cpu() != codes_cpu
        total_flips += int(flipped.sum())
        total_codes += flipped.numel()
        logits_cpu = darknet.int_apply(stack_cpu, x, qcfg, cfg)
        tol = DN_RTOL_LOGITS * float(logits_cpu.abs().max())
        diff = (lf.cpu() - logits_cpu).abs().amax(dim=1)
        clean = ~flipped.reshape(b, -1).any(dim=1)
        worst_clean = float(diff[clean].max()) if clean.any() else 0.0
        worst_flip = float(diff[~clean].max()) if (~clean).any() else 0.0
        print(f"serve darknet B={b}: fused == fused_nopool == im2col (codes "
              f"and logits); {msg}entry codes flipped vs CPU "
              f"{int(flipped.sum())}/{flipped.numel()}; max |logit diff| "
              f"{worst_clean:.3g} (limit {tol:.3g}) on {int(clean.sum())} "
              f"unflipped requests, {worst_flip:.3g} on "
              f"{int((~clean).sum())} with flips", flush=True)
        if worst_clean > tol:
            raise AssertionError(f"B={b}: logits off the CPU run by "
                                 f"{worst_clean} > {tol}")
    frac = total_flips / total_codes
    print(f"serve darknet: entry codes flipped by conv0 sum order (cuDNN vs "
          f"CPU): {total_flips} of {total_codes} ({frac:.2e})", flush=True)
    if frac > MAX_FLIP_FRACTION:
        raise AssertionError(f"flip fraction {frac} > {MAX_FLIP_FRACTION}")

    # every layer's output codes on the largest request batch
    codes = entry(stack, torch.from_numpy(requests[DN_BATCHES[-1]]).to(dev))
    shares = {}
    for step in plan[darknet._split_plan(plan):]:
        if step[0] == "pool":
            codes = ii.int_maxpool2d(codes)
            continue
        _, name, ks, pooled = step
        run = ii.int_conv2d_pool if pooled else ii.int_conv2d
        codes = run(stack[name], codes, ksize=ks, padding=ks // 2)
        shares[name] = float((codes != 0).double().mean())
    print(f"serve darknet B={DN_BATCHES[-1]}: nonzero output codes per "
          "layer: " + " ".join(f"{k}={v:.3f}" for k, v in shares.items()),
          flush=True)
    dead = [k for k, v in shares.items() if v == 0.0]
    if dead:
        raise AssertionError(f"layers with all-zero output codes: {dead}")
    serve_timing(torch, "darknet", serve, requests, DN_BATCHES)

    # -- the packed stacks, each format counted in a run of its own -------
    stacks = {"int8": stack}
    for fmt in ("auto", "int4"):
        st = darknet.convert_int(params, state, qcfg, cfg, weight_format=fmt)
        stacks[st.specs[0].weight_format] = st
    result, packed_serve = serve_packed(
        torch, darknet, "darknet", stacks, ways, requests, logits, expect,
        lambda x: entry(stack, x.to(dev)), qcfg, cfg)
    big = DN_BATCHES[-1]
    for fmt in PACKED_FORMATS:
        _, c1, pc1 = counted(torch, kernels,
                             lambda: packed_serve[fmt]["fused"](requests[big]))
        one = {"fq_conv2d": n_conv - n_pooled, "fq_conv2d_pool": n_pooled}
        if (any(c1[k] != v or pc1[f"{k}_{fmt}"] != v for k, v in one.items())
                or c1["fq_matmul"] or c1["quantize_codes"] != 1):
            raise AssertionError(f"one fused {fmt} int_apply at B={big}: "
                                 f"{c1} {pc1}, expected {one} all packed")
        print(f"serve darknet {fmt}: one fused int_apply at B={big} launched "
              f"fq_conv2d={c1['fq_conv2d']} fq_conv2d_pool="
              f"{c1['fq_conv2d_pool']}, all packed", flush=True)
    n_ops = {}
    for fmt, fn in (("int8", serve["fused"]),
                    ("ternary", packed_serve["ternary"]["fused"])):
        n_ops[fmt] = device_profile(torch, lambda: fn(requests[big]),
                                    launched=True)[2]
    print(f"serve darknet B={big} fused: device ops launched per request "
          f"(profiled) int8 {n_ops['int8']:g}, ternary {n_ops['ternary']:g} "
          f"(int8 splits {fused_splits[big]} convs, each one launch; packed "
          f"weights never split)", flush=True)
    if not n_ops["int8"] or n_ops["int8"] != n_ops["ternary"]:
        raise AssertionError(f"the int8 fused path runs other device ops "
                             f"than the ternary one: {n_ops}")
    check_stacks(torch, ii, "darknet", stacks,
                 {n: params[n] for n in stack.layer_names})
    serve_timing(torch, "darknet ternary", packed_serve["ternary"], requests,
                 DN_BATCHES)

    # -- noise (§4.4), each format and mac_chunks counted on its own ------
    noisy, timed = serve_noisy(
        torch, darknet, "darknet", stacks, ways, requests, logits, expect,
        lambda x: entry(stack, x.to(dev)), qcfg, cfg,
        # the CPU core takes seconds per image: every run at B=1, and the
        # batch of the recorded kernels (B=8) once, packed, at chunks 1
        lambda fmt, chunks, b: b == DN_BATCHES[0] or (
            (fmt, chunks, b) == ("ternary", 1, DN_BATCHES[-1])))
    for chunks, fns in timed.items():
        serve_timing(torch, f"darknet noisy c{chunks}", fns, requests,
                     DN_BATCHES, profile_reps=NOISY_PROFILE_REPS)
    return {"int8": counts, **result, "noisy": noisy, "split": split}


# ---------------------------------------------------------------------------
# The batcher: CNN serving with each clean flush replayed as a CUDA graph
# ---------------------------------------------------------------------------

BATCHER = dict(max_batch=8, max_wait_ticks=2, max_inflight=4)
KWS_RUNGS = (140, 180)     # frames; clips of 100-220 frames crop or pad
DN_RUNGS = (160, 224)      # image sides; images of 128-288 a side
TRACE_TICKS = 10           # at 6 requests per tick and bursts of 3: ~84
MIN_TRACE_REQUESTS = 64
CANARY_REQUESTS = 12       # of the KWS trace, served noisy
# (label, stack format, batcher options): the four ways the trace is served
BATCHER_WAYS = (("sync", "int8", dict(dispatch_ahead=False)),
                ("ahead", "int8", dict(dispatch_ahead=True)),
                ("ahead 2 lanes", "int8", dict(dispatch_ahead=True,
                                               n_replicas=2)),
                ("ahead ternary", "ternary", dict(dispatch_ahead=True)))
# K1, K3 and K3b as the profiler names them on the card
GRAPH_KERNELS = {"kws": ("quantize_codes_kernel", "fq_conv_kernel"),
                 "darknet": ("quantize_codes_kernel", "fq_conv_kernel",
                             "fq_conv_pool2_kernel")}


def mixed_arrivals(rng, sample_fn, *, n_ticks, rate, burst_p=0.2, burst=3):
    """Seeded arrival trace: per tick, Poisson(rate) requests; some
    arrivals burst into ``burst`` same-shape copies (hot-bucket pressure).
    The reference benchmark's trace (``benchmarks/run.py``,
    ``_mixed_arrivals``), copied."""
    import numpy as np
    arrivals = []
    for _ in range(n_ticks):
        batch = []
        for _ in range(int(rng.poisson(rate))):
            x = sample_fn(rng)
            batch.append(x)
            if rng.random() < burst_p:
                batch.extend(np.array(x) for _ in range(burst - 1))
        arrivals.append(batch)
    return arrivals


class Resolved:
    """The batcher's ``on_event`` sink: each resolved flush's requests and
    the host-clock time each request resolved at."""

    def __init__(self):
        self.flushes, self.at = [], {}

    def __call__(self, etype, fields):
        if etype == "resolve":
            now = time.perf_counter()
            self.flushes.append(fields["reqs"])
            for r in fields["reqs"]:
                self.at[r.rid] = now


def replay(cb, b, sink, arrivals):
    """Drive ``arrivals`` through batcher ``b`` tick by tick with no drain
    (completion through ticks alone, as the reference benchmark replays
    it). Returns (requests, ticks, wall s, per-request wall latency ms:
    submit to resolve, s of the wall spent in ``submit``: the ladder)."""
    import numpy as np
    sink.flushes.clear()
    sink.at.clear()
    reqs, submitted, ticks, in_submit = [], {}, 0, 0.0
    t0 = time.perf_counter()
    for batch in arrivals:
        new = [cb.CNNRequest(rid=len(reqs) + i, x=x)
               for i, x in enumerate(batch)]
        now = time.perf_counter()
        b.submit(new)
        in_submit += time.perf_counter() - now
        reqs.extend(new)
        submitted.update((r.rid, now) for r in new)
        b.tick()
        ticks += 1
    while b.outstanding() and ticks < 10_000:
        b.tick()
        ticks += 1
    wall = time.perf_counter() - t0
    if b.outstanding():
        raise AssertionError("the trace did not complete through ticks")
    lat = np.asarray([(sink.at[r.rid] - submitted[r.rid]) * 1e3
                      for r in reqs])
    return reqs, ticks, wall, lat, in_submit


def padded_batch(cb, reqs, max_batch):
    """A flush's batch as the batcher packs it: the normalized payloads in
    order, zero rows up to its slot count."""
    import numpy as np
    x = np.zeros((cb.batch_bucket(len(reqs), max_batch),)
                 + reqs[0].x_served.shape, reqs[0].x_served.dtype)
    for i, r in enumerate(reqs):
        x[i] = r.x_served
    return x


def check_served(cb, label, b, reqs, flushes, fn):
    """Every request served once; every flush replayed a graph, at most
    n_signatures graphs a lane; each flush's rows bit-identical to the
    eager ``fn`` on the same padded batch. Returns {rid: slots}."""
    import numpy as np
    st, steps = b.stats, b.step_stats
    rids = sorted(r.rid for batch in flushes for r in batch)
    if (rids != list(range(len(reqs))) or st["served"] != len(reqs)
            or not all(r.done and r.error is None for r in reqs)):
        raise AssertionError(f"{label}: not every request served once")
    if steps["graph_flushes"] != st["flushes"] or steps["eager_flushes"]:
        raise AssertionError(f"{label}: a clean flush ran eagerly: {steps}")
    if max(steps["graphs"]) > b.n_signatures:
        raise AssertionError(f"{label}: graphs per lane {steps['graphs']} "
                             f"> n_signatures {b.n_signatures}")
    slots = {}
    for batch in flushes:
        x = padded_batch(cb, batch, b.max_batch)
        want = fn(x).cpu().numpy()
        for i, r in enumerate(batch):
            slots[r.rid] = x.shape[0]
            if r.out.dtype != want.dtype or not np.array_equal(r.out,
                                                               want[i]):
                raise AssertionError(f"{label}: request {r.rid} != the "
                                     "eager int_serve_fn on its flush's "
                                     "batch")
    return slots


def serve_batcher_model(torch, dev, path, fns, ladder, sample, smi):
    """One model's trace through the batcher the four ways of
    BATCHER_WAYS, each counted in a run of its own and checked; then the
    sync and dispatch-ahead int8 batchers serve it again, warm and timed,
    and the dispatch-ahead one once more, profiled."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.serve import cnn_batching as cb
    arrivals = mixed_arrivals(np.random.default_rng(SEED + 5), sample,
                              n_ticks=TRACE_TICKS, rate=6.0, burst_p=0.2,
                              burst=3)
    n = sum(len(a) for a in arrivals)
    if n < MIN_TRACE_REQUESTS:
        raise AssertionError(f"{path}: the trace has {n} requests < "
                             f"{MIN_TRACE_REQUESTS}")
    outs, slots, kept = {}, {}, {}
    for label, fmt, kw in BATCHER_WAYS:
        sink = Resolved()
        b = cb.CNNBatcher(fns[fmt], ladder=ladder, on_event=sink,
                          **BATCHER, **kw)
        (reqs, ticks, wall, _, _), counts, packed = counted(
            torch, kernels, lambda: replay(cb, b, sink, arrivals))
        loader_note = loaders(kernels, path, counts)
        split = kernels.split_launch_counts()
        if label == "ahead":
            graph_kernels = GRAPH_KERNELS[path] + (
                SPLIT_GRAPH_KERNELS if split["fq_conv2d_splitk"] else ())
        slots[label] = check_served(cb, f"{path} {label}", b, reqs,
                                    sink.flushes, fns[fmt])
        outs[label] = [r.out for r in reqs]
        missing = [k for k in PATH_KERNELS[path] if k != "fq_matmul"
                   and counts[k] == 0]
        if missing or counts["fq_matmul"]:
            raise AssertionError(f"{path} {label}: launches {counts}: "
                                 f"{missing} never captured, or K2 on the "
                                 "fused path")
        if fmt != "int8" and any(
                packed[f"{k}_{fmt}"] != counts[k]
                for k in ("fq_conv2d", "fq_conv2d_pool")):
            raise AssertionError(f"{path} {label}: {packed} not all {fmt}")
        st, steps = b.stats, b.step_stats
        print(launch_line(f"batcher, {path}, {label}, at capture and "
                          "warm-up", counts, packed) + loader_note
              + " (split-K " + " ".join(f"{k}={v}" for k, v in split.items())
              + ")", flush=True)
        print(f"serve_batcher {path} {label}: {n} requests served once in "
              f"{ticks} ticks, {st['flushes']} flushes all replayed from "
              f"graphs ({steps['graph_flushes']}), {st['padded_rows']} "
              f"padded rows, n_signatures {b.n_signatures}, graphs per lane "
              f"{steps['graphs']}, {steps['captures']} captures in "
              f"{steps['capture_s']:.4f} s; wall {wall:.4f} s with the "
              "captures; every flush == eager int_serve_fn on its padded "
              "batch, bit for bit", flush=True)
        kept[label] = (b, sink)
    for label in ("ahead", "ahead 2 lanes", "ahead ternary"):
        other = "ahead" if label == "ahead ternary" else "sync"
        diff = [i for i, (a, c) in enumerate(zip(outs[label], outs[other]))
                if not np.array_equal(a, c)]
        if diff:
            moved = sum(slots[label][i] != slots[other][i] for i in diff)
            raise AssertionError(
                f"{path}: {label} != {other} on {len(diff)} of {n} requests "
                f"({moved} of them served at another slot count)")
    same_slots = sum(slots["sync"][i] == slots["ahead"][i] for i in range(n))
    print(f"serve_batcher {path}: sync == ahead == ahead 2 lanes and ahead "
          f"ternary == ahead int8, bit for bit, on all {n} requests "
          f"({same_slots} served at the same slot count in sync and ahead)",
          flush=True)

    # graph-served sync and dispatch-ahead, warm: timed; then profiled
    for label in ("sync", "ahead"):
        b, sink = kept[label]
        reqs, ticks, wall, lat, in_submit = replay(cb, b, sink, arrivals)
        waits = np.asarray([r.wait_ticks for r in reqs])
        padded = sum(padded_batch(cb, f, b.max_batch).shape[0] - len(f)
                     for f in sink.flushes)
        print(f"serve_batcher {path} {label} int8 graphs (warm): {n} "
              f"requests in {wall:.4f} s = {n / wall:.1f} requests/s, "
              f"{ticks} ticks, {in_submit:.4f} s of it in submit (the "
              f"ladder); wall latency per request p50 "
              f"{np.percentile(lat, 50):.4f} ms p99 "
              f"{np.percentile(lat, 99):.4f} ms (host clock, submit to "
              f"resolve); wait ticks p50 {np.percentile(waits, 50):g} p99 "
              f"{np.percentile(waits, 99):g}; {len(sink.flushes)} flushes, "
              f"{padded} padded rows; graphs {b.n_graphs} (n_signatures "
              f"{b.n_signatures}); {smi}", flush=True)
    b, sink = kept["ahead"]
    captures = b.step_stats["captures"]
    wall_ms, busy, n_ops, names = device_profile(
        torch, lambda: replay(cb, b, sink, arrivals), reps=1, top=1000)
    if b.step_stats["captures"] != captures:
        raise AssertionError(f"{path}: warm replays captured again")
    seen = [k for k in graph_kernels if any(k in name for name, _ in names)]
    print(f"serve_batcher {path} ahead int8 graphs profile: wall "
          f"{wall_ms:.4f} ms for {n} requests, device busy {busy:.4f} ms, "
          f"busy share {busy / wall_ms:.4f}, {n_ops:g} device ops "
          f"({n_ops / len(sink.flushes):.1f} per flush); kernels seen in "
          f"the replayed graphs: {seen}; most device time: " + "; ".join(
              re.sub(r"^void |\(anonymous namespace\)::", "", name)[:56]
              + f" {ms:.4f} ms" for name, ms in names[:8]), flush=True)
    if seen != list(graph_kernels):
        raise AssertionError(f"{path}: the profiled replay shows "
                             f"{[name for name, _ in names]}, not all of "
                             f"{graph_kernels}")
    staged = sum(padded_batch(cb, f, b.max_batch).nbytes
                 for f in sink.flushes)
    h2d = sum(ms for name, ms in names if "Pinned -> Device" in name)
    rate = f"{staged / h2d / 1e6:.1f} GB/s" if h2d else "not measured"
    print(f"serve_batcher {path} ahead int8 graphs profile: pinned "
          f"host-to-device copies {h2d:.4f} ms for {staged / 1e6:.3f} MB of "
          f"padded batches ({rate})", flush=True)


def flush_vs_eager(torch, cb, path, fn, ladder, xs, smi, reps=50):
    """One flush of the requests ``xs`` (all on one rung) through a sync
    batcher with max_batch len(xs), against the eager ``fn`` on the same
    normalized batch, result fetched to the host either way: host-clock
    ms per request batch (mean of ``reps``, graph first), then the
    profiled device busy time, ops and host-to-device copy of each."""
    import numpy as np
    b = cb.CNNBatcher(fn, ladder=ladder, max_batch=len(xs),
                      max_wait_ticks=0)
    b.run([cb.CNNRequest(rid=i, x=x) for i, x in enumerate(xs)])  # capture

    def graph():
        rs = [cb.CNNRequest(rid=i, x=x) for i, x in enumerate(xs)]
        b.submit(rs)
        b.tick()
        assert all(r.done for r in rs)
    x = np.stack([ladder.normalize(x) for x in xs])

    def eager():
        fn(x).cpu()
    ms, prof = {}, {}
    for name, call in (("graph", graph), ("eager", eager)):
        call()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        ms[name] = (time.perf_counter() - t0) * 1e3 / reps
        prof[name] = device_profile(torch, call, reps=10, top=1000)
    if b.step_stats["eager_flushes"] or b.step_stats["captures"] != 1:
        raise AssertionError(f"{path}: {b.step_stats}")

    def h2d(names):
        return sum(v for k, v in names if k.startswith("Memcpy HtoD"))
    print(f"serve_batcher {path} one flush of {len(xs)} on the "
          f"{x.shape[1:]} rung, to the host: graph {ms['graph']:.4f} ms vs "
          f"eager {ms['eager']:.4f} ms per request batch (host clock, mean of "
          f"{reps}); device busy graph {prof['graph'][1]:.4f} ms "
          f"({prof['graph'][2]:g} ops, host-to-device copy "
          f"{h2d(prof['graph'][3]):.4f} ms pinned) vs eager "
          f"{prof['eager'][1]:.4f} ms ({prof['eager'][2]:g} ops, "
          f"{h2d(prof['eager'][3]):.4f} ms pageable) (profiled); {smi}",
          flush=True)


def phase_serve_batcher(torch, dev):
    """CNN serving through ``repro_torch.serve.cnn_batching.CNNBatcher``:
    full-width KWS and DarkNet-19 mixed traces with every clean flush
    replayed from a CUDA graph, and a KWS noise canary run eagerly."""
    import numpy as np
    from repro_torch.core import integer_inference as ii
    from repro_torch.core import prng
    from repro_torch.core.noise import TABLE7_CONDITIONS
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import darknet, frontends, kws
    from repro_torch.serve import cnn_batching as cb

    smi = nvidia_smi()
    qcfg = QuantConfig(2, 4, 4, fq=True)
    kcfg = kws.KWSConfig()
    params, state = kws.init(torch.Generator().manual_seed(SEED), kcfg,
                             device=dev)
    params = kws.to_fq(params, state, kcfg)
    names = kws.conv_names(kcfg)
    for name in names:
        params[name] = {**params[name],
                        "s_out": torch.tensor(S_OUT, device=dev)}
    params = ii.sync_handoff(params, names)
    kfns = {fmt: kws.int_serve_fn(kws.convert_int(
        params, state, qcfg, kcfg, weight_format=wf), qcfg, kcfg)
        for fmt, wf in (("int8", None), ("ternary", "auto"))}

    dcfg = darknet.DarkNetConfig()
    calib = torch.from_numpy(np.random.default_rng(SEED + 3).standard_normal(
        (DN_CALIB, DN_SIZE, DN_SIZE, dcfg.in_channels)).astype(np.float32))
    dparams, dstate, _ = darknet_live_params(torch, dcfg, qcfg, calib, dev)
    dfns = {fmt: darknet.int_serve_fn(darknet.convert_int(
        dparams, dstate, qcfg, dcfg, weight_format=wf), qcfg, dcfg)
        for fmt, wf in (("int8", None), ("ternary", "auto"))}

    def kws_sample(rng):
        t = int(rng.integers(100, 221))
        return rng.standard_normal((t, kcfg.n_mfcc)).astype(np.float32)

    def dn_sample(rng):
        h, w = (int(v) for v in rng.integers(128, 289, size=2))
        return rng.standard_normal(
            (h, w, dcfg.in_channels)).astype(np.float32)

    kladder = frontends.kws_serving_ladder(kcfg, KWS_RUNGS)
    dladder = frontends.darknet_serving_ladder(dcfg, DN_RUNGS)
    serve_batcher_model(torch, dev, "kws", kfns, kladder, kws_sample, smi)
    serve_batcher_model(torch, dev, "darknet", dfns, dladder, dn_sample,
                        smi)
    rng = np.random.default_rng(SEED + 6)
    for path, fn, ladder, shape, sizes in (
            ("kws", kfns["int8"], kladder, (kcfg.seq_len, kcfg.n_mfcc),
             (1, 8)),
            ("darknet", dfns["int8"], dladder,
             (DN_SIZE, DN_SIZE, dcfg.in_channels), DN_BATCHES)):
        for size in sizes:
            flush_vs_eager(torch, cb, path, fn, ladder, list(
                rng.standard_normal((size,) + shape).astype(np.float32)),
                smi)

    # the noise canary: eager on the lane's stream, one fold_in key a flush
    cond = TABLE7_CONDITIONS[-1]
    xs = [x for batch in mixed_arrivals(
        np.random.default_rng(SEED + 5), kws_sample, n_ticks=TRACE_TICKS,
        rate=6.0) for x in batch][:CANARY_REQUESTS]
    sink = Resolved()
    b = cb.CNNBatcher(kfns["int8"], ladder=kladder, on_event=sink,
                      noise_config=cond, noise_seed=NOISE_KEY, **BATCHER)
    t0 = time.perf_counter()
    out = b.run([cb.CNNRequest(rid=i, x=x) for i, x in enumerate(xs)])
    wall = time.perf_counter() - t0
    steps, st = b.step_stats, b.stats
    if not (steps["eager_flushes"] == st["flushes"] == st["noise_trials"]
            == len(sink.flushes) > 0) or steps["graph_flushes"] or b.n_graphs:
        raise AssertionError(f"noise canary: {steps} {st['flushes']} "
                             f"flushes, {st['noise_trials']} trials")
    moved = 0
    for trial, batch in enumerate(sink.flushes):
        x = padded_batch(cb, batch, b.max_batch)
        key = prng.fold_in(prng.PRNGKey(NOISE_KEY), trial).to(dev)
        want = kfns["int8"](x, noise=cond, rng=key).cpu().numpy()
        clean = kfns["int8"](x).cpu().numpy()
        for i, r in enumerate(batch):
            if not np.array_equal(out[r.rid], want[i]):
                raise AssertionError(f"noise canary: request {r.rid} != the "
                                     "eager noisy int_serve_fn, same key")
            moved += not np.array_equal(out[r.rid], clean[i])
    if not moved:
        raise AssertionError("noise canary: the noise moved no output")
    print(f"serve_batcher kws noise canary (Table 7's noisiest, noise_seed "
          f"{NOISE_KEY}): {len(xs)} requests, {st['flushes']} flushes run "
          f"eagerly on the lane's stream in {wall:.3f} s, each == eager "
          "int_serve_fn(noise, rng=fold_in(PRNGKey(seed), trial)) bit for "
          f"bit; the noise moved {moved} of {len(xs)} outputs", flush=True)


# ---------------------------------------------------------------------------
# The integer LM served (serve_lm)
# ---------------------------------------------------------------------------

LM_SLOTS = (1, 4, 8)       # ContinuousBatcher decode slots
LM_RECORD_SLOTS = 8        # the record's forward: one decode step of 8 slots
LM_PREFILLS = (16, 64)     # prefill lengths timed (B=1); K2's M there
LM_MAX_LEN = 128           # the cache: FQLMConfig().max_seq
LM_REQUESTS = 12           # more requests than slots
LM_PROMPT_LENS = (1, 24)   # staggered prompt lengths, inclusive
LM_MAX_NEW = 16
LM_STEPS_TIMED = 20        # decode steps on the host clock, mean
LM_BUDGET_S = 60.0
# (K, N) of the projections: wq / wo, wk / wv, up, down; launches a layer
LM_KN = {(64, 64): 2, (64, 32): 2, (64, 128): 1, (128, 64): 1}


def lm_island_work(qpos, kv, g, dh, length):
    """(bytes, float32 operations) of the function one island call
    computes, counted from the call's query positions ``qpos`` ((B, Tq))
    and the cache length: a query at position p needs keys 0..min(p, L - 1)
    alone (a masked key's weight is exactly 0 and changes no sum), whatever
    the kernel reads. Bytes: the int8 q codes, each batch row's K / V codes
    up to its furthest needed key, the three scales, e_in and qpos read
    once, the int8 re-entry codes written once. Operations per query head
    and needed key: the score and the context (2 dh each), the scale, max,
    sum and divide (1 each) and the exp (~18 float32-equivalent steps);
    plus the dequantizing of q and of the needed K / V codes (2 each) and
    the re-entry quantizer (divide, clip, multiply, round: 4 an output)."""
    b, tq = qpos.shape
    keys = qpos.long().cpu().clamp(max=length - 1) + 1
    q_el = b * tq * kv * g * dh
    kv_el = 2 * int(keys.max(1).values.sum()) * kv * dh
    bytes_ = q_el + kv_el + 12 + 4 + 4 * b * tq + q_el
    ops = (int(keys.sum()) * kv * g * (4 * dh + 22) + 2 * (q_el + kv_el)
           + 4 * q_el)
    return bytes_, ops


def lm_requests(rng, vocab):
    lo, hi = LM_PROMPT_LENS
    return [[int(t) for t in rng.integers(0, vocab, int(rng.integers(
        lo, hi + 1)))] for _ in range(LM_REQUESTS)]


def lm_margin(torch, logits):
    """The top-2 logit margin of the last position."""
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def phase_serve_lm(torch, dev):
    """The integer LM (``models.fq_lm``, full width) served on the card:
    K1 / K2 / K4 and the island kernel held against their plain versions
    at its shapes, prefill + decode against a longer prefill, the batcher
    at slots 1, 4 and 8 against ``int_generate`` on the card and the CPU,
    the integer core against the CPU's, launches counted, times."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.core import integer_inference as ii
    from repro_torch.core import prng, quant
    from repro_torch.core.noise import NoiseConfig, TABLE7_CONDITIONS
    from repro_torch.kernels import ref
    from repro_torch.kernels.fq_matmul import fq_matmul
    from repro_torch.kernels.lm_island import (lm_island, lm_island_plain,
                                               sqrt_head)
    from repro_torch.kernels.quantize import quantize_codes
    from repro_torch.models import fq_lm
    from repro_torch.serve.batching import ContinuousBatcher, Request

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    cfg, qcfg = fq_lm.FQLMConfig(), fq_lm.LM_QCFG
    kv, dh, g = cfg.n_kv_heads, cfg.d_head, cfg.n_heads // cfg.n_kv_heads
    n = 127
    params = fq_lm.standin_params(torch.Generator().manual_seed(SEED), cfg,
                                  device=dev)
    stack = fq_lm.convert_int(params, cfg, qcfg)
    cpu_stack = stack.to("cpu")
    if ii.stack_digest(stack) != ii.stack_digest(cpu_stack):
        raise AssertionError("serve_lm: the stack's digest moved with it")
    rng = np.random.default_rng(SEED + 11)

    # every projection's output codes live (not all zero) on a prompt
    outs = {}

    def spy(ip, codes, **kw):
        y = ii.int_linear(ip, codes, **kw)
        outs.setdefault(id(ip), []).append(bool(y.any()))
        return y

    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 24)).astype(
        np.int32)).to(dev)
    fq_lm.int_prefill(stack, toks, qcfg, cfg, max_len=LM_MAX_LEN, linear=spy)
    dead = [name for name in fq_lm.proj_names(cfg)
            if not any(outs.get(id(stack[name]), [False]))]
    if dead or len(outs) != 6 * cfg.n_layers:
        raise AssertionError(f"serve_lm: projections with all-zero output "
                             f"codes: {dead}")
    print(f"serve_lm: full-width FQ LM stand-in (seed {SEED}; vocab "
          f"{cfg.vocab}, d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{kv} KV heads, {cfg.n_layers} layers, d_ff {cfg.d_ff}, "
          f"max_len {LM_MAX_LEN}), {len(stack.handoff_edges)} hand-off "
          f"edges, digest {ii.stack_digest(stack)}; all "
          f"{6 * cfg.n_layers} projections' output codes live", flush=True)

    # -- kernels against their plain versions at the LM's shapes ----------
    rows = Rows(torch, "lm", names=["quantize_codes", "fq_matmul",
                                    "lm_island"] + [
        noisy_name("fq_matmul", "int8", c) for c in CHUNKS])
    cond = TABLE7_CONDITIONS[-1]

    def codes(shape, lo=-n, hi=n):
        return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(
            np.int8)).to(dev)

    ms = sorted({1, 4, LM_RECORD_SLOTS, *LM_SLOTS, *LM_PREFILLS})
    timed_m = (LM_RECORD_SLOTS, max(LM_PREFILLS))
    for m in ms:
        x = torch.from_numpy(rng.standard_normal((m, cfg.d_model)).astype(
            np.float32)).to(dev)
        inv = quant.exp(-stack["entry"]["s_in"])
        kq = dict(n=n, b=-1.0)
        got = quantize_codes(x, inv, **kq)
        want = ref.ref_quantize_codes(x, inv, **kq)
        if m in timed_m:
            rows.record("quantize_codes", m, tuple(x.shape), got, want,
                        lambda: quantize_codes(x, inv, **kq),
                        lambda: ref.ref_quantize_codes(x, inv, **kq), None,
                        x.numel() * 5 + 4, x.numel() * 5, "fp32")
        elif max_abs_err(torch, got, want):
            raise AssertionError(f"quantize_codes ({m}, 64) != plain")
        for (k, nn), per_layer in LM_KN.items():
            name = {(64, 64): "wq0", (64, 32): "wk0", (64, 128): "up0",
                    (128, 64): "down0"}[(k, nn)]
            ip = stack[name]
            a = codes((m, k), 0 if name == "down0" else -n, n)
            w, s = ip["w_codes"], ip["rescale"]
            kw = dict(n_out=n, lo=ip["lo"])
            for chunks in (None,) + CHUNKS:
                nz = {}
                if chunks:
                    nz = dict(noise_sigma_acc=torch.div(torch.full_like(
                        s, cond.sigma_mac), s), noise_seed=torch.tensor(
                        1000 * m + k + nn, dtype=torch.uint32, device=dev),
                        mac_chunks=chunks)
                fn = (lambda a=a, w=w, s=s, nz=nz:
                      fq_matmul(a, w, s, **kw, **nz))
                plain = (lambda a=a, w=w, s=s, nz=nz:
                         ref.ref_fq_matmul(a, w, s, **kw, **nz))
                got = fn()
                name_k = ("fq_matmul" if chunks is None
                          else noisy_name("fq_matmul", "int8", chunks))
                if m in timed_m and (chunks is None or m == LM_RECORD_SLOTS):
                    rows.record(
                        name_k, m, (m, k, nn), got, plain(), fn, plain,
                        int_mm(torch, a, w) if chunks is None else None,
                        m * k + k * nn + m * nn + 4 + (8 if chunks else 0),
                        2 * m * k * nn, "int8",
                        twin=(lambda a=a, w=w, s=s: fq_matmul(a, w, s, **kw))
                        if chunks else None,
                        extra_work=field_work(m * nn, chunks)
                        if chunks else None,
                        plain_calls=2 if chunks else 20)
                else:
                    err = max_abs_err(torch, got, plain())
                    rows.extra_err[name_k] = max(
                        rows.extra_err.get(name_k, 0.0), err)
                    if err:
                        raise AssertionError(f"{name_k} {(m, k, nn)} != "
                                             f"plain (max abs err {err})")
    consts = fq_lm.island_consts(stack)
    island_shapes = [(b, 1) for b in LM_SLOTS] + [(1, t)
                                                   for t in LM_PREFILLS]
    kw_isl = dict(n=n, n_a=quant.n_levels(qcfg.bits_a), n_heads=cfg.n_heads,
                  sqrt_dh=sqrt_head(dh))
    for b, tq in island_shapes:
        q = codes((b, tq, cfg.d_model))
        kc, vc = codes((b, LM_MAX_LEN, kv, dh)), codes((b, LM_MAX_LEN, kv, dh))
        sc, e_in = consts[0]
        qpos = torch.from_numpy(rng.integers(tq - 1, LM_MAX_LEN, (b, tq))
                                .astype(np.int32)).to(dev)
        if tq > 1:
            qpos = (torch.arange(tq, dtype=torch.int32, device=dev)[None]
                    .expand(b, tq).contiguous())
        fn = (lambda q=q, kc=kc, vc=vc, sc=sc, qpos=qpos:
              lm_island(q, kc, vc, sc, qpos, e_in, **kw_isl))
        plain = (lambda q=q, kc=kc, vc=vc, sc=sc, qpos=qpos:
                 lm_island_plain(q, kc, vc, sc, qpos, e_in, **kw_isl))
        got = fn()
        # the library yardstick: SDPA on the dequantized floats, K / V
        # repeated per query head, the same mask (the context alone: no
        # one PyTorch call also requantizes it)
        e = sc.cpu()
        qf = (e[0] * torch.div(q.float(), float(n))).reshape(
            b, tq, cfg.n_heads, dh).transpose(1, 2).contiguous()
        kf, vf = ((e[i] * torch.div(c.float(), float(n))).permute(0, 2, 1, 3)
                  .repeat_interleave(g, 1).contiguous()
                  for i, c in ((1, kc), (2, vc)))
        mask = (torch.arange(LM_MAX_LEN, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]
        lib = (lambda qf=qf, kf=kf, vf=vf, mask=mask:
               F.scaled_dot_product_attention(qf, kf, vf, attn_mask=mask))
        bytes_, ops = lm_island_work(qpos, kv, g, dh, LM_MAX_LEN)
        if (b, tq) in ((LM_RECORD_SLOTS, 1), (1, max(LM_PREFILLS))):
            rows.record("lm_island", b if tq == 1 else tq, (b, tq, LM_MAX_LEN),
                        got, plain(), fn, plain, lib, bytes_, ops, "fp32",
                        plain_calls=2)
        else:
            err = max_abs_err(torch, got, plain())
            rows.extra_err["lm_island"] = max(
                rows.extra_err.get("lm_island", 0.0), err)
            if err:
                raise AssertionError(f"lm_island {(b, tq)} != plain")
    print(f"serve_lm kernels: K1, K2 (clean, noisy c1 / c4) and the island "
          f"(its int8 re-entry codes) bit-exact against their plain versions "
          f"at M in {ms} and island shapes {island_shapes} (timed rows "
          "above)", flush=True)

    # -- prefill(T) + decode == prefill(T + 1), on the card ---------------
    pre = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20)).astype(
        np.int32)).to(dev)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1)).astype(
        np.int32)).to(dev)
    _, caches = fq_lm.int_prefill(stack, pre, qcfg, cfg, max_len=LM_MAX_LEN)
    l_step, c_step = fq_lm.int_decode_step(stack, caches, nxt, qcfg, cfg)
    l_full, c_full = fq_lm.int_prefill(stack, torch.cat([pre, nxt], 1), qcfg,
                                       cfg, max_len=LM_MAX_LEN, full=True)
    if not (torch.equal(l_step, l_full[:, -1:]) and all(
            torch.equal(a[x], b[x]) for a, b in zip(c_step, c_full)
            for x in ("k", "v", "pos"))):
        raise AssertionError("serve_lm: prefill(T) + decode != prefill(T+1)")
    print("serve_lm: prefill(20) + decode == prefill(21, full=True) bit for "
          "bit on the card (caches and logits, B=2)", flush=True)

    # -- the batcher at every slot count, against int_generate ------------
    prompts = lm_requests(rng, cfg.vocab)
    probe = fq_lm.int_generate(stack, prompts[0], qcfg, cfg,
                               max_new=LM_MAX_NEW, max_len=LM_MAX_LEN)
    eos = probe[2]
    t_cpu = time.perf_counter()
    want_cpu = [fq_lm.int_generate(cpu_stack, p, qcfg, cfg,
                                   max_new=LM_MAX_NEW, max_len=LM_MAX_LEN,
                                   eos_id=eos) for p in prompts]
    t_cpu = time.perf_counter() - t_cpu
    want = [fq_lm.int_generate(stack, p, qcfg, cfg, max_new=LM_MAX_NEW,
                               max_len=LM_MAX_LEN, eos_id=eos)
            for p in prompts]
    bad = [i for i, (a, b) in enumerate(zip(want, want_cpu)) if a != b]
    for i in bad:
        toks = torch.tensor([prompts[i]], dtype=torch.int32, device=dev)
        lg, _ = fq_lm.int_prefill(stack, toks, qcfg, cfg, max_len=LM_MAX_LEN)
        print(f"serve_lm: request {i} card {want[i]} CPU {want_cpu[i]}; "
              f"prefill top-2 margin {lm_margin(torch, lg):.3g}", flush=True)
    if bad:
        raise AssertionError(f"serve_lm: int_generate card != CPU at {bad}")
    counts = {}
    for slots in LM_SLOTS:
        pf, sf, icf = fq_lm.serve_fns(cfg, qcfg, max_len=LM_MAX_LEN,
                                      device=dev)
        calls = {"prefill": 0, "step": 0}

        def prefill_fn(st, t, pf=pf, calls=calls):
            calls["prefill"] += 1
            return pf(st, t)

        def step_fn(st, c, t, sf=sf, calls=calls):
            calls["step"] += 1
            return sf(st, c, t)

        b = ContinuousBatcher(stack, cfg, qcfg, slots=slots,
                              max_len=LM_MAX_LEN, eos_id=eos,
                              prefill_fn=prefill_fn, step_fn=step_fn,
                              init_caches_fn=icf)
        reqs = [Request(rid=i, prompt=p, max_new=LM_MAX_NEW)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        out, c, _ = counted(torch, kernels, lambda: b.run(reqs))
        wall = time.perf_counter() - t0
        noisy = kernels.noisy_launch_counts()
        fwd = calls["prefill"] + calls["step"]
        expect = {"quantize_codes": fwd, "fq_matmul": 6 * cfg.n_layers * fwd,
                  "fq_conv2d": 0, "fq_conv2d_pool": 0,
                  "lm_island": cfg.n_layers * fwd}
        if c != expect or any(noisy.values()):
            raise AssertionError(f"serve_lm slots {slots}: launches {c} "
                                 f"(noisy {noisy}) != {expect}")
        if lm_island.vector_launches != c["lm_island"]:
            raise AssertionError(f"serve_lm slots {slots}: "
                                 f"{lm_island.vector_launches} of "
                                 f"{c['lm_island']} island launches took "
                                 "the 16-byte row loader (d_head 16)")
        mism = [i for i in range(len(prompts)) if out[i] != want[i]]
        for i in mism:
            toks = torch.tensor([prompts[i]], dtype=torch.int32, device=dev)
            lg, _ = fq_lm.int_prefill(stack, toks, qcfg, cfg,
                                      max_len=LM_MAX_LEN)
            print(f"serve_lm slots {slots}: request {i} batched {out[i]} "
                  f"!= int_generate {want[i]}; prefill top-2 margin "
                  f"{lm_margin(torch, lg):.3g}", flush=True)
        if mism:
            raise AssertionError(f"serve_lm slots {slots}: tokens differ at "
                                 f"{mism}")
        n_tok = sum(len(o) for o in out.values())
        print(f"serve_lm batcher slots {slots}: {len(prompts)} requests "
              f"(prompts {LM_PROMPT_LENS[0]}-{LM_PROMPT_LENS[1]} tokens, "
              f"max_new {LM_MAX_NEW}, eos {eos}: "
              f"{sum(o[-1] == eos for o in out.values())} stopped by it), "
              f"{calls['prefill']} prefills + {calls['step']} decode steps, "
              f"{n_tok} tokens == int_generate on the card == the CPU's, in "
              f"{wall:.3f} s; kernels (lm, slots {slots}): "
              + " ".join(f"{k}={v}" for k, v in c.items())
              + f" (K1 1, K2 {6 * cfg.n_layers}, island {cfg.n_layers} a "
              "forward, every island on the 16-byte row loader; noisy 0)",
              flush=True)
        counts = c
    print(f"serve_lm: the CPU's int_generate of the {len(prompts)} requests "
          f"took {t_cpu:.2f} s", flush=True)

    # -- the integer core, card against CPU -------------------------------
    ent = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(
        np.int32)).to(dev)
    x = stack["embed"]["w"][ent] + stack["pos"]["w"][:24][None]
    h = ii.entry_codes(x, stack["entry"], qcfg, b_in=-1.0)
    attn = codes((cfg.n_layers, 2, 24, cfg.d_model))
    noise = NoiseConfig(cond.sigma_w, cond.sigma_a, cond.sigma_mac)
    noisy_counts = {}
    for chunks in (None,) + CHUNKS:
        kw = {} if chunks is None else dict(
            noise=noise, rng=prng.PRNGKey(NOISE_KEY).to(dev),
            mac_chunks=chunks)
        got, c, _ = counted(torch, kernels, lambda: fq_lm.int_core(
            stack, h, attn, qcfg, cfg, **kw))
        nc = kernels.noisy_launch_counts()["fq_matmul_noisy"]
        if chunks:
            noisy_counts[noisy_name("fq_matmul", "int8", chunks)] = nc
            kw["rng"] = kw["rng"].cpu()
        cpu = fq_lm.int_core(cpu_stack, h.cpu(), attn.cpu(), qcfg, cfg, **kw)
        diff = sum(int((a.cpu() != b).sum()) for a, b in zip(got, cpu))
        total = sum(b.numel() for b in cpu)
        label = "clean" if chunks is None else f"noisy c{chunks}"
        print(f"serve_lm GPU int_core vs CPU int_core ({label}): {diff} of "
              f"{total} codes differ; K2 {c['fq_matmul']} launches, "
              f"{nc} noisy", flush=True)
        if (c["fq_matmul"] != 6 * cfg.n_layers
                or nc != (0 if chunks is None else 6 * cfg.n_layers)):
            raise AssertionError(f"serve_lm int_core {label}: {c}, noisy "
                                 f"{nc}")
        if diff > (0 if chunks is None else MAX_FLIP_FRACTION * total):
            raise AssertionError(f"serve_lm int_core {label}: {diff} codes "
                                 "differ from the CPU's")

    # -- times (the island constants derived once, as the batcher's are) ---
    step_ms, lines = {}, []
    for slots in LM_SLOTS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (slots, 8)).astype(
            np.int32)).to(dev)
        _, cc = fq_lm.int_prefill(stack, toks, qcfg, cfg, max_len=LM_MAX_LEN)
        tok = toks[:, -1:].contiguous()

        def step(cc=cc, tok=tok):
            return fq_lm.int_decode_step(stack, cc, tok, qcfg, cfg,
                                         inplace=True, consts=consts)
        step_ms[slots] = eager_ms(torch, step, reps=LM_STEPS_TIMED)
        lines.append(f"slots {slots}: {step_ms[slots]:.4f} ms a decode step, "
                     f"{slots * 1e3 / step_ms[slots]:.1f} tokens/s")
        if slots == LM_RECORD_SLOTS:
            wall, busy, ops, top = device_profile(torch, step, reps=5,
                                                  launched=True)
    prefill_ms = {}
    for t in LM_PREFILLS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, t)).astype(
            np.int32)).to(dev)
        prefill_ms[t] = eager_ms(torch, lambda toks=toks: fq_lm.int_prefill(
            stack, toks, qcfg, cfg, max_len=LM_MAX_LEN, consts=consts),
            reps=10)
    kv_bytes = sum(c["k"][0].numel() + c["v"][0].numel()
                   for c in fq_lm.init_caches(cfg, 1, LM_MAX_LEN, device=dev))
    print(f"serve_lm times ({smi}; host clock, eager): " + "; ".join(lines)
          + "; prefill " + ", ".join(f"T={t} {v:.4f} ms"
                                      for t, v in prefill_ms.items())
          + f"; KV cache {kv_bytes} int8 bytes a slot", flush=True)
    print(f"serve_lm profile (decode step, slots {LM_RECORD_SLOTS}): wall "
          f"{wall:.4f} ms, device busy {busy:.4f} ms (share "
          f"{busy / wall:.4f}), {ops:.1f} device ops launched a decode step; "
          "most device "
          "time: " + ", ".join(f"{k.split('(')[0][-48:]} {v:.4f}"
                               for k, v in top), flush=True)
    for name in ("fq_matmul", "lm_island"):
        for r in rows.rows[name]:
            print(f"serve_lm {name} {r['shape']}: ms {r['ms']:.5f}, bound "
                  f"{r['bound_ms']:.6f} ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.5f}, library "
                  + ("-" if r["library_ms"] is None
                     else f"{r['library_ms']:.5f}"), flush=True)
    secs = time.perf_counter() - t_phase
    print(f"serve_lm: phase {secs:.1f} s (budget {LM_BUDGET_S:.0f} s)",
          flush=True)
    if secs > LM_BUDGET_S:
        raise AssertionError(f"serve_lm took {secs:.1f} s > {LM_BUDGET_S}")
    return {"rows": rows, "counts": counts, "noisy": noisy_counts,
            "step_ms": step_ms, "prefill_ms": prefill_ms,
            "n_layers": cfg.n_layers}


# ---------------------------------------------------------------------------
# The float transformer zoo served (serve_transformer)
# ---------------------------------------------------------------------------

TX_ARCH = "minitron-4b"        # the full-width model served
# its depth in this run: 16 of its 32 layers, at full width (the whole
# smoke run's phases must stay within 1,100 of its 1,200 s once
# train_transformer joined; PERF.md §4)
TX_LAYERS = 16
TX_SLOTS = (1, 4)              # decode slots timed; the batcher runs on 4
TX_REQUESTS = 8                # greedy requests through the batcher
TX_PROMPT = 128                # tokens a prompt (equal lengths: one position)
TX_NEW = 32                    # new tokens a request
TX_MAX_LEN = 256
TX_DECODE = 3                  # prefill TX_PROMPT - 3, then 3 decode steps
# The decode-parity bound in bf16, x max|logit| of forward's: prefill +
# decode and forward run the bf16 model in two op orders (flash against
# one-token attention, GEMMs of M = 128 against M = 1), each op rounding
# to bf16. tools/tx_parity_probe.py on an H100 reads 0.039-0.055 over 3
# params seeds x 4 prompts; the bound is 1.45x the largest. The sharp
# check is float32's (~1e-5 read, the reference's 2e-2 bound).
TX_RTOL = 8e-2
TX_RTOL_F32 = 2e-2             # the reference's decode-parity bound
TX_KV8_TOL = 0.05              # the reference's int8-KV tolerance (an op's)
# The int8 KV cache at full depth, logits x max|logit| of forward's. Each
# layer's attention meets the reference's tolerance; through 32 random
# layers the logits move 0.075-0.105 (bf16) and 0.058-0.085 (float32) in
# tools/tx_parity_probe.py's 12 runs. Planted faults there read: K or V of
# one KV head at twice its scale 0.80-1.12, codes rounded down instead of
# half-even 0.161-0.251; the guard sits between.
TX_KV8_GUARD = 0.15
TX_CUT_LAYERS = 2              # part 2: card against CPU, in float32
TX_CUT_PROMPT = 32
TX_CUT_DECODE = 2
TX_CPU_RTOL = 1e-4             # x max|logit|: float32 sums in other orders
TX_SMOKE_NEW = 4               # part 3: tokens a smoke request
TX_STEPS_TIMED = 5             # decode steps on the host clock, mean
TX_BUDGET_S = 90.0
TX_MOE = ("llama4-maverick-400b-a17b", "deepseek-v2-lite-16b")


def tx_compare(torch, got, want, rtol):
    """(max |got - want|, max |want|, ok) of two logit tensors, the bound
    ``rtol`` x max |want|."""
    g, w = got.double().cpu(), want.double().cpu()
    err, top = float((g - w).abs().max()), float(w.abs().max())
    return err, top, err <= rtol * top


def tx_margin(torch, logits):
    """Top-2 margin of each position's logits (..., V) -> (...)."""
    top = torch.topk(logits.double(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def tx_taps_run(torch, fn, ref=None):
    """(fn(), its Taps): recording the quantizers' inputs, or pinned to
    ``ref``'s where a code rounds otherwise (``repro_torch.taps``)."""
    from repro_torch.taps import Taps
    taps = Taps(ref, record=ref is None)
    with taps, torch.no_grad():
        out = fn()
    if ref is not None:
        taps.matched()
        if taps.code_flips != taps.round_ties:
            raise AssertionError(
                f"{taps.code_flips} code flips, only {taps.round_ties} "
                f"rounding ties, of {taps.positions} quantized values")
    return out, taps


def tx_kv8_attention(torch, fn):
    """Run ``fn()`` with every decode attention over a float cache repeated
    over the cache's int8 codes (``attention._q8``); returns (the largest
    |int8 out - float out| / (TX_KV8_TOL + TX_KV8_TOL |float out|), calls):
    the reference's int8-KV tolerance (``tests/test_attention.py``) at
    each call."""
    from repro_torch.models import attention as A
    orig, worst = A.decode_attention, [0.0, 0]

    def both(q, cache, *, window=None):
        out = orig(q, cache, window=window)
        c8 = dict(cache)
        (c8["k"], c8["k_scale"]), (c8["v"], c8["v_scale"]) = (
            A._q8(cache["k"]), A._q8(cache["v"]))
        o8 = orig(q, c8, window=window).float()
        ratio = (o8 - out.float()).abs() / (
            TX_KV8_TOL + TX_KV8_TOL * out.float().abs())
        worst[0] = max(worst[0], float(ratio.max()))
        worst[1] += 1
        return out
    A.decode_attention = both
    try:
        fn()
    finally:
        A.decode_attention = orig
    return worst[0], worst[1]


def tx_smoke_batch(torch, cfg, dev, seed, b=2, s=12):
    import numpy as np
    rng = np.random.default_rng(seed)
    n_vis = cfg.frontend.n_positions if (cfg.frontend.enabled
                                         and not cfg.enc_dec) else 0
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s - n_vis)).astype(np.int32)).to(dev)}
    if cfg.frontend.enabled:
        batch["feats"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.frontend.n_positions, cfg.frontend.feat_dim)).astype(
            np.float32)).to(dev)
    return batch


def tx_smoke_arch(torch, dev, arch_id):
    """One smoke arch on the card against the port's CPU path from the same
    params: forward, prefill + 3 decode steps, greedy generate, and the
    batcher (against generate; the MoE archs against the CPU's batcher:
    capacity is shared by the slots). Returns a line of flips and errors."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serve.batching import ContinuousBatcher, Request
    from repro_torch.serve.decode import generate
    a = get_arch(arch_id)
    cfg, q = a.smoke, a.qcfg
    cpu = torch.device("cpu")
    params = T.make_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                           device=dev)
    cparams = tree.map(lambda x: x.cpu(), params)
    batch = tx_smoke_batch(torch, cfg, dev, SEED + 41)
    cbatch = {k: v.cpu() for k, v in batch.items()}
    worst, flips, n = 0.0, 0, 0

    def hold(fn):
        """fn on the card (quantizer inputs recorded), then on the CPU
        pinned to them; (card's, CPU's)."""
        nonlocal flips, n
        got, taps = tx_taps_run(torch, lambda: fn(dev, params, batch))
        want, ctaps = tx_taps_run(torch, lambda: fn(cpu, cparams, cbatch),
                                  taps)
        flips += ctaps.code_flips
        n += ctaps.positions
        return got, want

    def fwd(d, p, b):
        return T.forward(p, b, cfg, q)[0]
    got, want = hold(fwd)
    err, top, ok = tx_compare(torch, got, want, TX_CPU_RTOL)
    worst = max(worst, err / top)
    if not ok:
        raise AssertionError(f"{arch_id} forward: card {err:.3g} from the "
                             f"CPU, bound {TX_CPU_RTOL * top:.3g}")
    n_pre = batch["tokens"].shape[1] - TX_DECODE

    def pre_dec(d, p, b, c_=cfg):
        toks = b["tokens"]
        lg, c = T.prefill(p, dict(b, tokens=toks[:, :n_pre]), c_, q,
                          max_len=16)
        out = [lg[:, -1]]
        for i in range(n_pre, n_pre + TX_DECODE):
            lg, c = T.decode_step(p, c, toks[:, i:i + 1], c_, q)
            out.append(lg[:, -1])
        return torch.stack(out, 1)
    got, want = hold(pre_dec)
    err, top, ok = tx_compare(torch, got, want, TX_CPU_RTOL)
    worst = max(worst, err / top)
    if not ok:
        raise AssertionError(f"{arch_id} prefill + decode: card {err:.3g} "
                             f"from the CPU, bound {TX_CPU_RTOL * top:.3g}")

    kv8 = ""
    if arch_id == TX_ARCH:
        # the int8 KV cache at smoke depth, on the card: within the
        # reference's tolerance of forward's logits
        with torch.no_grad():
            full = T.forward(params, batch, cfg, q)[0][:, n_pre - 1:]
            cfg8 = dataclasses.replace(cfg, kv_bits=8)
            err, top, ok = tx_compare(torch, pre_dec(
                dev, params, batch, cfg8), full, TX_KV8_TOL)
        if not ok:
            raise AssertionError(f"{arch_id} kv_bits=8: {err / top:.3g} x "
                                 "max|logit| from forward")
        kv8 = f"; kv_bits=8 {err / top:.3g} x max|logit| from forward"

    def gen(d, p, b):
        return generate(p, cfg, q, b, max_new=TX_SMOKE_NEW)
    got, want = hold(gen)
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"{arch_id} generate: card {got.tolist()} CPU "
                             f"{want.tolist()}")
    prompts = [t.tolist() for t in batch["tokens"][:, :4].cpu()] + \
        [batch["tokens"][0, 2:6].tolist()]
    feats = batch["feats"][:1] if cfg.enc_dec else None
    max_len = 18

    def batcher(d, p, b):
        pf = None
        if cfg.enc_dec:
            def pf(pp, toks):
                return T.prefill(pp, {"tokens": toks, "feats": feats.to(d)},
                                 cfg, q, max_len=max_len)
        bt = ContinuousBatcher(p, cfg, q, slots=2, max_len=max_len,
                               prefill_fn=pf)
        out = bt.run([Request(rid=i, prompt=pr, max_new=TX_SMOKE_NEW)
                      for i, pr in enumerate(prompts)])
        return [out[i] for i in range(len(prompts))]
    if arch_id in TX_MOE:
        got, want = hold(batcher)
        how = "the CPU's batcher"
    else:
        with torch.no_grad():
            got = batcher(dev, params, batch)
            want = []
            for pr in prompts:
                b = {"tokens": torch.tensor([pr], dtype=torch.int32,
                                            device=dev)}
                if feats is not None:
                    b["feats"] = feats
                want.append(generate(params, cfg, q, b, max_new=TX_SMOKE_NEW,
                                     max_len=max_len)[0].tolist())
        how = "generate's"
    if got != want:
        raise AssertionError(f"{arch_id} batcher: {got} != {how} {want}")
    return (f"{arch_id}: forward, prefill + {TX_DECODE} decode within "
            f"{worst:.2e} x max|logit| of the CPU; generate == CPU; batcher "
            f"== {how}; {flips} of {n} codes pinned (rounding ties){kv8}")


def phase_serve_transformer(torch, dev):
    """The float transformer zoo served on the card: minitron-4b at full
    width through the float batcher, decode parity, int8 KV, times; a
    2-layer float32 cut against the CPU; all ten smoke archs against the
    CPU. No integer kernel may launch."""
    import dataclasses

    import numpy as np
    from repro_torch import kernels, tree
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serve.batching import ContinuousBatcher, Request
    from repro_torch.serve.decode import generate, make_serve_step

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    kernels.reset_launch_counts()
    arch = get_arch(TX_ARCH)
    cfg = dataclasses.replace(arch.model, n_layers=TX_LAYERS)
    q = arch.qcfg
    rng = np.random.default_rng(SEED + 31)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        # -- part 1: full width, full depth ---------------------------------
        t0 = time.perf_counter()
        params = T.make_params(torch.Generator(device=dev).manual_seed(SEED),
                               cfg, device=dev)
        n_params = sum(x.numel() for x in tree.leaves(params))
        sp = T.quantize_params_for_serving(params, bits_w=arch.serve_bits_w)
        del params
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        leaves = tree.named_leaves(sp)
        code_b = sum(x.numel() for n, x in leaves if n.endswith("_codes"))
        emb_b = sp["embed"]["w"].numel() * sp["embed"]["w"].element_size()
        w_bytes = sum(x.numel() * x.element_size() for _, x in leaves)
        kv_slot = sum(x.numel() * x.element_size() for n, x in
                      tree.named_leaves(T.init_caches(cfg, 1, TX_MAX_LEN,
                                                      device="meta"))
                      if n.split(".")[-1] in ("k", "v"))
        print(f"serve_transformer: {TX_ARCH} at full width ({cfg.n_layers} "
              f"of its {arch.model.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} / "
              f"{cfg.n_kv_heads} heads, head_dim {cfg.head_dim_}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}), "
              f"{n_params} params from seed {SEED} on the card, converted "
              f"to int8 codes (serve_bits_w {arch.serve_bits_w}) in "
              f"{t_build:.1f} s; weight bytes {w_bytes} ({code_b} int8 code "
              f"bytes, the head's included; {emb_b} bf16 embedding bytes; "
              f"{w_bytes - code_b - emb_b} of scales and norms); KV "
              f"{kv_slot} bytes a slot at max_len {TX_MAX_LEN} ({smi})",
              flush=True)

        prompts = rng.integers(0, cfg.vocab, (TX_REQUESTS, TX_PROMPT)).astype(
            np.int32)
        toks = torch.from_numpy(prompts[:1]).to(dev)
        n_pre = TX_PROMPT - TX_DECODE

        def prefill_decode(p, c):
            """Logits of prefill(T - 3)'s last position and of 3 decode
            steps, (4, V) float32."""
            lg, caches = T.prefill(p, {"tokens": toks[:, :n_pre]}, c, q,
                                   max_len=TX_MAX_LEN)
            out = [lg[0, -1]]
            for i in range(n_pre, TX_PROMPT):
                lg, caches = T.decode_step(p, caches, toks[:, i:i + 1], c,
                                           q)
                out.append(lg[0, -1])
            return torch.stack(out).float()

        # the served bf16 model: prefill(T - 3) + 3 decode against forward(T)
        want = T.forward(sp, {"tokens": toks}, cfg, q)[0][0, n_pre - 1:]
        want = want.float()
        got = prefill_decode(sp, cfg)
        err, top, ok = tx_compare(torch, got, want, TX_RTOL)
        margin = tx_margin(torch, want)
        sure = margin > TX_RTOL * top
        same = got.argmax(-1) == want.argmax(-1)
        print(f"serve_transformer decode parity (bf16, as served): prefill("
              f"{n_pre}) + {TX_DECODE} decode steps against forward("
              f"{TX_PROMPT}): max |diff| {err:.4g}, max|logit| {top:.4g}, "
              f"{err / top:.4g} x max|logit| (bound {TX_RTOL}); greedy tokens "
              f"equal at {int(same.sum())} of {same.numel()} positions, "
              f"{int(sure.sum())} of them with forward's top-2 margin past "
              f"the bound (margins {[round(float(m), 4) for m in margin]})",
              flush=True)
        if not ok or not bool(same[sure].all()):
            raise AssertionError("serve_transformer: decode parity (bf16)")
        got8 = prefill_decode(sp, dataclasses.replace(cfg, kv_bits=8))
        err8, top8, ok8 = tx_compare(torch, got8, want, TX_KV8_GUARD)
        # the same served weights with float32 activations and caches: the
        # op orders' bf16 roundings gone, the two paths agree to float32,
        # and the int8 KV cache's own effect shows alone
        sp32 = tree.map(lambda x: x.float() if x.dtype == torch.bfloat16
                        else x, sp)
        cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
        want32 = T.forward(sp32, {"tokens": toks}, cfg32, q)[0][
            0, n_pre - 1:].float()
        got32 = prefill_decode(sp32, cfg32)
        err32, top32, ok32 = tx_compare(torch, got32, want32, TX_RTOL_F32)
        # greedy tokens equal where float32 forward's top-2 margin passes
        # the float32 bound
        sure32 = tx_margin(torch, want32) > TX_RTOL_F32 * top32
        ok32 = ok32 and bool((got32.argmax(-1) == want32.argmax(-1))[
            sure32].all())
        got32_8 = prefill_decode(sp32, dataclasses.replace(cfg32, kv_bits=8))
        err32_8, _, ok32_8 = tx_compare(torch, got32_8, want32, TX_KV8_GUARD)
        # the reference's int8-KV tolerance where the reference states it,
        # on one attention call: every layer's decode attention over the
        # served model's own q, K and V, int8 cache against float cache
        op_ratio, op_calls = tx_kv8_attention(
            torch, lambda: prefill_decode(sp32, cfg32))
        print(f"serve_transformer decode parity (the served weights, float32 "
              f"activations and caches): {err32 / top32:.4g} x max|logit| "
              f"(bound {TX_RTOL_F32}, the reference's), greedy tokens equal "
              f"at the {int(sure32.sum())} of {sure32.numel()} positions "
              f"with forward's top-2 margin past it; kv_bits=8: each "
              f"decode attention's int8-cache output within "
              f"{op_ratio:.4g} of the reference's tolerance |diff| <= "
              f"{TX_KV8_TOL} + {TX_KV8_TOL} |out| (over {op_calls} calls: "
              f"{cfg.n_layers} layers x {TX_DECODE} steps); logits against "
              f"forward {err32_8 / top32:.4g} x max|logit| in float32, "
              f"{err8 / top8:.4g} in bf16 (guard {TX_KV8_GUARD} for both: "
              f"the int8 cache's rounding grown through {cfg.n_layers} "
              f"random layers reads <= 0.105, planted faults >= 0.161)",
              flush=True)
        if not (ok32 and ok8 and ok32_8 and op_ratio <= 1.0):
            raise AssertionError("serve_transformer: float32 decode parity / "
                                 "kv_bits=8")
        del want32

        # the batcher's float default, then generate at B = 1
        slots = max(TX_SLOTS)
        b = ContinuousBatcher(sp, cfg, q, slots=slots, max_len=TX_MAX_LEN)
        reqs = [Request(rid=i, prompt=prompts[i].tolist(), max_new=TX_NEW)
                for i in range(TX_REQUESTS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = b.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_tok = sum(len(o) for o in out.values())
        if sorted(out) != list(range(TX_REQUESTS)) or any(
                len(o) != TX_NEW for o in out.values()):
            raise AssertionError("serve_transformer: batcher lost tokens")
        single = generate(sp, cfg, q, {"tokens": toks}, max_new=TX_NEW,
                          max_len=TX_MAX_LEN)[0].tolist()
        agree = next((i for i, (x, y) in enumerate(zip(single, out[0]))
                      if x != y), TX_NEW)
        # forward over request 0's prompt and the batcher's tokens (teacher
        # forcing): each batched token within the decode-parity bound of
        # forward's maximum, and where generate parts from the batcher, its
        # token too
        seq = torch.tensor([prompts[0].tolist() + out[0][:-1]],
                           dtype=torch.int32, device=dev)
        lg = T.forward(sp, {"tokens": seq}, cfg, q)[0][0, TX_PROMPT - 1:]
        lg = lg.float()
        top_j = lg.max(-1).values
        tol_j = TX_RTOL * lg.abs().max(-1).values
        idx = torch.arange(TX_NEW, device=dev)
        regret = (top_j - lg[idx, torch.tensor(out[0], device=dev)]) / tol_j
        worst = float(regret.max())
        tie = ""
        if agree < TX_NEW:
            gap = float((top_j[agree] - lg[agree, single[agree]])
                        / tol_j[agree])
            worst = max(worst, gap)
            tie = (f" (at token {agree} forward's top-2 margin is "
                   f"{float(tx_margin(torch, lg[agree])):.4g}; both tokens "
                   f"within {gap:.3g} of the bound of its maximum)")
        # the witness: the same served weights in float32, where the GEMMs
        # of M = 4 and M = 1 agree to ~1e-5 of max|logit| (the float32
        # decode parity above): the batcher on its first wave of requests
        # and generate at B=1 must give request 0 the same tokens
        t0 = time.perf_counter()
        out32 = ContinuousBatcher(sp32, cfg32, q, slots=slots,
                                  max_len=TX_MAX_LEN).run(
            [Request(rid=i, prompt=prompts[i].tolist(), max_new=TX_NEW)
             for i in range(slots)])
        single32 = generate(sp32, cfg32, q, {"tokens": toks}, max_new=TX_NEW,
                            max_len=TX_MAX_LEN)[0].tolist()
        agree32 = next((i for i, (x, y) in enumerate(zip(single32,
                                                         out32[0]))
                        if x != y), TX_NEW)
        print(f"serve_transformer batcher: {TX_REQUESTS} requests of "
              f"{TX_PROMPT} tokens, {TX_NEW} new each, {slots} slots: "
              f"{n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tokens/s "
              f"with the prefills); generate at B=1 on request 0 agrees for "
              f"{agree} of {TX_NEW} tokens in bf16{tie}; every batched token "
              f"of request 0 within {worst:.3g} of the bound (TX_RTOL x "
              f"max|logit|) of forward's maximum; float32 (the served "
              f"weights): the batcher over requests 0-{slots - 1} and "
              f"generate at B=1 agree for {agree32} of {TX_NEW} tokens of "
              f"request 0 ({time.perf_counter() - t0:.1f} s)", flush=True)
        if worst > 1.0:
            raise AssertionError("serve_transformer: the batcher's tokens "
                                 "are not greedy within the bound")
        if agree32 < TX_NEW:
            raise AssertionError("serve_transformer: float32 batcher != "
                                 "generate at B=1")
        del sp32
        torch.cuda.empty_cache()

        # times: a decode step at each slot count, prefill, the profile
        step = make_serve_step(cfg, q)
        lines, step_ms = [], {}
        for s in TX_SLOTS:
            tt = torch.from_numpy(prompts[:s]).to(dev)
            _, cc = T.prefill(sp, {"tokens": tt}, cfg, q, max_len=TX_MAX_LEN)
            tok = tt[:, -1:].contiguous()
            fn = (lambda cc=cc, tok=tok: step(sp, cc, tok))
            step_ms[s] = eager_ms(torch, fn, reps=TX_STEPS_TIMED)
            lines.append(f"slots {s}: {step_ms[s]:.4f} ms a decode step, "
                         f"{s * 1e3 / step_ms[s]:.1f} tokens/s")
            if s == slots:
                prof = device_profile(torch, fn, reps=1, launched=True)
        prefill_ms = eager_ms(torch, lambda: T.prefill(
            sp, {"tokens": toks}, cfg, q, max_len=TX_MAX_LEN), reps=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # a step reads every int8 code, scale and norm, and one embedding
        # row a slot (the gather), not the whole embedding
        row_b = emb_b // cfg.vocab
        read_b = {s: w_bytes - emb_b + s * row_b for s in TX_SLOTS}
        bound_ms = {s: read_b[s] / HBM_BYTES_PER_S * 1e3 for s in TX_SLOTS}
        wall_p, busy, ops, top_ops = prof
        print(f"serve_transformer times ({smi}; host clock, eager): "
              + "; ".join(lines) + f"; prefill T={TX_PROMPT} B=1 "
              f"{prefill_ms:.4f} ms; a decode step's weight-read bound "
              + ", ".join(f"{bound_ms[s]:.4f} ms at slots {s} ({read_b[s]} "
                          "bytes)" for s in TX_SLOTS)
              + f" at {HBM_BYTES_PER_S / 1e12:.2f} TB/s (the int8 codes, "
              f"scales and norms, and {row_b} bytes of embedding a slot); "
              f"peak memory {peak:.2f} GiB", flush=True)
        print(f"serve_transformer profile (decode step, slots {slots}; "
              f"{smi}): part 1 {time.perf_counter() - t_phase:.1f} s; wall "
              f"{wall_p:.4f} ms, device busy {busy:.4f} ms "
              f"(share {busy / wall_p:.4f}), {ops:.1f} device ops; most "
              "device time: " + ", ".join(
                  f"{k.split('(')[0][-48:]} {v:.4f}" for k, v in top_ops),
              flush=True)
        del sp, b
        torch.cuda.empty_cache()

        # -- part 2: a 2-layer float32 cut, card against CPU ----------------
        t0 = time.perf_counter()
        cut = dataclasses.replace(cfg, n_layers=TX_CUT_LAYERS,
                                  param_dtype=torch.float32)
        p2 = T.quantize_params_for_serving(T.make_params(
            torch.Generator(device=dev).manual_seed(SEED + 1), cut,
            device=dev), bits_w=arch.serve_bits_w)
        c2 = tree.map(lambda x: x.cpu(), p2)
        t2 = torch.from_numpy(rng.integers(
            0, cfg.vocab, (1, TX_CUT_PROMPT + TX_CUT_DECODE)).astype(
            np.int32))

        def cut_run(p, t):
            lg, cc = T.prefill(p, {"tokens": t[:, :TX_CUT_PROMPT]}, cut, q,
                               max_len=TX_CUT_PROMPT + TX_CUT_DECODE)
            out = [lg[0, -1]]
            for i in range(TX_CUT_PROMPT, TX_CUT_PROMPT + TX_CUT_DECODE):
                lg, cc = T.decode_step(p, cc, t[:, i:i + 1], cut, q)
                out.append(lg[0, -1])
            return torch.stack(out)
        err, top, ok = tx_compare(torch, cut_run(p2, t2.to(dev)),
                                  cut_run(c2, t2), TX_CPU_RTOL)
        print(f"serve_transformer card against CPU: {TX_ARCH} cut to "
              f"{TX_CUT_LAYERS} layers (of {arch.model.n_layers}) and float32 "
              f"(from "
              f"{cfg.param_dtype}), full widths, served (int8 codes), TF32 "
              f"off: prefill({TX_CUT_PROMPT}) + {TX_CUT_DECODE} decode "
              f"logits {err:.4g} apart, {err / top:.3g} x max|logit| (bound "
              f"{TX_CPU_RTOL}); {time.perf_counter() - t0:.1f} s", flush=True)
        if not ok:
            raise AssertionError("serve_transformer: card against CPU")
        del p2, c2
        torch.cuda.empty_cache()

        # -- part 3: every arch at its smoke config --------------------------
        for aid in ARCH_IDS:
            t0 = time.perf_counter()
            line = tx_smoke_arch(torch, dev, aid)
            print(f"serve_transformer smoke {line} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)

    counts = kernels.launch_counts()
    others = {**kernels.packed_launch_counts(),
              **kernels.noisy_launch_counts(),
              **kernels.split_launch_counts()}
    if any(counts.values()) or any(others.values()):
        raise AssertionError(f"serve_transformer launched integer kernels: "
                             f"{counts} {others}")
    print("kernels (transformer): none (" + " ".join(
        f"{k}={v}" for k, v in counts.items()) + "; the zoo runs no TPU "
          "kernel: its products are torch.matmul / einsum)", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"serve_transformer: phase {secs:.1f} s (budget "
          f"{TX_BUDGET_S:.0f} s)", flush=True)
    if secs > TX_BUDGET_S:
        raise AssertionError(f"serve_transformer took {secs:.1f} s > "
                             f"{TX_BUDGET_S}")
    return {"step_ms": step_ms, "prefill_ms": prefill_ms, "secs": secs}


# ---------------------------------------------------------------------------
# The float transformer zoo trained (train_transformer)
# ---------------------------------------------------------------------------

TRAIN_TX_ARCH = "minicpm-2b"   # trained at full width and depth
TRAIN_TX_BATCH = 8
TRAIN_TX_SEQ = 256
TRAIN_TX_STEPS = 6             # each run; WSD: step 0's lr is 0
TRAIN_TX_LR = 1e-3
TRAIN_TX_PROFILED = 4          # the step profiled (float32 moments' run)
TRAIN_TX_SAMPLE = 4096         # elements a leaf sampled to see it change
TRAIN_TX_CUT_LAYERS = 2        # part 2: card against CPU, in float32
TRAIN_TX_CUT_BATCH = 2
TRAIN_TX_CUT_SEQ = 32
# part 2 holds one make_train_step step at grad_accum 1 card against CPU:
# the CPU twin of one full-width forward and backward takes ~20 s on an
# H100 machine's host (the taps and weight quantizers over 122M float32
# weights, the 283M-element tied embedding), so more steps, or one at
# grad_accum 2, do not fit the phase's 90 s beside part 1; grad_accum 2 and
# further steps are held against the reference on the CPU
# (tests/test_torch_train_lm_step.py, tests/test_torch_launch_train.py)
# code flips card against CPU that are not rounding ties, at most this
# share of the quantized values (sound runs on an H100 read 2 of
# 124,600,320 and 0: two small inputs summed from large terms); the ties
# are counted
TRAIN_TX_MAX_FLIPS = 1e-7
TRAIN_TX_RTOL_LOSS = 1e-5      # relative: a mean of log-softmaxes
# a leaf's gradient and the params after an update, relative L2: float32
# sums in other orders; a log-scale's gradient within TRAIN_C_S x M + 2 D
# (its terms cancel: ROADMAP C14, as train_fq holds it)
TRAIN_TX_RTOL_GRAD = 1e-3
TRAIN_TX_BUDGET_S = 90.0


def tx_sample(torch, params):
    """A strided sample of every leaf (TRAIN_TX_SAMPLE elements), cloned:
    enough to see whether an update moved the leaf."""
    from repro_torch import tree
    out = []
    for x in tree.leaves(params):
        flat = x.reshape(-1)
        out.append(flat[::max(1, flat.numel() // TRAIN_TX_SAMPLE)].clone())
    return out


def tx_train_run(torch, smi, bits):
    """The launcher's own path (``launch.train.TrainRun``) on minicpm-2b at
    full width and depth, TRAIN_TX_STEPS steps: every step's loss, global
    norm and params finite, the params unchanged by step 0 (lr 0) and moved
    by every later step; returns its numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree
    from repro_torch.launch import train as launch

    argv = ["--arch", TRAIN_TX_ARCH, "--steps", str(TRAIN_TX_STEPS),
            "--batch", str(TRAIN_TX_BATCH), "--seq", str(TRAIN_TX_SEQ),
            "--lr", str(TRAIN_TX_LR), "--seed", str(SEED), "--log-every",
            "1", "--device", "cuda"]
    if bits:
        argv += ["--moment-bits", str(bits)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = launch.TrainRun(launch.parse_args(argv))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    cfg, n_params = run.cfg, sum(x.numel() for x in tree.leaves(run.params))
    prof_out = {}
    step_fn = run.step_fn

    def profiled(p, s, b, i):
        if bits or i != TRAIN_TX_PROFILED:
            return step_fn(p, s, b, i)
        torch.cuda.synchronize()
        # device events only, read raw: recording the host's ~1.6 x 10^5
        # operator calls and parsing them cost ~50 s on the card's host
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            out = step_fn(p, s, b, i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        dev_evs = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
        prof_out.update(wall_ms=wall * 1e3, ops=len(dev_evs), busy_ms=sum(
            e.duration_ns() for e in dev_evs) / 1e6)
        return out
    run.step_fn = profiled

    rec = {"loss": [], "gnorm": [], "ms": [], "moved": []}
    before = [tx_sample(torch, run.params)]
    clock = [time.perf_counter()]

    def on_step(i, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec["ms"].append((now - clock[0]) * 1e3)
        after = tx_sample(torch, run.params)
        moved = sum(int((a != b).sum()) for a, b in zip(after, before[0]))
        total = sum(a.numel() for a in after)
        finite = torch.stack([torch.isfinite(x).all()
                              for x in tree.leaves(run.params)]).all()
        rec["loss"].append(float(m["loss"]))
        rec["gnorm"].append(float(m["grad_norm"]))
        rec["moved"].append(moved / total)
        if not (bool(finite) and math.isfinite(rec["loss"][-1])
                and math.isfinite(rec["gnorm"][-1])):
            raise AssertionError(f"train_transformer: step {i} not finite "
                                 f"(loss {rec['loss'][-1]}, grad norm "
                                 f"{rec['gnorm'][-1]}, params finite "
                                 f"{bool(finite)})")
        if (moved == 0) != (i == 0):
            raise AssertionError(f"train_transformer: step {i} moved "
                                 f"{moved} of {total} sampled params (only "
                                 "step 0, at lr 0, may move none)")
        before[0] = after
        clock[0] = time.perf_counter()

    run.run(on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if bits:
        for mom in tree.leaves(run.opt_state["mom"],
                               is_leaf=lambda x: isinstance(x, dict)
                               and "m" in x):
            if (mom["m"].dtype != torch.int8 or mom["v"].dtype != torch.int8
                    or not bool(mom["m_s"] > 0) or not bool(mom["v_s"] > 0)):
                raise AssertionError("train_transformer: int8 moments")
    del run
    return dict(rec, cfg=cfg, n_params=n_params, peak=peak, setup=t_setup,
                **prof_out)


def tx_cut_step(torch, dev, cut, q, p0):
    """One ``make_train_step`` step (AdamW, weight decay 0.1, grad_accum 1)
    on the card from ``p0``, repeated on the CPU from a copy of
    the card's params and state, the CPU's quantizers pinned to the card's
    inputs (taps: code flips counted, those not rounding ties held under
    TRAIN_TX_MAX_FLIPS of the values); the loss, the gradients (taken where
    the step clips them) and the updated params compared, on the card in
    float64. Returns a summary line."""
    from repro_torch import tree
    from repro_torch import taps as taps_mod
    from repro_torch.data import loader, synthetic
    from repro_torch.optim import adam, schedules
    from repro_torch.train import trainer

    opt = adam.make(schedules.constant(TRAIN_TX_LR), weight_decay=0.1)
    cur, seen, secs = {}, {}, {}

    def tapped_vg(fn, has_aux=False):
        def vg(params, *args):
            (v, aux), named = taps_mod.value_and_grad(
                lambda p: fn(p, *args), params, cur["taps"])
            return (v, aux), tree.unflatten(params, list(named.values()))
        return vg

    def clip(grads, max_norm):
        seen[cur["where"]] = grads
        return orig_clip(grads, max_norm)

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[key] = secs.get(key, 0.0) + time.perf_counter() - t
        return out

    orig_vg, orig_clip = tree.value_and_grad, trainer.clip_by_global_norm
    tree.value_and_grad, trainer.clip_by_global_norm = tapped_vg, clip
    try:
        steps = {w: trainer.make_train_step(cut, q, opt, device=d)
                 for w, d in (("card", dev), ("cpu", "cpu"))}
        batch = loader.SyntheticLMLoader(loader.LoaderConfig(
            TRAIN_TX_CUT_BATCH, TRAIN_TX_CUT_SEQ, cut.vocab, seed=SEED + 2),
            synthetic.lm_batch, device=dev).batch_at(0)
        card = [tree.map(torch.clone, p0)]
        card.append(opt.init(card[0]))
        cpu = timed("copy", lambda: tree.map(
            lambda x: x.to("cpu", copy=True), card))
        card_taps = taps_mod.Taps(record=True)
        cpu_taps = taps_mod.Taps(card_taps)
        metrics = {}
        for where, st, tp in (("card", card, card_taps),
                              ("cpu", cpu, cpu_taps)):
            cur.update(where=where, taps=tp)
            p, s, metrics[where] = timed(where, lambda: steps[where](
                st[0], st[1], batch, 0))
            st[:] = [p, s]
    finally:
        tree.value_and_grad, trainer.clip_by_global_norm = orig_vg, orig_clip
    cpu_taps.matched()
    # as train_fq: a code whose input the two devices sum apart by float32
    # rounding may round to its neighbour, a tie within 2^-16 LSB of the
    # boundary or (rarely) a small input summed from large terms
    flips = (cpu_taps.code_flips, cpu_taps.round_ties, cpu_taps.positions)
    worst = {"loss": 0.0, "grad": 0.0, "scale": 0.0, "param": 0.0,
             "scale_step": 0.0}
    t0 = time.perf_counter()
    lc, lh = (float(metrics[w]["loss"]) for w in ("card", "cpu"))
    worst["loss"] = abs(lc - lh) / abs(lh)
    scales = set()
    for (name, gc), gh in zip(tree.named_leaves(seen["card"]),
                              tree.leaves(seen["cpu"])):
        gc, gh = gc.double(), gh.to(dev).double()
        if not bool(torch.isfinite(gc).all()):
            raise AssertionError(f"train_transformer cut: {name}'s "
                                 "gradient not finite on the card")
        parts = ([(name, 0, gh.numel())] if name in cpu_taps.mag
                 else [(k, *map(int, k[len(name) + 1:-1].split(":")))
                       for k in cpu_taps.mag if k.startswith(name + "[")])
        if parts:   # a log-scale, or a stack of them (C14)
            scales.add(name)
            err = (gc - gh).abs().reshape(-1)
            for k, a, z in parts:
                lim = (TRAIN_C_S * cpu_taps.mag[k]
                       + 2.0 * cpu_taps.fwd.get(k, 0.0))
                r = float(err[a:z].max()) / max(lim, 1e-30)
                worst["scale"] = max(worst["scale"], r)
        else:
            r = float((gc - gh).norm() / gh.norm().clamp_min(1e-30))
            worst["grad"] = max(worst["grad"], r)
    for (name, pc), ph in zip(tree.named_leaves(card[0]),
                              tree.leaves(cpu[0])):
        ph = ph.to(dev).double()
        diff = pc.double() - ph
        if name in scales:
            # Adam moves a param by lr g / (|g| + eps), lr x its sign: where
            # a log-scale's gradient lies within its bound of 0 the two runs
            # may step apart by 2 lr
            r = float(diff.abs().max()) / (2.0 * TRAIN_TX_LR)
            worst["scale_step"] = max(worst["scale_step"], r)
        else:
            r = float(diff.norm() / ph.norm().clamp_min(1e-30))
            worst["param"] = max(worst["param"], r)
    secs["compare"] = time.perf_counter() - t0
    del seen, card, cpu
    ok = (worst["loss"] <= TRAIN_TX_RTOL_LOSS and worst["scale"] <= 1.0
          and worst["grad"] <= TRAIN_TX_RTOL_GRAD
          and worst["param"] <= TRAIN_TX_RTOL_GRAD
          and worst["scale_step"] <= 1.0
          and flips[0] - flips[1] <= TRAIN_TX_MAX_FLIPS * flips[2])
    line = (f"1 step at grad_accum 1, loss "
            f"{worst['loss']:.3g} relative (bound {TRAIN_TX_RTOL_LOSS}), "
            f"gradients {worst['grad']:.3g} relative L2 (bound "
            f"{TRAIN_TX_RTOL_GRAD}), log-scales {worst['scale']:.3g} of "
            f"C_S M + 2 D, params after the update {worst['param']:.3g} "
            f"relative L2 (bound {TRAIN_TX_RTOL_GRAD}; log-scales "
            f"{worst['scale_step']:.3g} of 2 lr); code flips {flips[0]} of "
            f"{flips[2]} quantized values, {flips[1]} of them rounding ties "
            f"(the others bound {TRAIN_TX_MAX_FLIPS} of the values); s: "
            + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    if not ok:
        raise AssertionError(f"train_transformer cut, card against CPU: "
                             f"{line}")
    return line


def tx_resume(torch, dev, cut, q, p0):
    """On the card: 2 steps, save, restore and 2 more steps against 4
    straight steps (int8 moments, constant lr), params and state bit for
    bit; the checkpoint in a temporary directory, deleted after."""
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.data import loader, synthetic
    from repro_torch.optim import adam, schedules
    from repro_torch.train import checkpoint, trainer

    opt = adam.make(schedules.constant(TRAIN_TX_LR), weight_decay=0.1,
                    moment_bits=8)
    step = trainer.make_train_step(cut, q, opt, device=dev)
    ld = loader.SyntheticLMLoader(loader.LoaderConfig(
        TRAIN_TX_CUT_BATCH, TRAIN_TX_CUT_SEQ, cut.vocab, seed=SEED + 3),
        synthetic.lm_batch, device=dev)

    def fresh():
        p = tree.map(torch.clone, p0)
        return p, opt.init(p)

    p, s = fresh()
    for i in range(4):
        p, s, _ = step(p, s, ld.batch_at(i), i)
    p2, s2 = fresh()
    for i in range(2):
        p2, s2, _ = step(p2, s2, ld.batch_at(i), i)
    d = tempfile.mkdtemp(prefix="train_transformer_ckpt_")
    try:
        t0 = time.perf_counter()
        path = checkpoint.save(d, 2, p2, s2)
        nbytes = os.path.getsize(path)
        template = (tree.map(torch.empty_like, p2),
                    tree.map(torch.empty_like, s2))
        del p2, s2
        k, p3, s3, _ = checkpoint.restore(d, *template)
        t_ck = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for i in range(k, 4):
        p3, s3, _ = step(p3, s3, ld.batch_at(i), i)
    differ = [n for (n, a), b in zip(tree.named_leaves((p, s)),
                                     tree.leaves((p3, s3)))
              if a.dtype != b.dtype or not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"train_transformer resume: {len(differ)} "
                             f"leaves differ, e.g. {differ[:4]}")
    return (f"2 steps, save ({nbytes} bytes), restore, 2 steps == 4 "
            f"straight steps, params and int8 moments bit for bit "
            f"(save + restore {t_ck:.1f} s; the directory removed)")


def phase_train_transformer(torch, dev):
    """The float transformer zoo trained on the card: minicpm-2b at full
    width and depth through the launcher, float32 then int8 moments; a
    2-layer float32 cut card against CPU; a bit-identical resume. No
    integer kernel may launch."""
    import dataclasses

    from repro_torch import kernels, tree
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    torch.cuda.empty_cache()
    print(f"train_transformer: {torch.cuda.memory_allocated() / 2 ** 30:.3f}"
          f" GiB still allocated by earlier phases at the start "
          f"({torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB reserved)",
          flush=True)
    kernels.reset_launch_counts()

    # -- part 1: full width, full depth, through the launcher --------------
    runs = {}
    for bits in (None, 8):
        runs[bits] = r = tx_train_run(torch, smi, bits)
        cfg = r["cfg"]
        toks = TRAIN_TX_BATCH * TRAIN_TX_SEQ
        timed = [ms for i, ms in enumerate(r["ms"])
                 if i not in (0, TRAIN_TX_PROFILED)]
        r["step_ms"] = sum(timed) / len(timed)
        name = "float32" if bits is None else "int8"
        skip = "" if bits else f", step {TRAIN_TX_PROFILED} profiled"
        print(f"train_transformer: {TRAIN_TX_ARCH} at full width and depth "
              f"({cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} / {cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, "
              f"vocab {cfg.vocab}, tied, {cfg.param_dtype}, remat "
              f"{cfg.remat}), {r['n_params']} params from seed {SEED}; "
              f"AdamW (weight decay 0.1, {name} moments), WSD lr "
              f"{TRAIN_TX_LR}, B={TRAIN_TX_BATCH} S={TRAIN_TX_SEQ} bigram "
              f"batches; set-up {r['setup']:.1f} s; losses "
              f"{[round(x, 4) for x in r['loss']]}, global norms "
              f"{[round(x, 4) for x in r['gnorm']]}, sampled params moved "
              f"{[round(x, 4) for x in r['moved']]} a step; ms a step "
              f"{[round(x, 1) for x in r['ms']]} (host clock; step 0 warms "
              f"up{skip}): mean {r['step_ms']:.1f} ms, "
              f"{toks * 1e3 / r['step_ms']:.1f} tokens/s; peak memory "
              f"{r['peak']:.2f} GiB ({smi})", flush=True)
        torch.cuda.empty_cache()
    r = runs[None]
    flop = 8 * r["n_params"] * TRAIN_TX_BATCH * TRAIN_TX_SEQ
    bound_ms = flop / PEAKS["bf16"] * 1e3
    print(f"train_transformer profile (step {TRAIN_TX_PROFILED}, float32 "
          f"moments; {smi}): wall {r['wall_ms']:.1f} ms, device busy "
          f"{r['busy_ms']:.1f} ms (share {r['busy_ms'] / r['wall_ms']:.4f}; "
          f"{r['busy_ms'] / r['step_ms']:.4f} of an unprofiled step's mean), "
          f"{r['ops']} device ops; the matmul bound 8 x {r['n_params']} "
          f"params x {TRAIN_TX_BATCH * TRAIN_TX_SEQ} tokens (forward, remat "
          f"recompute, backward) = {flop:.4g} FLOP, {bound_ms:.2f} ms at "
          f"{PEAKS['bf16'] / 1e12:.0f} TFLOP/s bf16; a step "
          f"{r['step_ms'] / bound_ms:.1f}x the bound", flush=True)

    # -- part 2: 2 layers at full width, float32, card against CPU --------
    t0 = time.perf_counter()
    arch = get_arch(TRAIN_TX_ARCH)
    # remat off in the cut (it changes no value: tests/test_torch_train_lm.py
    # holds it bit for bit; part 1 runs it): the CPU twin skips a recompute
    cut = dataclasses.replace(arch.model, n_layers=TRAIN_TX_CUT_LAYERS,
                              param_dtype=torch.float32, remat=False)
    p0 = T.make_params(torch.Generator(device=dev).manual_seed(SEED + 1),
                       cut, device=dev)
    line = tx_cut_step(torch, dev, cut, arch.qcfg, p0)
    print(f"train_transformer card against CPU: {TRAIN_TX_ARCH} cut to "
          f"{TRAIN_TX_CUT_LAYERS} of {arch.model.n_layers} layers, float32, "
          f"full widths, B={TRAIN_TX_CUT_BATCH} S={TRAIN_TX_CUT_SEQ}, TF32 "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'} "
          f"(float32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}): {line}", flush=True)
    line = tx_resume(torch, dev, cut, arch.qcfg, p0)
    print(f"train_transformer resume: {line}; part 2 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del p0
    torch.cuda.empty_cache()

    counts = kernels.launch_counts()
    others = {**kernels.packed_launch_counts(),
              **kernels.noisy_launch_counts(),
              **kernels.split_launch_counts()}
    if any(counts.values()) or any(others.values()):
        raise AssertionError(f"train_transformer launched integer kernels: "
                             f"{counts} {others}")
    print("kernels (train_transformer): none (" + " ".join(
        f"{k}={v}" for k, v in counts.items()) + "; the zoo runs no TPU "
          "kernel)", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"train_transformer: phase {secs:.1f} s (budget "
          f"{TRAIN_TX_BUDGET_S:.0f} s)", flush=True)
    if secs > TRAIN_TX_BUDGET_S:
        raise AssertionError(f"train_transformer took {secs:.1f} s > "
                             f"{TRAIN_TX_BUDGET_S}")
    return {"step_ms": {b: runs[b]["step_ms"] for b in runs}, "secs": secs}


# ---------------------------------------------------------------------------
# Float FQ training (train_fq)
# ---------------------------------------------------------------------------

# ResNet-32 at B=32, not 64: the CPU twin repeats every step on the host's
# 8 cores, and at B=32 the phase already takes 217-241 s of the smoke
# run's 1,200 on an H100 host.
TRAIN_BATCH = {"kws": 64, "darknet": 8, "resnet20": 128, "resnet32": 32}
TRAIN_STEPS = 3            # SGD steps a ladder stage, each checked
# steps timed a stage (host clock, mean): 5, not 10, since the fleet phase
# joined the run's 1,200 s
TRAIN_TIMED = 5
# Steps profiled a stage (busy share, device ops): 1. The profiler's host
# costs ~0.5 ms an event, and the 14 stages launch ~139,000 ops a step, so
# 3 steps (PR 20's window) added 142 s to the smoke run (1,084 s of its
# 1,200 on an H100); 1 against 3 moved device ops by -13 to +46 a stage
# (a window's first events go unseen) and busy ms by <= 5.2% (PERF.md §5).
TRAIN_PROFILED = 1
# SGD's rate: benchmarks/common.py's BenchTask.lr, 0.05. ResNet-32 at 0.01:
# at 0.05 its FQ stage's log-scale gradients reach 1e2-2e3 (the loss after
# the FQ transition is 150-800), one update moves a log-scale by 10-223 and
# the card's run went non-finite by its second FQ update in 2 of 4 runs, the
# CPU from the same params alike; the reference takes a move of 26 from the
# card's params (tools/train_fq_probe.py, tests/train_fq_reference_hold.py)
TRAIN_LR = {"kws": 0.05, "darknet": 0.05, "resnet20": 0.05, "resnet32": 0.01}
TRAIN_ALPHA = 0.7          # its distillation alpha
TRAIN_CAL_ITERS = 3        # calibrate iterations at the FQ transition
TRAIN_KEY = 9              # PRNGKey of the noisy stage (fold_in per step)
# DarkNet's weight scales at the FQ transition: e^{s_w} at the 99th
# percentile of |w| (init_scale(percentile=99)). The reference's to_fq sets
# it at max|w|, where 2-bit weights keep 1-6% of their codes nonzero and
# the BN-free net is dead from conv12 on after calibrate's 3 iterations
# (the reference's own run at full width: C-ref-5,
# tests/test_torch_darknet_fq_transition.py); at the percentile every
# layer is live. TRAIN_SW_SEEDED names, per row, the transitions at which
# the scales are so seeded: "q", the first quantized stage; "fq", after
# to_fq. ResNet-32's are seeded at its first 2-bit stage: at max|w| whole
# output channels of the stem and the 1x1 shortcuts have no nonzero code,
# their BN divides by sqrt(eps), and SGD from FP goes non-finite in the
# second Q W2A5 step on an H100 (C-ref-6,
# tests/test_torch_resnet_q_transition.py). Its FQ transition keeps the
# reference's recipe, which leaves it live (test_torch_train_fq_full.py).
TRAIN_SW_PERCENTILE = 99.0
TRAIN_SW_SEEDED = {"darknet": ("fq",), "resnet32": ("q",)}
# card against CPU, each step
TRAIN_RTOL_LOGITS = 1e-4   # x max|logit|: float32 sums in other orders
TRAIN_RTOL_LOSS = 1e-5     # relative: a mean of log-softmaxes
# relative L2 of every weight's and bias's gradient, conv and dense (an
# H100 reads <= 2.8e-5, conv17.w)
TRAIN_RTOL_W = 1e-3
# A log-scale s's gradient sums one term per element its quantizers see,
# BN's gamma's and beta's one per position: the terms cancel, so the bound
# scales with M = the sum of their magnitudes (repro_torch.taps), not with
# the result. Card and CPU sum in other orders from activations apart by
# float32 rounding: 1e-4 M (an H100 reads <= 2.4e-6 M, bn17.gamma). A
# log-scale's bound adds twice D, its terms' forward difference at the
# card's inputs (repro_torch.taps: g x sum |dL/dQ| x |x_card - x_cpu|): a
# log-scale whose every term is 0 in exact arithmetic has M = 0 on the CPU
# and the card's float32 residue of ~1e-10, which D bounds (twice: the
# residue of each run's own terms).
TRAIN_C_S = 1e-4
# The head (dL/dlogits) is held on its own: the loss's gradient by the
# logits is 1/(2B)-Lipschitz in the logits and alpha/(2B) in the teacher's
# (softmax Jacobians have norm <= 1/2), so card and CPU differ by at most
# (|dz| + alpha |dt|) / (2B) in L2, plus the float32 rounding of the
# softmaxes, TRAIN_RTOL_HEAD of the gradient's norm. The network below it
# is held from one head gradient, the card's (logits ~1e3 apart by float32
# rounding would otherwise carry the head's difference into every
# gradient: ResNet-32's FQ stage at lr 0.05, 5.8e-5 M).
TRAIN_RTOL_HEAD = 1e-5
# Where the CPU parts from the card on a discrete choice (repro_torch.taps;
# each pinned to the card's), per stage and per calibration, as a share:
# of quantizer inputs, as the CPU tests (an H100 reads <= 1.2e-5)
TRAIN_MAX_CODE_FLIPS = 1e-4
# of quantizer inputs: exact ties (a sum of quantized products 0 in one
# order and not in the other); KWS's narrow convs over sparse codes tie
# most. An H100 reads 2.8e-2 to 4.2e-2 (KWS) and 2.6e-3 to 5.0e-3
# (DarkNet) from run to run, as cuDNN picks its algorithms.
# The ResNets' limits were set before their first card run: ResNet-20's
# narrow convs (16-64 channels) over 2-bit codes as KWS's; ResNet-32's
# 64-256 channels between KWS's and DarkNet's (the reference against the
# port on the CPU reads 1.1e-3 at full width, B=1: test_torch_train_fq_full).
# An H100 reads ResNet-20 <= 1.2e-8 (Q W2A2 has no clip ties but a ReLU's)
# and ResNet-32 2.1e-3 to 1.3e-2 (FQ W2A5).
TRAIN_MAX_TIE_FLIPS = {"kws": 1e-1, "darknet": 2e-2, "resnet20": 1e-1,
                       "resnet32": 5e-2}
TRAIN_MAX_POOL_FLIPS = 1e-2    # of 2x2 windows (reads <= 3.0e-3, DarkNet Q)
TRAIN_MAX_RELU_FLIPS = 1e-5    # of (leaky) ReLU inputs (reads <= 7.6e-7)


def sw_seeded(path, transition):
    """Whether ``path``'s weight scales are seeded at ``transition`` ("q" or
    "fq"; TRAIN_SW_SEEDED), in ``train_fq`` and ``train_qat`` alike."""
    return transition in TRAIN_SW_SEEDED.get(path, ())


def seed_weight_scales(params, names):
    """``params`` with e^{s_w} of every conv in ``names`` at the
    TRAIN_SW_PERCENTILE-th percentile of its |w|."""
    from repro_torch.core.quant import init_scale
    return {**params, **{n: {**params[n], "s_w": init_scale(
        params[n]["w"], percentile=TRAIN_SW_PERCENTILE)} for n in names}}


FLIP_KINDS = (("code", "code_flips", "positions"),
              ("tie", "tie_flips", "positions"),
              ("pool", "pool_flips", "windows"),
              ("relu", "relu_flips", "relu_positions"))


def add_flips(total, taps):
    """``total`` plus the flips and positions ``taps`` counted."""
    for k in {k for _, n, of in FLIP_KINDS for k in (n, of)} | {
            "round_ties"}:
        total[k] = total.get(k, 0) + getattr(taps, k)
    return total


def check_flips(where, path, total, rounding_ties=False):
    """Fails where the CPU parted from the card more often than allowed.

    With ``rounding_ties`` the code flips that are rounding ties (taps:
    both inputs within float32 rounding of the half-LSB boundary between
    the two codes) count as ties. Deploy-QAT's surrogate needs it: its
    quantizers see sums of lattice values (the entry codes times ternary
    weights, k units each), and calibrate sets e^{s_out} of the entry
    layer to the largest of them, K units, so that layer's rescale is 7 / K
    up to the rounding of log and exp; where K / 7 is even, every output of
    K / 14 mod K / 7 units sits on a half-LSB boundary, and card and CPU
    sums resolve such ties apart, as they resolve ties at a clip bound. An
    H100 read 1.2e-3 of DarkNet's surrogate inputs flipped (K = 56: all in
    conv1's outputs, within 1.5e-6 LSB of the boundary) and 8e-6 of KWS's.
    The other code flips stay under TRAIN_MAX_CODE_FLIPS."""
    total = dict(total)
    if rounding_ties:
        r = total.get("round_ties", 0)
        total["code_flips"] -= r
        total["tie_flips"] += r
    limits = {"code": TRAIN_MAX_CODE_FLIPS, "tie": TRAIN_MAX_TIE_FLIPS[path],
              "pool": TRAIN_MAX_POOL_FLIPS, "relu": TRAIN_MAX_RELU_FLIPS}
    parts = []
    for kind, n, of in FLIP_KINDS:
        flips, positions = total.get(n, 0), total.get(of, 0)
        parts.append(f"{kind} {flips} of {positions}")
        if flips > limits[kind] * positions:
            raise AssertionError(f"{where}: {kind} flips {flips} of "
                                 f"{positions} > {limits[kind]} (rounding "
                                 f"ties among the code flips: "
                                 f"{total.get('round_ties', 0)})")
    print(f"{where}: CPU against card, flips pinned: " + ", ".join(parts)
          + (f" (ties: {total.get('round_ties', 0)} rounding ties among "
             "them)" if rounding_ties else
             f" (of the code flips {total.get('round_ties', 0)} rounding "
             "ties)"), flush=True)


def resnet_convs(cfg):
    """A ResNet's quantized convs in call order (the stem where
    ``quantize_first_last``; per block c1, c2 and the downsample shortcut
    sc), and the (conv, next conv) pairs where the next conv's input is the
    conv's own output: the stem's into the first c1, each c1's into its
    c2. The reference's ResNet has no list of its conv names."""
    names, pairs, cin = [], [], cfg.widths[0]
    if cfg.quantize_first_last:
        names.append("stem")
        pairs.append(("stem", "s0b0_c1"))
    for si, w in enumerate(cfg.widths):
        for bi in range(cfg.blocks_per_stage):
            pre = f"s{si}b{bi}"
            names += [pre + "_c1", pre + "_c2"] + (
                [pre + "_sc"] if cin != w else [])
            pairs.append((pre + "_c1", pre + "_c2"))
            cin = w
    return names, pairs


def train_setup(path):
    """The model, config, input shape, ladder stages ((QuantConfig, label,
    noisy) each), quantized conv names, (conv, next conv) pairs and the
    conv whose weight gradient shows TF32 of one ``train_fq`` row."""
    from repro_torch.configs.paper_nets import PAPER_NETS, ladder_for
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import darknet, kws

    batch = TRAIN_BATCH[path]
    if path in ("kws", "darknet"):
        model = kws if path == "kws" else darknet
        cfg = kws.KWSConfig() if path == "kws" else darknet.DarkNetConfig()
        shape = ((batch, cfg.seq_len, cfg.n_mfcc) if path == "kws"
                 else (batch, DN_SIZE, DN_SIZE, cfg.in_channels))
        fq = QuantConfig(2, 4, 4, fq=True)
        q = QuantConfig(2, 4) if path == "kws" else QuantConfig(2, 5)
        ladder = [QuantConfig(), q, fq, fq]
        quantized = (kws.conv_names(cfg) if path == "kws"
                     else darknet.int_conv_names(cfg))
        pairs = list(zip(quantized, quantized[1:]))
        teeth = "conv1" if path == "darknet" else "conv0"
    else:
        net = PAPER_NETS[{"resnet20": "resnet20-cifar10",
                          "resnet32": "resnet32-cifar100"}[path]]
        model, cfg = net.module, net.config
        shape = (batch,) + net.input_shape
        table = ladder_for(net)
        # Table 1's ladder has no FQ stage; Table 6's ends in FQ W2A5
        ladder = ([table[0], table[-1]] if path == "resnet20" else
                  [table[0], table[-2], table[-1], table[-1]])
        quantized, pairs = resnet_convs(cfg)
        teeth = "s0b0_c1"
    stages = [(q, "FP" if q.is_fp else q.label(), False) for q in ladder]
    if len(stages) == 4:  # the last stage again, noisy
        q, label, _ = stages[-1]
        stages[-1] = (q, label + " noisy", True)
    return dict(model=model, cfg=cfg, shape=shape, stages=stages,
                quantized=quantized, pairs=pairs, teeth=teeth)


def train_model(torch, dev, path, smi):
    """One model's short ladder on the card, each step repeated on the CPU
    from a copy of the card's params, state and momentum (an independent
    CPU run drifts by float32 rounding until codes flip between the two);
    returns the rows of its step-time table."""
    import numpy as np
    from repro_torch import taps, tree
    from repro_torch.core import distill, gradual, prng
    from repro_torch.core import fq_layers as fql
    from repro_torch.core import integer_inference as ii
    from repro_torch.core.noise import NoiseConfig, TABLE7_CONDITIONS
    from repro_torch.core.quant import QuantConfig
    from repro_torch.optim import schedules, sgd

    setup = train_setup(path)
    model, cfg, shape = setup["model"], setup["cfg"], setup["shape"]
    quantized, stages = setup["quantized"], setup["stages"]
    ladder = [q for q, _, _ in stages]
    batch = shape[0]
    rng = np.random.default_rng(SEED + 7)
    if path.startswith("resnet"):
        # the ResNets' images in [-1, 1], as ``resnet.apply`` takes them
        x_np = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    else:
        x_np = rng.standard_normal(shape).astype(np.float32)
    y_np = rng.integers(0, cfg.num_classes, batch)
    cond = TABLE7_CONDITIONS[-1]
    noise = NoiseConfig(cond.sigma_w, cond.sigma_a, cond.sigma_mac)
    devs = {"card": dev, "cpu": torch.device("cpu")}
    data = {d: (torch.from_numpy(x_np).to(v), torch.from_numpy(y_np).to(v))
            for d, v in devs.items()}
    rows, last = [], [(0.0, "")]

    def cpu(t):
        return ii.to_device(t, "cpu")

    def loss_fn(d, qcfg, state, teacher_logits, key, nz):
        x, y = data[d]

        def fn(p):
            logits, new = model.apply(p, state, x, qcfg, cfg, train=True,
                                      rng=key, noise=nz)
            if teacher_logits is None:
                onehot = torch.nn.functional.one_hot(
                    y, cfg.num_classes).float()
                loss = torch.mean(distill.softmax_cross_entropy(logits,
                                                                onehot))
            else:
                loss = distill.distillation_loss(logits, teacher_logits, y,
                                                 alpha=TRAIN_ALPHA)
            return loss, (logits, new)
        return fn

    def train_stage(bundle, qcfg, teacher, idx):
        _, label, noisy = stages[idx]
        nz = noise if noisy else None
        p, st, prev = bundle
        if sw_seeded(path, "q") and prev.is_fp and not qcfg.is_fp:
            p = seed_weight_scales(p, quantized)
        if qcfg.fq and not prev.fq:
            # paper §3.4: fold BN, calibrate the ranges on the batch; the
            # CPU does the same from the same params, then takes the card's
            # each calibration forward pinned to the card's, as the steps
            folded, card_taps, cal_flips = {}, [], {}
            for d, v in devs.items():
                pd, sd = ii.to_device(p, v), ii.to_device(st, v)
                pd = model.to_fq(pd, sd, cfg)
                if sw_seeded(path, "fq"):
                    pd = seed_weight_scales(pd, quantized)
                refs = iter(list(card_taps))

                def forward(pp, sd=sd, d=d, refs=refs):
                    with taps.Taps(None if d == "card" else next(refs),
                                   record=d == "card") as t:
                        model.apply(pp, sd, data[d][0], qcfg, cfg)
                    if d == "card":
                        card_taps.append(t)
                    else:
                        t.matched()
                        add_flips(cal_flips, t)
                folded[d] = fql.calibrate(forward, pd, iters=TRAIN_CAL_ITERS)
            check_flips(f"train_fq {path} {label}: calibrate", path,
                        cal_flips)
            worst = compare_params(torch, f"train_fq {path} {label}: "
                                   "to_fq + calibrate", folded["card"],
                                   folded["cpu"], {})
            print(f"train_fq {path} {label}: to_fq + calibrate "
                  f"({TRAIN_CAL_ITERS} iterations), card against CPU from "
                  "the same params: "
                  f"worst |diff| / bound {worst[0]:.3g} ({worst[1]})",
                  flush=True)
            p = folded["card"]
        t_logits = {}
        for d, v in devs.items():
            t_logits[d] = None
            if teacher is not None:
                tp, ts, tq = ii.to_device(teacher, v)
                with torch.no_grad():
                    t_logits[d], _ = model.apply(tp, ts, data[d][0], tq, cfg)
        sched = schedules.cosine(TRAIN_LR[path], TRAIN_STEPS)
        opt = sgd.make(sched, weight_decay=5e-4)
        ost = opt.init(p)
        # A conv whose s_in equals the previous conv's s_out (calibrate
        # took that conv's saturated maximum) gets the previous codes on
        # its own code grid: its input quantizer's s gradient is 0 in exact
        # arithmetic, float32 residue of ~1e-8 M that can sum to 0 in every
        # step (KWS conv1.s_in: the CPU reads 3e-12 = 4e-9 M, the card 0 in
        # some steps). The liveness check passes over it; the card-against-
        # CPU check of every s leaf holds it all the same.
        on_grid = ({f"{n}.s_in" for m, n in setup["pairs"]
                    if torch.equal(p[n]["s_in"], p[m]["s_out"])}
                   if qcfg.fq and nz is None else set())
        flips, live = {}, set()
        for i in range(TRAIN_STEPS):
            key = (prng.fold_in(prng.PRNGKey(TRAIN_KEY), i)
                   if nz is not None else None)
            start = {"card": (p, st, ost), "cpu": cpu((p, st, ost))}
            res, new = {}, {}
            for d, v in devs.items():
                pd, sd, od = start[d]
                fn = loss_fn(d, qcfg, sd, t_logits[d],
                             None if key is None else key.to(v), nz)
                # the CPU pinned to the card's discrete choices, its
                # backward below the head from the card's head gradient
                t = taps.Taps(res["card"][3] if d == "cpu" else None,
                              record=d == "card")
                res[d] = taps.head_value_and_grad(
                    fn, pd, t, head=res["card"][2] if d == "cpu" else None
                ) + (t,)
                grads = res[d][1]
                g_tree = tree.unflatten(pd, [grads[k] for k, _ in
                                             tree.named_leaves(pd)])
                new[d] = opt.update(pd, g_tree, od, i) + (res[d][0][1][1],)
            live |= check_train_step(torch, path, label, i, res, quantized,
                                     qcfg, on_grid, teacher=t_logits)
            res["cpu"][3].matched()
            add_flips(flips, res["cpu"][3])
            # the update: lr (1 + 0.9) times each gradient's bound (Nesterov
            # from the same momentum)
            lr = float(sched(i))
            cpu_taps = res["cpu"][3]
            bounds = {name: lr * 1.9 * (
                TRAIN_C_S * cpu_taps.mag[name]
                + 2.0 * cpu_taps.fwd.get(name, 0.0)
                if name in cpu_taps.mag else
                TRAIN_RTOL_W * float(g.norm()))
                for name, g in res["cpu"][1].items()}
            last[0] = compare_params(
                torch, f"train_fq {path} {label} step {i}: updated params",
                new["card"][0], new["cpu"][0], bounds)
            p, ost, st = new["card"]
            del res, new, start
        dead = [f"{n}.{k}" for n in quantized
                for k in ("w", "s_w", "s_in", "s_out")
                if f"{n}.{k}" not in live | on_grid]
        if qcfg.fq and dead:
            # the net is live: each leaf moves in some step of the stage
            raise AssertionError(f"train_fq {path} {label}: zero gradients "
                                 f"in every step at {dead}")
        check_flips(f"train_fq {path} {label}: {TRAIN_STEPS} steps", path,
                    flips)
        rows.append(time_train_step(torch, tree, path, label, opt,
                                    (p, st, t_logits["card"]), ost, qcfg,
                                    nz, loss_fn, smi))
        x, y = data["card"]
        with torch.no_grad():
            logits, _ = model.apply(p, st, x, qcfg, cfg)
        acc = float((logits.argmax(-1) == y).float().mean())
        return (p, st, qcfg), acc

    p, st = model.init(torch.Generator().manual_seed(SEED), cfg, device=dev)
    result = gradual.run_ladder(ladder, (p, st, QuantConfig()), train_stage)
    print(f"train_fq {path}: after the ladder, the CPU's last update from "
          f"the card's params: worst |diff| / bound {last[0][0]:.3g} "
          f"({last[0][1]})", flush=True)
    check_tf32_pinned(torch, tree, path, model, cfg, result.final.params,
                      data["card"], ladder[-1], setup["teeth"])
    print(f"train_fq {path}: ladder {result.summary()} (accuracy on the "
          "batch, card)", flush=True)
    return rows


def compare_params(torch, where, card, cpu, bounds):
    """Every leaf card against CPU: |diff| <= its bound in ``bounds`` plus
    1e-5 of the leaf's norm (of 1 for a leaf smaller than 1: the float32
    rounding of an update, a BN fold or the host's log of a calibrated
    maximum an ulp apart). Returns (worst |diff| / bound, leaf)."""
    worst = (0.0, "")
    from repro_torch import tree
    card = dict(tree.named_leaves(card))
    for name, t in tree.named_leaves(cpu):
        diff = float((card[name].cpu() - t).norm())
        bound = bounds.get(name, 0.0) + 1e-5 * max(float(t.norm()), 1.0)
        if diff > bound:
            raise AssertionError(f"{where}: {name} off the CPU run by "
                                 f"{diff} > {bound}")
        worst = max(worst, (diff / bound, name))
    return worst


def head_bound(torch, lg_card, lg_cpu, t_card, t_cpu, g_cpu,
               alpha=TRAIN_ALPHA):
    """The L2 bound of the head gradient, card against CPU (TRAIN_RTOL_HEAD):
    (|dz| + alpha |dt|) / (2B) + TRAIN_RTOL_HEAD |g|, dz the logits' and dt
    the teacher logits' difference (alpha 0 without a teacher)."""
    dz = float((lg_card.detach().cpu() - lg_cpu.detach()).norm())
    dt = (0.0 if t_card is None
          else alpha * float((t_card.cpu() - t_cpu).norm()))
    return ((dz + dt) / (2 * lg_cpu.shape[0])
            + TRAIN_RTOL_HEAD * float(g_cpu.norm()))


def compare_step(torch, where, card, cpu, mag, *, exact_zero=(),
                 near_zero=(), fwd=None, head=None):
    """One value and gradient, card against the CPU run from the same
    params; ``card`` and ``cpu`` are (loss, logits, {leaf: gradient}).
    Fails unless the card's are finite, the logits within TRAIN_RTOL_LOGITS
    x max|logit| and the loss within TRAIN_RTOL_LOSS of the CPU's, and
    every leaf's gradient agrees: ``exact_zero`` leaves exactly 0 on both,
    ``near_zero`` ones (0 in exact arithmetic) within 1e-5 of the largest
    gradient's norm on both, a leaf with a magnitude M in ``mag`` (taps:
    the log-scales, BN's gamma and beta) within TRAIN_C_S x M plus twice its
    forward difference D in ``fwd`` (taps), every other within
    TRAIN_RTOL_W relative L2. ``head`` = (card's dL/dlogits, CPU's, bound):
    the head gradient held on its own (:func:`head_bound`; the CPU's leaf
    gradients are then its backward from the card's head gradient).
    Returns (max |logit diff|, (worst |diff| / bound, leaf), (worst
    relative L2, leaf))."""
    (l_card, lg_card, g_card), (l_cpu, lg_cpu, g_cpu) = card, cpu
    lg_card, lg_cpu = lg_card.detach(), lg_cpu.detach()
    fwd = fwd or {}
    if not (torch.isfinite(l_card) and torch.isfinite(lg_card).all()
            and all(torch.isfinite(g).all() for g in g_card.values())):
        raise AssertionError(f"{where}: loss, logits or gradients not "
                             "finite")
    d_logit = float((lg_card.cpu() - lg_cpu).abs().max())
    if d_logit > TRAIN_RTOL_LOGITS * float(lg_cpu.abs().max()):
        raise AssertionError(f"{where}: logits off the CPU run by {d_logit}")
    if abs(float(l_card) - float(l_cpu)) > TRAIN_RTOL_LOSS * abs(
            float(l_cpu)):
        raise AssertionError(f"{where}: loss {float(l_card)} vs CPU "
                             f"{float(l_cpu)}")
    if head is not None:
        h_card, h_cpu, h_bound = head
        err = float((h_card.cpu() - h_cpu).norm())
        if err > h_bound:
            raise AssertionError(f"{where}: head gradient off the CPU's by "
                                 f"{err} > {h_bound}")
    worst_w, worst_s = (0.0, ""), (0.0, "")
    gmax = max(float(g.norm()) for g in g_cpu.values())
    for name, gc in g_cpu.items():
        g = g_card[name].cpu()
        if name in exact_zero:
            if bool(g.any()) or bool(gc.any()):
                raise AssertionError(f"{where}: {name} gradient not exactly "
                                     f"0 (card {float(g.norm())}, CPU "
                                     f"{float(gc.norm())})")
            continue
        if name in near_zero:
            # rounding noise on both sides, held at zero
            if max(float(gc.norm()), float(g.norm())) > 1e-5 * gmax:
                raise AssertionError(f"{where}: {name} gradient not zero")
            continue
        err = float((g - gc).norm())
        if name in mag:
            m, d = mag[name], fwd.get(name, 0.0)
            lim = TRAIN_C_S * m + 2.0 * d
            if err > lim:
                raise AssertionError(f"{where}: {name} gradient off the "
                                     f"CPU's by {err} > {TRAIN_C_S} x M + "
                                     f"2 D = {lim} (M {m}, D {d})")
            worst_s = max(worst_s, (err / lim if lim else 0.0, name))
        else:
            rel = err / float(gc.norm()) if gc.norm() > 0 else err
            if rel > TRAIN_RTOL_W:
                raise AssertionError(f"{where}: {name} gradient rel L2 "
                                     f"{rel} > {TRAIN_RTOL_W}")
            worst_w = max(worst_w, (rel, name))
    return d_logit, worst_s, worst_w


def check_train_step(torch, path, label, i, res, quantized, qcfg,
                     on_grid=(), teacher=None):
    """Card against CPU for one step (:func:`compare_step`): the head
    gradient on its own, the network below it from the card's head
    gradient, the log-scales with their forward difference; in the FQ
    stages every quantized layer live. ``teacher``: {device: teacher
    logits or None}."""
    (l_card, (lg_card, _)), g_card, h_card, _ = res["card"]
    (l_cpu, (lg_cpu, _)), g_cpu, h_cpu, cpu_taps = res["cpu"]
    where = f"train_fq {path} {label} step {i}"
    teacher = teacher or {"card": None, "cpu": None}
    h_lim = head_bound(torch, lg_card, lg_cpu, teacher["card"],
                       teacher["cpu"], h_cpu)
    d_logit, worst_s, worst_w = compare_step(
        torch, where, (l_card, lg_card, g_card), (l_cpu, lg_cpu, g_cpu),
        cpu_taps.mag, near_zero=zero_by_construction(path, qcfg),
        fwd=cpu_taps.fwd, head=(h_card, h_cpu, h_lim))
    leaves = [f"{n}.{k}" for n in quantized
              for k in ("w", "s_w", "s_in", "s_out")]
    live = {k for k in leaves if bool((g_card[k] != 0).any())}
    zero = [k for k in leaves if k not in live]
    print(f"{where}: loss {float(l_card):.6f} (CPU {float(l_cpu):.6f}); "
          f"max |logit diff| {d_logit:.3g}; head gradient |diff| "
          f"{float((h_card.cpu() - h_cpu).norm()):.3g} (bound {h_lim:.3g}); "
          f"worst |diff| / (C_S M + 2 D) "
          f"{worst_s[0]:.3g} ({worst_s[1]}); worst weight / bias gradient "
          f"rel L2 {worst_w[0]:.3g} ({worst_w[1]})"
          + (f"; quantized layers' w, s_w, s_in, s_out: {len(zero)} zero "
             f"gradients {zero}, on the code grid {sorted(on_grid)}"
             if qcfg.fq else ""), flush=True)
    return live


def zero_by_construction(path, qcfg):
    """Leaves the loss does not depend on in exact arithmetic: KWS's
    embedding bias sits before a training-mode BN, and in FP mode that BN's
    beta too (conv0, VALID and unquantized, passes a per-channel shift on
    to the next training-mode BN)."""
    if path != "kws":
        return ()
    return ("embed.b",) + (("embed_bn.beta",) if qcfg.is_fp else ())


def time_step(torch, step, reps):
    """``step()`` on the card: one warm-up, then TRAIN_TIMED steps on the
    host clock (their peak memory), then ``reps`` profiled (busy share,
    device ops, device time by name). Returns the row's numbers, the
    names by time (``names``) and the printed text (``line``)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    wall, busy, ops, names = device_profile(torch, step, reps=reps,
                                            top=10 ** 6)
    line = (f"one step {ms:.4f} ms (host clock, mean of {TRAIN_TIMED}); "
            f"profiled over {reps}: {wall:.4f} ms, device busy {busy:.4f} "
            f"ms (share {busy / wall:.4f}), {ops:.1f} device ops; peak "
            f"memory {peak:.1f} MiB; top: " + ", ".join(
                f"{n[:60]} {t:.4f}" for n, t in names[:5]))
    return {"ms": ms, "busy_ms": busy, "busy_share": busy / wall,
            "device_ops": ops, "peak_mib": peak, "names": names,
            "line": line}


def time_train_step(torch, tree, path, label, opt, out, ost, qcfg, nz,
                    loss_fn, smi):
    """One training step on the card (value_and_grad + SGD update) from the
    stage's end, timed by :func:`time_step` over TRAIN_PROFILED profiled
    steps. The steps' results are dropped."""
    from repro_torch.core import prng
    p, st, t_logits = out
    key = (prng.fold_in(prng.PRNGKey(TRAIN_KEY), 99).to(
        tree.leaves(p)[0].device) if nz is not None else None)
    vg = tree.value_and_grad(loss_fn("card", qcfg, st, t_logits, key, nz),
                             has_aux=True)

    def step():
        (loss, _), g = vg(p)
        return opt.update(p, g, ost, 0)

    t = time_step(torch, step, reps=TRAIN_PROFILED)
    print(f"train_fq {path} {label}: {t.pop('line')}; {smi}", flush=True)
    del t["names"]
    return {"path": path, "stage": label, **t}


def check_tf32_pinned(torch, tree, path, model, cfg, bundle, data, qcfg,
                      name):
    """One backward (of stage ``qcfg``, training mode) with
    ``cudnn.allow_tf32`` set True globally gives the gradients of the run
    with it False, bit for bit (the convs pin it off in both directions);
    both runs with cuDNN's deterministic algorithms. Then conv ``name``
    through plain autograd, to show TF32 would have moved it."""
    p, st, _ = bundle
    x, y = data

    def fn(pp):
        logits, _ = model.apply(pp, st, x, qcfg, cfg, train=True)
        onehot = torch.nn.functional.one_hot(y, cfg.num_classes).float()
        return torch.mean(-torch.sum(onehot * torch.log_softmax(logits, -1),
                                     -1))
    vg = tree.value_and_grad(fn)
    det = torch.backends.cudnn.deterministic
    grads = {}
    try:
        torch.backends.cudnn.deterministic = True
        for flag in (False, True):
            torch.backends.cudnn.allow_tf32 = flag
            grads[flag] = tree.leaves(vg(p)[1])
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = det
    same = all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))
    # the teeth: a conv of the net through plain autograd, TF32 on and off
    w = p[name]["w"]
    nd = w.dim() - 2
    xin = torch.randn((x.shape[0], w.shape[-2]) + (32,) * nd,
                      device=x.device, generator=torch.Generator(
                          x.device).manual_seed(SEED))
    conv = torch.nn.functional.conv2d if nd == 2 else \
        torch.nn.functional.conv1d
    wc = w.permute(nd + 1, nd, *range(nd)).contiguous()
    plain = {}
    try:
        for flag in (False, True):
            torch.backends.cudnn.allow_tf32 = flag
            wl = wc.clone().requires_grad_(True)
            conv(xin, wl).square().sum().backward()
            plain[flag] = wl.grad
    finally:
        torch.backends.cudnn.allow_tf32 = False
    teeth = float((plain[True] - plain[False]).abs().max())
    print(f"train_fq {path}: {qcfg.label()} gradients with "
          "cudnn.allow_tf32 = True "
          f"globally {'==' if same else '!='} with False, bit for bit, over "
          f"{len(grads[False])} leaves; the unpinned {name} weight gradient "
          f"moves by {teeth:.3g} under TF32", flush=True)
    if not same:
        raise AssertionError(f"train_fq {path}: TF32 reached the gradients")


def phase_train_fq(torch, dev):
    """Float FQ training: a short gradual-quantization ladder of full-width
    KWS, DarkNet-19, ResNet-20 and ResNet-32 through the port's training
    entry points, card against its CPU twin step by step; no TPU-kernel
    counterpart runs."""
    from repro_torch import kernels
    smi = nvidia_smi()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rows = []
    # cuDNN's deterministic algorithms, so that each call trains the same
    # steps (ROADMAP C21): with its default ones DarkNet's FP stage ends
    # elsewhere each run, and the FQ calibrate that starts there read 0 to
    # 50,215 code flips of 180M card against CPU on an H100; deterministic,
    # one start, 70 flips in every run, after train_transformer or alone
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for path in ("kws", "darknet", "resnet20", "resnet32"):
            rows += train_model(torch, dev, path, smi)
    finally:
        torch.backends.cudnn.deterministic = det
    torch.cuda.synchronize()
    counts = {**kernels.launch_counts(), **kernels.packed_launch_counts(),
              **kernels.noisy_launch_counts(),
              **kernels.vector_launch_counts()}
    print("kernels (train_fq): " + " ".join(f"{k}={v}" for k, v in
                                            counts.items()), flush=True)
    if any(counts.values()):
        raise AssertionError(f"the training path launched K1-K5: {counts}")
    return rows


# ---------------------------------------------------------------------------
# Deploy-QAT training (train_qat)
# ---------------------------------------------------------------------------

QAT_STEPS = 3              # QATFinetune steps a condition (1 + 2 against 3)
QAT_LR = 0.01              # SGD, constant: the reference's QAT step smoke
QAT_CLIP = 1.0             # clip_by_global_norm
QAT_PROFILED = 2           # steps (int_apply calls) a profile runs
QAT_DATA = {"kws": 256, "darknet": 32}   # synthetic training-set sizes
QAT_DATA_KEY = 21          # PRNGKey of the datasets
# mac_chunks of the forward-equals-int_apply check (the reference's test's)
QAT_FWD_CHUNKS = {"kws": (1, 4), "darknet": (2,)}
# launches of K1, K3 and K3b inside one training step of each model
QAT_LAUNCHES = {"kws": {"quantize_codes": 1, "fq_matmul": 0,
                        "fq_conv2d": 7, "fq_conv2d_pool": 0, "lm_island": 0},
                "darknet": {"quantize_codes": 1, "fq_matmul": 0,
                            "fq_conv2d": 13, "fq_conv2d_pool": 4,
                            "lm_island": 0}}
QAT_KERNEL_NAMES = ("quantize_codes_kernel", "fq_conv_kernel",
                    "fq_conv_pool2_kernel", "fq_conv_pool_kernel",
                    "fq_matmul_kernel") + SPLIT_GRAPH_KERNELS


def qat_model(torch, dev, path):
    """(module, cfg, data, BN-folded FQ params, state, integer conv names)
    of one model on the card: the synthetic training set, init from seed
    SEED, to_fq (e^{s_w} seeded where TRAIN_SW_SEEDED says "fq": DarkNet,
    C-ref-5) and calibrate (3 iterations) on the set's first batch."""
    from repro_torch.core import fq_layers as fql
    from repro_torch.core import prng
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data import synthetic
    from repro_torch.models import darknet, kws

    fq = QuantConfig(2, 4, 4, fq=True)
    key = prng.PRNGKey(QAT_DATA_KEY, device=dev)
    if path == "kws":
        model, cfg = kws, kws.KWSConfig()
        data = synthetic.make_mfcc_dataset(
            key, n=QAT_DATA[path], seq_len=cfg.seq_len, n_mfcc=cfg.n_mfcc,
            num_classes=cfg.num_classes)
        names = kws.conv_names(cfg)
    else:
        model, cfg = darknet, darknet.DarkNetConfig()
        data = synthetic.make_image_dataset(
            key, n=QAT_DATA[path], shape=(DN_SIZE, DN_SIZE,
                                          cfg.in_channels),
            num_classes=cfg.num_classes)
        names = darknet.int_conv_names(cfg)
    p, st = model.init(torch.Generator().manual_seed(SEED), cfg, device=dev)
    p = model.to_fq(p, st, cfg)
    if sw_seeded(path, "fq"):
        p = seed_weight_scales(p, names)
    x0 = data[0][:TRAIN_BATCH[path]]
    p = fql.calibrate(lambda pp: model.apply(pp, st, x0, fq, cfg), p,
                      iters=TRAIN_CAL_ITERS)
    return model, cfg, data, p, st, names


def qat_loss(torch, model, cfg, st, nz, **kw):
    """fn(params, (x, y), rng) -> (softmax cross-entropy of ``qat_apply``,
    logits)."""
    from repro_torch.core import distill
    from repro_torch.core.quant import QuantConfig
    fq = QuantConfig(2, 4, 4, fq=True)

    def fn(p, batch, rng):
        x, y = batch
        logits = model.qat_apply(p, st, x, fq, cfg, noise=nz, rng=rng, **kw)
        onehot = torch.nn.functional.one_hot(y, cfg.num_classes).float()
        return torch.mean(distill.softmax_cross_entropy(logits, onehot)), \
            logits
    return fn


def qat_forward_is_int_apply(torch, path, model, cfg, p, st, x, noise):
    """(a): ``qat_apply`` == ``int_apply`` of ``sync_handoff`` +
    ``convert_int`` of the same params, bit for bit on the card, clean and
    noisy with one key, at each of QAT_FWD_CHUNKS (DarkNet at both
    ``fuse_pool``)."""
    from repro_torch.core import integer_inference as ii
    from repro_torch.core import prng
    from repro_torch.core.quant import QuantConfig
    fq = QuantConfig(2, 4, 4, fq=True)
    names = (model.conv_names(cfg) if path == "kws"
             else model.int_conv_names(cfg))
    ip = model.convert_int(ii.sync_handoff(p, names), st, fq, cfg)
    key = prng.PRNGKey(QAT_DATA_KEY + 1, device=x.device)
    pools = (True, False) if path == "darknet" else (None,)
    n = 0
    with torch.no_grad():
        for pool in pools:
            kw = {} if pool is None else {"fuse_pool": pool}
            for nz, rng, chunks in ([(None, None, 1)] + [
                    (noise, key, c) for c in QAT_FWD_CHUNKS[path]]):
                want = model.int_apply(ip, x, fq, cfg, noise=nz, rng=rng,
                                       mac_chunks=chunks, **kw)
                got = model.qat_apply(p, st, x, fq, cfg, noise=nz, rng=rng,
                                      mac_chunks=chunks, **kw)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"train_qat {path}: qat_apply != int_apply "
                        f"(noise {nz}, mac_chunks {chunks}, {kw}): max "
                        f"|diff| {float((got - want).abs().max())}")
                n += 1
    print(f"train_qat {path}: qat_apply == int_apply(sync_handoff + "
          f"convert_int) bit for bit on the card in {n} runs (clean; noisy "
          f"with one key at mac_chunks {QAT_FWD_CHUNKS[path]}"
          + (", fuse_pool True and False" if path == "darknet" else "")
          + ")", flush=True)
    return ip


def qat_card_vs_cpu(torch, path, label, model, cfg, p, st, batch, key, nz,
                    names):
    """(c): one QAT value-and-gradient on the card and again on the CPU from
    the card's params, batch and key, the CPU taking the card's entry codes
    (its own counted against them) and its surrogate's discrete choices
    pinned to the card's (``repro_torch.taps``; train_fq's limits, rounding
    ties counted as ties). Fails unless the integer codes of every layer
    are equal (clean) or differ in at most MAX_FLIP_FRACTION of them (noisy:
    the code-domain normals are not bit-exact, C4), logits, loss and
    gradients agree within train_fq's bounds (:func:`compare_step`), every
    stale inner s_in's
    gradient is exactly 0 on both, every layer's w and s_w and the entry
    s_in get a gradient, and no layer's output codes are all 0. Returns the
    card's gradients."""
    from repro_torch import taps
    from repro_torch.core import deploy_qat as dq
    from repro_torch.core import integer_inference as ii

    where = f"train_qat {path} {label}"
    unit = "qat_conv1d" if path == "kws" else "qat_conv2d"
    res = {}
    for d, v in (("card", batch[0].device), ("cpu", torch.device("cpu"))):
        codes, entry = [], []
        orig_unit, orig_entry = getattr(dq, unit), ii.entry_codes

        def unit_fn(*a, _orig=orig_unit, _codes=codes, **kw):
            h, c = _orig(*a, **kw)
            _codes.append(c)
            return h, c

        def entry_fn(h, pp, qcfg, *, b_in, _orig=orig_entry, _entry=entry,
                     _d=d):
            c = _orig(h, pp, qcfg, b_in=b_in)
            _entry.append(c)
            return res["card"]["entry"][0].cpu() if _d == "cpu" else c

        fn = qat_loss(torch, model, cfg, ii.to_device(st, v), nz)
        xb, yb = (t.to(v) for t in batch)
        k = None if key is None else key.to(v)
        t = taps.Taps(res["card"]["taps"] if d == "cpu" else None,
                      record=d == "card")
        setattr(dq, unit, unit_fn)
        ii.entry_codes = entry_fn
        try:
            (loss, logits), grads = taps.value_and_grad(
                lambda pp: fn(pp, (xb, yb), k), ii.to_device(p, v), t)
        finally:
            setattr(dq, unit, orig_unit)
            ii.entry_codes = orig_entry
        res[d] = dict(loss=loss, logits=logits.detach(), grads=grads,
                      taps=t, codes=codes, entry=entry)
    card, cpu = res["card"], res["cpu"]
    cpu["taps"].matched()
    # entry codes: the CPU's own from its float edge, counted (C2)
    flips = int((cpu["entry"][0] != card["entry"][0].cpu()).sum())
    n_entry = cpu["entry"][0].numel()
    if flips > MAX_FLIP_FRACTION * n_entry:
        raise AssertionError(f"{where}: {flips} of {n_entry} entry codes "
                             "flipped")
    differ = [int((a.cpu() != b).sum()) for a, b in zip(card["codes"],
                                                        cpu["codes"])]
    n_codes = sum(c.numel() for c in card["codes"])
    if len(differ) != len(names) or (
            sum(differ) > (MAX_FLIP_FRACTION * n_codes if nz else 0)):
        raise AssertionError(f"{where}: integer codes card against CPU "
                             f"differ per layer {differ} of {n_codes}")
    live = {n: float((c != 0).double().mean())
            for n, c in zip(names, card["codes"])}
    dead = [n for n, share in live.items() if share == 0.0]
    if dead:
        raise AssertionError(f"{where}: all output codes 0 at {dead}")
    stale = {f"{n}.s_in" for n in names[1:]}
    d_logit, worst_s, worst_w = compare_step(
        torch, where, (card["loss"], card["logits"], card["grads"]),
        (cpu["loss"], cpu["logits"], cpu["grads"]), cpu["taps"].mag,
        exact_zero=stale)
    # every layer's weights and weight scale and the entry scale move; an
    # s_out's surrogate gradient can be 0 in exact arithmetic (the
    # reference's is, for KWS conv0 after calibrate at reduced width), so
    # the zero ones are printed
    want_live = [f"{n}.{k}" for n in names for k in ("w", "s_w")]
    zero = [k for k in want_live + [f"{names[0]}.s_in"]
            if not bool(card["grads"][k].any())]
    if zero:
        raise AssertionError(f"{where}: zero gradients at {zero}")
    zero_out = [f"{n}.s_out" for n in names
                if not bool(card["grads"][f"{n}.s_out"].any())]
    check_flips(f"{where}: surrogate", path, add_flips({}, cpu["taps"]),
                rounding_ties=True)
    print(f"{where}: card against CPU from the card's params: loss "
          f"{float(card['loss']):.6f} (CPU {float(cpu['loss']):.6f}); entry "
          f"codes flipped {flips} of {n_entry}; integer codes differing per "
          f"layer {differ} of {n_codes}; max |logit diff| {d_logit:.3g}; "
          f"worst weight / bias gradient rel L2 {worst_w[0]:.3g} "
          f"({worst_w[1]}); "
          f"worst |diff| / M {worst_s[0]:.3g} ({worst_s[1]}); stale s_in "
          f"gradients exactly 0 on both ({len(stale)}); zero s_out "
          f"gradients {zero_out}; share of nonzero "
          "output codes per layer " + " ".join(
              f"{n}={v:.3f}" for n, v in live.items()), flush=True)
    return card["grads"]


def qat_step_counts(torch, path, ft, nz):
    """(b): one QATFinetune step with every launch counter set to 0 just
    before and read just after: K1, K3 and K3b launched QAT_LAUNCHES times
    (K2 never), each conv launch noisy (K4) under noise, each DarkNet one
    on the vector A loader. Returns (counts, noisy counts)."""
    from repro_torch import kernels
    _, counts, _ = counted(torch, kernels, lambda: ft.step(1))
    noisy = kernels.noisy_launch_counts()
    want = QAT_LAUNCHES[path]
    want_noisy = {f"{k}_noisy": (want[k] if nz else 0)
                  for k in kernels.NOISY}
    vec = loaders(kernels, path, counts)
    if counts != want or noisy != want_noisy:
        raise AssertionError(f"train_qat {path}: one step launched {counts} "
                             f"(noisy {noisy}), expected {want} (noisy "
                             f"{want_noisy})")
    print(f"kernels (train_qat {path}, one {'noisy ' if nz else ''}step): "
          + " ".join(f"{k}={v}" for k, v in counts.items()) + " noisy "
          + " ".join(f"{k}={v}" for k, v in noisy.items()) + vec,
          flush=True)
    return counts, noisy


def qat_time_step(torch, path, label, loss_fn, opt, p, batch, key, model,
                  cfg, st, names, nz, smi):
    """One QAT training step (``make_qat_train_step``) timed by
    :func:`time_step` over QAT_PROFILED profiled steps; and the device time
    of the kernels (K1, K3, K3b) in one QAT forward against the same
    ``int_apply``'s (of the same params, synced and converted)."""
    from repro_torch.core import integer_inference as ii
    from repro_torch.core.quant import QuantConfig
    from repro_torch.train import trainer
    fq = QuantConfig(2, 4, 4, fq=True)
    ip = model.convert_int(ii.sync_handoff(p, names), st, fq, cfg)
    step_fn = trainer.make_qat_train_step(
        lambda pp, b, r: loss_fn(pp, b, r)[0], opt, clip_norm=QAT_CLIP)
    ost = opt.init(p)

    def step():
        return step_fn(p, ost, batch, 0, key)

    def kernel_ms(names):
        return sum(t for n, t in names
                   if any(k in n for k in QAT_KERNEL_NAMES))
    # a profile costs seconds of host time here, so two: the step (whose
    # one QAT forward launches every K1 / K3 / K3b of it) and int_apply
    t = time_step(torch, step, reps=QAT_PROFILED)
    k_qat = kernel_ms(t.pop("names"))
    with torch.no_grad():
        k_int = kernel_ms(device_profile(
            torch, lambda: model.int_apply(ip, batch[0], fq, cfg, noise=nz,
                                           rng=key),
            reps=QAT_PROFILED, top=10 ** 6)[3])
    print(f"train_qat {path} {label}: {t.pop('line')}; K1/K3/K3b device "
          f"time in the step's QAT forward {k_qat:.5f} ms, in the same "
          f"int_apply {k_int:.5f} ms; {smi}", flush=True)
    return {"path": path, "stage": label, **t, "qat_kernel_ms": k_qat,
            "int_kernel_ms": k_int}


def qat_train_model(torch, dev, path, smi):
    """One model's deploy-QAT on the card: checks (a)-(e) of
    :func:`phase_train_qat`; returns its step-time rows and launch counts."""
    from repro_torch import tree
    from repro_torch.core import deploy_qat as dq
    from repro_torch.core import integer_inference as ii
    from repro_torch.core import prng
    from repro_torch.core.noise import NoiseConfig, TABLE7_CONDITIONS
    from repro_torch.core.quant import QuantConfig
    from repro_torch.optim import schedules, sgd
    from repro_torch.train import trainer

    fq = QuantConfig(2, 4, 4, fq=True)
    cond = TABLE7_CONDITIONS[-1]
    noise = NoiseConfig(cond.sigma_w, cond.sigma_a, cond.sigma_mac)
    clock = [time.perf_counter()]
    spent = {}

    def lap(part):
        torch.cuda.synchronize()
        now = time.perf_counter()
        spent[part] = spent.get(part, 0.0) + now - clock[0]
        clock[0] = now

    model, cfg, data, p, st, names = qat_model(torch, dev, path)
    lap("data, init, to_fq, calibrate")
    batch = TRAIN_BATCH[path]
    ip = qat_forward_is_int_apply(torch, path, model, cfg, p, st,
                                  data[0][:batch], noise)
    lap("(a) forward == int_apply")
    opt = sgd.make(schedules.constant(QAT_LR))
    rows, launches = [], {}
    for label, nz in (("clean", None), ("noisy", noise)):
        loss_fn = qat_loss(torch, model, cfg, st, nz)

        def finetune(params):
            return trainer.QATFinetune(
                lambda pp, b, r: loss_fn(pp, b, r)[0], params, opt,
                data=data, steps=QAT_STEPS, batch=batch, seed=SEED,
                clip_norm=QAT_CLIP)
        # step 0's batch and key, as QATFinetune draws them
        base = prng.PRNGKey(1000 + SEED, device=dev)
        idx = prng.randint(prng.fold_in(base, 0), (batch,), 0,
                           data[0].shape[0])
        b0 = (data[0][idx], data[1][idx])
        k0 = dq.train_step_key(base, 1)
        qat_card_vs_cpu(torch, path, label, model, cfg, p, st, b0, k0, nz,
                        names)
        lap("(c) card against CPU")
        det = torch.backends.cudnn.deterministic
        try:
            # (d) under cuDNN's deterministic algorithms: 1 + 2 steps
            # against one run of 3, bit for bit (the noisy condition)
            torch.backends.cudnn.deterministic = nz is not None
            ft = finetune(p)
            launches[label] = qat_step_counts(torch, path, ft, nz)
            ft.step(QAT_STEPS - 1)
            if nz is not None:
                again = finetune(p).run()
                same = all(torch.equal(a, b) for a, b in zip(
                    tree.leaves(ft.params), tree.leaves(again)))
                print(f"train_qat {path} {label}: QATFinetune 1 + "
                      f"{QAT_STEPS - 1} steps {'==' if same else '!='} one "
                      f"run of {QAT_STEPS}, bit for bit over "
                      f"{len(tree.leaves(again))} leaves (cudnn."
                      "deterministic)", flush=True)
                if not same:
                    raise AssertionError(f"train_qat {path}: QATFinetune "
                                         "resumed != run to the end")
        finally:
            torch.backends.cudnn.deterministic = det
        if not (ft.done and math.isfinite(ft.last_loss)):
            raise AssertionError(f"train_qat {path} {label}: finetune "
                                 f"ended at loss {ft.last_loss}")
        moved = float(sum((a - b).norm() ** 2 for a, b in zip(
            tree.leaves(ft.params), tree.leaves(p))) ** 0.5)
        print(f"train_qat {path} {label}: {QAT_STEPS} QATFinetune steps, "
              f"last loss {ft.last_loss:.6f}; params moved by {moved:.4g} "
              "(L2)", flush=True)
        if moved == 0.0:
            raise AssertionError(f"train_qat {path} {label}: params did not "
                                 "move")
        lap("(b) (d) finetune steps")
        rows.append(qat_time_step(torch, path, label, loss_fn, opt,
                                  ft.params, b0, k0, model, cfg, st, names,
                                  nz, smi))
        lap("timing and profiles")
        p = ft.params
    # (e) hot swap: the trained params synced, the deployed stack rederived
    # (extras too: the FP edges trained), served with a key == qat_apply
    synced = ii.sync_handoff(p, names)
    fresh = ip.rederive({n: synced[n] for n in names},
                        extras=model.int_extras(synced, st, cfg))
    key = prng.PRNGKey(QAT_DATA_KEY + 2, device=dev)
    x = data[0][:batch]
    with torch.no_grad():
        served = model.int_apply(fresh, x, fq, cfg, noise=noise, rng=key)
        trained = model.qat_apply(p, st, x, fq, cfg, noise=noise, rng=key)
    changed = sum(not torch.equal(fresh[n]["w_codes"], ip[n]["w_codes"])
                  for n in names)
    same = torch.equal(served, trained)
    print(f"train_qat {path}: hot swap, sync_handoff + rederive of the "
          f"trained params ({changed} of {len(names)} layers' weight codes "
          f"changed), noisy int_apply {'==' if same else '!='} qat_apply "
          "with the same key, bit for bit", flush=True)
    if not same:
        raise AssertionError(f"train_qat {path}: the hot-swapped stack "
                             "serves other logits than qat_apply")
    lap("(e) hot swap")
    print(f"train_qat {path}: seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in spent.items()), flush=True)
    return rows, launches


def phase_train_qat(torch, dev):
    """Deploy-QAT of full-width KWS and DarkNet-19 on the card."""
    smi = nvidia_smi()
    rows, launches = [], {}
    for path in ("kws", "darknet"):
        r, launches[path] = qat_train_model(torch, dev, path, smi)
        rows += r
    return {"rows": rows, "launches": launches}


# ---------------------------------------------------------------------------
# The fleet: the reference demo's incident on the card
# ---------------------------------------------------------------------------

# The schedule, fault plan and SLOs of the reference's fleet demo
# (benchmarks/fleet_demo.py): 8 clean ticks, Table 7's noisiest condition on
# KWS, 40 more ticks; 2 KWS requests a tick, 1 DarkNet request every 3rd
FLEET_PRE_TICKS = 8
FLEET_POST_TICKS = 40
FLEET_KWS_PER_TICK = 2
FLEET_DN_EVERY = 3
FLEET_PLAN = dict(seed=SEED + 13, p_flush_fail=0.15, p_stuck=0.2,
                  max_stuck_ticks=2, p_canary_corrupt=0.08, max_retries=3,
                  backoff_ticks=1)
FLEET_KWS_SLO = dict(deadline_ticks=8, max_agreement_drop=0.25,
                     canary_every=1, canary_window=4, baseline_obs=3,
                     retrain_steps_per_tick=10)
FLEET_DN_SLO = dict(deadline_ticks=8, max_agreement_drop=0.5,
                    canary_every=2, canary_window=4, baseline_obs=2)
FLEET_KWS_BATCHER = dict(max_batch=8, max_wait_ticks=1, dispatch_ahead=True,
                         max_inflight=2)
FLEET_DN_BATCHER = dict(FLEET_KWS_BATCHER, max_batch=4)
FLEET_KWS_LANES = 2
# the demo's sizes: "dry" pretrains 60 steps on 128 clips and retrains 30
# steps at batch 32; "full" 300 on 512 and 200 at 64. The phase's 120 s
# (the replay runs every retrain again) take the full set and 200 of its
# pretrain steps (~180 ms each on an H100), and the dry retrain (~490 ms a
# step: 4 noisy QAT forwards and backwards)
FLEET_SIZE = dict(pre_steps=200, ft_steps=30, n_train=512, ft_batch=32)
FLEET_PRE_LR = 0.02        # the retrain benchmark's pretrain rate
FLEET_PRE_BATCH = 64
FLEET_FT_LR = 0.01
FLEET_DRAWS = 4            # noise draws a retrain step averages
FLEET_FT_SEED = 7
FLEET_DATA_NOISE = 2.0     # make_mfcc_dataset's noise, the benchmark's
FLEET_PROBE = 64           # held-out KWS clips of the canary
FLEET_DN_PROBE = 8         # DarkNet canary images
FLEET_BUDGET_S = 120.0
# ticks of the replay profiled (the steady state after the swap)
FLEET_PROFILED_TICKS = range(40, 48)


def fleet_models(torch, dev):
    """The deployed stacks: KWS as serve_kws builds it, pretrained clean as
    the demo's ``_pretrained_kws`` does (QATFinetune to the end on a
    synthetic MFCC set, then sync_handoff + convert_int), and DarkNet-19
    from :func:`darknet_live_stack`; with the KWS finetune set, its float
    params and state, and both canary probes."""
    import numpy as np
    from repro_torch.core import integer_inference as ii
    from repro_torch.core import prng
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data import synthetic
    from repro_torch.models import darknet, kws
    from repro_torch.serve.fleet import QATFinetuneJob

    qcfg = QuantConfig(2, 4, 4, fq=True)
    cfg = kws.KWSConfig()
    names = kws.conv_names(cfg)
    params, state = kws.init(torch.Generator().manual_seed(SEED), cfg,
                             device=dev)
    params = kws.to_fq(params, state, cfg)
    for name in names:
        params[name] = {**params[name],
                        "s_out": torch.tensor(S_OUT, device=dev)}
    params = ii.sync_handoff(params, names)
    kd1, kd2 = prng.split(prng.PRNGKey(SEED + 5, device=dev))

    def clips(key, n):
        return synthetic.make_mfcc_dataset(
            key, n=n, seq_len=cfg.seq_len, n_mfcc=cfg.n_mfcc,
            num_classes=cfg.num_classes, noise=FLEET_DATA_NOISE)
    data = clips(kd1, FLEET_SIZE["n_train"])
    probe = clips(kd2, FLEET_PROBE)[0].cpu().numpy()
    t0 = time.perf_counter()
    pre = QATFinetuneJob(kws, params, state, cfg, qcfg, None, data=data,
                         steps=FLEET_SIZE["pre_steps"], lr=FLEET_PRE_LR,
                         batch=FLEET_PRE_BATCH, seed=0)
    loss = pre.step(FLEET_SIZE["pre_steps"])["loss"]
    kws_pre = pre.params
    kws_stack = kws.convert_int(ii.sync_handoff(kws_pre, names), state,
                                qcfg, cfg)
    sync(torch, dev)
    pre_s = time.perf_counter() - t0
    dcfg = darknet.DarkNetConfig()
    rng = np.random.default_rng(SEED + 3)
    calib = torch.from_numpy(rng.standard_normal(
        (DN_CALIB, DN_SIZE, DN_SIZE, dcfg.in_channels)).astype(np.float32))
    dn_stack, _ = darknet_live_stack(torch, dcfg, qcfg, calib, dev)
    dn_probe = np.random.default_rng(SEED).standard_normal(
        (FLEET_DN_PROBE, DN_SIZE, DN_SIZE, dcfg.in_channels)).astype(
            np.float32)
    print(f"fleet: KWS pretrained {FLEET_SIZE['pre_steps']} clean "
          f"QATFinetune steps (batch {FLEET_PRE_BATCH}, lr {FLEET_PRE_LR}, "
          f"{FLEET_SIZE['n_train']} clips) in {pre_s:.1f} s, last loss "
          f"{loss:.6f}", flush=True)
    return dict(qcfg=qcfg, kws=(cfg, kws_pre, state, data, probe, kws_stack),
                darknet=(dcfg, dn_probe, dn_stack))


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def fleet_build(torch, dev, models, config, trace, sink=None, clock=None):
    """The demo's ``build_fleet`` on the card: the registry rebuilt as
    recorded (the live run and ``trace.replay`` share it). ``sink``
    receives the synced params of each retrain; ``clock`` collects host
    times of the retrain steps."""
    from repro_torch.models import darknet, kws
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.fleet import (FleetRuntime, ModelSLO,
                                         QATFinetuneJob)
    trace.emit("config", **{k: v for k, v in config.items() if k != "e"})
    qcfg = models["qcfg"]
    cfg, kws_pre, state, data, probe, kws_stack = models["kws"]
    dcfg, dn_probe, dn_stack = models["darknet"]

    def factory(stack, condition):
        job = QATFinetuneJob(
            kws, kws_pre, state, cfg, qcfg, condition, data=data,
            steps=FLEET_SIZE["ft_steps"], lr=FLEET_FT_LR,
            batch=FLEET_SIZE["ft_batch"], draws=FLEET_DRAWS,
            seed=FLEET_FT_SEED, on_result=sink)
        if clock is not None:
            step, done = job.step, [0]

            def timed(n=1):
                t0 = time.perf_counter()
                out = step(n)
                sync(torch, dev)
                clock.setdefault("retrain", []).append(
                    (out["steps_done"] - done[0], time.perf_counter() - t0))
                done[0] = out["steps_done"]
                return out
            job.step = timed
        return job

    fleet = FleetRuntime(fault_plan=FaultPlan(**FLEET_PLAN), trace=trace)
    fleet.register("kws", kws_stack, lambda s: kws.int_serve_fn(s, qcfg, cfg),
                   slo=ModelSLO(**FLEET_KWS_SLO), probe=probe,
                   canary_seed=SEED + 31, finetune_factory=factory,
                   batcher_kw=FLEET_KWS_BATCHER, n_replicas=FLEET_KWS_LANES)
    fleet.register("darknet", dn_stack,
                   lambda s: darknet.int_serve_fn(s, qcfg, dcfg),
                   slo=ModelSLO(**FLEET_DN_SLO), probe=dn_probe,
                   canary_seed=SEED + 47, batcher_kw=FLEET_DN_BATCHER)
    fleet.shapes = {"kws": (cfg.seq_len, cfg.n_mfcc),
                    "darknet": (DN_SIZE, DN_SIZE, dcfg.in_channels)}
    return fleet


def fleet_drive(fleet, tick):
    """The demo's recorded schedule: steady traffic, the drift at a fixed
    tick; ``tick()`` runs (and times) one ``fleet.tick``."""
    from repro_torch.core.noise import TABLE7_CONDITIONS
    from repro_torch.serve.fleet import RequestSpec
    rid = {"kws": 0, "darknet": 10_000}

    def arrive(model, n):
        fleet.submit(model, [RequestSpec(rid=rid[model] + i, seed=SEED + 3,
                                         shape=fleet.shapes[model])
                             for i in range(n)])
        rid[model] += n

    for t in range(FLEET_PRE_TICKS):
        arrive("kws", FLEET_KWS_PER_TICK)
        if t % FLEET_DN_EVERY == 0:
            arrive("darknet", 1)
        tick()
    cond = TABLE7_CONDITIONS[-1]
    fleet.set_condition("kws", (cond.sigma_w, cond.sigma_a, cond.sigma_mac))
    for t in range(FLEET_POST_TICKS):
        arrive("kws", FLEET_KWS_PER_TICK)
        if t % FLEET_DN_EVERY == 0:
            arrive("darknet", 1)
        tick()
    fleet.drain()


def canary_medians(trace):
    """The demo's ``_canary_medians``: pre-drift / pre-swap / post-swap KWS
    canary medians, corrupted observations excluded."""
    import numpy as np
    drift_tick = trace.of_type("set-condition")[0]["tick"]
    swaps = trace.of_type("swap")
    swap_tick = swaps[0]["tick"] if swaps else None
    eras = {"pre_drift": [], "drifted": [], "post_swap": []}
    for c in trace.of_type("canary"):
        if c["model"] != "kws" or c["corrupted"]:
            continue
        if c["tick"] < drift_tick:
            eras["pre_drift"].append(c["agreement"])
        elif swap_tick is None or c["tick"] < swap_tick:
            eras["drifted"].append(c["agreement"])
        else:
            eras["post_swap"].append(c["agreement"])
    return {k: (round(float(np.median(v)), 4) if v else None)
            for k, v in eras.items()}


def fleet_timers(torch, dev, fleet, clock):
    """Host times (with a device sync) of each canary, noisy or clean, of
    each install (rederive, swap_apply_fn, canary rebuild) and of the KWS
    batcher's captures, tick-stamped."""
    canary, install = fleet._canary, fleet._install

    def timed_canary(m):
        kind = "noisy" if m.noisy_fn is not None else "clean"
        t0 = time.perf_counter()
        canary(m)
        sync(torch, dev)
        clock.setdefault(f"canary {m.name} {kind}", []).append(
            time.perf_counter() - t0)

    def timed_install(m):
        t0 = time.perf_counter()
        install(m)
        sync(torch, dev)
        clock.setdefault("install", []).append(
            (fleet._tick, time.perf_counter() - t0))

    fleet._canary, fleet._install = timed_canary, timed_install
    batcher = fleet._model("kws").batcher
    capture = batcher._capture

    def timed_capture(lane, x):
        t0 = time.perf_counter()
        g = capture(lane, x)
        sync(torch, dev)
        clock.setdefault("capture", []).append(
            (fleet._tick, time.perf_counter() - t0))
        return g
    batcher._capture = timed_capture


def phase_fleet(torch, dev):
    """The fleet control plane on the card: the reference demo's incident
    (canary breach -> background deploy-QAT retrain -> hot-swap, under
    injected faults) over full-width KWS (2 lanes) and DarkNet-19 at
    224 x 224, then ``trace.replay`` of it; see the module docstring."""
    from repro_torch import kernels
    from repro_torch.serve import trace as trace_mod

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # the retrain must replay
    try:
        models = fleet_models(torch, dev)
        config = dict(seed=SEED, plan=FLEET_PLAN, size=FLEET_SIZE)
        trace, synced, clock = trace_mod.Trace(), [], {}
        fleet = fleet_build(torch, dev, models, config, trace, synced.append,
                            clock)
        fleet_timers(torch, dev, fleet, clock)
        ticks = []

        def tick():
            t0 = time.perf_counter()
            fleet.tick()
            ticks.append(time.perf_counter() - t0)
            if len(ticks) % 8 == 0:
                print(f"fleet: tick {len(ticks)}, "
                      f"{time.perf_counter() - t_phase:.1f} s into the "
                      "phase", flush=True)
        sync(torch, dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fleet_drive(fleet, tick)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        noisy = kernels.noisy_launch_counts()
        problems = fleet_report(torch, dev, fleet, trace, models, synced,
                                clock, ticks, wall, counts, noisy, smi)
        t_live = time.perf_counter() - t_phase
        report, replay_s, samples = fleet_replay(torch, dev, trace, models)
    finally:
        torch.backends.cudnn.deterministic = det
    print(f"fleet replay: {report.summary()} in {replay_s:.2f} s, two "
          "samples profiled", flush=True)
    # the busy share over the incident, from the two profiled samples: a
    # tick's serving and canaries at the steady state's busy seconds, and
    # each retrain step at the sampled step's, over the live incident's
    # wall time
    t_busy, t_wall, n_ticks = samples.get("ticks", (0.0, 0.0, 0))
    s_busy, s_wall, _ = samples.get("retrain step", (0.0, 0.0, 0))
    steps_run = sum(n for n, _ in clock.get("retrain", []))
    print(f"fleet busy ({smi}): steady-state ticks {t_busy / t_wall:.4f} "
          f"({1e3 * t_busy / n_ticks:.3f} of {1e3 * t_wall / n_ticks:.3f} "
          f"ms a tick over {n_ticks}), a retrain step {s_busy / s_wall:.4f} "
          f"({1e3 * s_busy:.3f} of {1e3 * s_wall:.3f} ms); over the "
          f"incident, weighting those by its {len(ticks)} ticks and "
          f"{steps_run} retrain steps: "
          f"{(t_busy / n_ticks * len(ticks) + s_busy * steps_run) / wall:.4f}"
          " (profiled in the replay)", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"fleet: phase {phase_s:.1f} s (set-up and live incident "
          f"{t_live:.1f} s, replay {replay_s:.1f} s)", flush=True)
    if not report.bit_exact:
        problems.append(report.summary())
    if phase_s > FLEET_BUDGET_S:
        problems.append(f"the phase took {phase_s:.1f} s > {FLEET_BUDGET_S}")
    if problems:
        raise AssertionError("fleet: " + "; ".join(problems))
    return {"counts": counts, "noisy": noisy}


def fleet_replay(torch, dev, trace, models):
    """``trace.replay`` of the incident on the card, with two samples
    profiled (device events only; a whole incident is ~10^5 of them, too
    many to profile in the phase's budget): FLEET_PROFILED_TICKS of the
    steady state after the swap, and the first retrain step (a job's first
    ``step(n)`` runs as ``step(1)`` profiled, then ``step(n - 1)``: the
    finetune's schedule is a pure function of the step index, so the
    replay stays bit-exact). Returns (report, seconds, {sample: (device
    busy s, wall s, ticks or steps)})."""
    from repro_torch.serve import trace as trace_mod
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    samples = {}

    def profiled(key, fn, n):
        sync(torch, dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            sync(torch, dev)
            wall = time.perf_counter() - t0
        busy = sum(e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e6
        b, w, k = samples.get(key, (0.0, 0.0, 0))
        samples[key] = (b + busy, w + wall, k + n)
        return out

    def build(cfg, fresh):
        fleet = fleet_build(torch, dev, models, cfg, fresh)
        tick, factory = fleet.tick, fleet._model("kws").finetune_factory

        def sampled_tick():
            if fleet._tick in FLEET_PROFILED_TICKS:
                return profiled("ticks", tick, 1)
            return tick()

        def sampled_factory(stack, condition):
            job = factory(stack, condition)
            step = job.step

            def first_step_profiled(n=1):
                if "retrain step" in samples or n < 1:
                    return step(n)
                out = profiled("retrain step", lambda: step(1), 1)
                return step(n - 1) if n > 1 else out
            job.step = first_step_profiled
            return job
        fleet.tick = sampled_tick
        fleet._model("kws").finetune_factory = sampled_factory
        return fleet

    t0 = time.perf_counter()
    report = trace_mod.replay(trace, build)
    sync(torch, dev)
    return report, time.perf_counter() - t0, samples


def fleet_report(torch, dev, fleet, trace, models, synced, clock, ticks,
                 wall, counts, noisy, smi):
    """Print the live incident's lines; return the checks that failed."""
    from repro_torch.core import integer_inference as ii
    from repro_torch.models import kws
    audits = {name: fleet.audit(name) for name in fleet.models}
    stats = fleet.stats()
    breaches = trace.of_type("breach")
    swaps = trace.of_type("swap")
    retrains = trace.of_type("retrain")
    for name, a in audits.items():
        print(f"fleet {name}: {a['served']} of {a['n']} served, {a['shed']} "
              f"shed {a['shed_codes']}, lost {a['lost']}, exactly once "
              f"{a['exactly_once']}, within SLO {a['within_slo']}; flush "
              f"faults {stats[name]['flush_faults']}, retries "
              f"{stats[name]['retries']}, stuck {stats[name]['stuck_flushes']}"
              f", generation {stats[name]['generation']}", flush=True)
    print(f"fleet: {len(trace)} events; breach ticks "
          f"{[(e['model'], e['tick']) for e in breaches]}; retrain ticks "
          f"{[e['tick'] for e in retrains]} (last loss "
          f"{retrains[-1]['loss'] if retrains else None}); swap ticks "
          f"{[e['tick'] for e in swaps]}; KWS generations "
          f"{stats['kws']['generation']}; KWS canary medians "
          f"{canary_medians(trace)}", flush=True)
    faults = sum(stats[name]["flush_faults"] for name in fleet.models)

    # -- the first swapped stack against the CPU's rederive ----------------
    cfg, _, state, _, _, kws_stack = models["kws"]
    digest_ok = None
    if swaps and synced:
        cpu = ii.to_device(synced[0], "cpu")
        names = kws.conv_names(cfg)
        again = kws_stack.to("cpu").rederive(
            {n: cpu[n] for n in names},
            extras=kws.int_extras(cpu, ii.to_device(state, "cpu"), cfg))
        digest_ok = ii.stack_digest(again) == swaps[0]["stack"]
        print(f"fleet: first swapped stack digest {swaps[0]['stack']}, the "
              f"CPU's rederive of the same synced params "
              f"{ii.stack_digest(again)}: "
              f"{'equal' if digest_ok else 'DIFFERENT'}", flush=True)

    # -- graph replays, launches -------------------------------------------
    steps = {name: fleet._model(name).batcher.step_stats
             for name in fleet.models}
    for name, st in steps.items():
        print(f"fleet {name} flushes: {stats[name]['flushes']} "
              f"({st['graph_flushes']} graph replays, {st['eager_flushes']} "
              f"eager), {st['captures']} captures in {st['capture_s']:.2f} s, "
              f"graphs alive per lane {st['graphs']}", flush=True)
    print("kernels (fleet): " + " ".join(f"{k}={v}" for k, v in counts.items())
          + " noisy " + " ".join(f"{k}={v}" for k, v in noisy.items()),
          flush=True)

    # -- times -------------------------------------------------------------
    served = sum(a["served"] for a in audits.values())

    def mean_ms(xs):
        return f"{1e3 * sum(xs) / len(xs):.4f}" if xs else "none"
    retrain = clock.get("retrain", [])
    n_run = sum(n for n, _ in retrain)
    step_ms = (f"{1e3 * sum(t for _, t in retrain) / n_run:.4f}" if n_run
               else "none")
    captures = clock.get("capture", [])
    swap_ms = []
    for tick_no, s in clock.get("install", []):
        after = [c for t, c in captures if t >= tick_no]
        swap_ms.append(s + (after[0] if after else 0.0))
    print(f"fleet times ({smi}): {served} requests in {wall:.3f} s, "
          f"{served / wall:.2f} requests/s over the incident; mean ms of a "
          f"tick {mean_ms(ticks)} (of {len(ticks)}), a noisy KWS canary "
          f"{mean_ms(clock.get('canary kws noisy', []))}, a clean KWS canary "
          f"{mean_ms(clock.get('canary kws clean', []))}, a DarkNet canary "
          f"{mean_ms(clock.get('canary darknet clean', []))}, a retrain step "
          f"{step_ms} (batch "
          f"{FLEET_SIZE['ft_batch']}, {FLEET_DRAWS} draws), a swap (rederive "
          f"+ first capture) {mean_ms(swap_ms)}; host clock, each timed part "
          "ends in a device sync", flush=True)

    # -- checks ------------------------------------------------------------
    problems = []
    for name, a in audits.items():
        if not (a["exactly_once"] and a["within_slo"] and a["lost"] == 0):
            problems.append(f"{name} audit {a}")
    if not (breaches and breaches[0]["model"] == "kws"
            and breaches[0]["tick"] >= FLEET_PRE_TICKS):
        problems.append(f"no KWS breach after the drift: {breaches}")
    if not (trace.of_type("retrain-start") and retrains):
        problems.append("no QATFinetuneJob ran")
    if not (swaps and breaches and swaps[0]["tick"] > breaches[0]["tick"]):
        problems.append(f"no swap after the breach: {swaps}")
    if faults == 0:
        problems.append("no flush fault fired")
    if digest_ok is not True:
        problems.append("the swapped stack's digest is not the CPU "
                        "rederive's")
    if torch.device(dev).type == "cuda":
        for name, st in steps.items():
            if st["eager_flushes"] or \
                    st["graph_flushes"] != stats[name]["flushes"]:
                problems.append(f"{name}: not every clean flush replayed a "
                                f"graph {st}")
        if not (counts["quantize_codes"] and counts["fq_conv2d"]
                and counts["fq_conv2d_pool"] and noisy["fq_conv2d_noisy"]) \
                or counts["fq_matmul"]:
            problems.append(f"fleet launches {counts} noisy {noisy}: K1, "
                            "K3, K3b and K4 must launch and K2 not")
    return problems


# ---------------------------------------------------------------------------
# analysis: the static verifier (python -m repro_torch.analysis) on the card
# ---------------------------------------------------------------------------

ANALYSIS_BUDGET_S = 120.0
ANALYSIS_JOBS = 7          # trace processes (the host has 8 cores)
ANALYSIS_TRACES = 36       # 4 conv stacks x 2 impls x (clean + 3 mac_chunks)
                           # + the LM's clean + 3
# kernel nodes a trace of each full-size core must hold: one a kernel call
ANALYSIS_NODES = {("kws", "fused"): {"fq_conv2d": 7},
                  ("kws", "im2col"): {"fq_matmul": 7},
                  ("darknet", "fused"): {"fq_conv2d": 13,
                                         "fq_conv2d_pool": 4},
                  ("darknet", "im2col"): {"fq_matmul": 17},
                  ("lm", "int8"): {"fq_matmul": 24}}
# the reduced cores traced on the card and on the CPU: (target function,
# its arguments, impls, mac_chunks)
ANALYSIS_SAME_GRAPHS = (
    ("kws_target", {}, ("fused",), (1,)),
    ("kws_target", {}, ("im2col",), ()),
    ("kws_target", {"weight_format": "auto"}, ("fused", "im2col"), ()),
    ("lm_target", {}, ("int8",), ()))


def call_targets(gm) -> list:
    return [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]


def phase_analysis(torch, dev):
    """The static quantization-contract verifier on the card, run last so
    that the serve-time table misses of every earlier phase are in its
    counters: ``python -m repro_torch.analysis --device cuda`` in process
    (its traces in ANALYSIS_JOBS processes) over the five full-size
    default targets, both impls and mac_chunks 1, 4 and 16. It fails unless
    the command exits 0 with no finding at or above a warning (the table's
    policy rows are info) and nothing suppressed, every trace proves, each
    core's trace holds one kernel node a kernel call (ANALYSIS_NODES), no
    earlier (eager) phase entered a kernel operator, the reduced KWS and LM
    cores traced on the card hold the calls of their CPU traces in the same
    order, and the phase takes at most ANALYSIS_BUDGET_S."""
    import tempfile

    from repro_torch.analysis import intlint, targets
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.kernels import library

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    calls = dict(library.op_calls)
    print(f"analysis: kernel operator calls of the eager phases: {calls}",
          flush=True)
    if any(calls.values()):
        raise AssertionError(f"an eager phase entered a kernel operator: "
                             f"{calls}")
    if targets.DEFAULT_SUPPRESSIONS:
        raise AssertionError("analysis: DEFAULT_SUPPRESSIONS is not empty")
    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "analysis.json")
        t0 = time.perf_counter()
        rc = analysis_main(["--device", "cuda", "--json", path, "--jobs",
                            str(ANALYSIS_JOBS)], figures=figures)
        cli_s = time.perf_counter() - t0
        with open(path) as f:
            report = json.load(f)
    summary = report["summary"]
    print(f"analysis: the command exited {rc} in {cli_s:.1f} s: "
          f"{json.dumps(summary)}", flush=True)
    problems = []
    if rc != 0:
        problems.append(f"the command exited {rc}")
    loud = [f for f in report["findings"] if f["severity"] != "info"]
    quiet = [f for f in report["findings"] if f["severity"] == "info"]
    if loud or summary["suppressed"]:
        problems.append(f"{len(loud)} findings at or above a warning, "
                        f"{summary['suppressed']} suppressed")
    if any(f["check"] != "kernellint/table-schema"
           or "policy" not in f["details"] for f in quiet):
        problems.append("an info finding other than the table's policy rows")
    proved = {p["subject"] for p in report["proofs"]
              if p["check"] == "intlint"}
    if len(figures) != ANALYSIS_TRACES or proved != set(figures):
        problems.append(f"{len(proved)} traces proved of {len(figures)} "
                        f"(want {ANALYSIS_TRACES})")
    for subject, fig in figures.items():
        base, impl = subject.split("/")[0].split("-")[0], \
            subject.split("/")[1]
        want = ANALYSIS_NODES[(base, impl)]
        ok = fig["kernel_nodes"] == want
        state = "proved" if subject in proved else "NOT proved"
        print(f"analysis {subject}: {state}; "
              f"{fig['contractions']} contractions, largest bound "
              f"{fig['max_int_bound']:.0f}, int32 headroom "
              f"{fig['int32_headroom']:.6f}; {fig['nodes']} nodes, kernel "
              f"nodes {fig['kernel_nodes']}{'' if ok else f' (want {want})'}",
              flush=True)
        if not ok:
            problems.append(f"{subject}: kernel nodes {fig['kernel_nodes']}")
    host = sum(fig["seconds"] for fig in figures.values())
    print(f"analysis: {len(figures)} traces, "
          f"{sum(fig['nodes'] for fig in figures.values())} fx nodes, "
          f"{host:.1f} s of trace-process time in {cli_s:.1f} s",
          flush=True)
    misses = {k: v for k, v in report["counters"].items()
              if k.startswith("kernellint/runtime-miss")}
    print(f"analysis: serve-time table misses of the whole run: "
          f"{misses or 'none'}", flush=True)

    # the graphs do not depend on the device: the reduced cores, traced on
    # the card and on the CPU, call the same operators in the same order
    t0 = time.perf_counter()
    for make, kw, impls, chunks in ANALYSIS_SAME_GRAPHS:
        pair = [targets.core_traces(getattr(targets, make)(
            reduced=True, device=d, **kw), impls=impls, mac_chunks=chunks)
            for d in (dev, "cpu")]
        for card, cpu in zip(*pair):
            a = call_targets(intlint.trace(card.fn, card.example_args))
            b = call_targets(intlint.trace(cpu.fn, cpu.example_args))
            same = "hold the same" if a == b else "DIFFER in their"
            print(f"analysis {card.subject}: card and CPU graphs {same} "
                  f"{len(a)} calls", flush=True)
            if a != b:
                problems.append(f"{card.subject}: the card's graph is not "
                                "the CPU's")
    print(f"analysis: card against CPU graphs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"analysis: phase {secs:.1f} s (budget {ANALYSIS_BUDGET_S:.0f} s; "
          f"the command {cli_s:.1f} s, {ANALYSIS_JOBS} trace processes) on "
          f"{smi}", flush=True)
    if secs > ANALYSIS_BUDGET_S:
        problems.append(f"the phase took {secs:.1f} s > {ANALYSIS_BUDGET_S}")
    if problems:
        raise AssertionError("analysis: " + "; ".join(problems))
    return {"seconds": secs, "figures": figures, "summary": summary}


def kernels_record(rows, counts, batch, per_apply, names=None,
                   weight=lambda name, r: 1):
    """One entry per kernel of one path (or per kernel in ``names``): the
    work of one int_apply at request batch ``batch`` (``per_apply`` picks
    the rows one call runs, ``weight`` how many calls of a row's shape it
    makes), summed, with the launches of that path's counted run."""
    out = []
    for name in names or rows.rows:
        all_rows = rows.rows[name]
        top = [(r, weight(name, r)) for r in all_rows
               if r["batch"] == batch and per_apply(name, r)]

        def total(key):
            return sum(w * r[key] for r, w in top)
        work = {}
        for r, w in top:
            for kind, n in r["work"].items():
                work[kind] = work.get(kind, 0) + w * n
        bound_ms, bound_by = bound(total("bytes"), work)
        libs = [r["library_ms"] for r, _ in top]
        base, fmt, chunks = variant(name)
        replaces = (NOISE_REPLACES if chunks else
                    REPLACES if fmt == "int8" else PACKED_REPLACES)[base]
        entry = {
            "name": name, "path": rows.path, "route": "cuda",
            "source": SOURCES[base], "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(max(r["err"] for r in all_rows),
                               rows.extra_err.get(name, 0.0)),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": (None if any(v is None for v in libs)
                           else total("library_ms")),
            "eager_ms": total("eager_ms"),
            "batch": batch, "calls": sum(w for _, w in top),
        }
        if base in TC_KERNELS:
            entry.update(loop=TC_LOOP, loaders=sorted(
                {r["loader"] for r, _ in top}))
        if fmt != "int8":
            entry["prologue"] = TC_LOOP
        if chunks:
            entry.update(epilogue=NOISE_EPILOGUE, mac_chunks=chunks,
                         clean_ms=total("clean_ms"))
        elif fmt != "int8":
            entry["int8_ms"] = total("int8_ms")
        out.append(entry)
    return out


def kernels_record_all(torch, results):
    """The ``{"kernels": [...]}`` entries of every path and kernel."""
    # int_apply(impl="fused") runs K3 on the unpooled layers and K3b on the
    # pooled ones; impl="im2col" runs K2 on every layer
    pooled = {r["layer"] for r in results["kernels_darknet"].rows[
        "fq_conv2d_pool"]}

    def per_apply(name, r):
        return base_kernel(name) != "fq_conv2d" or r["layer"] not in pooled

    record = kernels_record(results["kernels_kws"],
                            results["serve_kws"]["int8"], rows_batch("kws"),
                            lambda name, r: True)
    record += kernels_record(results["kernels_darknet"],
                             results["serve_darknet"]["int8"],
                             rows_batch("darknet"), per_apply)
    # K3's split-K: the unpooled convs the policy splits at the record
    # batch, launches from the same counted run
    record += kernels_record(results["kernels_split"],
                             results["serve_darknet"]["split"],
                             rows_batch("darknet"), per_apply)
    # K5: the packed K3 / K3b the serving paths launch, each format's
    # launches from its own counted run. Packed K2 is off those paths (the
    # im2col oracle unpacks first): its sums are printed, not recorded.
    off_path = []
    for path in ("kws", "darknet"):
        rows, batch = results["kernels_packed"][path], rows_batch(path)
        for fmt in PACKED_FORMATS:
            for e in kernels_record(
                    rows, results[f"serve_{path}"][fmt], batch, per_apply,
                    [k for k in rows.rows if k.endswith("_" + fmt)]):
                on = e["name"] in PACKED_PATH_KERNELS[path]
                (record if on else off_path).append(e)
    # K4: the noisy kernels the serving paths launch, each (format, chunks)
    # with the launches of its own counted run; packed noisy K2 is off the
    # paths like packed K2
    for path in ("kws", "darknet"):
        rows = results["kernels_noise"][path]
        launched = results[f"serve_{path}"]["noisy"]
        for e in kernels_record(rows, dict.fromkeys(rows.rows, 0) | launched,
                                rows_batch(path), per_apply):
            (record if e["name"] in launched else off_path).append(e)
    # deploy-QAT: the kernels one training step launches (K1, K3, K3b; K4
    # in the noisy steps, at mac_chunks 1), at the shapes of the record
    # batches, which are the training batches
    for path in ("kws", "darknet"):
        counts, _ = results["train_qat"]["launches"][path]["clean"]
        entries = kernels_record(
            results[f"kernels_{path}"], counts, rows_batch(path),
            per_apply if path == "darknet" else (lambda name, r: True),
            [k for k, v in counts.items() if v])
        _, noisy = results["train_qat"]["launches"][path]["noisy"]
        launched = {noisy_name(k[:-len("_noisy")], "int8", 1): v
                    for k, v in noisy.items() if v}
        entries += kernels_record(results["kernels_noise"][path], launched,
                                  rows_batch(path), per_apply,
                                  list(launched))
        for e in entries:
            e["path"] = f"train_qat_{path}"
        record += entries
    # the fleet: the kernels its incident launched (K1, K3 and, in the noisy
    # canaries and retrain steps, K4 on KWS; K1, K3 and K3b on DarkNet), with
    # the launches of the live incident, times per int_apply from the serve
    # paths' rows (K3b: DarkNet's)
    fl = results["fleet"]
    entries = kernels_record(
        results["kernels_kws"], fl["counts"], rows_batch("kws"),
        lambda name, r: True,
        [k for k in ("quantize_codes", "fq_conv2d") if fl["counts"][k]])
    entries += kernels_record(
        results["kernels_darknet"], fl["counts"], rows_batch("darknet"),
        per_apply, [k for k in ("fq_conv2d_pool",) if fl["counts"][k]])
    launched = {noisy_name(k[:-len("_noisy")], "int8", 1): v
                for k, v in fl["noisy"].items() if v}
    entries += kernels_record(results["kernels_noise"]["kws"], launched,
                              rows_batch("kws"), lambda name, r: True,
                              list(launched))
    for e in entries:
        e["path"] = "fleet"
    record += entries
    # the integer LM: one decode step of LM_RECORD_SLOTS slots (K1 once, K2
    # 6 a layer at its (K, N) mix, the island once a layer; the noisy K2 of
    # the noisy integer cores), the launches of the counted batcher run at
    # those slots
    lm = results["serve_lm"]
    layers = lm["n_layers"]

    def lm_calls(name, r):
        if name == "quantize_codes":
            return 1
        return layers * (1 if name == "lm_island" else LM_KN[r["shape"][1:]])
    record += kernels_record(lm["rows"], lm["counts"] | lm["noisy"],
                             LM_RECORD_SLOTS, lambda name, r: True,
                             weight=lm_calls)
    # the tensor-core loop's off-path edge rows (kernels_tc) and K1's edges
    # (kernels_k1) count too
    for e in record + off_path:
        e["max_abs_err"] = max(e["max_abs_err"],
                               results["kernels_tc"].get(e["name"], 0.0))
        if e["name"] == "quantize_codes":
            e["max_abs_err"] = max(e["max_abs_err"],
                                   results["kernels_k1"]["extra_err"])
        if e["name"] in ("quantize_codes", "lm_island"):
            e["launch_floor_ms"] = min(
                ms for _, ms in results["kernels_k1"]["floor"].values())
    print("packed K2 per int_apply (clean and noisy), launched by no serving "
          "path and so not in the record: " + json.dumps(off_path),
          flush=True)
    # the same sums at every request batch, a measurement beside the record
    for path, batches in (("kws", BATCHES), ("darknet", DN_BATCHES)):
        for batch in batches:
            sums = []
            for rows in (results[f"kernels_{path}"],
                         results["kernels_packed"][path],
                         results["kernels_noise"][path]):
                for name in rows.rows:
                    top = [r for r in rows.rows[name]
                           if r["batch"] == batch and per_apply(name, r)]
                    if not top:
                        continue
                    twin = ""
                    for key, label in (("int8_ms", "int8"),
                                       ("clean_ms", "clean")):
                        if key in top[0]:
                            twin = (f" ({label} "
                                    f"{sum(r[key] for r in top):.5f})")
                    sums.append(f"{name}={sum(r['ms'] for r in top):.5f}"
                                + twin)
            print(f"device ms per int_apply, {path} B={batch}: "
                  + " ".join(sums), flush=True)
    print(f"kernels record: launches from each path's counted serve run "
          f"(packed kernels: that format's run; train_qat_<model>: one "
          f"training step, clean or noisy; fleet: the live incident); "
          f"times per int_apply, KWS at request batch {max(BATCHES)}, "
          f"DarkNet at {max(DN_BATCHES)} "
          f"(quantize_codes once, fq_matmul once per conv, fq_conv2d once per "
          f"unpooled conv and fq_conv2d_pool once per pooled conv, summed)")
    return record


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
    t_start = time.perf_counter()
    for name, phase in (
            ("build", lambda: phase_build(torch)),
            ("kernels_kws", lambda: phase_kernels_kws(torch, dev)),
            ("kernels_darknet", lambda: phase_kernels_darknet(torch, dev)),
            ("kernels_k1", lambda: phase_kernels_k1(torch, dev)),
            ("kernels_split", lambda: phase_kernels_split(torch, dev)),
            ("kernels_packed", lambda: phase_kernels_packed(torch, dev)),
            ("kernels_noise", lambda: phase_kernels_noise(torch, dev)),
            ("kernels_tc", lambda: phase_kernels_tc(torch, dev)),
            ("serve_kws", lambda: phase_serve_kws(torch, dev)),
            ("serve_darknet", lambda: phase_serve_darknet(torch, dev)),
            ("serve_batcher", lambda: phase_serve_batcher(torch, dev)),
            ("serve_lm", lambda: phase_serve_lm(torch, dev)),
            ("serve_transformer",
             lambda: phase_serve_transformer(torch, dev)),
            ("train_transformer",
             lambda: phase_train_transformer(torch, dev)),
            ("train_fq", lambda: phase_train_fq(torch, dev)),
            ("train_qat", lambda: phase_train_qat(torch, dev)),
            ("fleet", lambda: phase_fleet(torch, dev)),
            ("analysis", lambda: phase_analysis(torch, dev))):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            results[name] = phase()
            torch.cuda.synchronize()
        except Exception:  # report every phase, then fail as a whole
            for f in (sys.stdout, sys.stderr):
                traceback.print_exc(file=f)
                f.flush()
            failed.append(name)
            if name == "build":
                break
        print(f"== phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phases: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    if failed:
        fail(f"phases failed: {', '.join(failed)}")

    for path, phase in (("kws", "serve_kws"), ("darknet", "serve_darknet")):
        counts = results[phase]
        missing = [k for k in PATH_KERNELS[path] if counts["int8"][k] == 0]
        missing += [k for k in PACKED_PATH_KERNELS[path]
                    if counts[k.rsplit("_", 1)[1]][k] == 0]
        missing += [noisy_name(k, f, c) for k in PATH_KERNELS[path]
                    if k in NOISE_REPLACES
                    for f in ("int8",) + PACKED_FORMATS for c in CHUNKS
                    if (k != "fq_matmul" or f == "int8")
                    and not counts["noisy"].get(noisy_name(k, f, c))]
        launches = results["train_qat"]["launches"][path]
        missing += [f"train_qat {k}" for k in PATH_KERNELS[path]
                    if k != "fq_matmul" and not launches["clean"][0][k]]
        missing += [f"train_qat {k}_noisy" for k in PATH_KERNELS[path]
                    if k in NOISE_REPLACES and k != "fq_matmul"
                    and not launches["noisy"][1][f"{k}_noisy"]]
        if path == "darknet":
            missing += [k for k, v in results["serve_darknet"]["split"]
                        .items() if not v]
        if missing:
            fail(f"kernels never launched on the {path} path: {missing}")
    fl = results["fleet"]
    missing = [k for k in PATH_KERNELS["darknet"]
               if k != "fq_matmul" and not fl["counts"][k]]
    missing += [k for k in ("fq_conv2d_noisy",) if not fl["noisy"][k]]
    if missing:
        fail(f"kernels never launched on the fleet path: {missing}")
    lm = results["serve_lm"]
    missing = [k for k in ("quantize_codes", "fq_matmul", "lm_island")
               if not lm["counts"][k]]
    missing += [noisy_name("fq_matmul", "int8", c) for c in CHUNKS
                if not lm["noisy"].get(noisy_name("fq_matmul", "int8", c))]
    if missing:
        fail(f"kernels never launched on the lm path: {missing}")
    print(json.dumps({"kernels": kernels_record_all(torch, results)}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
