"""FQ transformer LM: fully quantized decode with an int8 code-domain KV cache.

Counterpart of ``repro.models.fq_lm``: the paper's recipe on a residual-add
DAG instead of a chain.

  * every attention / MLP projection is an FQ linear run integer-in /
    integer-out through ``integer_inference.int_linear`` -> K2
    (``kernels.fq_matmul``) with the requant epilogue, on signed codes
    (``a_lo = -n_a``; the ReLU'd ``up`` output feeds ``down`` at 0);
  * the residual stream lives at one common scale (``wq0.s_in``): each
    branch rejoining it requantizes onto that scale in its last
    projection's epilogue, so a residual add is a saturating code add
    (``integer_inference.int_residual_add``). The ties are the
    ``handoff_edges`` of the stack;
  * the KV cache holds int8 codes: quantize-then-append equals
    append-then-quantize, since quantization is elementwise;
  * attention is a float island between two integer segments: the
    ``kernels.lm_island`` kernel dequantizes Q and the cache, attends over
    the keys at or before each query's position in one fixed order over
    the cache's slots, and requantizes the context through ``wo``'s input
    quantizer (``island_s_in``) into int8 codes. The order does not depend
    on the shape of the call, so a prefill of T tokens and a decode step
    equal a prefill of T + 1 bit for bit.

``apply`` is the float FQ forward (training, noise); ``int_prefill`` /
``int_decode_step`` the integer deployment forward over a
:class:`~repro_torch.core.integer_inference.ConvertedStack`; ``serve_fns``
feeds them to ``serve.batching.ContinuousBatcher``. Entry codes go through
K1 once a forward, the 6 x n_layers projections through K2, the island once
a layer. The float forward's matmuls run with TF32 off, whatever the
caller's global setting; the integer path's FP head sums in float64.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import torch

from ..core import fq_layers as fql
from ..core import integer_inference as ii
from ..core import prng, quant
from ..core.noise import NoiseConfig
from ..core.quant import (QuantConfig, RELU_BOUND, WEIGHT_BOUND,
                          learned_quantize, n_levels)
from ..device import DeviceLike, resolve_device
from ..kernels import ref
from ..kernels.lm_island import lm_island, sqrt_head


@dataclasses.dataclass(frozen=True)
class FQLMConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 2
    n_layers: int = 4
    d_ff: int = 128
    max_seq: int = 128

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def reduced(cls) -> "FQLMConfig":
        return cls(vocab=64, d_model=32, n_heads=4, n_kv_heads=2,
                   n_layers=2, d_ff=64, max_seq=64)


# Stream codes share a denominator across the residual add (bits_a ==
# bits_out).
LM_QCFG = QuantConfig(8, 8, 8, fq=True)

# Projection kinds per block, in forward (= noise key) order.
_KINDS = ("wq", "wk", "wv", "wo", "up", "down")


def proj_names(cfg: FQLMConfig) -> List[str]:
    return [f"{k}{i}" for i in range(cfg.n_layers) for k in _KINDS]


def layer_specs(cfg: FQLMConfig):
    """Requant epilogues everywhere (the output decodes through
    ``s_out_last`` and the FP head); only ``up`` is a quantized ReLU."""
    return [ii.LayerSpec(name=f"{k}{i}", relu_out=(k == "up"), final=False)
            for i in range(cfg.n_layers) for k in _KINDS]


def handoff_edges(cfg: FQLMConfig):
    """Scale-tie edges of the residual-add DAG, topologically ordered: per
    layer the QKV projections read the stream (s_in ties), ``wo`` and
    ``down`` requantize onto it (s_out ties), ``up -> down`` is a chain
    hand-off; layer i > 0's stream is layer i - 1's ``down`` output."""
    edges = []
    for i in range(cfg.n_layers):
        if i > 0:
            edges.append((f"down{i - 1}", "s_out", f"wq{i}", "s_in"))
        for k in ("wk", "wv"):
            edges.append((f"wq{i}", "s_in", f"{k}{i}", "s_in"))
        edges.append((f"wq{i}", "s_in", f"wo{i}", "s_out"))
        edges.append((f"wq{i}", "s_in", f"up{i}", "s_in"))
        edges.append((f"wq{i}", "s_in", f"down{i}", "s_out"))
        edges.append((f"up{i}", "s_out", f"down{i}", "s_in"))
    return edges


def sync_scales(params, cfg: FQLMConfig):
    """Tie all stream / chain scales from the canonical roots (new dict)."""
    return ii.sync_handoff_edges(params, handoff_edges(cfg))


@contextlib.contextmanager
def _no_tf32():
    """Float32 matmuls at full precision inside the LM, whatever the
    caller set."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: FQLMConfig, *,
                device: DeviceLike = None):
    """Random float params from ``gen`` (drawn on the CPU, so one seed gives
    the same weights on every device), placed on ``device``."""
    dev = resolve_device(device)
    d, kvd = cfg.d_model, cfg.n_kv_heads * cfg.d_head
    params = {
        "embed": {"w": torch.randn((cfg.vocab, d), generator=gen) * 0.5},
        "pos": {"w": torch.randn((cfg.max_seq, d), generator=gen) * 0.25},
        "head": fql.init_dense(gen, d, cfg.vocab),
    }
    dims = {"wq": (d, d), "wk": (d, kvd), "wv": (d, kvd),
            "wo": (d, d), "up": (d, cfg.d_ff), "down": (cfg.d_ff, d)}
    for i in range(cfg.n_layers):
        for k in _KINDS:
            params[f"{k}{i}"] = fql.init_fq_linear(gen, *dims[k])
    return ii.to_device(params, dev)


def standin_params(gen: torch.Generator, cfg: FQLMConfig, *, s: float = 0.5,
                   device: DeviceLike = None):
    """An untrained stand-in with a valid hand-off contract: every
    activation scale pinned to ``s`` and the DAG tied (``s_w`` stays the
    observed weight range)."""
    params = init_params(gen, cfg, device=device)
    for name in proj_names(cfg):
        st = torch.tensor(s, dtype=torch.float32,
                          device=params[name]["w"].device)
        params[name] = {**params[name], "s_in": st, "s_out": st}
    return sync_scales(params, cfg)


def int_extras(params, cfg: FQLMConfig):
    """Float-side extras of the integer stack: the FP embedding, positions
    and head, the entry scale, the decode scale and ``island_s_in`` (each
    layer's ``wo.s_in``, the island's re-entry quantizer)."""
    return {
        "embed": params["embed"],
        "pos": params["pos"],
        "head": params["head"],
        "entry": {"s_in": params["wq0"]["s_in"]},
        "s_out_last": params[f"down{cfg.n_layers - 1}"]["s_out"],
        "island_s_in": [params[f"wo{i}"]["s_in"]
                        for i in range(cfg.n_layers)],
    }


def convert_int(params, cfg: FQLMConfig, qcfg: QuantConfig, *,
                weight_format: Optional[str] = None) -> ii.ConvertedStack:
    """Trained float LM -> integer deployment stack (DAG hand-off checked)."""
    if n_levels(qcfg.bits_a) != n_levels(qcfg.bits_out):
        raise ValueError(
            f"FQ LM needs n_levels(bits_a) == n_levels(bits_out) so stream "
            f"codes share a denominator across the residual add (got "
            f"bits_a={qcfg.bits_a}, bits_out={qcfg.bits_out})")
    params = sync_scales(params, cfg)
    return ii.convert_stack(params, qcfg, specs=layer_specs(cfg),
                            extras=int_extras(params, cfg),
                            handoff_edges=handoff_edges(cfg),
                            weight_format=weight_format)


# ---------------------------------------------------------------------------
# Interpreter 1: the float FQ forward
# ---------------------------------------------------------------------------


def _attention(q, k, v, mask, cfg: FQLMConfig):
    """GQA attention of the float forward (differentiable). q: (B, Tq,
    d_model); k / v: (B, Tk, kv * dh); mask: (B, Tq, Tk) bool. Masked
    scores go to -1e30, whose exp after the max-subtract is exactly 0."""
    b, tq = q.shape[:2]
    g = cfg.n_heads // cfg.n_kv_heads
    q = q.reshape(b, tq, cfg.n_kv_heads, g, cfg.d_head)
    k = k.reshape(b, -1, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, -1, cfg.n_kv_heads, cfg.d_head)
    f32 = dict(dtype=torch.float32, device=q.device)
    scores = torch.div(torch.einsum("bqhgd,bkhd->bhgqk", q, k),
                       torch.tensor(sqrt_head(cfg.d_head), **f32))
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(-1e30, **f32))
    m = torch.amax(scores, dim=-1, keepdim=True).detach()
    e = quant.exp(scores - m)
    probs = torch.div(e, torch.sum(e, dim=-1, keepdim=True))
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return ctx.reshape(b, tq, cfg.d_model)


def _causal_mask(b, t, device):
    i = torch.arange(t, device=device)
    return (i[None, :] <= i[:, None])[None].expand(b, t, t)


def apply(params, tokens, qcfg: QuantConfig, cfg: FQLMConfig, *,
          noise: Optional[NoiseConfig] = None, rng=None):
    """Float FQ forward over the residual DAG. tokens: (B, T) -> (B, T, V).

    Each ``fq_linear`` quantizer stands for a code hand-off of the integer
    path, and the stream requantize after each residual add for
    ``int_residual_add``. ``noise`` + ``rng`` run the §4.4 noise model, one
    key a projection split from ``rng`` as the reference splits it.
    """
    b, t = tokens.shape
    s_h = params["wq0"]["s_in"]
    x = params["embed"]["w"][tokens] + params["pos"]["w"][:t][None]
    h = learned_quantize(x, s_h, bits=qcfg.bits_a, b=WEIGHT_BOUND)
    rngs = iter(prng.layer_keys(rng, 6 * cfg.n_layers))
    mask = _causal_mask(b, t, tokens.device)

    def lin(name, inp, **kw):
        return fql.fq_linear(params[name], inp, qcfg, noise=noise,
                             rng=next(rngs), **kw)

    with _no_tf32():
        for i in range(cfg.n_layers):
            q = lin(f"wq{i}", h, b_in=WEIGHT_BOUND)
            k = lin(f"wk{i}", h, b_in=WEIGHT_BOUND)
            v = lin(f"wv{i}", h, b_in=WEIGHT_BOUND)
            ctx = _attention(q, k, v, mask, cfg)
            # wo's input quantizer IS the island re-entry quantizer
            o = lin(f"wo{i}", ctx, b_in=WEIGHT_BOUND)
            h = learned_quantize(h + o, s_h, bits=qcfg.bits_out,
                                 b=WEIGHT_BOUND)
            u = lin(f"up{i}", h, b_in=WEIGHT_BOUND, relu_out=True)
            dn = lin(f"down{i}", u, b_in=RELU_BOUND)
            h = learned_quantize(h + dn, s_h, bits=qcfg.bits_out,
                                 b=WEIGHT_BOUND)
        return fql.dense(params["head"], h)


# ---------------------------------------------------------------------------
# Interpreter 2: the integer deployment forward
# ---------------------------------------------------------------------------


def _proj(ip, codes, linear, **kw):
    """An integer projection of (..., din) codes as one 2-D matmul."""
    flat = codes.reshape(-1, codes.shape[-1])
    out = linear(ip, flat, **kw)
    return out.reshape(codes.shape[:-1] + (out.shape[-1],))


def int_linear_ref(ip, codes, *, noise: Optional[NoiseConfig] = None,
                   rng=None, mac_chunks: int = 1, a_lo: int = 0):
    """The plain oracle of ``int_linear`` (K2's plain version, same
    epilogue and noise field): a drop-in for the ``linear=`` seam."""
    w_codes, codes, sig, seed = ii.noisy_operands(ip, codes, noise, rng,
                                                  a_lo=a_lo)
    return ref.ref_fq_matmul(codes, w_codes, ip["rescale"],
                             epilogue="requant", n_out=ip["n_out"],
                             lo=ip["lo"], noise_sigma_acc=sig,
                             noise_seed=seed, mac_chunks=mac_chunks)


def island_consts(stack):
    """Per layer: the island's dequant scales e^s of the wq / wk / wv
    outputs, a (3,) float32 tensor, and e^{island_s_in}, by
    ``core.quant.exp`` (the reference's exp). A forward derives them unless
    its caller passes them (``consts=``): ``serve_fns`` and
    ``int_generate`` derive them once per stack, so a decode step runs no
    exp."""
    consts = []
    for i in range(len(stack["island_s_in"])):
        s = torch.stack([torch.as_tensor(stack[f"{k}{i}"]["s_out"])
                         for k in ("wq", "wk", "wv")])
        consts.append((quant.exp(s.float()).contiguous(),
                       quant.exp(torch.as_tensor(
                           stack["island_s_in"][i]).float())))
    return consts


def _island(stack, i, consts, qc, kcache, vcache, qpos, cfg: FQLMConfig,
            qcfg: QuantConfig):
    """The attention island of layer i and its re-entry codes
    round(clip(ctx / e^s, -1, 1) * n), both in the island kernel, with
    e^s from ``consts``, the stack's :func:`island_consts`."""
    scales, e_in = consts[i]
    return lm_island(qc, kcache, vcache, scales, qpos, e_in,
                     n=stack[f"wq{i}"]["n_out"], n_a=n_levels(qcfg.bits_a),
                     n_heads=cfg.n_heads, sqrt_dh=sqrt_head(cfg.d_head))


def _block_tail(stack, i, h, ctx_codes, linear, *, noise=None, rngs=None,
                mac_chunks=1):
    """wo -> residual add -> MLP -> residual add, all in the code domain."""
    n_out = stack[f"wq{i}"]["n_out"]
    n_a = stack[f"wq{i}"]["n_a"]

    def kw(j, a_lo):
        return dict(noise=noise, rng=None if rngs is None else rngs[6 * i + j],
                    mac_chunks=mac_chunks, a_lo=a_lo)

    o = _proj(stack[f"wo{i}"], ctx_codes, linear, **kw(3, -n_a))
    h = ii.int_residual_add(h, o, n_out=n_out)
    u = _proj(stack[f"up{i}"], h, linear, **kw(4, -n_a))
    dn = _proj(stack[f"down{i}"], u, linear, **kw(5, 0))
    return ii.int_residual_add(h, dn, n_out=n_out)


def _qkv(stack, i, h, linear, *, noise=None, rngs=None, mac_chunks=1):
    n_a = stack[f"wq{i}"]["n_a"]

    def kw(j):
        return dict(noise=noise, rng=None if rngs is None else rngs[6 * i + j],
                    mac_chunks=mac_chunks, a_lo=-n_a)

    return tuple(_proj(stack[f"{k}{i}"], h, linear, **kw(j))
                 for j, k in enumerate(("wq", "wk", "wv")))


def int_core(ip, codes, attn_codes, qcfg: QuantConfig, cfg: FQLMConfig, *,
             impl=None, noise: Optional[NoiseConfig] = None, rng=None,
             mac_chunks: int = 1):
    """The integer core: both integer segments of every block around the
    island, given per-layer stand-in island-output codes ``attn_codes``
    ((n_layers, B, T, d_model) int8). Returns the final stream codes and
    every Q / K / V projection's output codes. ``impl`` is accepted for
    uniformity with the conv stacks (a matmul has one integer impl);
    ``noise`` + ``rng`` run the noisy K2 (K4), one key a projection."""
    del impl
    rngs = None if rng is None else list(prng.split(rng, 6 * cfg.n_layers))
    h = codes
    outs = []
    for i in range(cfg.n_layers):
        qc, kc, vc = _qkv(ip, i, h, ii.int_linear, noise=noise, rngs=rngs,
                          mac_chunks=mac_chunks)
        outs += [qc, kc, vc]
        h = _block_tail(ip, i, h, attn_codes[i], ii.int_linear, noise=noise,
                        rngs=rngs, mac_chunks=mac_chunks)
    return (h, *outs)


def init_caches(cfg: FQLMConfig, batch: int, max_len: int, *,
                device: DeviceLike = None):
    """Int8 code-domain KV caches, (B, max_len, kv, dh) each, and a
    per-slot position vector per layer (staggered prompts decode in one
    batch)."""
    dev = resolve_device(device)
    dh, kv = cfg.d_head, cfg.n_kv_heads
    return [{"k": torch.zeros((batch, max_len, kv, dh), dtype=torch.int8,
                              device=dev),
             "v": torch.zeros((batch, max_len, kv, dh), dtype=torch.int8,
                              device=dev),
             "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
            for _ in range(cfg.n_layers)]


def _logits(stack, h, qcfg: QuantConfig):
    """Decode the stream codes (the stack's ``decode_scale``) and apply the
    FP head. Its dot products are summed in float64, where each float32
    product is exact and any order of the 64-term sum rounds to the same
    float32 (but for a sum within ~1e-14 of a float32 rounding midpoint):
    cuBLAS and the CPU's BLAS pick their order from the number of rows, and
    a row's logits must not depend on it (prefill + decode == a longer
    prefill, bit for bit)."""
    hf = ii.decode_output(h, stack["s_out_last"], qcfg.bits_out,
                          scale=stack.get("decode_scale"))
    head = stack["head"]
    y = torch.matmul(hf.double(), head["w"].double()).float()
    return y + head["b"] if "b" in head else y


def int_prefill(stack, tokens, qcfg: QuantConfig, cfg: FQLMConfig, *,
                max_len: int, linear=None, full: bool = False, consts=None):
    """Integer prefill: (B, T) tokens -> (last-token logits, caches).

    K/V codes go straight into the padded cache, and attention runs over
    the full ``max_len`` cache, so its per-row reductions have the shape
    of a decode step's. ``full=True`` returns logits at every position.
    ``consts``: the stack's :func:`island_consts`, derived if None.
    """
    linear = linear or ii.int_linear
    consts = island_consts(stack) if consts is None else consts
    b, t = tokens.shape
    dh, kv = cfg.d_head, cfg.n_kv_heads
    dev = tokens.device
    x = stack["embed"]["w"][tokens] + stack["pos"]["w"][:t][None]
    h = ii.entry_codes(x, stack["entry"], qcfg, b_in=WEIGHT_BOUND)
    caches = init_caches(cfg, b, max_len, device=dev)
    qpos = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(
        b, t).contiguous()
    for i in range(cfg.n_layers):
        qc, kc, vc = _qkv(stack, i, h, linear)
        caches[i]["k"][:, :t] = kc.reshape(b, t, kv, dh)
        caches[i]["v"][:, :t] = vc.reshape(b, t, kv, dh)
        caches[i]["pos"].fill_(t)
        ctx_codes = _island(stack, i, consts, qc, caches[i]["k"],
                            caches[i]["v"], qpos, cfg, qcfg)
        h = _block_tail(stack, i, h, ctx_codes, linear)
    if not full:
        h = h[:, -1:]
    return _logits(stack, h, qcfg), caches


def int_decode_step(stack, caches, tokens, qcfg: QuantConfig,
                    cfg: FQLMConfig, *, linear=None, inplace: bool = False,
                    consts=None):
    """One integer decode step: append K/V codes at each slot's position,
    attend, advance the positions. tokens: (B, 1) -> (logits (B, 1, V),
    caches). The cache never sees float K/V.

    ``inplace`` writes into ``caches`` (as the reference's batcher donates
    them); otherwise the step returns new caches and leaves its argument
    as it was. A slot at or past ``max_len`` (a retired lane still flowing
    through the batch) writes nothing, as the reference's scatter drops
    it, and reads the last position embedding, as its gather clamps.
    ``consts``: the stack's :func:`island_consts`, derived if None.
    """
    linear = linear or ii.int_linear
    consts = island_consts(stack) if consts is None else consts
    b = tokens.shape[0]
    dh, kv = cfg.d_head, cfg.n_kv_heads
    max_len = caches[0]["k"].shape[1]
    rows = torch.arange(b, device=tokens.device)
    pos = caches[0]["pos"]
    x = (stack["embed"]["w"][tokens[:, 0]]
         + stack["pos"]["w"][pos.clamp(max=cfg.max_seq - 1)])[:, None]
    h = ii.entry_codes(x, stack["entry"], qcfg, b_in=WEIGHT_BOUND)
    new_caches = []
    for i in range(cfg.n_layers):
        qc, kc, vc = _qkv(stack, i, h, linear)
        p = caches[i]["pos"]
        keep = (p < max_len)[:, None, None]
        at = p.clamp(max=max_len - 1)
        layer = {}
        for name, c in (("k", kc), ("v", vc)):
            cache = caches[i][name] if inplace else caches[i][name].clone()
            new = c[:, 0].reshape(b, kv, dh)
            cache[rows, at] = torch.where(keep, new, cache[rows, at])
            layer[name] = cache
        layer["pos"] = p + 1
        if inplace:
            caches[i].update(layer)
        new_caches.append(caches[i] if inplace else layer)
        qpos = p[:, None].contiguous()
        ctx_codes = _island(stack, i, consts, qc, layer["k"], layer["v"],
                            qpos, cfg, qcfg)
        h = _block_tail(stack, i, h, ctx_codes, linear)
    return _logits(stack, h, qcfg), new_caches


def serve_fns(cfg: FQLMConfig, qcfg: QuantConfig, *, max_len: int,
              linear=None, device: DeviceLike = None):
    """(prefill_fn, step_fn, init_caches_fn) for ``ContinuousBatcher``; the
    step updates the batch's caches in place. ``device`` is where the
    caches live (the stack's device). The island constants are derived
    once for each stack the functions are given (a swapped-in stack is a
    new object)."""
    derived = {}

    def consts_of(stack):
        if derived.get("stack") is not stack:
            derived.update(stack=stack, consts=island_consts(stack))
        return derived["consts"]

    def prefill_fn(stack, tokens):
        return int_prefill(stack, tokens, qcfg, cfg, max_len=max_len,
                           linear=linear, consts=consts_of(stack))

    def step_fn(stack, caches, tokens):
        return int_decode_step(stack, caches, tokens, qcfg, cfg,
                               linear=linear, inplace=True,
                               consts=consts_of(stack))

    def init_caches_fn(batch):
        return init_caches(cfg, batch, max_len, device=device)

    return prefill_fn, step_fn, init_caches_fn


def int_generate(stack, prompt, qcfg: QuantConfig, cfg: FQLMConfig, *,
                 max_new: int, max_len: int, eos_id: int = -1, linear=None):
    """Unbatched greedy loop, token for token the batcher's semantics: the
    prefill logits give the first token; decode continues until EOS
    (appended, then stop) or the budget runs out."""
    toks = torch.tensor([list(prompt)], dtype=torch.int32,
                        device=stack.device)
    consts = island_consts(stack)
    logits, caches = int_prefill(stack, toks, qcfg, cfg, max_len=max_len,
                                 linear=linear, consts=consts)
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(max_new - 1):
        if out[-1] == eos_id:
            break
        tok = torch.tensor([[out[-1]]], dtype=torch.int32,
                           device=stack.device)
        logits, caches = int_decode_step(stack, caches, tok, qcfg, cfg,
                                         linear=linear, inplace=True,
                                         consts=consts)
        out.append(int(torch.argmax(logits[0, -1])))
    return out
