"""The unified FQ transformer of the ten assigned architectures.

Counterpart of ``repro.models.transformer``. One config dataclass and one
forward / prefill / decode implementation cover:

  * dense GQA decoders        (codeqwen1.5-7b, minicpm-2b, minitron-4b,
                               llama3-405b, internvl2-1b's backbone)
  * MoE decoders              (llama4-maverick: alternating dense / MoE,
                               deepseek-v2-lite: MLA, a dense first layer)
  * encoder-decoder           (whisper-tiny, audio frontend stub)
  * hybrid recurrent          (recurrentgemma-2b: RG-LRU x2 : local attn x1)
  * attention-free SSM        (rwkv6-7b)

Every projection is an FQ layer. The parameter layout is the reference's,
so that carrying its params across is a copy: ``prefix`` layers, then the
``pattern`` groups, each pattern position's params stacked over a leading
group dim (``blocks``), then the remainder ``pattern[:rem]`` (``rem``). The
reference scans over the group dim; the port loops over it (``scan_layers``
only steers how XLA compiles the reference). With ``remat`` and autograd
recording, each prefix and remainder block, each group and each encoder
layer is one ``torch.utils.checkpoint`` unit, as each is one
``jax.checkpoint`` in the reference: its activations are recomputed in the
backward, which changes no value. ``remat_policy="save_tp"`` (keep the
tensor-parallel outputs) only saves a mesh's all-reduce; without a mesh it
recomputes everything, as "full" does.

Caches mirror the parameter layout (stacked for the groups). ``prefill``
fills fresh caches; ``decode_step`` writes the caches it is given (the
reference's serving step donates them). Positions stay on the device.

The port takes e^s of the serving conversion with ``quant.exp`` (XLA's
float32 exp), so the int8 codes and ``w_scale`` are the reference's bit for
bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..core.quant import QuantConfig, WEIGHT_BOUND, exp, n_levels
from ..device import DeviceLike, resolve_device
from . import attention as attn
from . import frontends
from . import layers as L
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv as rwkv_mod
from . import sharding as shd
from .frontends import FrontendConfig
from .mla import MLAConfig
from .moe import MoEConfig

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's shape: a mixer plus a channel / FFN sub-block."""

    mixer: str = "attn"          # "attn" | "mla" | "rglru" | "rwkv"
    window: Optional[int] = None  # sliding-window size for local attention
    ffn: str = "swiglu"          # "swiglu" | "mlp" (gelu) | "channelmix" | "none"
    moe: Optional[MoEConfig] = None  # MoE FFN replaces the dense FFN
    d_ff: Optional[int] = None   # per-layer FFN width override (deepseek L0)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    prefix: Tuple[LayerSpec, ...] = ()
    head_dim: Optional[int] = None
    mla: Optional[MLAConfig] = None
    rnn_width: Optional[int] = None      # RG-LRU recurrence width
    rwkv_head_dim: int = 64
    rope_theta: float = 10000.0
    pos: str = "rope"                    # "rope" | "abs"
    remat_policy: str = "full"           # "save_tp" acts as "full" (no mesh)
    max_seq: int = 8192                  # abs-pos table length / cache bound
    # encoder-decoder
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: FrontendConfig = FrontendConfig()
    tie_embeddings: bool = False
    quantize_first_last: bool = False    # paper protocol: embed/head stay FP
    # numerics / memory
    param_dtype: Any = torch.bfloat16
    remat: bool = True                   # activation recompute (training)
    scan_layers: bool = True             # XLA's; accepted, not used
    seq_shard: bool = False              # sequence parallelism (a mesh's)
    loss_chunk: Optional[int] = None     # chunked cross-entropy (training)
    kv_bits: Optional[int] = None        # int8 KV cache ("8" = quantized)
    moe_seq_chunk: int = 4096

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_specs(self):
        """(prefix_specs, n_groups, remainder_specs)."""
        n_main = self.n_layers - len(self.prefix)
        p = len(self.pattern)
        return self.prefix, n_main // p, self.pattern[: n_main % p]

    @property
    def attention_free(self) -> bool:
        specs = self.prefix + self.pattern
        return all(s.mixer in ("rglru", "rwkv") for s in specs)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(1) or O(window): eligible for 500k."""
        specs = self.prefix + self.pattern
        return all(s.mixer in ("rglru", "rwkv")
                   or (s.mixer == "attn" and s.window is not None)
                   for s in specs)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_attn(gen, cfg: TransformerConfig, dt):
    dh = cfg.head_dim_
    return {
        "wq": L.init_proj(gen, cfg.d_model, cfg.n_heads * dh, dt),
        "wk": L.init_proj(gen, cfg.d_model, cfg.n_kv_heads * dh, dt),
        "wv": L.init_proj(gen, cfg.d_model, cfg.n_kv_heads * dh, dt),
        "wo": L.init_proj(gen, cfg.n_heads * dh, cfg.d_model, dt),
    }


def _init_ffn(gen, spec: LayerSpec, cfg: TransformerConfig, dt):
    d, f = cfg.d_model, spec.d_ff or cfg.d_ff
    if spec.moe is not None:
        return {"moe": moe_mod.init_moe(gen, d, spec.moe, dt)}
    if spec.ffn == "mlp":
        return {"up": L.init_proj(gen, d, f, dt),
                "down": L.init_proj(gen, f, d, dt)}
    return {"gate": L.init_proj(gen, d, f, dt),
            "up": L.init_proj(gen, d, f, dt),
            "down": L.init_proj(gen, f, d, dt)}


def _init_block(gen, spec: LayerSpec, cfg: TransformerConfig, *,
                cross: bool = False):
    dt = cfg.param_dtype
    dev = L.device_of(gen)
    p = {"ln1": L.init_rmsnorm(cfg.d_model, dt, dev)}
    if spec.mixer == "attn":
        p["attn"] = _init_attn(gen, cfg, dt)
    elif spec.mixer == "mla":
        p["attn"] = mla_mod.init_mla(gen, cfg.d_model, cfg.n_heads, cfg.mla,
                                     dt)
    elif spec.mixer == "rglru":
        p["attn"] = rglru_mod.init_rglru_block(
            gen, cfg.d_model, cfg.rnn_width or cfg.d_model, dt)
    elif spec.mixer == "rwkv":
        p["attn"] = rwkv_mod.init_rwkv_block(
            gen, cfg.d_model, cfg.rwkv_head_dim, dt, d_ff=cfg.d_ff)
    else:
        raise ValueError(spec.mixer)
    if cross:
        p["lnx"] = L.init_rmsnorm(cfg.d_model, dt, dev)
        p["xattn"] = _init_attn(gen, cfg, dt)
    if spec.mixer != "rwkv":  # rwkv bundles its own channel mix
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dt, dev)
        p["ffn"] = _init_ffn(gen, spec, cfg, dt)
    return p


def _stack(trees):
    return tree.map(lambda *xs: torch.stack(xs), *trees)


def _make_params(gen, cfg: TransformerConfig):
    dt = cfg.param_dtype
    dev = L.device_of(gen)
    params: dict = {
        "embed": {"w": L.normal(gen, (cfg.vocab, cfg.d_model), dt) * 0.02},
        "final_norm": L.init_rmsnorm(cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_proj(gen, cfg.d_model, cfg.vocab, dt)
    if cfg.pos == "abs":
        params["pos_embed"] = L.normal(gen, (cfg.max_seq, cfg.d_model),
                                       dt) * 0.02
    if cfg.frontend.enabled:
        params["frontend"] = frontends.init_adapter(gen, cfg.frontend,
                                                    cfg.d_model, dt)
    prefix, n_groups, rem = cfg.layer_specs()
    cross = cfg.enc_dec

    def stacked(spec, n, **kw):
        return _stack([_init_block(gen, spec, cfg, **kw) for _ in range(n)])

    params["prefix"] = tuple(_init_block(gen, s, cfg, cross=cross)
                             for s in prefix)
    params["blocks"] = tuple(stacked(s, n_groups, cross=cross)
                             for s in cfg.pattern) if n_groups else ()
    params["rem"] = tuple(_init_block(gen, s, cfg, cross=cross) for s in rem)
    if cfg.enc_dec:
        params["enc_blocks"] = stacked(LayerSpec(mixer="attn", ffn="mlp"),
                                       cfg.n_enc_layers)
        params["enc_norm"] = L.init_rmsnorm(cfg.d_model, dt, dev)
        params["enc_pos_embed"] = L.normal(
            gen, (cfg.frontend.n_positions, cfg.d_model), dt) * 0.02
    return params


def make_params(gen: torch.Generator, cfg: TransformerConfig, *,
                device: DeviceLike = None):
    """A concrete parameter tree drawn from ``gen`` (on the generator's
    device), placed on ``device`` (CUDA unless the CPU is asked for)."""
    dev = resolve_device(device)
    params = _make_params(gen, cfg)
    if gen.device != dev:
        params = tree.map(lambda x: x.to(dev), params)
    return params


def param_struct(cfg: TransformerConfig):
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    storage (the reference's ``eval_shape``)."""
    return _make_params(None, cfg)


def count_params(cfg: TransformerConfig) -> int:
    return sum(x.numel() for x in tree.leaves(param_struct(cfg)))


def count_active_params(cfg: TransformerConfig) -> int:
    """Active params per token (MoE: only top-k + shared experts count)."""
    total = count_params(cfg)
    prefix, n_groups, rem = cfg.layer_specs()
    inactive = 0
    for s in list(prefix) + list(cfg.pattern) * n_groups + list(rem):
        if s.moe is not None:
            m = s.moe
            inactive += (m.n_experts - m.top_k) * 3 * cfg.d_model * m.d_expert
    return total - inactive


# ---------------------------------------------------------------------------
# Per-kind apply (full sequence)
# ---------------------------------------------------------------------------


def _heads(x, n, dh):
    b, t, _ = x.shape
    return x.reshape(b, t, n, dh).permute(0, 2, 1, 3)   # (B, H, T, Dh)


def _unheads(x):
    b, h, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dh)


def _chunk_of(t: int, target: int) -> int:
    c = min(target, t)
    while t % c:
        c -= 1
    return c


def _apply_rope(q, k, positions, cfg):
    if cfg.pos != "rope":
        return q, k
    b, h, t, dh = q.shape
    qf = L.rope(q.reshape(b * h, t, dh), positions, theta=cfg.rope_theta)
    kf = L.rope(k.reshape(b * k.shape[1], k.shape[2], dh),
                positions if k.shape[2] == t else positions[: k.shape[2]],
                theta=cfg.rope_theta)
    return qf.reshape(q.shape), kf.reshape(k.shape)


def _self_attn_seq(p, h, spec, cfg, qcfg, positions, *, causal=True,
                   return_kv=False):
    dh = cfg.head_dim_
    q = _heads(L.proj(p["wq"], h, qcfg), cfg.n_heads, dh)
    k = _heads(L.proj(p["wk"], h, qcfg), cfg.n_kv_heads, dh)
    v = _heads(L.proj(p["wv"], h, qcfg), cfg.n_kv_heads, dh)
    q, k = _apply_rope(q, k, positions, cfg)
    q = shd.constrain(q, "batch", "model", None, None)
    k = shd.constrain(k, "batch", None, None, None)
    t = h.shape[1]
    out = attn.flash_attention(
        q, k, v, causal=causal, window=spec.window,
        q_chunk=_chunk_of(t, 512), kv_chunk=_chunk_of(t, 1024))
    y = L.proj(p["wo"], _unheads(out), qcfg)
    if return_kv:
        return y, (k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))
    return y


def _cross_attn_seq(p, h, enc_out, cfg, qcfg):
    dh = cfg.head_dim_
    q = _heads(L.proj(p["wq"], h, qcfg), cfg.n_heads, dh)
    k = _heads(L.proj(p["wk"], enc_out, qcfg), cfg.n_kv_heads, dh)
    v = _heads(L.proj(p["wv"], enc_out, qcfg), cfg.n_kv_heads, dh)
    q = shd.constrain(q, "batch", "model", None, None)
    tq, tk = h.shape[1], enc_out.shape[1]
    out = attn.flash_attention(
        q, k, v, causal=False, q_chunk=_chunk_of(tq, 512),
        kv_chunk=_chunk_of(tk, 1024))
    return L.proj(p["wo"], _unheads(out), qcfg)


def _zero_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance": z, "router_z": z}


def _ffn(p, h, spec, cfg, qcfg):
    """Channel block. Returns (y, aux)."""
    if spec.moe is not None:
        return moe_mod.apply_moe(p["moe"], h, spec.moe, qcfg,
                                 seq_chunk=cfg.moe_seq_chunk)
    if spec.ffn == "mlp":
        z = rglru_mod.gelu(L.proj(p["up"], h, qcfg))
    else:
        z = F.silu(L.proj(p["gate"], h, qcfg)) * L.proj(p["up"], h, qcfg)
    z = shd.constrain(z, "batch", None, "model")
    return L.proj(p["down"], z, qcfg), _zero_aux(h.device)


def _hidden_constrain(h):
    # the reference shards the sequence too where cfg.seq_shard; both specs
    # are the identity without a mesh, and the mesh slice brings them
    return shd.constrain(h, "batch", None, None)


def _apply_block(bp, h, spec: LayerSpec, cfg, qcfg, positions, enc_out=None,
                 *, causal=True):
    """One residual layer (mixer + channel block). Returns (h, aux)."""
    hn = L.maybe_norm(bp["ln1"], h, qcfg)
    if spec.mixer == "attn":
        mix = _self_attn_seq(bp["attn"], hn, spec, cfg, qcfg, positions,
                             causal=causal)
    elif spec.mixer == "mla":
        mix, _ = mla_mod.mla_attention(
            bp["attn"], hn, positions, cfg.n_heads, cfg.mla, qcfg,
            causal=causal, q_chunk=_chunk_of(hn.shape[1], 512),
            kv_chunk=_chunk_of(hn.shape[1], 1024))
    elif spec.mixer == "rglru":
        mix = rglru_mod.apply_rglru_seq(bp["attn"], hn, qcfg)
    elif spec.mixer == "rwkv":
        mix = rwkv_mod.apply_timemix_seq(bp["attn"], hn, qcfg,
                                         cfg.rwkv_head_dim)
    else:
        raise ValueError(spec.mixer)
    aux = _zero_aux(h.device)
    h = h + mix
    if enc_out is not None and "xattn" in bp:
        hx = L.maybe_norm(bp["lnx"], h, qcfg)
        h = h + _cross_attn_seq(bp["xattn"], hx, enc_out, cfg, qcfg)
    if spec.mixer == "rwkv":
        h = h + rwkv_mod.apply_channelmix_seq(
            bp["attn"], L.maybe_norm(bp["ln1"], h, qcfg), qcfg)
        return _hidden_constrain(h), aux
    y, aux2 = _ffn(bp["ffn"], L.maybe_norm(bp["ln2"], h, qcfg), spec, cfg,
                   qcfg)
    aux = {k: aux[k] + aux2[k] for k in aux}
    return _hidden_constrain(h + y), aux


def _groups(stacked, n: int):
    """The ``n`` groups of a stacked tree, each a tree of views into it
    (one ``unbind`` a leaf)."""
    if n == 0:
        return []
    parts = [x.unbind(0) for x in tree.leaves(stacked)]
    return [tree.unflatten(stacked, [u[gi] for u in parts])
            for gi in range(n)]


def _in_order(tree_, cfg):
    """A params or caches tree's per-layer entries in layer order: the
    prefix, then group by group the pattern's positions, then the rest."""
    _, n_groups, _ = cfg.layer_specs()
    groups = _groups(tree_["blocks"], n_groups)
    return (list(tree_["prefix"])
            + [g[i] for g in groups for i in range(len(cfg.pattern))]
            + list(tree_["rem"]))


def _layers(params, cfg):
    """(block params, spec) of every layer in order."""
    prefix, n_groups, rem = cfg.layer_specs()
    specs = list(prefix) + list(cfg.pattern) * n_groups + list(rem)
    return list(zip(_in_order(params, cfg), specs))


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------


def _embed_tokens(params, tokens, cfg, *, offset: int = 0):
    h = params["embed"]["w"][tokens.long()]
    if cfg.pos == "abs":
        t = tokens.shape[1]
        start = min(max(offset, 0), params["pos_embed"].shape[0] - t)
        h = h + params["pos_embed"][start:start + t][None]
    return h


def _encode(params, feats, cfg: TransformerConfig, qcfg):
    """Whisper-style encoder over precomputed frontend features."""
    h = frontends.apply_adapter(params["frontend"], feats, cfg.frontend, qcfg)
    h = h + params["enc_pos_embed"][None].to(h.dtype)
    enc_spec = LayerSpec(mixer="attn", ffn="mlp")
    positions = torch.arange(h.shape[1], device=h.device)
    body = _remat(lambda bp, hh: _apply_block(
        bp, hh, enc_spec, cfg, qcfg, positions, causal=False)[0], cfg)
    for bp in _groups(params["enc_blocks"], cfg.n_enc_layers):
        h = body(bp, h)
    return L.rmsnorm(params["enc_norm"], h)


def _input_hidden(params, batch, cfg, qcfg):
    """Token embeddings (+ frontend patch embeddings for VLM archs)."""
    tokens = batch["tokens"]
    if cfg.frontend.enabled and not cfg.enc_dec and "feats" in batch:
        vis = frontends.apply_adapter(params["frontend"], batch["feats"],
                                      cfg.frontend, qcfg)
        txt = _embed_tokens(params, tokens, cfg,
                            offset=cfg.frontend.n_positions
                            if cfg.pos == "abs" else 0)
        return torch.cat([vis.to(txt.dtype), txt], dim=1)
    return _embed_tokens(params, tokens, cfg)


def _remat(fn, cfg):
    """``fn`` as one checkpoint unit where ``cfg.remat`` and autograd
    records (module doc); the forward draws no random numbers, so the RNG
    state is not saved."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def _hidden_forward(params, batch, cfg: TransformerConfig,
                    qcfg: QuantConfig):
    """forward() minus the LM head: the final hidden states and aux."""
    h = _hidden_constrain(_input_hidden(params, batch, cfg, qcfg))
    positions = torch.arange(h.shape[1], device=h.device)
    enc_out = (_encode(params, batch["feats"], cfg, qcfg) if cfg.enc_dec
               else None)
    prefix, n_groups, rem = cfg.layer_specs()

    def block(spec):
        return _remat(lambda bp, hh: _apply_block(
            bp, hh, spec, cfg, qcfg, positions, enc_out), cfg)

    def group_fn(xs, hh, acc):
        for bp, spec in zip(xs, cfg.pattern):
            hh, a = _apply_block(bp, hh, spec, cfg, qcfg, positions,
                                 enc_out)
            acc = {k: acc[k] + a[k] for k in acc}
        return hh, acc

    group = _remat(group_fn, cfg)
    aux = _zero_aux(h.device)
    for bp, spec in zip(params["prefix"], prefix):
        h, a = block(spec)(bp, h)
        aux = {k: aux[k] + a[k] for k in aux}
    for xs in _groups(params["blocks"], n_groups):
        h, aux = group(xs, h, aux)
    for bp, spec in zip(params["rem"], rem):
        h, a = block(spec)(bp, h)
        aux = {k: aux[k] + a[k] for k in aux}
    return L.rmsnorm(params["final_norm"], h), aux


def forward(params, batch, cfg: TransformerConfig, qcfg: QuantConfig):
    """Full-sequence forward. batch: {"tokens": (B, S) [, "feats"]}.

    Returns (logits (B, S_total, vocab), aux dict of scalar MoE losses)."""
    h, aux = _hidden_forward(params, batch, cfg, qcfg)
    return _lm_logits(params, h, cfg, qcfg), aux


def _lm_logits(params, h, cfg, qcfg):
    head_q = qcfg if cfg.quantize_first_last else QuantConfig(fq=qcfg.fq)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", h,
                            params["embed"]["w"].to(h.dtype))
    return L.proj(params["lm_head"], h, head_q)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _ce_terms(logits, labels):
    """(sum over positions with label >= 0 of logsumexp - gold logit, the
    count of those positions), in float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp_min(
        labels.long(), 0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def _ce(logits, labels):
    """Mean CE over positions with label >= 0."""
    tot, cnt = _ce_terms(logits, labels)
    return torch.div(tot, torch.clamp_min(cnt, 1.0))


def loss_fn(params, batch, cfg: TransformerConfig, qcfg: QuantConfig, *,
            lb_coef: float = 0.01, z_coef: float = 1e-3):
    """Returns (loss, metrics). batch must contain "labels" (B, S_text);
    a vision prefix (``S_total - S_text`` positions) takes no loss.

    With ``cfg.loss_chunk`` the final hidden states are split along the
    sequence and the logits and CE are taken a chunk at a time, summed in
    the reference's order (the same loss as unchunked)."""
    labels = batch["labels"]
    if cfg.loss_chunk:
        h, aux = _hidden_forward(params, batch, cfg, qcfg)
        h = h[:, h.shape[1] - labels.shape[1]:]
        c = _chunk_of(h.shape[1], cfg.loss_chunk)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, h.shape[1], c):
            t, n = _ce_terms(_lm_logits(params, h[:, i:i + c], cfg, qcfg),
                             labels[:, i:i + c])
            tot, cnt = tot + t, cnt + n
        ce = torch.div(tot, torch.clamp_min(cnt, 1.0))
    else:
        logits, aux = forward(params, batch, cfg, qcfg)
        ce = _ce(logits[:, logits.shape[1] - labels.shape[1]:], labels)
    loss = ce + lb_coef * aux["load_balance"] + z_coef * aux["router_z"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# KV caches / decode state
# ---------------------------------------------------------------------------


def _block_cache(spec: LayerSpec, cfg: TransformerConfig, batch: int,
                 max_len: int, enc_len: int, device):
    dh = cfg.head_dim_
    dt = torch.bfloat16 if cfg.param_dtype == torch.bfloat16 else torch.float32
    if spec.mixer == "attn":
        if spec.window is not None:
            c = attn.init_ring_cache(batch, min(spec.window, max_len),
                                     cfg.n_kv_heads, dh, dtype=dt,
                                     device=device)
        else:
            c = attn.init_cache(batch, max_len, cfg.n_kv_heads, dh,
                                kv_bits=cfg.kv_bits, dtype=dt, device=device)
    elif spec.mixer == "mla":
        c = mla_mod.init_mla_cache(batch, max_len, cfg.mla, dt, device=device)
    elif spec.mixer == "rglru":
        c = rglru_mod.init_rglru_state(batch, cfg.rnn_width or cfg.d_model,
                                       dt, device=device)
    elif spec.mixer == "rwkv":
        c = rwkv_mod.init_rwkv_state(batch, cfg.d_model, cfg.rwkv_head_dim,
                                     dt, device=device)
    else:
        raise ValueError(spec.mixer)
    if cfg.enc_dec and enc_len:
        for name in ("xk", "xv"):
            c[name] = torch.zeros((batch, enc_len, cfg.n_kv_heads, dh),
                                  dtype=dt, device=device)
    return c


def init_caches(cfg: TransformerConfig, batch: int, max_len: int, *,
                device: DeviceLike = None):
    """Cache tree parallel to the block layout (stacked for the groups), on
    ``device`` (CUDA unless the CPU is asked for; "meta" for shapes)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    enc_len = cfg.frontend.n_positions if cfg.enc_dec else 0
    prefix, n_groups, rem = cfg.layer_specs()

    def one(spec):
        return _block_cache(spec, cfg, batch, max_len, enc_len, dev)

    return {
        "prefix": tuple(one(s) for s in prefix),
        "blocks": tuple(_stack([one(s) for _ in range(n_groups)])
                        for s in cfg.pattern) if n_groups else (),
        "rem": tuple(one(s) for s in rem),
    }


def cache_struct(cfg: TransformerConfig, batch: int, max_len: int):
    """:func:`init_caches`' tree on the ``meta`` device."""
    return init_caches(cfg, batch, max_len, device="meta")


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _prefill_block(bp, h, cache, spec, cfg, qcfg, positions, enc_out):
    """Sequence forward that also fills this layer's cache (in place)."""
    hn = L.maybe_norm(bp["ln1"], h, qcfg)
    s_len = h.shape[1]
    if spec.mixer == "attn":
        mix, (k, v) = _self_attn_seq(bp["attn"], hn, spec, cfg, qcfg,
                                     positions, return_kv=True)
        if spec.window is not None:
            attn.ring_fill(cache, k, v)
        else:
            cache["pos"].zero_()
            attn.cache_update(cache, k, v)
    elif spec.mixer == "mla":
        mix, (ckv, k_rope) = mla_mod.mla_attention(
            bp["attn"], hn, positions, cfg.n_heads, cfg.mla, qcfg,
            q_chunk=_chunk_of(s_len, 512), kv_chunk=_chunk_of(s_len, 1024))
        cache["ckv"][:, :s_len] = ckv.to(cache["ckv"].dtype)
        cache["k_rope"][:, :s_len] = k_rope.to(cache["k_rope"].dtype)
        cache["pos"].fill_(s_len)
    elif spec.mixer == "rglru":
        mix, st = rglru_mod.apply_rglru_seq(bp["attn"], hn, qcfg,
                                            return_state=True)
        cache["h"].copy_(st["h"])
        cache["conv"].copy_(st["conv"])
    elif spec.mixer == "rwkv":
        mix, S = rwkv_mod.apply_timemix_seq(bp["attn"], hn, qcfg,
                                            cfg.rwkv_head_dim,
                                            return_state=True)
        cache["S"].copy_(S)
        cache["x_tm"].copy_(hn[:, -1])
    else:
        raise ValueError(spec.mixer)
    h = h + mix
    if enc_out is not None and "xattn" in bp:
        hx = L.maybe_norm(bp["lnx"], h, qcfg)
        h = h + _cross_attn_seq(bp["xattn"], hx, enc_out, cfg, qcfg)
        xp, b = bp["xattn"], enc_out.shape[0]
        for name, w in (("xk", "wk"), ("xv", "wv")):
            cache[name].copy_(L.proj(xp[w], enc_out, qcfg).reshape(
                b, -1, cfg.n_kv_heads, cfg.head_dim_))
    if spec.mixer == "rwkv":
        hn2 = L.maybe_norm(bp["ln1"], h, qcfg)
        h = h + rwkv_mod.apply_channelmix_seq(bp["attn"], hn2, qcfg)
        cache["x_cm"].copy_(hn2[:, -1])
        return _hidden_constrain(h)
    y, _ = _ffn(bp["ffn"], L.maybe_norm(bp["ln2"], h, qcfg), spec, cfg, qcfg)
    return _hidden_constrain(h + y)


def prefill(params, batch, cfg: TransformerConfig, qcfg: QuantConfig, *,
            max_len: Optional[int] = None):
    """Process the prompt; returns (last-token logits, filled caches)."""
    h = _hidden_constrain(_input_hidden(params, batch, cfg, qcfg))
    s_total = h.shape[1]
    max_len = max_len or s_total
    positions = torch.arange(s_total, device=h.device)
    enc_out = (_encode(params, batch["feats"], cfg, qcfg) if cfg.enc_dec
               else None)
    caches = init_caches(cfg, h.shape[0], max_len, device=h.device)
    for (bp, spec), cache in zip(_layers(params, cfg),
                                 _in_order(caches, cfg)):
        h = _prefill_block(bp, h, cache, spec, cfg, qcfg,
                           positions, enc_out)
    h_last = L.rmsnorm(params["final_norm"], h[:, -1:])
    return _lm_logits(params, h_last, cfg, qcfg), caches


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------


def _decode_block(bp, h, cache, spec, cfg, qcfg, tables):
    """One-token step. h: (B, 1, d). Writes the layer's cache; returns h.
    ``tables``: the step's rope (cos, sin) at the incoming position, or
    None where ``cfg.pos`` is not rope."""
    hn = L.maybe_norm(bp["ln1"], h, qcfg)
    dh = cfg.head_dim_
    if spec.mixer == "attn":
        p = bp["attn"]
        q = _heads(L.proj(p["wq"], hn, qcfg), cfg.n_heads, dh)
        k = _heads(L.proj(p["wk"], hn, qcfg), cfg.n_kv_heads, dh)
        v = _heads(L.proj(p["wv"], hn, qcfg), cfg.n_kv_heads, dh)
        if cfg.pos == "rope":
            # q and k rotated in one call (the same angles)
            qk = L.apply_rope(torch.cat([q, k], 1), *tables)
            q, k = qk[:, :cfg.n_heads], qk[:, cfg.n_heads:]
        kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        if spec.window is not None:
            out = attn.ring_decode_attention(q, attn.ring_update(cache, kt,
                                                                 vt))
        else:
            out = attn.decode_attention(q, attn.cache_update(cache, kt, vt))
        mix = L.proj(p["wo"], _unheads(out), qcfg)
    elif spec.mixer == "mla":
        mix, _ = mla_mod.mla_decode(bp["attn"], hn, cache, cfg.n_heads,
                                    cfg.mla, qcfg)
    elif spec.mixer == "rglru":
        mix, upd = rglru_mod.apply_rglru_step(
            bp["attn"], hn, {"h": cache["h"], "conv": cache["conv"]}, qcfg)
        cache["h"].copy_(upd["h"])
        cache["conv"].copy_(upd["conv"])
    elif spec.mixer == "rwkv":
        sub = {k2: cache[k2] for k2 in ("S", "x_tm", "x_cm")}
        mix, upd = rwkv_mod.apply_block_step(bp["attn"], hn, sub, qcfg,
                                             cfg.rwkv_head_dim)
        cache["S"].copy_(upd["S"])
        cache["x_tm"].copy_(upd["x_tm"])
    else:
        raise ValueError(spec.mixer)
    h = h + mix
    if "xattn" in bp and "xk" in cache:
        hx = L.maybe_norm(bp["lnx"], h, qcfg)
        q = _heads(L.proj(bp["xattn"]["wq"], hx, qcfg), cfg.n_heads, dh)
        xc = {"k": cache["xk"], "v": cache["xv"],
              "pos": torch.tensor(cache["xk"].shape[1], dtype=torch.int32,
                                  device=h.device)}
        out = attn.decode_attention(q, xc)
        h = h + L.proj(bp["xattn"]["wo"], _unheads(out), qcfg)
    if spec.mixer == "rwkv":
        hn2 = L.maybe_norm(bp["ln1"], h, qcfg)
        y, cm = rwkv_mod.apply_channelmix_step(bp["attn"], hn2,
                                               {"x_cm": cache["x_cm"]}, qcfg)
        cache["x_cm"].copy_(cm["x_cm"])
        return h + y
    y, _ = _ffn(bp["ffn"], L.maybe_norm(bp["ln2"], h, qcfg), spec, cfg, qcfg)
    return h + y


def decode_step(params, caches, tokens, cfg: TransformerConfig,
                qcfg: QuantConfig):
    """tokens: (B, 1) -> (logits (B, 1, vocab), caches): the caches given
    are written and returned (the serving step's donation)."""
    pos = _current_pos(caches, tokens.device)
    h = _embed_tokens_at(params, tokens, cfg, pos)
    # every full / ring attention layer sits at the first stateful cache's
    # position (positions move in lockstep): its rope tables, taken once
    tables = None
    if cfg.pos == "rope":
        tables = L.rope_tables(pos.reshape(1), cfg.head_dim_, cfg.rope_theta,
                               h.dtype, h.device)
    for (bp, spec), cache in zip(_layers(params, cfg),
                                 _in_order(caches, cfg)):
        h = _decode_block(bp, h, cache, spec, cfg, qcfg, tables)
    h = L.rmsnorm(params["final_norm"], h)
    return _lm_logits(params, h, cfg, qcfg), caches


def _current_pos(caches, device):
    """Absolute position of the incoming token, from the first stateful
    cache (a copy, read before the step moves it)."""
    for c in list(caches["prefix"]) + list(caches["rem"]):
        if "pos" in c:
            return c["pos"].clone()
    for c in caches["blocks"]:
        if "pos" in c:
            return c["pos"][0].clone()
    # pure-SSM stacks track no position
    return torch.zeros((), dtype=torch.int32, device=device)


def _embed_tokens_at(params, tokens, cfg, pos):
    h = params["embed"]["w"][tokens.long()]
    if cfg.pos == "abs":
        n = params["pos_embed"].shape[0]
        idx = torch.clamp(pos.to(torch.int64), 0, n - 1).reshape(1)
        pe = params["pos_embed"].index_select(0, idx)
        h = h + pe[None].to(h.dtype)
    return h


# ---------------------------------------------------------------------------
# Serving-time parameter quantization (paper §3.4 deployment)
# ---------------------------------------------------------------------------


def quantize_params_for_serving(params, bits_w: int = 8):
    """Convert every FQ projection's weights to stored int8 codes.

    Real value = e^{s_w} / n * code (paper eq. 4); ``layers.proj`` and the
    MoE path pick the codes up. Embeddings, norms and small vectors stay in
    their dtype. e^s is ``quant.exp``, the reference's bit for bit."""
    n = n_levels(bits_w)

    def codes_of(w, s):
        """round(clip(w / e^s, -1, 1) * n), s broadcast over w's trailing
        matrix dims (s may carry leading stack / expert dims)."""
        sb = exp(s).reshape(tuple(s.shape) + (1,) * (w.dim() - s.dim()))
        u = torch.clamp(torch.div(w.to(torch.float32), sb), WEIGHT_BOUND, 1.0)
        return torch.round(u * n).to(torch.int8)

    def scale_of(s):
        e = exp(s)
        return torch.div(e, torch.tensor(float(n), device=e.device))

    def walk(t):
        if isinstance(t, dict):
            if ("w" in t and "s_w" in t
                    and t["w"].dim() - t["s_w"].dim() == 2):
                # an FQ projection: (di, do) + scalar s, or stacked
                # (G, di, do) + (G,) s
                rest = {k: v for k, v in t.items() if k != "w"}
                return {"w_codes": codes_of(t["w"], t["s_w"]),
                        "w_scale": scale_of(t["s_w"]), **rest}
            if "w_gate" in t and "s_w" in t:
                # MoE experts: s_w (3, E, 1, 1) or stacked (G, 3, E, 1, 1);
                # the matrix index sits at axis -4
                out = {k: v for k, v in t.items()
                       if k not in ("w_gate", "w_up", "w_down")}
                scales = []
                for i, k in enumerate(("w_gate", "w_up", "w_down")):
                    s = t["s_w"].select(-4, i)
                    out[k + "_codes"] = codes_of(t[k], s)
                    scales.append(scale_of(s))
                out["w_scale"] = torch.stack(scales, dim=-4)
                return out
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(params)
