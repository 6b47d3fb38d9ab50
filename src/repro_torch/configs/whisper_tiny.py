"""whisper-tiny [audio] — 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865,
encoder-decoder, conv frontend STUB. [arXiv:2212.04356; unverified]

The conv1d frontend is stubbed per the assignment: ``input_specs()`` provides
precomputed (B, 1500, 80) log-mel frame embeddings; a learned FQ adapter maps
them into d_model. 4 encoder + 4 decoder layers, GELU MLP FFN, absolute
positional embeddings (whisper uses sinusoidal enc / learned dec — we use one
learned table, a documented deviation). Decode shapes exercise the decoder's
self-attention KV cache + fixed cross-attention KV over the 1500 frames.

Counterpart of ``repro.configs.whisper_tiny``, dtypes as torch dtypes.
"""
from __future__ import annotations

import torch

from ..core.quant import QuantConfig
from ..models.frontends import AUDIO_WHISPER_TINY, FrontendConfig
from ..models.transformer import LayerSpec, TransformerConfig
from .base import ArchConfig

CONFIG = TransformerConfig(
    name="whisper-tiny",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    enc_dec=True,
    frontend=AUDIO_WHISPER_TINY,
    pattern=(LayerSpec(ffn="mlp"),),
    pos="abs",
    max_seq=33280,          # decode_32k needs a >=32768 learned-pos table
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="whisper-smoke",
    n_layers=2,
    n_enc_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=256,
    enc_dec=True,
    frontend=FrontendConfig("audio", feat_dim=16, n_positions=20),
    pattern=(LayerSpec(ffn="mlp"),),
    pos="abs",
    max_seq=128,
    param_dtype=torch.float32,
)


def get() -> ArchConfig:
    return ArchConfig(
        arch_id="whisper-tiny",
        model=CONFIG,
        smoke=SMOKE,
        mode="tp",          # 8M params — replicate over data
        qcfg=QuantConfig(8, 8),
        notes="Conv frontend stubbed to precomputed frame embeddings; "
              "single learned pos table for enc+dec (deviation).",
    )
