"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783; unverified]

The scale stress-test: full activation remat (the reference's
scan-over-layers + checkpointing), gradient accumulation, 2-D FSDP x TP parameter
sharding, and (hillclimb levers) sequence-parallel hidden states + chunked
cross-entropy + int8 KV and optimizer moments.

Counterpart of ``repro.configs.llama3_405b``, dtypes as torch dtypes.
"""
from __future__ import annotations

import torch

from ..core.quant import QuantConfig
from ..models.transformer import TransformerConfig
from .base import ArchConfig

CONFIG = TransformerConfig(
    name="llama3-405b",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    head_dim=128,
    rope_theta=500000.0,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="llama3-smoke",
    n_layers=4,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=208,
    vocab=512,
    head_dim=8,
    param_dtype=torch.float32,
    max_seq=128,
)


def get() -> ArchConfig:
    return ArchConfig(
        arch_id="llama3-405b",
        model=CONFIG,
        smoke=SMOKE,
        mode="fsdp_tp",
        qcfg=QuantConfig(8, 8),
        grad_accum=16,
        notes="126L scan-over-layers; full remat; ZeRO moments sharded 2-D.",
    )
