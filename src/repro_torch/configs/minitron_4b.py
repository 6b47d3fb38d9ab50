"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000, pruned nemotron. [arXiv:2407.14679; hf]

Counterpart of ``repro.configs.minitron_4b``, dtypes as torch dtypes.
"""
from __future__ import annotations

import torch

from ..core.quant import QuantConfig
from ..models.transformer import TransformerConfig
from .base import ArchConfig

CONFIG = TransformerConfig(
    name="minitron-4b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    head_dim=128,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="minitron-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab=512,
    head_dim=16,
    param_dtype=torch.float32,
    max_seq=128,
)


def get() -> ArchConfig:
    return ArchConfig(
        arch_id="minitron-4b",
        model=CONFIG,
        smoke=SMOKE,
        mode="fsdp_tp",
        qcfg=QuantConfig(8, 8),
    )
