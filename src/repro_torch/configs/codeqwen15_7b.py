"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416, qwen1.5 architecture. [hf:Qwen/CodeQwen1.5-7B; hf]

Counterpart of ``repro.configs.codeqwen15_7b``, dtypes as torch dtypes.
"""
from __future__ import annotations

import torch

from ..core.quant import QuantConfig
from ..models.transformer import TransformerConfig
from .base import ArchConfig

CONFIG = TransformerConfig(
    name="codeqwen1.5-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,          # MHA (kv == q heads)
    d_ff=13440,
    vocab=92416,
    rope_theta=1000000.0,   # 64k-context qwen1.5 rope base
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="codeqwen-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab=512,
    param_dtype=torch.float32,
    max_seq=128,
)


def get() -> ArchConfig:
    return ArchConfig(
        arch_id="codeqwen1.5-7b",
        model=CONFIG,
        smoke=SMOKE,
        mode="fsdp_tp",
        qcfg=QuantConfig(8, 8),
        grad_accum=2,
    )
