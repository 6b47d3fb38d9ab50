"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536, Finch: data-dependent decay. [arXiv:2404.05892; hf]

Attention-free: every layer is a time-mix (matrix-valued per-head state,
data-dependent decay) + channel-mix (squared-ReLU MLP). O(1) decode state
(no KV cache) -> runs the long_500k cell. The WKV state recurrence stays FP
(elementwise/stateful, not a MAC — DESIGN.md §Arch-applicability); the
r/k/v/g/o and channel-mix projections are all FQ layers.

Counterpart of ``repro.configs.rwkv6_7b``, dtypes as torch dtypes.
"""
from __future__ import annotations

import torch

from ..core.quant import QuantConfig
from ..models.transformer import LayerSpec, TransformerConfig
from .base import ArchConfig

CONFIG = TransformerConfig(
    name="rwkv6-7b",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # d / rwkv_head_dim (informational)
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    rwkv_head_dim=64,
    pattern=(LayerSpec(mixer="rwkv", ffn="channelmix"),),
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="rwkv6-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=224,
    vocab=512,
    rwkv_head_dim=16,
    pattern=(LayerSpec(mixer="rwkv", ffn="channelmix"),),
    param_dtype=torch.float32,
    max_seq=128,
)


def get() -> ArchConfig:
    return ArchConfig(
        arch_id="rwkv6-7b",
        model=CONFIG,
        smoke=SMOKE,
        mode="fsdp_tp",
        qcfg=QuantConfig(8, 8),
        notes="WKV recurrence kept FP; head-dim-64 matrix state; "
              "O(1)-state decode enables long_500k.",
    )
