"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attention 1:2. [arXiv:2402.19427; hf]

Pattern (RG-LRU, RG-LRU, local-attn window 2048) x 8 + (RG-LRU, RG-LRU) = 26
layers, exactly the Griffin layout. Decode state is O(1) per RG-LRU layer +
a 2048-slot ring buffer per local-attn layer, which is why this arch RUNS
the long_500k cell. The RG-LRU elementwise recurrence stays FP (DESIGN.md
§Arch-applicability); all projections are FQ layers.

Counterpart of ``repro.configs.recurrentgemma_2b``, dtypes as torch dtypes.
"""
from __future__ import annotations

import torch

from ..core.quant import QuantConfig
from ..models.transformer import LayerSpec, TransformerConfig
from .base import ArchConfig

_WINDOW = 2048

CONFIG = TransformerConfig(
    name="recurrentgemma-2b",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    rnn_width=2560,
    pattern=(LayerSpec(mixer="rglru"), LayerSpec(mixer="rglru"),
             LayerSpec(window=_WINDOW)),
    tie_embeddings=True,             # gemma family ties in/out embeddings
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="recurrentgemma-smoke",
    n_layers=5,                      # (R,R,A) + (R,R) remainder
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=512,
    head_dim=16,
    rnn_width=64,
    pattern=(LayerSpec(mixer="rglru"), LayerSpec(mixer="rglru"),
             LayerSpec(window=16)),
    param_dtype=torch.float32,
    max_seq=128,
)


def get() -> ArchConfig:
    return ArchConfig(
        arch_id="recurrentgemma-2b",
        model=CONFIG,
        smoke=SMOKE,
        mode="fsdp_tp",
        qcfg=QuantConfig(8, 8),
        notes="RG-LRU recurrence kept FP (not a dot product); local-attn "
              "ring-buffer cache bounds long_500k to 2048 slots/layer.",
    )
