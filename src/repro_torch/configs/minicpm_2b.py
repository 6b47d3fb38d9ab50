"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753, WSD learning-rate schedule (arch = llama-like).
[arXiv:2404.06395; hf]

Tied embeddings (MiniCPM shares input/output embedding). The WSD
(warmup-stable-decay) schedule lives in ``optim/schedules.py`` and is the
default schedule for this arch in ``launch/train.py``. The 122753 vocab is
deliberately not divisible by the 16-way model axis: the sharding rules
detect this and replicate the embedding's vocab dim (a real-world oddity the
framework must tolerate).

Counterpart of ``repro.configs.minicpm_2b``, dtypes as torch dtypes.
"""
from __future__ import annotations

import torch

from ..core.quant import QuantConfig
from ..models.transformer import TransformerConfig
from .base import ArchConfig

CONFIG = TransformerConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="minicpm-smoke",
    n_layers=3,
    d_model=48,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=509,              # also indivisible, like the real vocab
    tie_embeddings=True,
    param_dtype=torch.float32,
    max_seq=128,
)


def get() -> ArchConfig:
    return ArchConfig(
        arch_id="minicpm-2b",
        model=CONFIG,
        smoke=SMOKE,
        mode="fsdp_tp",
        qcfg=QuantConfig(8, 8),
        notes="WSD schedule (optim/schedules.py); tied embeddings; "
              "indivisible vocab exercises the replicate-fallback rule.",
    )
