"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655, InternViT + InternLM2 backbone. [arXiv:2404.16821; hf]

The InternViT frontend is a STUB per the assignment: ``input_specs()``
provides precomputed (B, 256, 1024) patch embeddings; a learned FQ adapter
projects them into the LM backbone, occupying the first 256 positions of
every sequence (labels cover only the text positions).

Counterpart of ``repro.configs.internvl2_1b``, dtypes as torch dtypes.
"""
from __future__ import annotations

import torch

from ..core.quant import QuantConfig
from ..models.frontends import VISION_INTERNVL, FrontendConfig
from ..models.transformer import TransformerConfig
from .base import ArchConfig

CONFIG = TransformerConfig(
    name="internvl2-1b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    head_dim=64,
    frontend=VISION_INTERNVL,
    rope_theta=1000000.0,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="internvl2-smoke",
    n_layers=3,
    d_model=56,
    n_heads=4,
    n_kv_heads=2,
    d_ff=112,
    vocab=512,
    head_dim=14,
    frontend=FrontendConfig("vision", feat_dim=32, n_positions=8),
    param_dtype=torch.float32,
    max_seq=128,
)


def get() -> ArchConfig:
    return ArchConfig(
        arch_id="internvl2-1b",
        model=CONFIG,
        smoke=SMOKE,
        mode="fsdp_tp",
        qcfg=QuantConfig(8, 8),
        notes="ViT frontend stubbed to precomputed patch embeddings; "
              "vocab 151655 indivisible by 16 -> replicated vocab dim.",
    )
