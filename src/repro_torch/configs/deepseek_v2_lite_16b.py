"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 vocab=102400,
MLA kv_lora=512, MoE 64 routed top-6 + 2 shared. [arXiv:2405.04434; hf]

Assignment header says 64 experts; its note says "160 routed" which is the
full V2, not Lite — we follow the header (64, matching the HF checkpoint).
Layer 0 is a dense FFN (d_ff 10944) like the real model; layers 1..26 are
MoE. MLA: per-layer latent cache (ckv 512 + rope 64) instead of 16 heads x
2 x 128 KV — a ~8x decode-cache reduction that composes with the paper's
quantization (the latent is just another FQ projection output).

Counterpart of ``repro.configs.deepseek_v2_lite_16b``, dtypes as torch dtypes.
"""
from __future__ import annotations

import torch

from ..core.quant import QuantConfig
from ..models.mla import MLAConfig
from ..models.moe import MoEConfig
from ..models.transformer import LayerSpec, TransformerConfig
from .base import ArchConfig

_MLA = MLAConfig(kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
                 v_head_dim=128)
_MOE = MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                 capacity_factor=1.25)

CONFIG = TransformerConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    mla=_MLA,
    prefix=(LayerSpec(mixer="mla", d_ff=10944),),      # dense first layer
    pattern=(LayerSpec(mixer="mla", moe=_MOE),),
    rope_theta=10000.0,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="deepseek-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=512,
    mla=MLAConfig(kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    prefix=(LayerSpec(mixer="mla", d_ff=256),),
    pattern=(LayerSpec(mixer="mla",
                       moe=MoEConfig(8, 2, 96, n_shared=2)),),
    param_dtype=torch.float32,
    max_seq=128,
)


def get() -> ArchConfig:
    return ArchConfig(
        arch_id="deepseek-v2-lite-16b",
        model=CONFIG,
        smoke=SMOKE,
        mode="fsdp_tp",
        qcfg=QuantConfig(8, 8),
        grad_accum=2,
        notes="MLA latent KV cache; per-expert FQ scales (paper's per-layer "
              "scale -> per-expert: each expert is a layer).",
    )
