"""ArchConfig: one assigned architecture = model config + runtime policy.

Counterpart of ``repro.configs.base``."""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.quant import QuantConfig
from ..models.transformer import TransformerConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    model: TransformerConfig
    smoke: TransformerConfig
    # parameter partition mode of the mesh slice: "tp" replicates over data
    # (small models), "fsdp_tp" 2-D-shards every matrix (big models)
    mode: str = "fsdp_tp"
    # paper-faithful default QAT stage (gradual quantization walks the
    # arch's ladder down from here)
    qcfg: QuantConfig = QuantConfig(8, 8)
    # serving-side weight quantization bits (paper eq. 4 deployment)
    serve_bits_w: Optional[int] = 8
    # microbatches for gradient accumulation at the train_4k shape
    grad_accum: int = 1
    notes: str = ""
