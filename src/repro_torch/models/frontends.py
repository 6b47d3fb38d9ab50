"""Modality frontend stubs for the [audio] / [vlm] architectures, and the
serving shape ladders.

Counterpart of ``repro.models.frontends``. The transformer backbone is the
implemented system; a modality frontend is a stub that takes precomputed
frame / patch embeddings (``feature_spec`` gives their shape and dtype), and
a small learned adapter (an FQ projection, so the paper's quantization
applies from the first matmul) maps them into the backbone's d_model:

  * Whisper's conv frontend -> precomputed log-mel frame embeddings
    (B, n_frames, feat);
  * InternViT / llama4 early fusion -> precomputed patch embeddings
    (B, n_patches, feat).

The ``*_serving_ladder`` constructors bind each modality's shape contract
(n_mfcc / channels / feat_dim) to a :class:`..serve.shape_ladder.ShapeLadder`,
so the CNN batcher can fold arbitrary request shapes onto a bounded rung
set (crop/pad, quantizer-commuting).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..core.quant import QuantConfig
from ..serve.shape_ladder import LadderSpec, ShapeLadder
from . import layers as L


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    kind: str = "none"          # "none" | "audio" | "vision"
    feat_dim: int = 0           # frontend feature dim (80 mel / ViT width)
    n_positions: int = 0        # frames (audio) or patches (vision)

    @property
    def enabled(self) -> bool:
        return self.kind != "none"


AUDIO_WHISPER_TINY = FrontendConfig("audio", feat_dim=80, n_positions=1500)
VISION_INTERNVL = FrontendConfig("vision", feat_dim=1024, n_positions=256)
VISION_LLAMA4 = FrontendConfig("vision", feat_dim=1408, n_positions=144)


def init_adapter(gen, cfg: FrontendConfig, d_model: int,
                 dtype=torch.float32):
    """Learned adapter: frontend features -> backbone d_model (FQ layer)."""
    if not cfg.enabled:
        return {}
    return {"adapter": L.init_proj(gen, cfg.feat_dim, d_model, dtype)}


def apply_adapter(p, feats, cfg: FrontendConfig, qcfg: QuantConfig):
    """feats: (B, n_positions, feat_dim) precomputed embeddings -> (B, n, d)."""
    return L.proj(p["adapter"], feats, qcfg)


def feature_spec(cfg: FrontendConfig, batch: int, dtype=torch.bfloat16):
    """The precomputed features' shape and dtype, as a ``meta`` tensor (no
    storage), or None without a frontend."""
    if not cfg.enabled:
        return None
    return torch.empty((batch, cfg.n_positions, cfg.feat_dim), dtype=dtype,
                       device="meta")


def synthetic_features(gen: torch.Generator, cfg: FrontendConfig, batch: int,
                       dtype=torch.float32):
    """Deterministic stand-in features (standard normals from ``gen``, on
    its device) for smoke runs and examples."""
    if not cfg.enabled:
        return None
    return L.normal(gen, (batch, cfg.n_positions, cfg.feat_dim), dtype)


def kws_serving_ladder(cfg, frame_counts: Optional[Sequence[int]] = None
                       ) -> ShapeLadder:
    """MFCC frame-count ladder for ``models.kws`` requests ``(T, n_mfcc)``.

    Short clips zero-pad (silence), long clips center-crop. Rungs default
    to the config's training length. Every rung must exceed the dilated
    conv stack's receptive field or VALID padding leaves no frames.
    """
    counts = tuple(frame_counts) if frame_counts else (cfg.seq_len,)
    rf = 1 + (cfg.ksize - 1) * sum(cfg.dilations)
    if min(counts) < rf:
        raise ValueError(
            f"ladder rung {min(counts)} is below the KWS receptive field "
            f"{rf}; VALID convs would produce no output frames")
    return ShapeLadder(LadderSpec("frames", counts, cfg.n_mfcc))


def darknet_serving_ladder(cfg, sizes: Sequence) -> ShapeLadder:
    """Letterbox ladder for ``models.darknet`` requests ``(H, W, C)``.

    ``sizes`` are (H, W) rungs (ints mean square planes); channels are
    preserved exactly: a channel-count mismatch is a ladder miss, never a
    conversion. Every rung must survive the config's maxpool stack (each
    "M" halves the plane with VALID semantics), or normalized requests
    would reach an empty plane inside the conv stack at serve time.
    """
    ladder = ShapeLadder(LadderSpec("image", tuple(sizes), cfg.in_channels))
    floor = 2 ** sum(1 for layer in cfg.layers if layer == "M")
    for h, w in ladder.specs[0].sizes:
        if h < floor or w < floor:
            raise ValueError(
                f"ladder rung ({h}, {w}) collapses to an empty plane in "
                f"the config's maxpool stack; rungs need min dim >= "
                f"{floor}")
    return ladder


def frontend_serving_ladder(cfg: FrontendConfig,
                            positions: Optional[Sequence[int]] = None
                            ) -> Optional[ShapeLadder]:
    """Token-grid ladder for precomputed frontend features ``(n, feat)``.

    Audio frame embeddings and vision patch embeddings share the rank-2
    "frames" policy: crop/pad the position axis, pin ``feat_dim``.
    """
    if not cfg.enabled:
        return None
    counts = tuple(positions) if positions else (cfg.n_positions,)
    return ShapeLadder(LadderSpec("frames", counts, cfg.feat_dim))
