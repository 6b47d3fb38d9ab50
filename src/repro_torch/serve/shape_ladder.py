"""Shape-ladder normalization for mixed-shape CNN serving.

Counterpart of ``repro.serve.shape_ladder``, in numpy alone. The batcher
(:mod:`.cnn_batching`) captures one CUDA graph per (input shape, batch
slots) signature, so a frontend that forwarded arbitrary request shapes
would capture without bound. The ladder folds every request onto a small
*configured* set of target shapes before bucketing, so the signature count
is bounded by ``len(ladder.shapes) * (log2(max_batch) + 1)`` per payload
dtype, whatever shapes traffic brings.

Two normalization policies, both pure crop/pad (no resampling arithmetic):

  * ``frames`` -- rank-2 ``(T, feat)`` payloads (KWS MFCC frames, audio /
    vision token grids): center-crop when the request has more frames than
    the chosen rung, zero-pad (centered) when it has fewer. ``feat`` is a
    hard contract (n_mfcc / feature width).
  * ``image`` -- rank-3 ``(H, W, C)`` payloads (DarkNet image planes):
    letterbox -- center the plane on the chosen rung and zero-pad the
    border; oversized dimensions center-crop. ``C`` is preserved exactly
    (a channel mismatch is a ladder miss, never a conversion).

Both policies are **quantizer-commuting**, so they may run on int8 *codes*
as well as on float payloads and the integer path stays integer end to
end: the learned quantizer maps 0.0 to code 0 for both clip bounds, hence
``Q(pad0(x)) == pad0(Q(x))`` and ``Q(crop(x)) == crop(Q(x))``.

Rung selection: the smallest rung that fits the request in every spatial
dimension (pure pad); if the request exceeds the largest rung in any
dimension, the largest rung hosts it (crop the oversized dims, pad the
rest). A payload whose rank or feature/channel dim matches no spec is a
*ladder miss* -- ``normalize`` returns None and the caller decides (the
batcher serves it raw under its own bucket and counts ``ladder_misses``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def center_crop_pad(x: np.ndarray, axis: int, target: int) -> np.ndarray:
    """Center-crop or zero-pad ``x`` along ``axis`` to ``target`` length.

    Odd deficits/excesses put the extra element on the trailing side.
    Zero is the pad value in both domains (float 0.0 == code 0).
    """
    cur = x.shape[axis]
    if cur == target:
        return x
    if cur > target:
        lo = (cur - target) // 2
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(lo, lo + target)
        return np.ascontiguousarray(x[tuple(sl)])
    lo = (target - cur) // 2
    widths = [(0, 0)] * x.ndim
    widths[axis] = (lo, target - cur - lo)
    return np.pad(x, widths)


@dataclasses.dataclass(frozen=True)
class LadderSpec:
    """One modality's rung set.

    kind:  "frames" -> payload rank 2, spatial axis 0, sizes are ints (T);
           "image"  -> payload rank 3, spatial axes (0, 1), sizes are
           (H, W) pairs.
    sizes: the rungs, ascending.
    feat:  the fixed trailing dim (n_mfcc / feature width / channels).
    """
    kind: str
    sizes: Tuple
    feat: int

    def __post_init__(self):
        if self.kind not in ("frames", "image"):
            raise ValueError(f"unknown ladder kind {self.kind!r}")
        if not self.sizes:
            raise ValueError("a LadderSpec needs at least one rung")
        norm = tuple(
            (int(s), int(s)) if self.kind == "image" and np.isscalar(s)
            else (tuple(int(v) for v in s) if self.kind == "image"
                  else int(s))
            for s in self.sizes)
        if self.kind == "image" and any(len(s) != 2 for s in norm):
            raise ValueError("image rungs must be (H, W) pairs")
        if self.kind == "image":
            # area-ascending, so first-fit picks the cheapest hosting rung
            # even for non-square rung sets (lexicographic order would let
            # a skinny (12, 200) rung shadow a (16, 16) one)
            norm = sorted(norm, key=lambda s: (s[0] * s[1], s))
        else:
            norm = sorted(norm)
        object.__setattr__(self, "sizes", tuple(norm))

    @property
    def rank(self) -> int:
        return 2 if self.kind == "frames" else 3

    @property
    def shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """The full target shapes this spec can emit."""
        if self.kind == "frames":
            return tuple((t, self.feat) for t in self.sizes)
        return tuple((h, w, self.feat) for h, w in self.sizes)

    def _spatial(self, size) -> Tuple[int, ...]:
        return (size,) if self.kind == "frames" else tuple(size)

    def matches(self, shape: Tuple[int, ...]) -> bool:
        return len(shape) == self.rank and shape[-1] == self.feat

    def target_for(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Spatial dims of the rung hosting ``shape`` (must match first)."""
        req = shape[:-1]
        for size in self.sizes:  # ascending: smallest rung that fits
            tgt = self._spatial(size)
            if all(r <= t for r, t in zip(req, tgt)):
                return tgt
        return self._spatial(self.sizes[-1])  # oversized: crop to the top


class ShapeLadder:
    """Normalizes request payloads onto the union of its specs' rungs."""

    def __init__(self, *specs: LadderSpec):
        if not specs:
            raise ValueError("ShapeLadder needs at least one LadderSpec")
        self.specs = tuple(specs)

    @property
    def shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """Every target shape the ladder can emit (the signature bound)."""
        out = []
        for spec in self.specs:
            out.extend(s for s in spec.shapes if s not in out)
        return tuple(out)

    def spec_for(self, shape: Tuple[int, ...]) -> Optional[LadderSpec]:
        for spec in self.specs:
            if spec.matches(shape):
                return spec
        return None

    def normalize(self, x: np.ndarray) -> Optional[np.ndarray]:
        """Crop/pad ``x`` onto its rung; None on a ladder miss.

        Works identically on float payloads and int8 code payloads (the
        quantizer-commuting property in the module docstring).
        """
        x = np.asarray(x)
        spec = self.spec_for(x.shape)
        if spec is None:
            return None
        for axis, tgt in enumerate(spec.target_for(x.shape)):
            x = center_crop_pad(x, axis, tgt)
        return x
