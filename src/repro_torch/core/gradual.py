"""Gradual quantization (paper §3.2): curriculum over bitwidth.

Train full-precision first, then re-train the SAME parameter tree at
successively lower bitwidths, each stage initialized from the previous one.
The teacher for distillation is the best-on-validation network found so far
(paper §4.2: "Each time we obtained a more accurate network ... the more
accurate network became the teacher").

The ladder is model-agnostic: the caller supplies a ``train_stage`` callable
so the same ladder runs the paper's CNNs and the assigned LM architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

from .quant import QuantConfig

# train_stage(params, qcfg, teacher, stage_idx) -> (new_params, val_metric)
TrainStageFn = Callable[[Any, QuantConfig, Optional[Any], int], Tuple[Any, float]]


@dataclasses.dataclass
class StageResult:
    qcfg: QuantConfig
    val_metric: float
    params: Any


@dataclasses.dataclass
class LadderResult:
    stages: List[StageResult]

    @property
    def final(self) -> StageResult:
        return self.stages[-1]

    @property
    def best(self) -> StageResult:
        return max(self.stages, key=lambda r: r.val_metric)

    def summary(self) -> List[Tuple[str, float]]:
        return [(r.qcfg.label(), r.val_metric) for r in self.stages]


def run_ladder(
    ladder: Sequence[QuantConfig],
    init_params: Any,
    train_stage: TrainStageFn,
    *,
    use_best_teacher: bool = True,
) -> LadderResult:
    """Run the gradual-quantization ladder.

    Each stage is initialized from the previous stage's parameters; the
    distillation teacher is the best network so far (or the immediately
    preceding one when ``use_best_teacher=False`` — the paper's Table 1 uses
    a fixed FP1 teacher, which callers express by wrapping ``train_stage``).
    """
    stages: List[StageResult] = []
    params = init_params
    teacher: Optional[Any] = None
    best_metric = float("-inf")
    for i, qcfg in enumerate(ladder):
        params, metric = train_stage(params, qcfg, teacher, i)
        stages.append(StageResult(qcfg, metric, params))
        if not use_best_teacher or metric > best_metric:
            best_metric = max(best_metric, metric)
            teacher = params
    return LadderResult(stages)


def no_gq_baseline(
    target: QuantConfig,
    fp_params: Any,
    train_stage: TrainStageFn,
) -> StageResult:
    """Table 1's "No GQ" ablation: jump straight from FP to the target bits."""
    params, metric = train_stage(fp_params, target, fp_params, 0)
    return StageResult(target, metric, params)
