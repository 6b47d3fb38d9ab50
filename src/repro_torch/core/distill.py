"""Network distillation (paper §3.3, Hinton et al. 2015) and label refinery.

Counterpart of ``repro.core.distill``. The low-precision student learns
from the teacher's output probabilities: temperature distillation for
CIFAR / KWS, label refinery (temperature-free, Bagherinezhad et al. 2018)
for ImageNet / DarkNet-19.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits: torch.Tensor,
                          labels_onehot: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(labels_onehot * logp, dim=-1)


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor, labels: torch.Tensor, *,
                      temperature: float = 4.0, alpha: float = 0.9,
                      num_classes: Optional[int] = None) -> torch.Tensor:
    """alpha * T^2 * KL(teacher_T || student_T) + (1 - alpha) * CE(labels).

    The T^2 factor keeps gradient magnitudes comparable across
    temperatures. ``labels`` are integer class ids.
    """
    if num_classes is None:
        num_classes = student_logits.shape[-1]
    t = temperature
    t_dev = torch.tensor(t, dtype=student_logits.dtype,
                         device=student_logits.device)
    soft_teacher = torch.softmax(torch.div(teacher_logits, t_dev), dim=-1)
    log_soft_student = torch.log_softmax(torch.div(student_logits, t_dev),
                                         dim=-1)
    floor = torch.tensor(1e-12, dtype=soft_teacher.dtype,
                         device=soft_teacher.device)
    log_teacher = torch.log(torch.maximum(soft_teacher, floor))
    kl = torch.sum(soft_teacher * (log_teacher - log_soft_student), dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).to(student_logits.dtype)
    ce = softmax_cross_entropy(student_logits, onehot)
    return torch.mean(alpha * (t * t) * kl + (1.0 - alpha) * ce)


def label_refinery_loss(student_logits: torch.Tensor,
                        teacher_logits: torch.Tensor) -> torch.Tensor:
    """Cross-entropy against the teacher's probabilities, no temperature."""
    soft = torch.softmax(teacher_logits, dim=-1)
    logp = torch.log_softmax(student_logits, dim=-1)
    return -torch.mean(torch.sum(soft * logp, dim=-1))
