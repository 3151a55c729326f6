"""Classification metrics (answers to ``repro/core/metrics.py``;
macro-F1 matches the paper's Table 1)."""
from __future__ import annotations

import torch


def confusion_matrix(y_true: torch.Tensor, y_pred: torch.Tensor, n_classes: int) -> torch.Tensor:
    idx = y_true.long() * n_classes + y_pred.long()
    cm = torch.bincount(idx, minlength=n_classes * n_classes)
    return cm.view(n_classes, n_classes).to(torch.float32)


def f1_macro(y_true: torch.Tensor, y_pred: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Macro-F1 over the classes present in ``y_true`` (a 0-dim tensor)."""
    cm = confusion_matrix(y_true, y_pred, n_classes)
    tp = torch.diagonal(cm)
    fp = torch.sum(cm, dim=0) - tp
    fn = torch.sum(cm, dim=1) - tp
    precision = tp / torch.clamp_min(tp + fp, 1e-12)
    recall = tp / torch.clamp_min(tp + fn, 1e-12)
    f1 = 2 * precision * recall / torch.clamp_min(precision + recall, 1e-12)
    present = (torch.sum(cm, dim=1) > 0).to(torch.float32)
    return torch.sum(f1 * present) / torch.clamp_min(torch.sum(present), 1.0)
