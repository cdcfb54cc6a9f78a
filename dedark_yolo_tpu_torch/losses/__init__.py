"""The task-aligned assigner and the losses (JAX losses/__init__.py)."""

from .detection import LossItems, detection_loss
from .tal import AssignResult, select_candidates_in_gts, task_aligned_assign

__all__ = ["task_aligned_assign", "select_candidates_in_gts", "AssignResult",
           "detection_loss", "LossItems"]
