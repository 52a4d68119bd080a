"""The end-to-end scheduling pipeline: TorchScheduler (tpu_scheduler.py)."""

from .tpu_scheduler import TorchScheduler

__all__ = ["TorchScheduler"]
