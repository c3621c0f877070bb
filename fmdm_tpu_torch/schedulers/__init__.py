"""Schedulers (counterpart of ``fmdm_tpu/schedulers``)."""

from fmdm_tpu_torch.schedulers.base import Scheduler
from fmdm_tpu_torch.schedulers.dpm import DPMSolverMultistepScheduler

__all__ = ["Scheduler", "DPMSolverMultistepScheduler"]
