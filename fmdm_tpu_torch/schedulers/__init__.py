"""Schedulers (counterpart of ``fmdm_tpu/schedulers``)."""

from fmdm_tpu_torch.schedulers.base import Scheduler
from fmdm_tpu_torch.schedulers.ddpm import DDPMScheduler
from fmdm_tpu_torch.schedulers.dpm import DPMSolverMultistepScheduler
from fmdm_tpu_torch.schedulers.flow_match import FlowMatchEulerDiscreteScheduler
from fmdm_tpu_torch.schedulers.registry import (
    SCHEDULER_REGISTRY,
    build_scheduler,
    resolve_conditioning_mode,
    resolve_scheduler_override,
)

__all__ = [
    "Scheduler", "DDPMScheduler", "DPMSolverMultistepScheduler",
    "FlowMatchEulerDiscreteScheduler", "SCHEDULER_REGISTRY", "build_scheduler",
    "resolve_conditioning_mode", "resolve_scheduler_override",
]
