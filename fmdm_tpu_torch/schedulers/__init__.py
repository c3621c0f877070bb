"""Schedulers (counterpart of ``fmdm_tpu/schedulers``)."""

from fmdm_tpu_torch.schedulers.base import Scheduler
from fmdm_tpu_torch.schedulers.ddim import DDIMScheduler
from fmdm_tpu_torch.schedulers.ddpm import DDPMScheduler
from fmdm_tpu_torch.schedulers.dpm import DPMSolverMultistepScheduler
from fmdm_tpu_torch.schedulers.dpm_sde import DPMSolverSDEScheduler
from fmdm_tpu_torch.schedulers.flow_match import FlowMatchEulerDiscreteScheduler
from fmdm_tpu_torch.schedulers.registry import (
    SCHEDULER_REGISTRY,
    build_scheduler,
    resolve_conditioning_mode,
    resolve_scheduler_override,
)
from fmdm_tpu_torch.schedulers.unipc import UniPCMultistepScheduler

__all__ = [
    "Scheduler", "DDIMScheduler", "DDPMScheduler", "DPMSolverMultistepScheduler",
    "DPMSolverSDEScheduler", "FlowMatchEulerDiscreteScheduler", "UniPCMultistepScheduler",
    "SCHEDULER_REGISTRY", "build_scheduler", "resolve_conditioning_mode",
    "resolve_scheduler_override",
]
