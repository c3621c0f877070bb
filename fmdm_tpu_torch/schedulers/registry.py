"""
Scheduler registry, builder and CLI alias resolution (counterpart of
``fmdm_tpu/schedulers/registry.py:25-122``): the same registry names, the same
alias table, the same constructor-kwarg filtering by signature.

Names whose classes are not ported yet stay in the registry as the class's
name; :func:`build_scheduler` raises ``NotImplementedError`` naming it when
it looks one up.
"""

from __future__ import annotations

import inspect
import json
from typing import Dict, Optional, Tuple, Union

from fmdm_tpu_torch.schedulers.base import Scheduler
from fmdm_tpu_torch.schedulers.ddpm import DDPMScheduler
from fmdm_tpu_torch.schedulers.dpm import DPMSolverMultistepScheduler
from fmdm_tpu_torch.schedulers.flow_match import FlowMatchEulerDiscreteScheduler

SCHEDULER_REGISTRY: Dict[str, Union[type, str]] = {
    "ddpm": DDPMScheduler,
    "ddim": "DDIMScheduler",
    "dpm_multistep": DPMSolverMultistepScheduler,
    "dpm_sde": "DPMSolverSDEScheduler",
    "unipc": "UniPCMultistepScheduler",
    "flow_match_euler": FlowMatchEulerDiscreteScheduler,
    "flowmatch": FlowMatchEulerDiscreteScheduler,
}

_ALIASES = {
    "ddpm": {"name": "ddpm"},
    "ddim": {"name": "ddim"},
    "dpmsolver1": {"name": "dpm_multistep", "params": {"solver_order": 1, "algorithm_type": "dpmsolver"}},
    "dpmsolver2": {"name": "dpm_multistep", "params": {"solver_order": 2, "algorithm_type": "dpmsolver"}},
    "dpmsolver++": {"name": "dpm_multistep", "params": {"solver_order": 2, "algorithm_type": "dpmsolver++"}},
    "dpmsolversde": {"name": "dpm_sde"},
    "unipc": {"name": "unipc"},
    "flowmatch": {"name": "flow_match_euler"},
    "flow_match_euler": {"name": "flow_match_euler"},
}


def resolve_conditioning_mode(value) -> Optional[str]:
    if value is None:
        return None
    value = str(value).strip().lower()
    return value if value else None


def build_scheduler(spec: Optional[Dict], training_cfg: Optional[Dict]) -> Tuple[Scheduler, int]:
    """Instantiate a scheduler from config dicts; returns (scheduler, num_inference).

    The name comes from ``spec['name']``, else ``training_cfg['scheduler']``,
    else 'ddpm'; ``num_train_timesteps`` and ``num_inference_steps`` from the
    spec, else the training section (defaults 1000 and num_train)."""
    scheduler_cfg = dict(spec or {})
    training_cfg = dict(training_cfg or {})
    name = scheduler_cfg.get("name") or training_cfg.get("scheduler") or "ddpm"
    key = str(name).lower()
    if key not in SCHEDULER_REGISTRY:
        raise ValueError(f"Unknown scheduler '{name}'. Available: {', '.join(SCHEDULER_REGISTRY)}")
    cls = SCHEDULER_REGISTRY[key]
    if isinstance(cls, str):
        raise NotImplementedError(f"scheduler '{key}': {cls} is not ported yet")
    num_train_steps = int(
        scheduler_cfg.get("num_train_timesteps") or training_cfg.get("num_train_timesteps") or 1000)
    params = dict(scheduler_cfg.get("params", {}))
    sig = inspect.signature(cls.create)
    if not any(p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
        params = {k: v for k, v in params.items() if k in sig.parameters}
    scheduler = cls.create(num_train_timesteps=num_train_steps, **params)
    num_inference = int(scheduler_cfg.get("num_inference_steps")
                        or training_cfg.get("num_inference_steps") or num_train_steps)
    return scheduler, num_inference


def resolve_scheduler_override(name: Optional[str]) -> Optional[Dict]:
    """Map a user-facing scheduler alias to a scheduler config override.

    Optional query-string parameters follow a '?': "dpmsolver++?thresholding=true,order=3"
    (values parsed as JSON literals, bare words kept as strings)."""
    if not name:
        return None
    key = str(name).strip().lower()
    if not key:
        return None
    extra: Dict = {}
    if "?" in key:
        key, _, qs = key.partition("?")
        for kv in filter(None, qs.split(",")):
            k, _, v = kv.partition("=")
            try:
                extra[k] = json.loads(v)
            except ValueError:
                extra[k] = v
    if key in _ALIASES:
        cfg = dict(_ALIASES[key])
    elif key in SCHEDULER_REGISTRY:
        cfg = {"name": key}
    else:
        raise ValueError(f"Unknown scheduler override '{name}'. "
                         f"Available: {', '.join(sorted(_ALIASES))}")
    if extra:
        cfg["params"] = {**cfg.get("params", {}), **extra}
    return cfg
