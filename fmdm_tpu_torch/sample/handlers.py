"""
Samplers and model handlers (counterpart of ``fmdm_tpu/sample/handlers.py``):
``BaseSampler`` -> ``AbstractSampler`` -> ``DiffusionLikeSampler`` /
``VAESampler``, and ``ModelHandler`` with a lazily built ``sampler``, under
the thin ``DiffusionHandler``, ``FlowMatchingHandler`` and ``VAEHandler``.
Users call e.g. ``DiffusionHandler(ckpt_dir=..., device="cuda").evaluate()``.
``VAESampler`` runs the modes of :mod:`fmdm_tpu_torch.sample.autoencoder_like`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

from fmdm_tpu_torch.sample import autoencoder_like, diffusion_like
from fmdm_tpu_torch.sample.sampling_utils import build_tensor_cache_from_config, load_run_config


class BaseSampler:
    """The options of a run, and the tensor-cache build."""

    def __init__(self, **kwargs):
        self.options: Dict[str, Any] = dict(kwargs)
        self.ckpt_dir = Path(kwargs["ckpt_dir"])

    def build_tensor_cache(self) -> int:
        return build_tensor_cache_from_config(
            load_run_config(self.ckpt_dir),
            self.options.get("data_txt"),
            int(self.options.get("batch_size", 4)),
            int(self.options.get("seed", 42)),
            self.options.get("num_samples"),
        )


class AbstractSampler(BaseSampler):
    """The encode/decode/sample/evaluate/debug_compare contract."""

    def encode(self):
        raise NotImplementedError

    def decode(self):
        raise NotImplementedError

    def sample(self):
        raise NotImplementedError

    def evaluate(self):
        raise NotImplementedError

    def debug_compare(self):
        raise NotImplementedError


class AbstractAutoencoderSampler(AbstractSampler):
    """Marker base of the autoencoder samplers."""


_DECODE_OPTIONS = ("ckpt_dir", "data_txt", "save", "output_dir", "batch_size", "device", "seed",
                   "num_samples", "save_input", "save_conditioning", "num_inference_steps",
                   "start_step", "last_n_steps", "scheduler", "save_tensor_cache", "latent_vae")


class DiffusionLikeSampler(AbstractSampler):
    """The modes of :mod:`fmdm_tpu_torch.sample.diffusion_like`; ``sample``
    is ``decode``."""

    def __init__(self, model_type: str, **kwargs):
        super().__init__(**kwargs)
        self.model_type = model_type

    def _common(self, keys):
        return {k: self.options.get(k) for k in keys if k in self.options}

    def encode(self):
        return diffusion_like._run_encode(
            model_type=self.model_type,
            **self._common(("ckpt_dir", "data_txt", "save", "output_dir", "batch_size",
                            "device", "seed", "timestep", "num_samples", "save_tensor_cache")),
        )

    def decode(self):
        return diffusion_like._run_decode(model_type=self.model_type, **self._common(_DECODE_OPTIONS))

    def sample(self):
        return self.decode()

    def evaluate(self):
        return diffusion_like._run_evaluate(model_type=self.model_type, **self._common(_DECODE_OPTIONS))

    def debug_compare(self):
        return diffusion_like._run_debug_compare(
            model_type=self.model_type,
            **self._common(("ckpt_dir", "data_txt", "output_dir", "device", "seed",
                            "num_samples", "num_inference_steps", "start_step",
                            "last_n_steps", "scheduler", "save_tensor_cache")),
        )


class VAESampler(AbstractAutoencoderSampler):
    """The modes of :mod:`fmdm_tpu_torch.sample.autoencoder_like`."""

    def encode(self):
        return autoencoder_like.encode(**self.options)

    def decode(self):
        return autoencoder_like.decode(**self.options)

    def sample(self):
        return autoencoder_like.sample(**self.options)

    def evaluate(self):
        return autoencoder_like.evaluate(**self.options)

    def debug_compare(self):
        return autoencoder_like.debug_compare(**self.options)


class ModelHandler:
    """A handler that builds its sampler on first use."""

    sampler_cls = None
    model_type: Optional[str] = None

    def __init__(self, ckpt_dir, **kwargs):
        self._options = dict(kwargs)
        self._options["ckpt_dir"] = Path(ckpt_dir)
        self._sampler = None

    def create_sampler(self):
        if self.model_type is not None:
            return self.sampler_cls(model_type=self.model_type, **self._options)
        return self.sampler_cls(**self._options)

    @property
    def sampler(self):
        if self._sampler is None:
            self._sampler = self.create_sampler()
        return self._sampler

    def encode(self):
        return self.sampler.encode()

    def decode(self):
        return self.sampler.decode()

    def sample(self):
        return self.sampler.sample()

    def evaluate(self):
        return self.sampler.evaluate()

    def build_tensor_cache(self):
        return self.sampler.build_tensor_cache()

    def debug_compare(self):
        return self.sampler.debug_compare()


class VAEHandler(ModelHandler):
    sampler_cls = VAESampler
    model_type = None


class DiffusionHandler(ModelHandler):
    sampler_cls = DiffusionLikeSampler
    model_type = "diffusion"


class FlowMatchingHandler(ModelHandler):
    sampler_cls = DiffusionLikeSampler
    model_type = "flow_matching"


# the reference's name beside VAESampler
AutoencoderSampler = VAESampler
