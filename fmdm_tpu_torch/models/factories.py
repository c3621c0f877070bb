"""
Model factories: the JSON config vocabulary -> model constructors
(counterpart of ``fmdm_tpu/models/factories.py:69-236``).
``DiffusionUNetFactory`` builds both UNets: ``EfficientUNetND`` (the
``efficient_nd`` branch, the default ``unet_impl``) and ``UNetDiffusersND``;
of ``VAEFactory`` the ``kl`` branch is ported (``vq`` raises).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

from fmdm_tpu_torch.device import DeviceArg
from fmdm_tpu_torch.models.unet_diffusers import UNetDiffusersND
from fmdm_tpu_torch.models.unet_efficient import EfficientUNetND
from fmdm_tpu_torch.models.vae import VQVAE, AutoencoderKL

__all__ = ["DiffusionUNetFactory", "VAEFactory"]


class _Cfg:
    """Read-only view over a model config dict with typed, defaulted access."""

    def __init__(self, raw: Optional[Dict[str, Any]]):
        self.raw = dict(raw or {})

    def __contains__(self, key: str) -> bool:
        return key in self.raw

    def get(self, key: str, default=None):
        return self.raw.get(key, default)

    def int(self, key: str, default: int) -> int:
        return int(self.raw.get(key, default))

    def float(self, key: str, default: float) -> float:
        return float(self.raw.get(key, default))

    def bool(self, key: str, default: bool) -> bool:
        return bool(self.raw.get(key, default))

    def str(self, key: str, default: str) -> str:
        return str(self.raw.get(key, default))

    def dims(self, key: str, default):
        """int-or-sequence coerced to tuple; absent/None -> default."""
        value = self.raw.get(key)
        if value is None:
            return default
        return (value,) if isinstance(value, int) else tuple(value)


def _mult_from_widths(widths, base: int):
    """Recover a channel-mult ladder from absolute per-stage widths."""
    if not widths:
        return ()
    base = base or widths[0]
    return tuple(max(1, int(w // base)) for w in widths)


class DiffusionUNetFactory:
    """Builds EfficientUNetND / UNetDiffusersND from a model config dict,
    accepting both native and diffusers-style keys."""

    DEFAULT_BLOCK_CHANNELS = (128, 128, 256, 256, 512, 512)
    _DIFFUSERS_IMPLS = frozenset({"diffusers_nd", "diffusers_exact_nd", "exact_nd", "diffusers"})

    def build(self, model_cfg: Dict[str, Any], conditioning: Optional[str] = None,
              channels: Optional[int] = None, *, device: DeviceArg = None):
        cfg = _Cfg(model_cfg)
        impl = cfg.str("unet_impl", "efficient_nd").lower()
        cond_mode = (conditioning or "").lower()
        if impl in self._DIFFUSERS_IMPLS:
            return self._build_diffusers_nd(cfg, cond_mode, channels, device)
        return self._build_efficient_nd(cfg, cond_mode, channels, device)

    def _build_efficient_nd(self, cfg: _Cfg, cond_mode: str, channels: Optional[int],
                            device: DeviceArg):
        widths = cfg.dims("block_out_channels", self.DEFAULT_BLOCK_CHANNELS)
        base_width = cfg.int("model_channels", widths[0] if widths else 128)

        in_ch = cfg.get("in_channels", channels or 1)
        cond_ch = cfg.get("conditioning_channels", channels or in_ch)
        if cond_mode == "concatenate":
            # channel-stacked conditioning enters through the input conv
            in_ch = in_ch + cond_ch

        # attention conditioning places cross-attention wherever
        # self-attention lives (and in the middle, unless the key is given)
        attn_res = cfg.dims("attention_resolutions", (1,))
        xattn_res = cfg.get("cross_attention_resolutions")
        xattn_mid = cfg.bool("cross_attention_in_middle", False)
        if xattn_res is None and cond_mode == "attention":
            xattn_res = attn_res
            if "cross_attention_in_middle" not in cfg:
                xattn_mid = True

        return EfficientUNetND(
            spatial_dims=cfg.int("spatial_dims", 2),
            in_channels=in_ch,
            model_channels=base_width,
            out_channels=cfg.get("out_channels", channels or 1),
            num_res_blocks=cfg.int("num_res_blocks", cfg.get("layers_per_block", 2)),
            attention_resolutions=attn_res,
            cross_attention_resolutions=xattn_res,
            cross_attention_dim=cfg.int("cross_attention_dim", cond_ch),
            cross_attention_in_middle=xattn_mid,
            dropout=cfg.float("dropout", 0.0),
            channel_mult=cfg.dims("channel_mult", _mult_from_widths(widths, base_width)) or (1, 2, 3, 4),
            conv_resample=cfg.bool("conv_resample", True),
            dim_head=cfg.int("dim_head", 64),
            num_heads=cfg.int("num_heads", 4),
            use_linear_attn=cfg.bool("use_linear_attn", True),
            use_scale_shift_norm=cfg.bool("use_scale_shift_norm", True),
            emb_activation_before_proj=cfg.bool("emb_activation_before_proj", False),
            pool_factor=cfg.int("pool_factor", 1),
            device=device,
        )

    @staticmethod
    def _default_block_layout(cond_mode: str):
        if cond_mode == "attention":
            return (
                ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
                ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
                "UNetMidBlock2DCrossAttn",
            )
        return (
            ("DownBlock2D",) + ("AttnDownBlock2D",) * 3,
            ("AttnUpBlock2D",) * 3 + ("UpBlock2D",),
            "UNetMidBlock2D",
        )

    def _build_diffusers_nd(self, cfg: _Cfg, cond_mode: str, channels: Optional[int],
                            device: DeviceArg):
        in_ch = cfg.int("in_channels", channels or 1)
        cond_ch = cfg.int("conditioning_channels", channels or in_ch)
        if cond_mode == "concatenate" and not cfg.bool("in_channels_already_conditioned", False):
            in_ch = in_ch + cond_ch

        default_down, default_up, default_mid = self._default_block_layout(cond_mode)

        return UNetDiffusersND(
            spatial_dims=cfg.int("spatial_dims", 2),
            sample_size=cfg.get("sample_size"),
            in_channels=in_ch,
            out_channels=cfg.int("out_channels", channels or 1),
            center_input_sample=cfg.bool("center_input_sample", False),
            time_embedding_type=cfg.str("time_embedding_type", "positional"),
            freq_shift=cfg.int("freq_shift", 0),
            flip_sin_to_cos=cfg.bool("flip_sin_to_cos", True),
            down_block_types=cfg.get("down_block_types", default_down),
            mid_block_type=cfg.get("mid_block_type", default_mid),
            up_block_types=cfg.get("up_block_types", default_up),
            block_out_channels=cfg.dims("block_out_channels", (224, 448, 672, 896)),
            layers_per_block=cfg.int("layers_per_block", 2),
            downsample_padding=cfg.int("downsample_padding", 1),
            dropout=cfg.float("dropout", 0.0),
            attention_head_dim=cfg.int("attention_head_dim", 8),
            norm_num_groups=cfg.int("norm_num_groups", 32),
            norm_eps=cfg.float("norm_eps", 1e-5),
            resnet_time_scale_shift=cfg.str("resnet_time_scale_shift", "default"),
            add_attention=cfg.bool("add_attention", True),
            cross_attention_dim=cfg.int("cross_attention_dim", cond_ch) if cond_mode == "attention" else None,
            device=device,
        )


class VAEFactory:
    """Builds ``AutoencoderKL`` or ``VQVAE`` (``latent_type`` "kl" / "vq")
    from a ``{training, model}`` JSON config.

    The selector keys (``latent_type``, ``model_type``, ``norm_type``,
    ``act``) are peeled off and the rest is forwarded as constructor kwargs,
    with the "None"-string normalization of the JAX factory."""

    _STRING_NONE_KEYS = ("emb_channels", "ckpt_path", "down_channels")
    _MODELS = {"kl": AutoencoderKL, "vq": VQVAE}

    def build_from_json(self, json_path, *, device: DeviceArg = None):
        path = Path(json_path)
        if not path.exists():
            raise FileNotFoundError(f"Config not found: {path}")
        cfg = json.loads(path.read_text())
        if "model" not in cfg:
            raise ValueError("Config must contain a 'model' section.")
        return self.build(cfg["model"], device=device)

    def build(self, model_cfg: Dict[str, Any], *, device: DeviceArg = None):
        """The model of a config's ``model`` section."""
        if model_cfg.get("model_type", "vae").lower() != "vae":
            raise ValueError(f"Expected model_type 'vae', got '{model_cfg.get('model_type')}'.")
        vae_cfg = self._normalize(model_cfg)
        latent_type = vae_cfg.get("latent_type", "kl").lower()
        model_cls = self._MODELS.get(latent_type)
        if model_cls is None:
            raise ValueError(
                f"Unsupported latent_type '{latent_type}'. Expected one of {list(self._MODELS)}.")
        kwargs = {k: v for k, v in vae_cfg.items()
                  if k not in ("latent_type", "model_type", "norm_type", "act")}
        kwargs.setdefault("in_channels", 3)
        kwargs.setdefault("out_channels", vae_cfg.get("in_channels", 3))
        kwargs.setdefault("resolution", 256)
        kwargs["block_norm_type"] = vae_cfg.get("norm_type", "gn")
        kwargs["block_act"] = vae_cfg.get("act", "silu")
        return model_cls(**kwargs, device=device)

    @classmethod
    def _normalize(cls, model_cfg: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(model_cfg)
        for key in cls._STRING_NONE_KEYS:
            value = out.get(key)
            if isinstance(value, str) and value.lower() == "none":
                out[key] = None
            elif key == "down_channels" and isinstance(value, list):
                out[key] = tuple(value)
        return out
