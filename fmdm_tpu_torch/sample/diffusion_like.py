"""
The sampling modes of the diffusion and flow-matching models (counterpart
of ``fmdm_tpu/sample/diffusion_like.py``): ``_run_encode`` (forward noising
of the data, saved), ``_run_decode`` (full or partial reverse sampling, with
the predictions, inputs and conditioning saved), ``_run_evaluate`` (MSE,
PSNR and SSIM against the data, model throughput, the per-image and summary
CSVs and ``run_config.json``) and ``_run_debug_compare`` (one sample's
tensors, a no-conditioning probe and their statistics).

Each batch is stacked on the host, moved to the device once, decoded there,
and its output copied back once. Random draws come from one
``torch.Generator`` on the device seeded by ``seed`` and continued from
batch to batch, where the JAX package splits a ``PRNGKey(seed)`` per batch:
the two packages, and a card and a CPU run, draw different noise. Under
``--deep_cache auto:<dPSNR>`` ``_run_evaluate`` resolves the setting on its
first batch of references before the timed loop, from a generator seeded
``seed + 1``. Under ``--latent_vae <vae run dir>[?scale=S]`` the samples
are latents: ``_run_decode`` and ``_run_evaluate`` decode them (and
``_run_evaluate`` the target latents too) through the VAE before saving and
scoring.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fmdm_tpu_torch.data.dataset_utils import save_output_tensor
from fmdm_tpu_torch.data.dataset_utils import save_tensor_cache as _write_tensor
from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.sample.diffusion_utils import (
    auto_deep_cache_pending,
    build_diffusion_model,
    decode_diffusion_batch,
    encode_diffusion_batch,
    resolve_auto_deep_cache,
)
from fmdm_tpu_torch.sample.sampling_utils import (
    append_eval_metrics,
    append_per_image_eval_metrics,
    build_sampling_dataset,
    create_experiment_dir,
    load_run_config,
    progress_batches,
    resolve_checkpoint,
    resolve_output_root,
    resolve_sample_indices,
    write_eval_metrics,
)
from fmdm_tpu_torch.sample.vae_utils import build_vae_model, decode_vae_batch
from fmdm_tpu_torch.schedulers import build_scheduler, resolve_conditioning_mode
from fmdm_tpu_torch.utils.config import set_seed
from fmdm_tpu_torch.utils.evaluation import compute_ssim_sample


def _stack(samples, key) -> Optional[torch.Tensor]:
    """The samples' ``key`` arrays as one f32 CPU batch, or None if any
    sample lacks one."""
    vals = [s.get(key) for s in samples]
    if any(v is None for v in vals):
        return None
    return torch.from_numpy(np.stack([np.asarray(v, np.float32) for v in vals], axis=0))


def _to(batch: Optional[torch.Tensor], device: torch.device) -> Optional[torch.Tensor]:
    return None if batch is None else batch.to(device)


def _conditioning_mode(training_cfg: dict, model_cfg: dict) -> Optional[str]:
    return resolve_conditioning_mode(training_cfg.get("conditioning") or model_cfg.get("conditioning"))


def _load_latent_vae(latent_vae, device: torch.device):
    """The latent-to-pixel decode of ``--latent_vae``, or None.

    ``latent_vae`` is a VAE run dir, optionally ``<run_dir>?scale=S`` where S
    is the factor the stored latents were multiplied by at encode time; the
    decode divides it back out before the VAE's decoder and maps the output
    to images in [0, 1] with the VAE config's ``recon_type``. Returns
    ``decode(latents) -> numpy images`` (latents a tensor or an array)."""
    if not latent_vae:
        return None
    path, scale = str(latent_vae), 1.0
    if "?" in path:
        path, _, query = path.partition("?")
        for item in filter(None, query.split(",")):
            key, _, value = item.partition("=")
            if key != "scale":
                raise ValueError(f"Unknown --latent_vae param '{key}'")
            scale = float(value)
    vae_dir = Path(path)
    vae_cfg = load_run_config(vae_dir)
    vae_model = build_vae_model(vae_cfg, device=device,
                                ckpt_path=resolve_checkpoint(vae_dir, "vae")).eval()
    recon_type = str(vae_cfg.get("training", {}).get("recon_type", "l1"))

    @torch.no_grad()
    def decode(latents) -> np.ndarray:
        raw = torch.as_tensor(latents, dtype=torch.float32).to(device) / scale
        return decode_vae_batch(vae_model, raw, recon_type=recon_type).cpu().numpy()

    return decode


def _save_batch_outputs(dataset, indices, samples, generated: np.ndarray, output_root: Path,
                        save_input: bool, save_conditioning: bool) -> None:
    """Each sample's prediction under ``output_root/predicted``, and its
    target and conditioning under ``input`` and ``conditioning`` on request."""
    for batch_idx, sample_idx in enumerate(indices):
        row = dataset.data[sample_idx]
        save_output_tensor(dataset, row, dataset.target_key, generated[batch_idx],
                           output_root / "predicted")
        if save_input:
            save_output_tensor(dataset, row, dataset.target_key, samples[batch_idx]["target"],
                               output_root / "input")
        if save_conditioning and dataset.conditioning_key is not None:
            save_output_tensor(dataset, row, dataset.conditioning_key, samples[batch_idx]["image"],
                               output_root / "conditioning")


def _run_encode(*, ckpt_dir, model_type: str, data_txt=None, save: bool = False,
                output_dir=None, batch_size: int = 4, device: DeviceArg = None, seed: int = 42,
                timestep=None, num_samples=None, save_tensor_cache: bool = False) -> None:
    """Noise each selected sample to ``timestep`` (else a random train
    timestep per sample) and save the noisy tensors."""
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    cfg = load_run_config(ckpt_dir)
    training_cfg, model_cfg = cfg["training"], cfg["model"]
    set_seed(seed)

    dataset = build_sampling_dataset(cfg, data_txt, save_tensor_cache_override=save_tensor_cache)
    selected_indices = resolve_sample_indices(dataset, num_samples, seed=seed)
    output_root = resolve_output_root(ckpt_dir, output_dir, save)

    scheduler, _ = build_scheduler(model_cfg.get("scheduler", {}), training_cfg)
    generator = torch.Generator(device).manual_seed(seed)
    for indices, samples in progress_batches(dataset, batch_size, f"{model_type} encode",
                                             indices=selected_indices):
        targets = _stack(samples, "target").to(device)
        if timestep is None:
            timesteps = torch.randint(0, scheduler.num_train_timesteps, (targets.shape[0],),
                                      generator=generator, device=device, dtype=torch.int32)
        else:
            timesteps = torch.full((targets.shape[0],), int(timestep), dtype=torch.int32, device=device)
        noisy = encode_diffusion_batch(scheduler, targets, timesteps, generator).cpu().numpy()
        if output_root is not None:
            for batch_idx, sample_idx in enumerate(indices):
                save_output_tensor(dataset, dataset.data[sample_idx], dataset.target_key,
                                   noisy[batch_idx], output_root)
    logging.info("%s encode completed for %d samples.", model_type.replace("_", "-").title(),
                 len(selected_indices))


def _run_decode(*, ckpt_dir, model_type: str, data_txt=None, save: bool = False,
                output_dir=None, batch_size: int = 4, device: DeviceArg = None, seed: int = 42,
                num_samples=None, save_input: bool = False, save_conditioning: bool = False,
                num_inference_steps=None, start_step=None, last_n_steps=None,
                scheduler=None, save_tensor_cache: bool = False, latent_vae=None) -> None:
    """Sample each selected batch (from noise, or from its noised data under
    ``start_step``/``last_n_steps``) and save the predictions, decoded to
    pixels through ``latent_vae`` when given."""
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    cfg = load_run_config(ckpt_dir)
    ckpt_path = resolve_checkpoint(ckpt_dir, model_type)
    training_cfg, model_cfg = cfg["training"], cfg["model"]
    set_seed(seed)

    dataset = build_sampling_dataset(cfg, data_txt, save_tensor_cache_override=save_tensor_cache)
    selected_indices = resolve_sample_indices(dataset, num_samples, seed=seed)
    output_root = resolve_output_root(ckpt_dir, output_dir, save)

    model = build_diffusion_model(cfg, ckpt_path=ckpt_path, device=device)
    conditioning_mode = _conditioning_mode(training_cfg, model_cfg)
    vae_decode = _load_latent_vae(latent_vae, device)
    generator = torch.Generator(device).manual_seed(seed)
    for indices, samples in progress_batches(dataset, batch_size, f"{model_type} decode",
                                             indices=selected_indices):
        targets = _stack(samples, "target")
        cond = _stack(samples, "image") if conditioning_mode in {"concatenate", "attention"} else None
        generated = decode_diffusion_batch(
            model, training_cfg, model_cfg, tuple(targets.shape), _to(cond, device),
            generator=generator,
            reference_batch=targets.to(device),
            init_from_reference=(start_step is not None) or (last_n_steps is not None),
            num_inference_steps=num_inference_steps,
            start_step=start_step, last_n_steps=last_n_steps,
            scheduler_override=scheduler, device=device,
        )
        generated = vae_decode(generated) if vae_decode is not None else generated.cpu().numpy()
        generated = np.clip(generated, 0.0, 1.0)
        if output_root is not None:
            _save_batch_outputs(dataset, indices, samples, generated, output_root, save_input,
                                save_conditioning)
    logging.info("%s decode completed for %d samples.", model_type.replace("_", "-").title(),
                 len(selected_indices))


def _run_evaluate(*, ckpt_dir, model_type: str, data_txt=None, save: bool = False,
                  output_dir=None, batch_size: int = 4, device: DeviceArg = None, seed: int = 42,
                  num_samples=None, save_input: bool = False, save_conditioning: bool = False,
                  num_inference_steps=None, start_step=None, last_n_steps=None,
                  scheduler=None, save_tensor_cache: bool = False, latent_vae=None) -> None:
    """Decode each selected batch and score it against its data: MSE, PSNR
    and SSIM per image and on average, and the model's throughput, written
    to ``eval_metrics.csv`` and ``eval_metrics_per_image.csv`` (in a new
    experiment dir under ``output_dir``, else appended in the run dir).
    Under ``latent_vae`` the samples and the targets are latents, and both
    are decoded to pixels before they are scored."""
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    cfg = load_run_config(ckpt_dir)
    ckpt_path = resolve_checkpoint(ckpt_dir, model_type)
    training_cfg, model_cfg = cfg["training"], cfg["model"]
    set_seed(seed)

    dataset = build_sampling_dataset(cfg, data_txt, evaluate=True,
                                     save_tensor_cache_override=save_tensor_cache)
    selected_indices = resolve_sample_indices(dataset, num_samples, seed=seed)
    experiment_dir = create_experiment_dir(
        output_dir=output_dir, mode="evaluate", scheduler=scheduler,
        last_n_steps=last_n_steps, start_step=start_step,
        num_inference_steps=num_inference_steps, num_samples=num_samples,
        seed=seed, batch_size=batch_size,
    )
    output_root = ((experiment_dir / "samples") if (save and experiment_dir is not None)
                   else resolve_output_root(ckpt_dir, output_dir, save))
    model = build_diffusion_model(cfg, ckpt_path=ckpt_path, device=device)
    conditioning_mode = _conditioning_mode(training_cfg, model_cfg)
    vae_decode = _load_latent_vae(latent_vae, device)

    # --deep_cache auto:<dPSNR>: resolved on the first batch of references,
    # at this run's settings, before the timed loop
    if auto_deep_cache_pending():
        probe = [dataset[i] for i in selected_indices[:batch_size]]
        probe_cond = (_stack(probe, "image")
                      if conditioning_mode in {"concatenate", "attention"} else None)
        resolve_auto_deep_cache(
            model, training_cfg, model_cfg, _stack(probe, "target"), _to(probe_cond, device),
            num_inference_steps=num_inference_steps, scheduler_override=scheduler,
            generator=torch.Generator(device).manual_seed(seed + 1), device=device,
            postprocess=vae_decode)

    total_mse = total_psnr = total_ssim = 0.0
    count = ssim_count = 0
    model_timing = {"model_seconds": 0.0, "model_calls": 0}
    per_image_rows = []
    generator = torch.Generator(device).manual_seed(seed)

    batch_iter = progress_batches(dataset, batch_size, f"{model_type} evaluate", indices=selected_indices)
    for indices, samples in batch_iter:
        targets = _stack(samples, "target")
        cond = _stack(samples, "image") if conditioning_mode in {"concatenate", "attention"} else None
        generated = decode_diffusion_batch(
            model, training_cfg, model_cfg, tuple(targets.shape), _to(cond, device),
            generator=generator, timing=model_timing,
            reference_batch=targets.to(device),
            init_from_reference=(start_step is not None) or (last_n_steps is not None),
            num_inference_steps=num_inference_steps,
            start_step=start_step, last_n_steps=last_n_steps,
            scheduler_override=scheduler, device=device,
        )
        if vae_decode is not None:
            # the latent chain: score in pixels, against the VAE's decode of
            # the target latents (what the chain can reach)
            generated = vae_decode(generated)
            targets_np = np.clip(vae_decode(targets), 0.0, 1.0)
        else:
            generated = generated.cpu().numpy()
            targets_np = np.clip(targets.numpy(), 0.0, 1.0)
        generated = np.clip(generated, 0.0, 1.0)
        if output_root is not None:
            _save_batch_outputs(dataset, indices, samples, generated, output_root, save_input,
                                save_conditioning)

        reduce_dims = tuple(range(1, generated.ndim))
        mse = np.mean((generated - targets_np) ** 2, axis=reduce_dims)
        psnr_values = 10.0 * np.log10(1.0 / np.clip(mse, 1e-12, None))
        total_mse += float(mse.sum())
        total_psnr += float(psnr_values.sum())
        ssim_values = [compute_ssim_sample(generated[i], targets_np[i]) for i in range(len(indices))]
        for value in ssim_values:
            if value is not None:
                total_ssim += value
                ssim_count += 1
        for batch_idx, sample_idx in enumerate(indices):
            sample = samples[batch_idx]
            ssim = ssim_values[batch_idx]
            per_image_rows.append({
                "sample_index": sample_idx,
                "img_id": sample.get("img_id"),
                "img_path": sample.get("img_path"),
                "mse": f"{mse[batch_idx]:.8f}",
                "psnr": f"{psnr_values[batch_idx]:.6f}",
                "ssim": "" if ssim is None else f"{ssim:.6f}",
            })
        count += generated.shape[0]
        if hasattr(batch_iter, "set_postfix"):
            running = {
                "mse": f"{(total_mse / max(count, 1)):.6f}",
                "psnr": f"{(total_psnr / max(count, 1)):.3f}",
                "sps": f"{(count / max(model_timing['model_seconds'], 1e-12)):.3f}",
            }
            if ssim_count > 0:
                running["ssim"] = f"{(total_ssim / ssim_count):.4f}"
            batch_iter.set_postfix(running)

    if count == 0:
        raise RuntimeError("No samples available for evaluation.")

    avg_mse = total_mse / count
    avg_psnr = total_psnr / count
    model_seconds = float(model_timing["model_seconds"])
    model_sps = count / model_seconds if model_seconds > 0 else 0.0
    model_s_per_sample = model_seconds / count
    logging.info("Eval MSE: %.6f | PSNR: %.3f", avg_mse, avg_psnr)
    print(f"Eval MSE: {avg_mse:.6f} | PSNR: {avg_psnr:.3f}")
    print(f"Model throughput: {model_sps:.3f} samples/s | "
          f"{model_s_per_sample:.6f} s/sample | model time {model_seconds:.3f}s")
    avg_ssim = None
    if ssim_count > 0:
        avg_ssim = total_ssim / ssim_count
        logging.info("Eval SSIM: %.4f", avg_ssim)
        print(f"Eval SSIM: {avg_ssim:.4f}")

    row = {
        "samples": count,
        "mse": f"{avg_mse:.8f}",
        "psnr": f"{avg_psnr:.6f}",
        "ssim": "" if avg_ssim is None else f"{avg_ssim:.6f}",
        "ssim_enabled": True,
        "model_seconds": f"{model_seconds:.6f}",
        "model_samples_per_second": f"{model_sps:.6f}",
        "model_seconds_per_sample": f"{model_s_per_sample:.8f}",
        "model_calls": model_timing["model_calls"],
    }
    metrics_root = experiment_dir if experiment_dir is not None else ckpt_dir
    metrics_path = (write_eval_metrics(metrics_root, row) if experiment_dir is not None
                    else append_eval_metrics(metrics_root, row))
    logging.info("Wrote eval metrics: %s", metrics_path)
    per_image_metrics_path = append_per_image_eval_metrics(metrics_root, per_image_rows)
    logging.info("Wrote per-image eval metrics: %s", per_image_metrics_path)
    if experiment_dir is not None:
        run_cfg = {
            "mode": "evaluate", "model_type": model_type, "ckpt_dir": str(ckpt_dir),
            "data_txt": data_txt, "scheduler": scheduler,
            "num_inference_steps": num_inference_steps, "start_step": start_step,
            "last_n_steps": last_n_steps, "num_samples": num_samples,
            "batch_size": batch_size, "seed": seed, "save": save,
            "save_input": save_input, "save_conditioning": save_conditioning,
            "latent_vae": None if latent_vae is None else str(latent_vae),
        }
        with (experiment_dir / "run_config.json").open("w") as fh:
            json.dump(run_cfg, fh, indent=2)


def _tensor_stats(name: str, tensor) -> dict:
    if tensor is None:
        return {"name": name, "present": False}
    t = np.asarray(tensor, np.float32)
    return {
        "name": name, "present": True, "shape": list(t.shape),
        "min": float(t.min()), "max": float(t.max()), "mean": float(t.mean()),
        "std": float(t.std(ddof=1)) if t.size > 1 else 0.0,
    }


def _run_debug_compare(*, ckpt_dir, model_type: str, data_txt=None, output_dir=None,
                       device: DeviceArg = None, seed: int = 42, num_samples=None,
                       num_inference_steps=None, start_step=None, last_n_steps=None,
                       scheduler=None, save_tensor_cache: bool = False) -> None:
    """Decode the first selected sample alone and dump its tensors (target,
    conditioning, raw and clamped output, and for concatenate conditioning
    the output with the conditioning zeroed, from the same draws), their
    exports through the dataset's writer and ``stats.json``."""
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    cfg = load_run_config(ckpt_dir)
    ckpt_path = resolve_checkpoint(ckpt_dir, model_type)
    training_cfg, model_cfg = cfg["training"], cfg["model"]
    set_seed(seed)

    dataset = build_sampling_dataset(cfg, data_txt, evaluate=True,
                                     save_tensor_cache_override=save_tensor_cache)
    selected_indices = resolve_sample_indices(dataset, num_samples, seed=seed)
    if not selected_indices:
        raise RuntimeError("No samples available for debug_compare.")
    sample_idx = int(selected_indices[0])
    sample = dataset[sample_idx]
    row = dataset.data[sample_idx]

    target = torch.from_numpy(np.asarray(sample["target"], np.float32))[None]
    cond = sample.get("image")
    cond_batch = torch.from_numpy(np.asarray(cond, np.float32))[None] if cond is not None else None

    model = build_diffusion_model(cfg, ckpt_path=ckpt_path, device=device)
    timing = {"model_seconds": 0.0, "model_calls": 0}
    generated_raw = decode_diffusion_batch(
        model, training_cfg, model_cfg, tuple(target.shape), _to(cond_batch, device),
        generator=torch.Generator(device).manual_seed(seed), timing=timing,
        reference_batch=target.to(device),
        init_from_reference=(start_step is not None) or (last_n_steps is not None),
        num_inference_steps=num_inference_steps, start_step=start_step,
        last_n_steps=last_n_steps, scheduler_override=scheduler, device=device,
    ).cpu().numpy()
    generated_clamped = np.clip(generated_raw, 0.0, 1.0)

    conditioning_mode = _conditioning_mode(training_cfg, model_cfg)
    generated_raw_no_cond = generated_clamped_no_cond = None
    no_cond_error = None
    if conditioning_mode == "concatenate":
        # a concatenate UNet has the conditioning's input channels: feed zeros
        zeros_cond = torch.zeros_like(cond_batch).to(device) if cond_batch is not None else None
        generated_raw_no_cond = decode_diffusion_batch(
            model, training_cfg, model_cfg, tuple(target.shape), zeros_cond,
            generator=torch.Generator(device).manual_seed(seed),
            num_inference_steps=num_inference_steps, start_step=start_step,
            last_n_steps=last_n_steps, scheduler_override=scheduler, device=device,
        ).cpu().numpy()
        generated_clamped_no_cond = np.clip(generated_raw_no_cond, 0.0, 1.0)
    elif conditioning_mode == "attention":
        no_cond_error = "Skipped no-cond probe: attention model requires context."

    debug_root = Path(output_dir) if output_dir else (ckpt_dir / "debug_compare")
    debug_root.mkdir(parents=True, exist_ok=True)

    _write_tensor(target.numpy(), debug_root / "target.pt")
    if cond_batch is not None:
        _write_tensor(cond_batch.numpy(), debug_root / "conditioning.pt")
    _write_tensor(generated_raw, debug_root / "generated_raw.pt")
    _write_tensor(generated_clamped, debug_root / "generated_clamped.pt")
    if generated_raw_no_cond is not None:
        _write_tensor(generated_raw_no_cond, debug_root / "generated_raw_no_cond.pt")
        _write_tensor(generated_clamped_no_cond, debug_root / "generated_clamped_no_cond.pt")

    save_output_tensor(dataset, row, dataset.target_key, generated_clamped[0], debug_root / "generated")
    save_output_tensor(dataset, row, dataset.target_key, target[0].numpy(), debug_root / "target")
    if dataset.conditioning_key is not None and cond is not None:
        save_output_tensor(dataset, row, dataset.conditioning_key, np.asarray(cond),
                           debug_root / "conditioning_export")
    if generated_clamped_no_cond is not None:
        save_output_tensor(dataset, row, dataset.target_key, generated_clamped_no_cond[0],
                           debug_root / "generated_no_cond")

    stats = {
        "model_type": model_type, "sample_index": sample_idx,
        "img_id": sample.get("img_id"), "img_path": sample.get("img_path"),
        "conditioning_mode": conditioning_mode, "timing": timing,
        "num_inference_steps": num_inference_steps, "start_step": start_step,
        "last_n_steps": last_n_steps, "scheduler_override": scheduler,
        "target": _tensor_stats("target", target),
        "conditioning": _tensor_stats("conditioning", cond_batch),
        "generated_raw": _tensor_stats("generated_raw", generated_raw),
        "generated_clamped": _tensor_stats("generated_clamped", generated_clamped),
        "generated_raw_no_cond": _tensor_stats("generated_raw_no_cond", generated_raw_no_cond),
        "generated_clamped_no_cond": _tensor_stats("generated_clamped_no_cond", generated_clamped_no_cond),
        "no_cond_note": no_cond_error,
    }
    with (debug_root / "stats.json").open("w") as fh:
        json.dump(stats, fh, indent=2)
    logging.info("Debug compare completed. Artifacts written to: %s", debug_root)
    print(f"Debug compare completed. Artifacts written to: {debug_root}")
