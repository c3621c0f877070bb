"""
The sampling modes of the autoencoders, KL and VQ (counterpart of
``fmdm_tpu/sample/autoencoder_like.py:78-314``): ``encode`` (latents of the
data, saved), ``decode`` (the dataset's targets fed to the decoder as
latents), ``sample`` (reconstructions), ``evaluate`` (MSE, PSNR and SSIM of
the reconstructions against the data, the model's throughput, the per-image
and summary CSVs and ``run_config.json``) and ``debug_compare`` (one
sample's reconstruction, its tensors and statistics).

Each batch is stacked on the host, moved to the device once, run there in
one call, and copied back once; the metrics are computed in numpy, as the
JAX package computes them. A VQ model reconstructs in eval mode: its EMA
codebook is not updated. With several cards visible (and data-parallel
sampling on, as for the diffusion modes) each batch runs over them
(:func:`_make_dp_fn`): one replica of the model per card, a ragged batch
edge-padded to the card count, split, and cropped back.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fmdm_tpu_torch.data.dataset_utils import save_output_tensor
from fmdm_tpu_torch.data.dataset_utils import save_tensor_cache as _write_tensor
from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.parallel.mesh import DataMesh, pad_batch_to_multiple, replicate
from fmdm_tpu_torch.sample.diffusion_utils import _sampling_mesh
from fmdm_tpu_torch.sample.engine import on_device
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
from fmdm_tpu_torch.sample.vae_utils import (
    build_vae_model,
    decode_vae_batch,
    encode_vae_batch,
    reconstruct_vae_batch,
)
from fmdm_tpu_torch.utils.config import set_seed
from fmdm_tpu_torch.utils.evaluation import compute_ssim_sample


def _stack_targets(samples) -> np.ndarray:
    return np.stack([np.asarray(s["target"], np.float32) for s in samples], axis=0)


def _load(ckpt_dir, device: DeviceArg):
    """(config, model in eval mode on the device, recon_type, device) of a
    VAE run dir."""
    device = resolve_device(device)
    cfg = load_run_config(Path(ckpt_dir))
    model = build_vae_model(cfg, device=device,
                            ckpt_path=resolve_checkpoint(Path(ckpt_dir), "vae")).eval()
    return cfg, model, cfg.get("training", {}).get("recon_type", "l1"), device


def _make_dp_fn(core, model, batch_size: int, device: torch.device,
                mesh: Optional[DataMesh] = None):
    """``run(batch) -> output on device``: ``core(model, x)`` on a host
    batch, over the cards of ``mesh`` (default: the sampling mesh of
    ``batch_size``; one card without one) with one replica of the model
    each, a ragged batch edge-padded to the card count, split, and cropped
    back to its rows."""
    mesh = mesh if mesh is not None else _sampling_mesh(batch_size, device)
    if mesh is not None and len(mesh.devices) == 1:
        mesh = None
    devices = mesh.devices if mesh is not None else (device,)
    replicas = replicate(mesh, model)

    @torch.no_grad()
    def run(batch: np.ndarray) -> torch.Tensor:
        padded, real = pad_batch_to_multiple(np.asarray(batch, np.float32), len(devices))
        outs = []
        for shard, replica, dev in zip(torch.from_numpy(padded).tensor_split(len(devices)),
                                       replicas, devices):
            with on_device(dev):
                outs.append(core(replica, shard.to(dev)))
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(devices[0], non_blocking=True) for o in outs])[:real]
    return run


def _runner(core, model, batch_size: int, device: torch.device):
    """``run(batch) -> numpy output``: :func:`_make_dp_fn`, copied back."""
    dp = _make_dp_fn(core, model, batch_size, device)
    return lambda batch: dp(batch).cpu().numpy()


def _save_outputs(dataset, indices, samples, outputs: np.ndarray, output_root: Path,
                  save_input: bool, save_conditioning: bool) -> None:
    for batch_idx, sample_idx in enumerate(indices):
        row = dataset.data[sample_idx]
        save_output_tensor(dataset, row, dataset.target_key, outputs[batch_idx],
                           output_root / "predicted")
        if save_input:
            save_output_tensor(dataset, row, dataset.target_key, samples[batch_idx]["target"],
                               output_root / "input")
        if save_conditioning and dataset.conditioning_key is not None:
            save_output_tensor(dataset, row, dataset.conditioning_key, samples[batch_idx]["image"],
                               output_root / "conditioning")


def encode(ckpt_dir, data_txt=None, save=False, output_dir=None, batch_size=4,
           device: DeviceArg = None, seed=42, timestep=None, num_samples=None,
           save_tensor_cache=False, **_):
    """Encode each selected sample (a KL posterior's mode, a VQ model's
    pre-quantization latent) and save the latents."""
    ckpt_dir = Path(ckpt_dir)
    set_seed(seed)
    cfg, model, _, device = _load(ckpt_dir, device)
    dataset = build_sampling_dataset(cfg, data_txt, evaluate=True,
                                     save_tensor_cache_override=save_tensor_cache)
    selected_indices = resolve_sample_indices(dataset, num_samples, seed=seed)
    experiment_dir = create_experiment_dir(
        output_dir=output_dir, mode="evaluate", scheduler="vae", last_n_steps=None,
        start_step=None, num_inference_steps=None, num_samples=num_samples,
        seed=seed, batch_size=batch_size)
    output_root = ((experiment_dir / "samples") if (save and experiment_dir is not None)
                   else resolve_output_root(ckpt_dir, output_dir, save))
    enc = _runner(encode_vae_batch, model, batch_size, device)
    for indices, samples in progress_batches(dataset, batch_size, "Autoencoder encode",
                                             indices=selected_indices):
        latents = enc(_stack_targets(samples))
        if output_root is not None:
            for batch_idx, sample_idx in enumerate(indices):
                save_output_tensor(dataset, dataset.data[sample_idx], dataset.target_key,
                                   latents[batch_idx], output_root)
    logging.info("Autoencoder encode completed for %d samples.", len(selected_indices))


def decode(ckpt_dir, data_txt=None, save=False, output_dir=None, batch_size=4,
           device: DeviceArg = None, seed=42, num_samples=None, save_input=False,
           save_conditioning=False, save_tensor_cache=False, **_):
    """Decode the dataset's targets as latents (a run dir whose data are
    latents) and save the images under ``predicted``."""
    ckpt_dir = Path(ckpt_dir)
    set_seed(seed)
    cfg, model, recon_type, device = _load(ckpt_dir, device)
    dataset = build_sampling_dataset(cfg, data_txt, save_tensor_cache_override=save_tensor_cache)
    selected_indices = resolve_sample_indices(dataset, num_samples, seed=seed)
    output_root = resolve_output_root(ckpt_dir, output_dir, save)
    dec = _runner(lambda m, z: decode_vae_batch(m, z, recon_type=recon_type), model, batch_size,
                  device)
    for indices, samples in progress_batches(dataset, batch_size, "Autoencoder decode",
                                             indices=selected_indices):
        recon = dec(_stack_targets(samples))
        if output_root is not None:
            _save_outputs(dataset, indices, samples, recon, output_root, save_input,
                          save_conditioning)
    logging.info("Autoencoder decode completed for %d samples.", len(selected_indices))


def sample(ckpt_dir, data_txt=None, save=False, output_dir=None, batch_size=4,
           device: DeviceArg = None, seed=42, num_samples=None, save_input=False,
           save_conditioning=False, save_tensor_cache=False, **_):
    """Reconstruct each selected sample and save the images under
    ``predicted``."""
    ckpt_dir = Path(ckpt_dir)
    set_seed(seed)
    cfg, model, recon_type, device = _load(ckpt_dir, device)
    dataset = build_sampling_dataset(cfg, data_txt, save_tensor_cache_override=save_tensor_cache)
    selected_indices = resolve_sample_indices(dataset, num_samples, seed=seed)
    output_root = resolve_output_root(ckpt_dir, output_dir, save)
    rec_fn = _runner(lambda m, x: reconstruct_vae_batch(m, x, recon_type=recon_type), model,
                     batch_size, device)
    for indices, samples in progress_batches(dataset, batch_size, "Autoencoder sample",
                                             indices=selected_indices):
        recon = rec_fn(_stack_targets(samples))
        if output_root is not None:
            _save_outputs(dataset, indices, samples, recon, output_root, save_input,
                          save_conditioning)
    logging.info("Autoencoder sample completed for %d samples.", len(selected_indices))


def evaluate(ckpt_dir, data_txt=None, save=False, output_dir=None, batch_size=4,
             device: DeviceArg = None, seed=42, num_samples=None, save_input=False,
             save_conditioning=False, save_tensor_cache=False, **_):
    """Reconstruct each selected batch and score it against its data: MSE,
    PSNR and SSIM per image and on average, and the model's throughput,
    written to ``eval_metrics.csv`` and ``eval_metrics_per_image.csv`` (in
    a new experiment dir under ``output_dir``, else appended in the run
    dir)."""
    ckpt_dir = Path(ckpt_dir)
    set_seed(seed)
    cfg, model, recon_type, device = _load(ckpt_dir, device)
    dataset = build_sampling_dataset(cfg, data_txt, evaluate=True,
                                     save_tensor_cache_override=save_tensor_cache)
    selected_indices = resolve_sample_indices(dataset, num_samples, seed=seed)
    experiment_dir = create_experiment_dir(
        output_dir=output_dir, mode="evaluate", scheduler="vae", last_n_steps=None,
        start_step=None, num_inference_steps=None, num_samples=num_samples,
        seed=seed, batch_size=batch_size)
    output_root = ((experiment_dir / "samples") if (save and experiment_dir is not None)
                   else resolve_output_root(ckpt_dir, output_dir, save))

    rec_fn = _make_dp_fn(lambda m, x: reconstruct_vae_batch(m, x, recon_type=recon_type), model,
                         batch_size, device)

    total_mse = total_psnr = total_ssim = 0.0
    count = ssim_count = 0
    timing = {"model_seconds": 0.0, "model_calls": 0}
    per_image_rows = []
    for indices, samples in progress_batches(dataset, batch_size, "Autoencoder evaluate",
                                             indices=selected_indices):
        targets = _stack_targets(samples)
        start = time.perf_counter()
        out = rec_fn(targets)
        if device.type == "cuda":
            torch.cuda.synchronize(out.device)
        timing["model_seconds"] += time.perf_counter() - start
        timing["model_calls"] += 1
        recon = np.clip(out.cpu().numpy(), 0.0, 1.0)
        targets_np = np.clip(targets, 0.0, 1.0)
        if output_root is not None:
            _save_outputs(dataset, indices, samples, recon, output_root, save_input,
                          save_conditioning)

        reduce_dims = tuple(range(1, recon.ndim))
        mse = np.mean((recon - targets_np) ** 2, axis=reduce_dims)
        psnr_values = 10.0 * np.log10(1.0 / np.clip(mse, 1e-12, None))
        total_mse += float(mse.sum())
        total_psnr += float(psnr_values.sum())
        ssim_values = [compute_ssim_sample(recon[i], targets_np[i]) for i in range(recon.shape[0])]
        for value in ssim_values:
            if value is not None:
                total_ssim += value
                ssim_count += 1
        for batch_idx, sample_idx in enumerate(indices):
            sample_d = samples[batch_idx]
            ssim = ssim_values[batch_idx]
            per_image_rows.append({
                "sample_index": sample_idx,
                "img_id": sample_d.get("img_id"),
                "img_path": sample_d.get("img_path"),
                "mse": f"{mse[batch_idx]:.8f}",
                "psnr": f"{psnr_values[batch_idx]:.6f}",
                "ssim": "" if ssim is None else f"{ssim:.6f}",
            })
        count += recon.shape[0]

    if count == 0:
        raise RuntimeError("No samples available for evaluation.")
    avg_mse = total_mse / count
    avg_psnr = total_psnr / count
    model_seconds = timing["model_seconds"]
    model_sps = count / model_seconds if model_seconds > 0 else 0.0
    print(f"Eval MSE: {avg_mse:.6f} | PSNR: {avg_psnr:.3f}")
    print(f"Model throughput: {model_sps:.3f} samples/s | "
          f"{model_seconds / max(count, 1):.6f} s/sample | model time {model_seconds:.3f}s")
    avg_ssim = total_ssim / ssim_count if ssim_count else None
    if avg_ssim is not None:
        print(f"Eval SSIM: {avg_ssim:.4f}")

    row = {
        "samples": count,
        "mse": f"{avg_mse:.8f}",
        "psnr": f"{avg_psnr:.6f}",
        "ssim": "" if avg_ssim is None else f"{avg_ssim:.6f}",
        "ssim_enabled": True,
        "model_seconds": f"{model_seconds:.6f}",
        "model_samples_per_second": f"{model_sps:.6f}",
        "model_seconds_per_sample": f"{(model_seconds / count) if count else 0.0:.8f}",
        "model_calls": timing["model_calls"],
    }
    metrics_root = experiment_dir if experiment_dir is not None else ckpt_dir
    if experiment_dir is not None:
        write_eval_metrics(metrics_root, row)
    else:
        append_eval_metrics(metrics_root, row)
    append_per_image_eval_metrics(metrics_root, per_image_rows)
    if experiment_dir is not None:
        run_cfg = {
            "mode": "evaluate", "model_type": "vae", "ckpt_dir": str(ckpt_dir),
            "data_txt": data_txt, "num_samples": num_samples,
            "batch_size": batch_size, "seed": seed, "save": save,
        }
        with (experiment_dir / "run_config.json").open("w") as fh:
            json.dump(run_cfg, fh, indent=2)


def debug_compare(ckpt_dir, data_txt=None, output_dir=None, device: DeviceArg = None, seed=42,
                  num_samples=None, save_tensor_cache=False, **_):
    """Reconstruct the first selected sample alone and dump its tensors
    (target, raw and clamped output), their exports through the dataset's
    writer and ``stats.json``."""
    ckpt_dir = Path(ckpt_dir)
    set_seed(seed)
    cfg, model, recon_type, device = _load(ckpt_dir, device)
    dataset = build_sampling_dataset(cfg, data_txt, evaluate=True,
                                     save_tensor_cache_override=save_tensor_cache)
    selected_indices = resolve_sample_indices(dataset, num_samples, seed=seed)
    if not selected_indices:
        raise RuntimeError("No samples available for debug_compare.")
    sample_idx = int(selected_indices[0])
    sample_d = dataset[sample_idx]
    row = dataset.data[sample_idx]

    target = np.asarray(sample_d["target"], np.float32)[None]
    recon = _runner(lambda m, x: reconstruct_vae_batch(m, x, recon_type=recon_type), model, 1,
                    device)(target)
    recon_clamped = np.clip(recon, 0.0, 1.0)

    debug_root = Path(output_dir) if output_dir else (ckpt_dir / "debug_compare")
    debug_root.mkdir(parents=True, exist_ok=True)
    _write_tensor(target, debug_root / "target.pt")
    _write_tensor(recon, debug_root / "generated_raw.pt")
    _write_tensor(recon_clamped, debug_root / "generated_clamped.pt")
    save_output_tensor(dataset, row, dataset.target_key, recon_clamped[0], debug_root / "generated")
    save_output_tensor(dataset, row, dataset.target_key, target[0], debug_root / "target")

    stats = {
        "model_type": "vae", "sample_index": sample_idx,
        "img_id": sample_d.get("img_id"), "img_path": sample_d.get("img_path"),
        "target_min": float(np.min(target)), "target_max": float(np.max(target)),
        "recon_min": float(recon.min()), "recon_max": float(recon.max()),
        "recon_mean": float(recon.mean()),
    }
    with (debug_root / "stats.json").open("w") as fh:
        json.dump(stats, fh, indent=2)
    print(f"Debug compare completed. Artifacts written to: {debug_root}")
