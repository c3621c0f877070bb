"""Flow-matching trainer (counterpart of ``fmdm_tpu/train/flow_matching_lib.py``):
t ~ U(0,1), x_t = (1-t)x0 + t*eps, velocity target v = eps - x0, 'flow' checkpoints."""

from fmdm_tpu_torch.train.denoise_lib import debug_visual_only as _debug, train as _train


def train(dataset, json_path, val_dataset=None, resume=None, **kwargs):
    return _train(dataset, json_path, val_dataset=val_dataset, resume=resume,
                  variant="flow_matching", **kwargs)


def debug_visual_only(dataset, json_path, ckpt_path, **kwargs):
    return _debug(dataset, json_path, ckpt_path, variant="flow_matching", **kwargs)
