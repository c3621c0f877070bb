"""``flash_roofline.train`` / ``.sample``: the least time of the attention
calls the flash kernels take (T >= 1024): K3's forward, and in a train step
K4 + K5's backward (dq, dk, dv: twice the forward's products, q, k, v, o, do
read and dq, dk, dv written), over the device time of ``flash_fwd``,
``flash_bwd_dkv`` and ``flash_bwd_dq``."""

from benchmark import counters
from benchmark.devtrace import FLASH


def read(r):
    measured = sum(r.class_s.get(k, 0.0) for k in FLASH)
    if measured <= 0:
        return None
    bound = counters.attention_bound_s(r.ops, "flash", r.train, r.dtype)
    return 100.0 * bound * r.forwards_per_unit * r.units / measured
