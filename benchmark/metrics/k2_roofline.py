"""``k2_roofline.train`` / ``.sample``: the least time of the attention
calls K2 takes (T = S < 1024, d <= 64), forward only (its backward is plain
autograd), the larger of FLOPs over the bf16 peak and q, k, v, o over the
HBM rate, over the device time of ``small_t_attention``."""

from benchmark import counters


def read(r):
    measured = r.class_s.get("K2 small_t_attention", 0.0)
    if measured <= 0:
        return None
    bound = counters.attention_bound_s(r.ops, "k2", False, r.dtype)
    return 100.0 * bound * r.forwards_per_unit * r.units / measured
