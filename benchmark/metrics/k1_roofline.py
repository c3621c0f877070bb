"""``k1_roofline.train`` / ``.sample``: K1's least time (x read once, y
written once, the f32 affine, a FiLM's scale and shift, at 3.35 TB/s) over
the device time of ``gn_cluster``, ``gn_stats`` and ``gn_apply``. Only the
forward calls: the backward is not K1's."""

from benchmark import counters


def read(r):
    measured = r.class_s.get("K1 group_norm_act", 0.0)
    if measured <= 0:
        return None
    return 100.0 * counters.k1_bound_s(r.ops, r.dtype) * r.forwards_per_unit * r.units / measured
