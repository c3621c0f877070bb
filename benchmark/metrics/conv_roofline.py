"""``conv_roofline.train`` / ``.sample``: the convolutions' least time at
the published peaks (per call the larger of FLOPs over the dtype's peak and
bytes over the HBM rate; a train step adds the wgrad, and the dgrad where
the input needs one) over the device time of the kernels classed as
convolution (cuDNN's, its layout transforms included)."""

from benchmark import counters


def read(r):
    measured = r.class_s.get("convolution", 0.0)
    if measured <= 0:
        return None
    bound = counters.conv_bound_s(r.ops, r.train, r.dtype) * r.forwards_per_unit * r.units
    return 100.0 * bound / measured
