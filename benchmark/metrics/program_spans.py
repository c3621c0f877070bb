"""What the span readers share: the program's spans of the traced window
(``fmdm_tpu_torch/utils/trace.py``; they are recorded only while a profiler
session is active, and the harness profiles only that window), summed by
name per unit.

A reading is None, and nothing raises, where the program has no spans (a
checkout before them), where the window's root spans of the unit's kind
(``train.step`` per step, ``sample.call`` per call) are not one per unit
traced, or where a span read has no device time (no CUDA events: a CPU
run)."""

ROOTS = {True: "train.step", False: "sample.call"}


def window_spans(r):
    """The spans of the traced window, or None (see above)."""
    try:
        from fmdm_tpu_torch.utils import trace
    except ImportError:
        return None
    got = trace.spans()
    roots = sum(s.parent is None and s.name == ROOTS[r.train] for s in got)
    return got if r.units > 0 and roots == r.units else None


def ms_per_unit(r, names, host=False, per_step=False):
    """The device ms (``host``: host ms) of the spans named in ``names``,
    summed over the window, per unit (``per_step``: per model forward of a
    unit, a sampler's denoise step)."""
    got = window_spans(r)
    if got is None:
        return None
    picked = [s for s in got if s.name in names]
    if not picked or any(s.device_ms is None for s in picked):
        return None
    total = sum(s.host_ms if host else s.device_ms for s in picked)
    return total / r.units / (r.forwards_per_unit if per_step else 1)
