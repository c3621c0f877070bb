"""``device_idle_pct.train`` / ``.sample``: the share of the traced window in
which no kernel or copy ran on the device (busy time is the union of their
intervals). Read under the profiler, which slows the host's launches: where
the host paces the device, this reads above the untraced window's idle
share."""


def read(r):
    if r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (r.window_s - r.busy_s) / r.window_s
