"""``device_busy_ms.train`` / ``.sample``: the device's busy time per step or
per call over the traced window (the union of its kernel and copy
intervals, over the units traced). The card's own share of a unit's time:
steady where the host's pace wanders, so a change to the work on the device
shows here apart from the host."""


def read(r):
    if r.units <= 0 or r.busy_s <= 0:
        return None
    return 1e3 * r.busy_s / r.units
