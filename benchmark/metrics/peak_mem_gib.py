"""``peak_mem_gib.train`` / ``.sample``: ``torch.cuda.max_memory_allocated``
over the traced window (reset at its start), in GiB."""


def read(r):
    return r.peak_bytes / 2 ** 30 if r.peak_bytes > 0 else None
