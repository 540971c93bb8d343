"""torch.cuda.max_memory_allocated() over the window (reset at its start), in GiB."""


def read(rec):
    return None if rec.get("peak_bytes") is None else rec["peak_bytes"] / 2 ** 30
