"""Share (%) of the traced episode in which the card ran nothing: 1 - the union of its
kernel, copy and set intervals over the episode's span."""


def read(rec):
    if not rec.get("busy_s") or not rec.get("traced_window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["traced_window_s"])
