"""Share (%) of the traced episode's wall spent inside the entry's iLQR solves, by the
host's clock around each call: each solve ends in a host read, so its end is the card's."""


def read(rec):
    if not rec.get("traced_s"):
        return None
    return 100.0 * rec["solve_s"] / rec["traced_s"]
