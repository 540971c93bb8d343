"""K1 launches (the solves' iterations, compacted stages included) per closed-loop step
of the traced episode."""


def read(rec):
    if not rec.get("traced_steps") or "launches" not in rec:
        return None
    return rec["launches"].get("ric", 0) / rec["traced_steps"]
