"""Share (%) of the traced episode's K1 launches made at the full batch width B: what
straggler compaction leaves at full width."""


def read(rec):
    by_width = rec.get("launches_by_width")
    if not by_width:
        return None
    total = sum(n for (k, _), n in by_width.items() if k == "ric")
    if not total:
        return None
    return 100.0 * by_width.get(("ric", rec["B"]), 0) / total
