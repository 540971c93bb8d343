"""K1's share (%) of its roofline in the traced episode: the least time its launches can
take (roofline table, at each launch's width) over its device time in the trace."""
import re

from bench_port.roofline import bound_s, lanes_of

KERNEL = re.compile(r"::ric_kernel<")


def read(rec):
    dev = sum(s for name, s in rec.get("device_ops", {}).items() if KERNEL.search(name))
    lanes = lanes_of(rec.get("launches_by_width", {}), "ric")
    if dev <= 0 or not lanes:
        return None
    return 100.0 * bound_s(rec["roofline"], "ric", lanes) / dev
