"""K2's share (%) of its roofline in the traced episode: fwd_kernel and fwd_staged_kernel.
Each solve's first K2 launch is its rollout (one step of the ladder, at full width); the
others are line searches at the width of that iteration's K1 launch."""
import re

from bench_port.roofline import bound_s, lanes_of

KERNEL = re.compile(r"::fwd(_staged)?_kernel<")


def read(rec):
    dev = sum(s for name, s in rec.get("device_ops", {}).items() if KERNEL.search(name))
    by_width = rec.get("launches_by_width", {})
    search = lanes_of(by_width, "ric")
    rollouts = lanes_of(by_width, "fwd") - search
    if dev <= 0 or not search:
        return None
    bound = bound_s(rec["roofline"], "fwd", search) + bound_s(rec["roofline"], "fwd.rollout", rollouts)
    return 100.0 * bound / dev
