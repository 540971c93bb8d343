"""The lane solver's reads of the card by the host (one at each iteration's loop test, one
at each compaction stage's count of unconverged lanes) per closed-loop step, from the
program's counter (``tube_mpc_tpu_torch.ops.cuda.solve_counts()["host_reads"]``). The
traced run zeroes the counter as its episode starts (``reset_launch_counts``, in
bench_port/trace.py); this reads it once the window has closed, so the count covers the
window's ``steps``. None for a program without the counter."""


def read(rec):
    if "launches" not in rec or not rec.get("steps"):
        return None
    try:
        from tube_mpc_tpu_torch.ops.cuda import solve_counts
    except ImportError:
        return None
    return solve_counts()["host_reads"] / rec["steps"]
