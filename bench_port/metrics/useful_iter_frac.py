"""Share (%) of K1's lane-work that fell on lanes still unconverged: the lanes that entered
the lane solver's iterations unconverged (``solve_counts()["live_lane_iters"]``) over the
lanes of K1's launches (Σ width × launches of ``launch_counts(by_width=True)``), compacted
stages included. Both counters are the program's, zeroed together as the traced episode
starts and read once the window has closed (as host_reads_per_step). None for a program
without the counter, or where K1 never launched."""


def read(rec):
    if "launches" not in rec:
        return None
    try:
        from tube_mpc_tpu_torch.ops.cuda import launch_counts, solve_counts
    except ImportError:
        return None
    lanes = sum(b * n for (k, b), n in launch_counts(by_width=True).items() if k == "ric")
    if not lanes:
        return None
    return 100.0 * solve_counts()["live_lane_iters"] / lanes
