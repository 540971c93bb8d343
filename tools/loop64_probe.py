#!/usr/bin/env python3
"""Where a short f64 lane loop on the card parts from the CPU's, and why.

    python3 tools/loop64_probe.py                    # Dubins' coupled loop at H=3 and H=5
    python3 tools/loop64_probe.py --kind paper --family cartpole --H 5
    python3 tools/loop64_probe.py --kind paper --family dubins_min_log --H 5

--family is a system or one of chip_smoke.MINLOG's configurations (its library variant).

For each H it runs chip_smoke.loop64_case (B=256, N=50, f64) four ways: through the
kernels on the card; through the plain versions on the card (chip_smoke.plain_on_card);
and through the plain versions on the CPU, once as given and once with the start and the
disturbances times 1 + 1e-15 (the two CPU loops in worker processes, beside the card's).
For every log field (over all H steps) and every final raw parameter it prints the
largest difference of: the kernels against the plain versions on the card; the card
against the CPU; the plain versions on the card against the CPU; the perturbed CPU loop
against the CPU's own. For the three fields where the card comes nearest to or goes
furthest over its tolerance against the CPU (chip_smoke's), it prints the lane and step
where that lies and the four loops' values there.

A gap that the kernels do not show against the plain versions on the same card, and
that the CPU's own 1e-15 perturbation reproduces in size, is a last-bit difference of
the card's math library grown by the loop, not a fault of the kernels. It checks
nothing: it prints, and exits 0 (2 without a card).
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PERTURBED = 1.0 + 1e-15


def worst_point(torch, cs, field, loops, tol):
    """(|card - cpu| over its tolerance, index, {loop: value}) where loops["card"] is
    furthest from loops["cpu"] in `field`, as a share of the tolerance (the index into the
    field's tensor [B, H, ...] or the raw leaf's)."""
    rtol, atol = tol[field.split(".")[0]]
    vals = {name: cs.loop_fields(out)[field].cpu() for name, out in loops.items()}
    ref = vals["cpu"]
    share = ((vals["card"] - ref).abs() / (atol + rtol * ref.abs())).nan_to_num(nan=float("inf"))
    flat = int(share.argmax())
    idx = tuple(int(i) for i in torch.unravel_index(torch.tensor(flat), share.shape))
    return float(share.max()), idx, {name: float(v[idx]) for name, v in vals.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", choices=("paper", "coupled"), default="coupled")
    ap.add_argument("--family", default="dubins")
    ap.add_argument("--H", type=int, nargs="+", default=[3, 5])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("loop64_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tube_mpc_tpu_torch.ops.cuda import _build

    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    _build.build([_build.library_name(src, args.family) for src in _build.SOURCES])
    dev = torch.device("cuda", 0)
    tol = cs.COUPLED_LOOP_TOL if args.kind == "coupled" else cs.LOOP_TOL
    workers = max(1, min(2 * len(args.H), (os.cpu_count() or 2) - 1))
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        cpu = {(H, scale): pool.apply_async(cs.cpu_loop64, (args.kind, args.family, H, scale))
               for H in args.H for scale in (1.0, PERTURBED)}
        for H in args.H:
            st, run, w = cs.loop64_case(torch, args.kind, args.family, dev, H)
            loops = {"card": run(st, w, dev)}
            with cs.plain_on_card():
                loops["plain card"] = run(st, w, dev)
            torch.cuda.synchronize()
            for name, scale in (("cpu", 1.0), ("cpu perturbed", PERTURBED)):
                loops[name] = cs.tree_map(torch.as_tensor, cpu[H, scale].get()[0])
            pairs = (("kernels - plain, card", "card", "plain card"), ("card - cpu", "card", "cpu"),
                     ("plain card - cpu", "plain card", "cpu"),
                     ("cpu perturbed - cpu", "cpu perturbed", "cpu"))
            diffs = {label: cs.loop_diffs(loops[a], loops[b], H, tol) for label, a, b in pairs}
            tag = f"[{args.kind} {args.family} B={cs.LOOP64_B} N={cs.N} H={H} f64]"
            for field in diffs["card - cpu"]:
                print(f"{tag} {field}: " + "; ".join(
                    f"{label} {d[field][0]!r}{'' if d[field][1] else ' OVER'}"
                    for label, d in diffs.items()), flush=True)
            bitwise = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
                cs.loop_fields(loops["card"]).values(), cs.loop_fields(loops["plain card"]).values()))
            print(f"{tag} kernels and plain versions on the card bitwise equal: {bitwise}")
            worst = sorted(((*worst_point(torch, cs, f, loops, tol), f)
                            for f in diffs["card - cpu"]), key=lambda r: -r[0])
            for share, idx, vals, field in worst[:3]:
                print(f"{tag} {field}: |card - cpu| is {share!r} of its tolerance at {idx}; "
                      f"the four loops there: {vals}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
