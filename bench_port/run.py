"""The benchmark of tube_mpc_tpu_torch: one run of one cell, one JSON line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The cell is an entry of
``workloads`` in BENCHMARK.json; its configuration (``bench_port/configs/<config>.json``),
its traffic (``bench_port/traffic/<traffic>.json``: the mode, the batch, the compaction
caps, the warm-up and the check's sample), its mode (``bench_port/modes/<mode>.py``), the
limits of its check (``bench_port/limits/<cell>.json``) and each metric's reader
(``bench_port/metrics/<metric>.py``) are files found by name.

Set-up (``setup_s``): imports, the program's set-up of the configuration, and a warm-up
episode that loads the variant's kernel libraries (building them on a fresh checkout) and
runs every kernel the cell uses. The window then runs whole episodes back to back,
starting the next while fewer than ``--seconds`` have passed; each draws one of the
traffic's disturbance pools, chosen by the seed and the episode, and deals it to the lanes
in an order drawn from the seed. With ``--trace 1`` the window's first episode is profiled
and the line holds the per-layer metrics; otherwise the end-to-end ones. After the window the kept steps are
replayed by the plain reference (``modes/<mode>.py``), and ``correct`` says whether every
number compared is within its limit; the numbers and limits close the line and the
standard error.

It exits with 2 and prints no result without enough CUDA devices, and with 3 if JAX or
the JAX package was loaded into the process.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench_port"
FORBIDDEN = {"jax", "jaxlib", "flax", "tube_mpc_tpu"}


def seed_of(seed: int, *salt: int) -> int:
    """A generator seed for one purpose of run ``seed`` (an episode's draw, its kept steps,
    the check's sample)."""
    s = seed % (1 << 61)
    for v in salt:
        s = (s * 1_000_003 + 7_919 * (v + 1)) % (1 << 61)
    return s


def load_cell(name: str) -> dict:
    """The cell ``name``: its BENCHMARK.json entry, configuration, traffic and limits."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    read = lambda *p: json.loads(BENCH.joinpath(*p).read_text())
    return dict(entry=entry, manifest=manifest,
                config=read("configs", f"{entry['config']}.json"),
                traffic=read("traffic", f"{entry['traffic']}.json"),
                limits=read("limits", f"{name}.json"))


def metrics_of(cell: dict, kind: str, rec: dict) -> dict:
    """{metric: {value, unit}} of the cell's ``kind`` metrics ("end_to_end" or
    "per_layer") that their readers find something to read for."""
    out = {}
    for m in cell["manifest"][kind]:
        value = importlib.import_module(f"bench_port.metrics.{m['name']}").read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def prepare(cell: dict, device: str):
    """The cell's mode on ``device``: the program's set-up of the configuration, then whole
    episodes that load (or build) the kernel libraries, run every kernel the cell uses and
    fill the allocator's cache (the first episode of a process runs ~30% slower than the
    next ones)."""
    traffic = cell["traffic"]
    mode = importlib.import_module(f"bench_port.modes.{traffic['mode']}").Mode(
        cell["config"], traffic, device)
    for e in range(int(traffic["warmup_episodes"])):
        episode(mode, -1, -1 - e, mode.H)
    return mode


def pool(mode, seed: int, e: int):
    """The disturbance pool of episode ``e`` of run ``seed``: B sequences of H steps,
    uniform in the configuration's box, drawn on the card from the traffic's
    ``pool_seeds[(seed + e) % len(pool_seeds)]``. The lanes are computed alone
    (``grad_clip_norm`` 0), so an episode's work is its pool's (the straggler tail sets a
    step's iterations), and every run of a few episodes deals every pool alike."""
    import torch

    seeds = mode.traffic["pool_seeds"]
    g = torch.Generator(device=mode.device).manual_seed(int(seeds[(seed + e) % len(seeds)]))
    return mode.draw(g, mode.H)


def episode(mode, seed: int, e: int, steps: int, tracer=None):
    """Episode ``e`` of run ``seed``: its pool's sequences dealt to the lanes in an order
    drawn from the seed, one call of the entry, synchronized; returns (lanes failed, the
    kept steps)."""
    import torch

    check = mode.traffic["check"]
    order = torch.Generator(device=mode.device).manual_seed(seed_of(seed, 0, e))
    pick = torch.Generator().manual_seed(seed_of(seed, 1, e))
    later = torch.randperm(steps - 1, generator=pick)[:check["steps_per_episode"] - 1] + 1
    sampler = mode.sampler([0] + sorted(later.tolist()),
                           torch.randperm(mode.B, generator=pick)[:check["lanes_per_step"]])
    w = pool(mode, seed, e)[torch.randperm(mode.B, generator=order, device=mode.device), :steps]
    with tracer if tracer is not None else contextlib.nullcontext():
        log = mode.episode(w, sampler)
        if mode.device.startswith("cuda"):
            torch.cuda.synchronize()
    return int(mode.failed_lanes(log).sum()), sampler.kept


def window(mode, seed: int, seconds: float, tracer=None) -> dict:
    """Whole episodes back to back, the next started while fewer than ``seconds`` have
    passed (at least one); the first one under ``tracer`` if given."""
    kept, failed, ends = [], 0, []
    t_start = time.perf_counter()
    while True:
        f, k = episode(mode, seed, len(ends), mode.H, tracer if not ends else None)
        ends.append(time.perf_counter() - t_start)
        failed += f
        kept += k
        if ends[-1] >= seconds:
            break
    return dict(window_s=ends[-1], episodes=len(ends), failed=failed, kept=kept,
                episode_s=[b - a for a, b in zip([0.0] + ends, ends)])


def check_seed(seed: int):
    """The generator that draws the check's sample of run ``seed``."""
    import torch

    return torch.Generator().manual_seed(seed_of(seed, 2))


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object."""
    import torch

    cuda = device.startswith("cuda")
    mode = prepare(cell, device)
    gc.collect()
    gc.freeze()   # set-up's objects out of the window's collections
    setup_s = time.perf_counter() - T0

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tracer = None
    if trace:
        from bench_port.trace import Tracer

        tracer = Tracer(mode)
    win = window(mode, seed, seconds, tracer)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else None

    rec = dict(B=mode.B, steps=win["episodes"] * mode.H, window_s=win["window_s"],
               peak_bytes=peak, setup_s=setup_s, traced_steps=mode.H,
               roofline=importlib.import_module("bench_port.roofline").table(cell["entry"]["config"]))
    if tracer is not None:
        rec.update(tracer.record)
    del mode.setup
    if cuda:
        torch.cuda.empty_cache()

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t_check = time.perf_counter()
    nums = mode.check(win["kept"], check_seed(seed), int(mode.traffic["check"]["samples"]))
    print(f"setup_s {setup_s:.3f} episodes {win['episodes']} window_s {win['window_s']:.3f} "
          f"check_s {time.perf_counter() - t_check:.3f} trace_reduce_s "
          f"{rec.get('reduce_s', 0.0):.3f} episode_s "
          f"{' '.join(f'{v:.3f}' for v in win['episode_s'])}", file=sys.stderr)
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    correct = all(v == v and v <= limits[k] for k, v in nums.items())

    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=int(cell["entry"]["chips"]), memory_peak_bytes=peak)
    out = dict(correct=correct, attempted=mode.B * win["episodes"], failed=win["failed"],
               metrics=metrics_of(cell, "per_layer" if trace else "end_to_end", rec), device=dev)
    if tracer is not None and tracer.record.get("traced_window_s"):
        dev.update(busy_s=tracer.record["busy_s"], window_s=tracer.record["traced_window_s"])
        out["breakdown"] = tracer.record["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    """Run the command line ``argv`` on the cell's cards."""
    ap = argparse.ArgumentParser(prog="python3 bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)   # one host thread drives the card; none competes with it
    cell = load_cell(args.workload)
    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")

    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if loaded:
        print(f"the process loaded {', '.join(loaded)}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
