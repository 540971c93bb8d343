"""Write ``roofline/<config>.json``: each lane kernel's bytes and operations per lane and
launch at the configuration's N, system and line-search ladder, in float32.

Bytes: each input read once and each output written once (of the const rows C only those
the kernel reads). Operations: every elementwise arithmetic or comparison operation of
the kernel's plain version, counted element by element on a few lanes of random inputs
(the plain versions take no branch on the data). This runs once, on the CPU, when a
configuration is added; the table it writes is the yardstick, and is not written again
when the kernels change:

    python3 bench_port/roofline/generate.py dubins quadrotor2d
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
HBM_BYTES_PER_S = 3.35e12   # one H100 SXM, NVIDIA's data sheet
PEAK_OPS_PER_S = 67e12      # float32 outside the tensor cores, same source
LANES = 8
REG_SENS, ACTIVE_TOL = 1e-9, 1e-8
C_ROWS_READ = {"sfwd": 3, "sfwd_generic": 3}   # K4 and K6 (generic) read α, γ, tight only
COUNTED = {"add", "sub", "rsub", "mul", "div", "neg", "exp", "log", "sin", "cos", "abs",
           "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where", "eq", "ne",
           "ge", "gt", "le", "lt", "isfinite", "isnan", "bitwise_or", "bitwise_and",
           "logical_or", "logical_and", "bitwise_not", "logical_not", "reciprocal", "_to_copy"}


def count_ops(fn, args) -> int:
    """Elementwise operations of fn(*args): each counted op adds its output's elements."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            if func.overloadpacket.__name__ in COUNTED and isinstance(out, torch.Tensor):
                Counter.ops += out.numel()
            return out

    with Counter():
        fn(*args)
    return Counter.ops


def kernels(pb, cfg, N: int):
    """{kernel: (plain version, input shapes, output shapes)} at N steps over LANES lanes."""
    from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd_plain, sbwd_upper_plain, sfwd_plain
    from tube_mpc_tpu_torch.ops.cuda.lane_solver import fwd_plain, ric_plain

    nh, m, B = pb.n_hat, pb.m, LANES
    na = len(cfg.alphas)
    nc = 2 * nh + m + 3
    X, U, C, x = (N, nh, B), (N, m, B), (nc, B), (nh, B)
    Kg, kf = (N, m * nh, B), (N, m, B)
    value = [(N, nh, B), (N, nh * nh, B), (N, 1, B)]
    grads = [(nh, B), (m, B)]
    generic_grads = grads + [(nh, B), (3, B)]
    return {
        "ric": (lambda *t: ric_plain(pb, cfg.reg, *t), [X, U, X, U, C, x], [Kg, kf]),
        "fwd": (lambda *t: fwd_plain(pb, cfg.alphas, *t), [x, X, U, Kg, kf, X, x, U, C],
                [(N, na * nh, B), (N, na * m, B), (na, B)]),
        "fwd.rollout": (lambda *t: fwd_plain(pb, (1.0,), *t), [x, X, U, Kg, kf, X, x, U, C],
                        [X, U, (1, B)]),
        "sbwd": (lambda *t: sbwd_plain(pb, REG_SENS, ACTIVE_TOL, *t), [U, X, X, C, x, x],
                 [Kg, kf]),
        "sfwd": (lambda *t: sfwd_plain(pb, *t), [Kg, kf, X, X, U, U, C, x, x], grads),
        "sbwd_generic": (lambda *t: sbwd_plain(pb, REG_SENS, ACTIVE_TOL, *t, generic=True),
                         [U, X, X, C, x, x], [Kg, kf] + value),
        "sbwd_upper": (lambda *t: sbwd_upper_plain(pb, REG_SENS, ACTIVE_TOL, *t),
                       [X, U, x, U, X, C], [Kg, kf] + value),
        "sfwd_generic": (lambda *t: sfwd_plain(pb, *t[:9], value=t[9:]),
                         [Kg, kf, X, X, U, U, C, x, x] + value, generic_grads),
        "sfwd_ref": (lambda *t: sfwd_plain(pb, *t[:9], value=t[9:], emit_ref_grads=True),
                     [Kg, kf, X, X, U, U, C, x, x] + value, generic_grads + [X, U, x]),
    }


def generate(name: str) -> dict:
    from tube_mpc_tpu_torch.presets import config_setup
    from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem
    from tube_mpc_tpu_torch.utils.config import parse_config

    conf = json.loads((ROOT / "bench_port" / "configs" / f"{name}.json").read_text())
    cfg = parse_config(conf["values"])
    N = cfg.system.horizon_N
    s = config_setup(cfg, N=N, H=1, device="cpu", dtype=torch.float32)
    pb = make_lane_problem(s.sys_c, barrier_type=s.barrier_type, eps=s.eps)
    nc = 2 * pb.n_hat + pb.m + 3
    gen = torch.Generator().manual_seed(0)
    out = {}
    for kname, (fn, ins, outs) in kernels(pb, s.cfg, N).items():
        args = [torch.rand(shape, generator=gen) + 0.5 for shape in ins]
        ops = count_ops(fn, args)
        elements = sum(torch.Size(sh).numel() for sh in ins + outs) // LANES
        unread = nc - C_ROWS_READ.get(kname, nc)
        out[kname] = {"bytes_per_lane": 4 * (elements - unread), "ops_per_lane": ops // LANES}
    return {"config": name, "dtype": "float32", "N": N, "n_hat": pb.n_hat, "m": pb.m,
            "nalpha": len(s.cfg.alphas), "hbm_bytes_per_s": HBM_BYTES_PER_S,
            "peak_ops_per_s": PEAK_OPS_PER_S, "kernels": out}


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    for name in sys.argv[1:]:
        tab = generate(name)
        (Path(__file__).resolve().parent / f"{name}.json").write_text(json.dumps(tab, indent=1) + "\n")
        print(name, json.dumps(tab["kernels"]))
