"""The per-layer readers and the roofline arithmetic on a hand-worked launch mix, and the
window's whole-episode rule with solves_per_s, attempted and failed on a stub mode."""
import pytest
import torch

from bench_port import run as bench
from bench_port.metrics import (device_idle_frac, fwd_roofline, ric_full_width_frac,
                                ric_launches_per_step, ric_roofline, solve_wall_frac,
                                solves_per_s)

TABLE = {"hbm_bytes_per_s": 1e3, "peak_ops_per_s": 1e4,
         "kernels": {"ric": {"bytes_per_lane": 2, "ops_per_lane": 40},
                     "fwd": {"bytes_per_lane": 10, "ops_per_lane": 50},
                     "fwd.rollout": {"bytes_per_lane": 5, "ops_per_lane": 10}}}


def traced_record():
    # 3 K1 launches at B=100 and 2 at 50 (compacted): 400 lane-launches; K2 the same plus
    # one rollout at 100
    by_width = {("ric", 100): 3, ("ric", 50): 2, ("fwd", 100): 4, ("fwd", 50): 2}
    return dict(B=100, traced_steps=2, traced_s=4.0, solve_s=3.0,
                launches={"ric": 5, "fwd": 6}, launches_by_width=by_width, roofline=TABLE,
                device_ops={"lane::ric_kernel<float, 0, 5>": 2.0,
                            "lane::fwd_kernel<float, 0, 5>": 1.0,
                            "lane::fwd_staged_kernel<float, 0, 5>": 1.0,
                            "lane::sfwd_kernel<float, false, false, 0, 5>": 7.0},
                busy_s=1.0, traced_window_s=4.0)


def test_roofline_readers_hand_worked():
    rec = traced_record()
    # K1: 400 lanes: bytes 800 / 1e3 = 0.8 s, operations 16000 / 1e4 = 1.6 s -> 1.6 of 2.0
    assert ric_roofline.read(rec) == pytest.approx(80.0)
    # K2: 400 search lanes: max(4.0, 2.0) = 4.0 s; 100 rollout lanes: max(0.5, 0.1);
    # device 2.0 s (sfwd_kernel is not K2)
    assert fwd_roofline.read(rec) == pytest.approx(100.0 * 4.5 / 2.0)
    assert ric_launches_per_step.read(rec) == pytest.approx(2.5)
    assert ric_full_width_frac.read(rec) == pytest.approx(60.0)
    assert solve_wall_frac.read(rec) == pytest.approx(75.0)
    assert device_idle_frac.read(rec) == pytest.approx(75.0)


def test_roofline_silent_without_launches():
    rec = traced_record()
    rec["device_ops"] = {}
    assert ric_roofline.read(rec) is None and fwd_roofline.read(rec) is None


class StubMode:
    """An entry whose episodes take 0.3 s and fail lane 0 in every other episode."""

    device, B, H = "cpu", 4, 10
    traffic = {"check": {"steps_per_episode": 2, "lanes_per_step": 2}, "pool_seeds": [1, 2]}

    def __init__(self):
        self.calls = 0

    def sampler(self, steps, lanes):
        assert steps[0] == 0 and len(steps) == 2 and len(lanes) == 2
        return type("S", (), {"kept": [{"t": torch.tensor(steps)}]})()

    def draw(self, generator, steps):
        return torch.rand((self.B, steps, 3), generator=generator)

    def episode(self, w, sampler):
        import time

        time.sleep(0.3)
        self.calls += 1
        loss = torch.zeros((self.B, w.shape[1]))
        loss[0, -1] = float("nan") if self.calls % 2 else 0.0
        return type("Log", (), {"loss": loss})()

    failed_lanes = staticmethod(lambda log: ~torch.isfinite(log.loss[:, -1]))


def test_window_whole_episodes():
    mode = StubMode()
    win = bench.window(mode, 2 ** 31 + 7, 0.7)
    # episodes start while fewer than 0.7 s have passed: at 0, 0.3, 0.6; the third ends at 0.9
    assert win["episodes"] == 3 and 0.9 <= win["window_s"] < 1.2
    assert win["failed"] == 2 and len(win["kept"]) == 3
    rec = dict(B=mode.B, steps=win["episodes"] * mode.H, window_s=win["window_s"])
    assert solves_per_s.read(rec) == pytest.approx(2 * 4 * 30 / win["window_s"])


def test_seeds_large_and_distinct():
    s = 2 ** 31 + 12345
    assert bench.seed_of(s, 0, 0) != bench.seed_of(s, 0, 1) != bench.seed_of(s, 1, 0)
    assert all(0 <= bench.seed_of(v, 2) < 2 ** 61 for v in (0, s, 2 ** 40, -5))


class FakeEvent:
    def __init__(self, kind, name, start, end):
        self.kind, self.n, self.s, self.e = kind, name, start, end

    def device_type(self):
        gpu = self.kind in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
        return torch.autograd.DeviceType.CUDA if gpu else torch.autograd.DeviceType.CPU

    name = lambda self: self.n
    start_ns = lambda self: self.s
    end_ns = lambda self: self.e


def test_reduce_events_hand_worked():
    from bench_port.trace import EPISODE_SPAN, reduce_events

    ev = [FakeEvent("user_annotation", EPISODE_SPAN, 0, 100),
          FakeEvent("gpu_user_annotation", EPISODE_SPAN, 0, 100),   # not device work
          FakeEvent("kernel", "void lane::ric_kernel<float, 0, 5>(float*)", 10, 30),
          FakeEvent("kernel", "void lane::ric_kernel<float, 0, 5>(float*)", 25, 40),
          FakeEvent("gpu_memcpy", "Memcpy DtoH", 60, 70),
          FakeEvent("kernel", "late", 95, 120),                      # clipped to the window
          FakeEvent("cpu_op", "aten::item", 40, 62),
          FakeEvent("cpu_op", "aten::_local_scalar_dense", 41, 61),
          FakeEvent("cuda_runtime", "cudaLaunchKernel", 75, 94)]
    r = reduce_events(ev)
    assert r["traced_window_s"] == pytest.approx(100e-9)
    assert r["busy_s"] == pytest.approx(45e-9)          # [10, 40], [60, 70], [95, 100]
    assert r["device_ops"]["lane::ric_kernel<float, 0, 5>"] == pytest.approx(35e-9)
    idle = dict(r["breakdown"]["idle_gaps"])
    # gaps [0, 10] (no host op), [40, 60] (innermost at 50), [70, 95] (launch at 82.5)
    assert idle == pytest.approx({"(no host operation)": 10e-9,
                                  "aten::_local_scalar_dense": 20e-9, "cudaLaunchKernel": 25e-9})
