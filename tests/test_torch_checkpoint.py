"""Checkpoint and resume in the port (tube_mpc_tpu_torch/utils/checkpoint.py), on the CPU
in f64.

- The lane loops (paper; generic with the coupled chain) given a ckpt_dir: a run in
  segments, killed after a segment (its last state_*/logs_* deleted) and resumed, gives
  the uninterrupted segmented run's results and the monolithic loop's, bitwise; so does a
  segmented run with straggler compaction caps. A different disturbance stream in the
  same directory is refused.
- The XLA engine's paper loop given a ckpt_dir (one trajectory) against the JAX package's
  run_paper_closed_loop_checkpointed on the disturbances that it draws from its key:
  within tests/test_closed_loop.py:139-143's tolerances (rtol 1e-6 on the states and
  controls, 1e-5 on the loss and weights, atol 1e-8); the JAX test of that function
  (tests/test_checkpoint_and_systems.py:43) holds it bitwise against the JAX monolithic
  loop, and this one holds the port's segmented loop bitwise against the port's
  monolithic loop, resumed or not.
- The state files name their leaves as the JAX package's do.
The JAX package's checkpointed lane loops are not run here: their own tests are in the
slow tier, and the port's monolithic lane loops are held against the JAX ones elsewhere.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.presets import dubins_paper_setup as j_dubins_paper_setup
from tube_mpc_tpu.tube.lane_closed_loop import generic_lane_init_state as j_generic_lane_init_state
from tube_mpc_tpu.tube.lane_closed_loop import paper_lane_init_state as j_paper_lane_init_state
from tube_mpc_tpu.tube.params import RawAuxTheta as JRawAuxTheta
from tube_mpc_tpu.tube.params import RawNominalTheta as JRawNominalTheta
from tube_mpc_tpu.utils import checkpoint as jckpt

from tube_mpc_tpu_torch.presets import dubins_paper_setup
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog, run_paper_closed_loop
from tube_mpc_tpu_torch.tube.lane_closed_loop import (
    generic_lane_init_state,
    paper_lane_init_state,
    run_generic_closed_loop_lanes,
    run_paper_closed_loop_lanes,
)
from tube_mpc_tpu_torch.tube.params import AdaptConfig, RawAuxTheta, RawNominalTheta
from tube_mpc_tpu_torch.utils import checkpoint as ckpt

from torch_xla_cases import built_pair, close, raw_of

F64 = torch.float64
B, N, H, SEG = 2, 6, 5, 2


def setup():
    return dubins_paper_setup(N=N, H=H, device="cpu", dtype=F64, nominal_max_iter=3,
                              aux_max_iter=3, alphas=(1.0, 0.5, 0.0))


def draw(s, seed=3):
    lo, hi = s.system.w_low.numpy(), s.system.w_high.numpy()
    return torch.as_tensor(np.random.default_rng(seed).uniform(lo, hi, size=(B, H, 3)))


def coupled(s):
    """bench.py's BENCH_MODE=coupled configuration at this size, and its raw θ̄, θ."""
    cfg = dataclasses.replace(s.cfg, adapt=AdaptConfig(lr=5e-2, momentum=0.9, steps=1,
                                                       grad_clip_norm=1.0, project=True),
                              adapt_nominal=True)
    t = lambda v: torch.as_tensor(v, dtype=F64)
    raw_nom = RawNominalTheta(Q_raw=t([1.0, 1.0, 0.0]), R_raw=t([1.0, 1.0]),
                              Qf_raw=t([1000.0] * 3), qb_raw=t(1.0), alpha_raw=t(0.0),
                              gamma_raw=t(0.0), tight_raw=t(0.0))
    raw_aux = RawAuxTheta(Q_raw=t([1.0, 1.0, 0.0]), R_raw=t([1.0, 1.0]), Qf_raw=t([1000.0] * 3),
                          qb_raw=t(1.0), alpha_raw=t(0.0), gamma_raw=t(0.0))
    return cfg, raw_nom, raw_aux


def kill_last_segment(d):
    """Delete the latest state and logs, as a run killed while writing them."""
    last = ckpt.latest_checkpoint(d)
    for f in (last, last + ".meta.json", ckpt._logs_path(last)):
        os.remove(f)
    return ckpt.latest_checkpoint(d)


def assert_same(a, b):
    for f in ClosedLoopLog._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def runs(kind):
    """(monolithic run, segmented run(ckpt_dir, **kw)) of the lane loop `kind`."""
    s = setup()
    w = draw(s)
    kw = dict(x0=s.x0, target=s.target, w_seqs=w, eps=s.eps, device="cpu")
    if kind == "paper":
        args = (s.system, s.aug, s.sys_c, s.cfg)
        kw.update(w_nominal=s.w_nominal, aux_init=s.aux_init, bp=s.bp)
        loop = run_paper_closed_loop_lanes
    else:
        cfg, raw_nom, raw_aux = coupled(s)
        args = (s.system, s.aug, s.sys_c, cfg)
        kw.update(raw_nom=raw_nom, raw_aux_init=raw_aux)
        loop = run_generic_closed_loop_lanes
    return (lambda **k: loop(*args, **kw, **k),
            lambda d, **k: loop(*args, ckpt_dir=d, segment_len=SEG, **kw, **k))


@pytest.mark.parametrize("kind", ["paper", "coupled"])
def test_lane_loop_resumes_bitwise(kind, tmp_path):
    mono_run, seg_run = runs(kind)
    mono = mono_run()
    d = str(tmp_path / "ck")
    full = seg_run(d)
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
        "logs_2.npz", "logs_4.npz", "logs_5.npz", "state_2.npz", "state_4.npz", "state_5.npz"]
    assert kill_last_segment(d).endswith("state_4.npz")
    resumed = seg_run(d)
    if kind == "paper":
        assert_same(full, mono)
        assert_same(resumed, mono)
        return
    assert_same(full[0], mono[0])
    assert_same(resumed[0], mono[0])
    for got in (full[1], resumed[1]):
        for tree, ref in zip(got, mono[1]):
            for name, a, b in zip(tree._fields, tree, ref):
                assert torch.equal(a, b), name


@pytest.mark.parametrize("kind", ["paper", "coupled"])
def test_lane_loop_takes_the_compaction_caps(kind, tmp_path):
    """The caps reach both solves of every step (the stages after the first cap run), and
    the result stays bitwise."""
    from tube_mpc_tpu_torch.ops.cuda.lane_solver import lane_ilqr_solve

    mono_run, seg_run = runs(kind)
    lane_ilqr_solve.stages = {"compacted": 0, "full": 0}
    out = seg_run(str(tmp_path / "ck"), aux_compact_caps=(1,), nom_compact_caps=(1, 2))
    # after one iteration no lane is converged, so each solve runs its next stage
    assert lane_ilqr_solve.stages["full"] >= 2 * H
    ref = mono_run()
    if kind == "paper":
        assert_same(out, ref)
    else:
        assert_same(out[0], ref[0])


def test_a_different_run_is_refused(tmp_path):
    _, seg_run = runs("paper")
    d = str(tmp_path / "ck")
    seg_run(d)
    kill_last_segment(d)
    s = setup()
    with pytest.raises(ValueError, match="written by a different run"):
        run_paper_closed_loop_lanes(
            s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
            bp=s.bp, x0=s.x0, target=s.target, w_seqs=draw(s, seed=4), ckpt_dir=d,
            segment_len=SEG, eps=s.eps, device="cpu")
    with pytest.raises(ValueError, match="segment_len must be >= 1"):
        run_paper_closed_loop_lanes(
            s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
            bp=s.bp, x0=s.x0, target=s.target, w_seqs=draw(s), ckpt_dir=str(tmp_path / "o"),
            segment_len=0, eps=s.eps, device="cpu")


def test_xla_loop_against_the_jax_one(tmp_path):
    Hx, seg = 4, 2
    raw = raw_of("dubins", N, Hx)
    jb, pb = built_pair(raw, paper_mode=True)
    key = jax.random.PRNGKey(7)
    ref = jckpt.run_paper_closed_loop_checkpointed(
        jb.system, jb.aug, jb.tube_cfg, w_nominal=jb.w_nominal, aux_init=jb.aux_init,
        bp=jb.bp, x0=jb.x0, target=jb.target, key=key, ckpt_dir=str(tmp_path / "jax"),
        segment_len=seg)
    w = torch.as_tensor(np.array(jb.system.sample_disturbance(key, (Hx,), dtype=jnp.float64)))

    def ours(**k):
        return run_paper_closed_loop(
            pb.system, pb.aug, pb.tube_cfg, w_nominal=pb.w_nominal, aux_init=pb.aux_init,
            bp=pb.bp, x0=pb.x0, target=pb.target, w_seq=w, device="cpu", **k)

    d = str(tmp_path / "port")
    full = ours(ckpt_dir=d, segment_len=seg)
    assert full.x_real.shape == (1, Hx, 3)
    for f in ClosedLoopLog._fields:
        tol = (1e-5, 1e-8) if f in ("loss", "Q_hist", "R_hist", "qb_hist") else (1e-6, 1e-8)
        close(getattr(full, f)[0], getattr(ref, f), *tol, f)
    mono = ours()
    assert_same(full, mono)
    assert kill_last_segment(d).endswith("state_2.npz")
    assert_same(ours(ckpt_dir=d, segment_len=seg), mono)


def test_state_files_name_their_leaves_as_the_jax_package(tmp_path):
    """save_state writes the leaf paths jax.tree_util.keystr gives the JAX package's loop
    states (".x", ".adapt.Q", ".raw_nom.tight_raw"), and load_state restores each leaf in
    the template's dtype."""
    js = j_dubins_paper_setup(N=N, H=H, dtype=jnp.float64)
    s = setup()
    raws = dict(Q_raw=[1.0, 1.0, 0.0], R_raw=[1.0, 1.0], Qf_raw=[1000.0] * 3, qb_raw=1.0,
                alpha_raw=0.0, gamma_raw=0.0)
    jnom = JRawNominalTheta(**{k: jnp.asarray(v) for k, v in raws.items()},
                            tight_raw=jnp.asarray(0.0))
    jaux = JRawAuxTheta(**{k: jnp.asarray(v) for k, v in raws.items()})
    _, raw_nom, raw_aux = coupled(s)
    pairs = [
        (j_paper_lane_init_state(js.system, js.aug, js.cfg, aux_init=js.aux_init, bp=js.bp,
                                 x0=js.x0, B=B, dtype=jnp.float64),
         paper_lane_init_state(s.system, s.aug, s.cfg, aux_init=s.aux_init, bp=s.bp, x0=s.x0,
                               B=B, dtype=F64)),
        (j_generic_lane_init_state(js.system, js.aug, js.cfg, raw_nom=jnom, raw_aux_init=jaux,
                                   x0=js.x0, B=B, dtype=jnp.float64),
         generic_lane_init_state(s.system, s.aug, s.cfg, raw_nom=raw_nom, raw_aux_init=raw_aux,
                                 x0=s.x0, B=B, dtype=F64)),
    ]
    for i, (jstate, state) in enumerate(pairs):
        jckpt.save_state(str(tmp_path / f"jax_{i}.npz"), jstate, step=3)
        ckpt.save_state(str(tmp_path / f"port_{i}.npz"), state, step=3, extra={"run": i})
        with np.load(tmp_path / f"jax_{i}.npz") as a, np.load(tmp_path / f"port_{i}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            assert (".adapt.Q" if i == 0 else ".raw_nom.tight_raw") in b.files
        f32 = type(state)(*(type(v)(*(t.float() for t in v)) if isinstance(v, tuple)
                            else v.float() for v in state))
        back, step = ckpt.load_state(str(tmp_path / f"port_{i}.npz"), f32)
        assert step == 3
        for (k, a), (_, b) in zip(ckpt._leaves(back), ckpt._leaves(state)):
            assert a.dtype == torch.float32 and torch.equal(a, b.float()), k
