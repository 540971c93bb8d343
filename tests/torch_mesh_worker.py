"""One rank of tests/test_torch_mesh.py's two-process gloo group: the port's sharded lane
paper loop (independent and population, monolithic and checkpointed, resumed, and refused
on a tampered mesh size or a batch the ranks do not divide) and the mesh path of
run_population_adaptation, all on the CPU in f64; every result to <outdir>/rank<r>.npz.

    python tests/torch_mesh_worker.py <init file> <world size> <rank> <outdir>

``case()`` is the workload, which the test also runs in one process.
"""
import json
import os
import sys

import numpy as np
import torch

B = 6   # three lanes a rank on two ranks


def case():
    """(setup, w [B, H, nx], x0 [B, nx]) at N=5, H=4 in f64 on the CPU."""
    from tube_mpc_tpu_torch.presets import dubins_paper_setup
    from tube_mpc_tpu_torch.utils.prng import PRNGKey

    s = dubins_paper_setup(N=5, H=4, device="cpu", dtype=torch.float64, nominal_max_iter=3,
                           aux_max_iter=3, alphas=(1.0, 0.5, 0.0))
    w = s.system.sample_disturbance(PRNGKey(11), (B, s.cfg.H), dtype=torch.float64)
    x0 = s.x0 + 0.05 * torch.arange(B, dtype=torch.float64)[:, None]
    return s, w, x0


def lane_kw(s, w, x0):
    return dict(w_nominal=s.w_nominal, aux_init=s.aux_init, bp=s.bp, x0=x0, target=s.target,
                w_seqs=w, eps=s.eps, device="cpu")


def population_kw(s, w, x0):
    return dict(w_nominal=s.w_nominal, aux_init=s.aux_init, bp=s.bp, x0_batch=x0,
                target=s.target, w_seqs=w, device="cpu")


def main(init_file, world, rank, outdir):
    import torch.distributed as dist

    from tube_mpc_tpu_torch.parallel import init_distributed, make_mesh, run_population_adaptation
    from tube_mpc_tpu_torch.tube.lane_closed_loop import run_paper_closed_loop_lanes_sharded

    torch.set_num_threads(1)
    assert init_distributed(f"file://{init_file}", world, rank, "gloo") == world
    try:
        mesh = make_mesh(device="cpu")
        s, w, x0 = case()
        kw = lane_kw(s, w, x0)

        def sharded(**more):
            return run_paper_closed_loop_lanes_sharded(s.system, s.aug, s.sys_c, s.cfg,
                                                       mesh=mesh, **dict(kw, **more))

        out = {}
        for population in (False, True):
            tag = "population" if population else "independent"
            for f, v in sharded(population=population)._asdict().items():
                out[f"{tag}.{f}"] = v.numpy()
            ck = os.path.join(outdir, f"ck_{tag}")
            full = sharded(population=population, ckpt_dir=ck, segment_len=2)
            dist.barrier()
            if rank == 0:   # a run killed before its last segment was written
                for name in ("state_4.npz", "logs_4.npz"):
                    os.remove(os.path.join(ck, name))
            dist.barrier()
            resumed = sharded(population=population, ckpt_dir=ck, segment_len=2)
            for f in full._fields:
                out[f"{tag}.ckpt.{f}"] = getattr(full, f).numpy()
                out[f"{tag}.resumed.{f}"] = getattr(resumed, f).numpy()
            dist.barrier()
            if rank == 0:   # the checkpoint as a run on three ranks would have written it
                meta = os.path.join(ck, "state_4.npz.meta.json")
                with open(meta, encoding="utf-8") as f:
                    fp = json.load(f)
                with open(meta, "w", encoding="utf-8") as f:
                    json.dump(dict(fp, mesh_devices=3), f)
            dist.barrier()
            try:
                sharded(population=population, ckpt_dir=ck, segment_len=2)
                out[f"{tag}.tampered_refused"] = np.asarray(False)
            except ValueError as e:
                out[f"{tag}.tampered_refused"] = np.asarray("different run" in str(e))
        try:
            sharded(w_seqs=w[:5], x0=x0[:5])
            out["indivisible_refused"] = np.asarray(False)
        except ValueError as e:
            out["indivisible_refused"] = np.asarray("not divisible by mesh size 2" in str(e))
        log, final = run_population_adaptation(s.system, s.aug, s.cfg, mesh=mesh,
                                               **population_kw(s, w, x0))
        out.update({f"adaptation.{f}": v.numpy() for f, v in log._asdict().items()})
        out.update({f"adaptation.final.{f}": v.numpy() for f, v in final._asdict().items()})
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
