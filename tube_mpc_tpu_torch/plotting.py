"""Run-directory plotting (a copy of tube_mpc_tpu/plotting.py:1-107, reading the port's
run directory): the reference's figure set (``plot_results.py:27-186``):

  traj_xy.png          xy trajectory (real + nominal) over the obstacle field
  states.png           state components over time
  controls.png         control components over time
  barrier_and_loss.png barrier state and upper loss
  adaptive_params.png  evolution of the adapted (Q, R, q_b)
"""
from __future__ import annotations

import os
from typing import List, Optional


def plot_run(run_dir: str, *, obstacles: Optional[List[dict]] = None, show: bool = False) -> List[str]:
    """Write the five figures into ``run_dir`` from its artifacts (lane 0); returns their
    paths. matplotlib is imported here, not with the module: only plotting needs it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .utils.io import load_run

    data = load_run(run_dir)
    written: List[str] = []

    def save(fig, name: str):
        path = os.path.join(run_dir, name)
        fig.savefig(path, dpi=130, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    x = data.get("x_real")
    xb = data.get("x_bar")
    u = data.get("u_real")
    ub = data.get("u_bar")
    b = data.get("b_real")
    loss = data.get("loss")

    # 1. xy trajectory over obstacle field
    if x is not None and x.shape[-1] >= 2:
        fig, ax = plt.subplots(figsize=(6, 6))
        if obstacles:
            for o in obstacles:
                c = plt.Circle(tuple(o["center"]), float(o["radius"]), color="crimson", alpha=0.35)
                ax.add_patch(c)
        ax.plot(x[:, 0], x[:, 1], "-", lw=1.5, label="real x")
        if xb is not None:
            ax.plot(xb[:, 0], xb[:, 1], "--", lw=1.2, label="nominal x̄")
        ax.plot(x[0, 0], x[0, 1], "go", label="start")
        ax.plot(x[-1, 0], x[-1, 1], "k*", ms=12, label="end")
        ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_aspect("equal"); ax.legend()
        ax.set_title("closed-loop trajectory")
        save(fig, "traj_xy.png")

    # 2. states over time
    if x is not None:
        fig, ax = plt.subplots(figsize=(8, 4))
        for i in range(x.shape[-1]):
            ax.plot(x[:, i], label=f"x[{i}]")
            if xb is not None:
                ax.plot(xb[:, i], "--", alpha=0.6)
        ax.set_xlabel("t"); ax.legend(); ax.set_title("states (dashed: nominal)")
        save(fig, "states.png")

    # 3. controls
    if u is not None:
        fig, ax = plt.subplots(figsize=(8, 4))
        for i in range(u.shape[-1]):
            ax.plot(u[:, i], label=f"u[{i}]")
            if ub is not None:
                ax.plot(ub[:, i], "--", alpha=0.6)
        ax.set_xlabel("t"); ax.legend(); ax.set_title("controls (dashed: nominal)")
        save(fig, "controls.png")

    # 4. barrier + loss
    if b is not None or loss is not None:
        fig, axes = plt.subplots(1, 2, figsize=(10, 3.5))
        if b is not None:
            axes[0].plot(b); axes[0].set_title("barrier state b"); axes[0].set_xlabel("t")
        if loss is not None:
            axes[1].plot(loss); axes[1].set_title("upper loss L"); axes[1].set_xlabel("t")
        save(fig, "barrier_and_loss.png")

    # 5. adaptive parameters
    Qh, Rh, qbh = data.get("Qa_history"), data.get("Ra_history"), data.get("qba_history")
    if Qh is not None and len(Qh):
        fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
        for i in range(Qh.shape[-1]):
            axes[0].plot(Qh[:, i], label=f"Q[{i}]")
        axes[0].legend(); axes[0].set_title("ancillary Q")
        if Rh is not None:
            for i in range(Rh.shape[-1]):
                axes[1].plot(Rh[:, i], label=f"R[{i}]")
            axes[1].legend(); axes[1].set_title("ancillary R")
        if qbh is not None:
            axes[2].plot(qbh); axes[2].set_title("ancillary q_b")
        for a in axes:
            a.set_xlabel("t")
        save(fig, "adaptive_params.png")

    if show:  # pragma: no cover
        import matplotlib.pyplot as plt2

        plt2.show()
    return written
