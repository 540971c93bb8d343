"""The setup of tests/test_parallel.py:28-45 (Dubins, two circles, smooth-min at beta 20,
the inverse barrier at eps 1e-4, N=6, H=4, four iterations per solve, f64) in both
packages, from the same numbers, and the JAX package's per-key disturbance draws, which
the port takes as w_seqs (its own draws from the same keys are bitwise these:
tests/test_torch_runner_draws.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tube_mpc_tpu.ops.costs import CostWeights as JCostWeights
from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.ops.dbas import make_augmented as j_make_augmented
from tube_mpc_tpu.ops.lanes import dubins_components as j_dubins_components
from tube_mpc_tpu.systems.dubins import DubinsConfig as JDubinsConfig
from tube_mpc_tpu.systems.dubins import make_dubins as j_make_dubins
from tube_mpc_tpu.systems.obstacles import CircleField as JCircleField
from tube_mpc_tpu.tube.closed_loop import TubeMPCConfig as JTubeMPCConfig
from tube_mpc_tpu.tube.params import AdaptConfig as JAdaptConfig
from tube_mpc_tpu.tube.params import AuxAdapt as JAuxAdapt

from tube_mpc_tpu_torch.convert import setup_from_numpy

F64 = jnp.float64
CENTERS = [[4.0, 2.0], [2.0, 4.0]]
NUMBERS = dict(
    w_nominal=dict(Q=[1.0, 1.0, 0.0], R=[1.0, 1.0], Qf=[1000.0] * 3, qb=1.0),
    aux_init=dict(Q=[1.0] * 3, R=[1.0] * 2, qb=1.0),
    bp=dict(alpha=0.0, gamma=0.0, tight=0.0),
    x0=[0.0, 0.0, np.pi / 4], target=[10.0, 10.0, np.pi / 4],
    centers=CENTERS, radii=[1.0, 1.0], beta=20.0, eps=1e-4,
)
# fixed weights of the tube verification (tests/test_parallel.py:72)
W_AUX = dict(Q=[1.0] * 3, R=[1.0] * 2, Qf=[1.0] * 3, qb=1.0)


def cfg_numbers(N, H):
    return dict(N=N, H=H, nominal_max_iter=4, aux_max_iter=4, tol=1e-3, reg=1e-6,
                alphas=(1.0, 0.5, 0.0),
                adapt=dict(lr=5e-2, momentum=0.9, steps=1, grad_clip_norm=0.0, project=True))


def jax_setup(N=6, H=4):
    """(system, aug, cfg, kw, x0, aux_init, sys_c) of the JAX package, as test_parallel's."""
    f = lambda v: jnp.asarray(v, dtype=F64)
    field = JCircleField(centers=f(CENTERS), radii=f(NUMBERS["radii"]))
    system = j_make_dubins(JDubinsConfig(dt=0.01), obstacles=field, aggregation="smoothmin",
                           beta=20.0, dtype=F64)
    aug = j_make_augmented(system, barrier_type="inverse", eps=1e-4)
    c = cfg_numbers(N, H)
    cfg = JTubeMPCConfig(**dict(c, adapt=JAdaptConfig(lr=5e-2, momentum=0.9)))
    wn = NUMBERS["w_nominal"]
    kw = dict(
        w_nominal=JCostWeights.create(wn["Q"], wn["R"], wn["Qf"], wn["qb"], dtype=F64),
        bp=JBarrierParams.create(0.0, 0.0, 0.0, dtype=F64),
        target=f(NUMBERS["target"]),
    )
    aux = JAuxAdapt(Q=f(NUMBERS["aux_init"]["Q"]), R=f(NUMBERS["aux_init"]["R"]), qb=f(1.0))
    sys_c = j_dubins_components(dt=0.01, v_min=-10.0, v_max=10.0, omega_max=float(np.pi),
                                centers=CENTERS, radii=NUMBERS["radii"],
                                aggregation="smoothmin", beta=20.0)
    return system, aug, cfg, kw, f(NUMBERS["x0"]), aux, sys_c


def port_setup(N=6, H=4):
    """The port's PaperSetup of the same numbers, on the CPU in f64."""
    return setup_from_numpy(dict(NUMBERS, cfg=cfg_numbers(N, H)), device="cpu",
                            dtype=torch.float64)


def draws(system, seed, B, H):
    """[B, H, nx]: each key of split(PRNGKey(seed), B) drawn as run_paper_closed_loop and
    tube_verification draw it, as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return keys, np.asarray(jax.vmap(
        lambda k: system.sample_disturbance(k, (H,), dtype=F64))(keys))
