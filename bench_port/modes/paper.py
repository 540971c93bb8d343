"""The paper mode: episodes of ``run_paper_closed_loop_lanes``, the entry that the window
drives, and how `correct` is decided for them, against the plain reference
(bench_port/reference/).

The paper loop's step t takes the carry state_t to state_{t+1} and logs row t. During the
window the harness keeps, at a few steps of each episode drawn from the seed, the carry
before and after the step and the log row, on a sample of lanes drawn from the seed
(``Sampler``). Once the window has closed, the reference replays each kept step from the
program's own state_t: its solves and its update in the configuration's precision (the
algorithm as configured: float32 decides where a solve stops, so a float64 solve is
another answer), every cost, rollout and propagation that judges them in float64. These
numbers are compared:

- start_gap: the carry at step 0 against the configuration's (x0, its barrier state, θ0,
  zero momentum and warm starts), relative to the value (+1); the worst kept lane.
- cost_gap_p90: for each of the two solves, the cost of the program's plan (u_t with the
  next step's warm start, which is the plan shifted by one) above the cost of the
  reference's own solve from the same warm start, as a share of the latter; the ancillary
  problem tracks the program's nominal plan. The larger of the two for each kept (step,
  lane), and the 90th percentile of those, so that a solve wrong on a tenth of the lanes
  or more fails it: where a float32 solve stops depends on its rounding (its freeze
  rule's tolerance lies near float32's resolution of the cost, and the quadrotor's nearly
  singular 2x2 Hessian of the two thrusts meets the inverse's guard), so two float32
  solves part by up to 1e15 in cost on a few kept pairs in a hundred (PERF.md).
- loss_gap_p90: the logged tube loss against the loss of the program's plans, relative;
  the 90th percentile.
- theta_gap_p90: θ_{t+1} and its momentum against the reference's sensitivity and
  projected momentum update at the program's plans, relative to the reference's step in
  each entry plus the median step of that leaf over the sample plus an ulp of the entry in
  the configuration's precision (a step below it cannot show in θ); the worst entry of each
  kept (step, lane), and the 90th percentile.
- state_gap: x, b, x̄, b̄ of state_{t+1} against f̂ of state_t under the logged u_t, ū_t
  plus the episode's disturbance, relative to the value (+1); the worst kept lane.

Near the obstacles, where the relaxed barrier's value reaches 1e12, a few kept steps in a
hundred are ill-conditioned: an independent float32 solve or update lands as far from the
float64 one as the program does (PERF.md); a percentile is steady from seed to seed where
the worst is not. A value that is not finite where the reference's is finite, or the
other way round, reads inf; both not finite reads 0."""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
from torch import Tensor

from bench_port.reference.tube import PaperTube, State, rollout

STATE_FIELDS = State._fields
NUMBERS = ("start_gap", "cost_gap_p90", "loss_gap_p90", "theta_gap_p90", "state_gap")
LOG_FIELDS = ("x_real", "u_real", "x_bar", "u_bar", "b_real", "loss", "Q_hist", "R_hist", "qb_hist")


def program_state(st) -> Dict[str, Tensor]:
    """The program's paper carry (LaneLoopState) as the reference's State fields."""
    return dict(x=st.x, b=st.b, x_bar=st.x_bar, b_bar=st.b_bar, U_nom_ws=st.U_nom_ws,
                U_aux_ws=st.U_aux_ws, Q=st.adapt.Q, R=st.adapt.R, qb=st.adapt.qb,
                vQ=st.vel.Q, vR=st.vel.R, vqb=st.vel.qb)


class Sampler:
    """Keeps, at the steps ``steps`` of an episode, the carry before and after the step,
    the disturbance and the log row of the lanes ``lanes``: copies on the device, a few
    small kernels at each kept step, moved to the host once the window has closed."""

    def __init__(self, steps: List[int], lanes: Tensor):
        self.steps, self.lanes = set(steps), lanes
        self.kept: List[Dict[str, Tensor]] = []

    def wrap(self, step):
        t = [0]
        lanes = self.lanes

        def observed(state, w_t):
            new_state, log = step(state, w_t)
            if t[0] in self.steps:
                idx = lanes.to(w_t.device)
                take = lambda v: v.index_select(0, idx).detach().clone()
                rec = {f"st.{k}": take(v) for k, v in program_state(state).items()}
                rec.update({f"nx.{k}": take(v) for k, v in program_state(new_state).items()})
                rec.update({f"log.{k}": take(v) for k, v in zip(LOG_FIELDS, log)})
                rec["w"] = take(w_t)
                rec["t"] = torch.full((lanes.numel(),), t[0])
                self.kept.append(rec)
            t[0] += 1
            return new_state, log

        return observed


def merge(records: List[Dict[str, Tensor]]) -> Dict[str, Tensor]:
    """The kept rows of several steps, lane by lane, as one batch on the host."""
    return {k: torch.cat([r[k].cpu() for r in records]) for k in records[0]}


def _state(rec: Dict[str, Tensor], prefix: str, dtype) -> State:
    return State(*(rec[f"{prefix}.{k}"].to(dtype) for k in STATE_FIELDS))


def program_answers(rec: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """What the program answered at each kept step: its two plans (u_t followed by the
    next warm start's first N-1 controls), its loss, θ_{t+1}, momentum and next state."""
    d = torch.float64
    g = lambda k: rec[k].to(d)
    plan = lambda u, ws: torch.cat([u[:, None], ws[:, :-1]], 1)
    return dict(U_nom=plan(g("log.u_bar"), g("nx.U_nom_ws")),
                U_aux=plan(g("log.u_real"), g("nx.U_aux_ws")), loss=g("log.loss"),
                theta=(g("log.Q_hist"), g("log.R_hist"), g("log.qb_hist")),
                vel=(g("nx.vQ"), g("nx.vR"), g("nx.vqb")),
                next=(g("nx.x"), g("nx.b"), g("nx.x_bar"), g("nx.b_bar")))


def reference_answers(tube: PaperTube, rec: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """What ``tube`` (the reference in some precision, put in the program's place) answers
    from the program's state_t; in float64 for the judge."""
    st = _state(rec, "st", tube.dtype)
    out = tube.step(st, rec["w"].to(tube.dtype))
    d = torch.float64
    return dict(U_nom=out["U_nom"].to(d), U_aux=out["U_aux"].to(d), loss=out["loss"].to(d),
                theta=tuple(v.to(d) for v in out["theta"]),
                vel=tuple(v.to(d) for v in out["vel"]),
                next=tuple(v.to(d) for v in out["next"]))


def _rel(got: Tensor, ref: Tensor, scale: Tensor) -> Tensor:
    """|got - ref| / scale per element; inf where exactly one of got, ref is finite,
    0 where neither is."""
    fg, fr = torch.isfinite(got), torch.isfinite(ref)
    gap = torch.where(fg & fr, (got - ref).abs() / scale, torch.zeros_like(ref))
    return torch.where(fg ^ fr, torch.full_like(gap, float("inf")), gap)


def _worst(*gaps: Tensor) -> float:
    return max(float(g.max()) if g.numel() else 0.0 for g in gaps)


def _percentile(g: Tensor, p: int) -> float:
    """The p-th percentile of g by nearest rank (NaN counts as inf, the largest)."""
    if not g.numel():
        return 0.0
    s = torch.sort(torch.nan_to_num(g.double(), nan=float("inf")))[0]
    return float(s[max(0, -(-p * s.numel() // 100) - 1)])


def start_gap(tube: PaperTube, rec: Dict[str, Tensor]) -> float:
    """The kept carries at step 0 against the configuration's initial carry."""
    st = _state(rec, "st", torch.float64)
    ref = tube.init_state(st.x.shape[0])
    return _worst(*(_rel(g, r, r.abs() + 1.0) for g, r in zip(st, ref)))


def _lane_max(g: Tensor) -> Tensor:
    """The worst entry of each lane (row) of g."""
    return g.reshape(g.shape[0], -1).amax(1) if g.ndim > 1 else g


def judge_lanes(tube: PaperTube, alg: PaperTube, rec: Dict[str, Tensor],
                ans: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The step numbers (see the module's docstring) of the answers ``ans`` to the kept steps
    ``rec``, each kept (step, lane) alone [L]: ``alg`` is the reference in the
    configuration's precision, which solves and updates; ``tube`` the float64 reference,
    which judges."""
    d = alg.dtype
    st, sa = _state(rec, "st", torch.float64), _state(rec, "st", d)
    w = rec["w"].to(torch.float64)
    L = w.shape[0]
    U_nom, U_aux = tube.plant.clamp(ans["U_nom"]), tube.plant.clamp(ans["U_aux"])

    nominal = tube.nominal_problem(st)
    X_nom = rollout(tube.plant, nominal[0], U_nom, tube.bp(L))
    ancillary = tube.ancillary_problem(st, X_nom, U_nom)
    X_aux = rollout(tube.plant, ancillary[0], U_aux, tube.bp(L))
    Xa_nom = rollout(alg.plant, alg.nominal_problem(sa)[0], U_nom.to(d), alg.bp(L))
    Xa_aux = rollout(alg.plant, alg.ancillary_problem(sa, Xa_nom, U_nom.to(d))[0], U_aux.to(d),
                     alg.bp(L))

    def cost_gap(problem, U_ref, U):
        got, ref = tube.problem_cost(problem, U), tube.problem_cost(problem, U_ref.double())
        gap = _rel(got, ref, ref.abs())
        return torch.where(got < ref, torch.zeros_like(gap), gap)

    loss = tube.tube_loss(X_aux, X_nom)
    theta, vel = alg.update(sa, Xa_aux, U_aux.to(d), Xa_nom, U_nom.to(d),
                            alg.tube_loss(Xa_aux, Xa_nom))
    leaves = []
    for got, ref, before in zip(ans["theta"] + ans["vel"], theta + vel,
                                (st.Q, st.R, st.qb, st.vQ, st.vR, st.vqb)):
        ref = ref.double()
        step = (ref - before).abs()
        fin = step[torch.isfinite(step)]
        med = fin.median() if fin.numel() else torch.zeros((), dtype=step.dtype, device=step.device)
        ulp = alg.guard_eps * ref.abs()   # the configuration's precision holds θ
        leaves.append(_lane_max(_rel(got, ref, step + torch.clamp(med, min=1e-12) + ulp)))
    nxt = tube.propagate(st, ans["U_aux"][:, 0], ans["U_nom"][:, 0], w)
    return dict(
        cost_gap_p90=torch.maximum(
            cost_gap(nominal, alg.solve_nominal(sa)[1], ans["U_nom"]),
            cost_gap(ancillary, alg.solve_ancillary(sa, Xa_nom, U_nom.to(d))[1], ans["U_aux"])),
        loss_gap_p90=_rel(ans["loss"], loss, loss.abs()),
        theta_gap_p90=torch.stack(leaves).amax(0),
        state_gap=torch.stack([_lane_max(_rel(g, r, r.abs() + 1.0))
                               for g, r in zip(ans["next"], nxt)]).amax(0),
    )


def reduce(lanes: Dict[str, Tensor]) -> Dict[str, float]:
    """judge_lanes' numbers over the kept (step, lane) pairs: the percentile that a name
    ends in (_p50, _p90, ...), the worst for the others."""
    out = {}
    for k, v in lanes.items():
        tail = k.rsplit("_", 1)[-1]
        out[k] = (_percentile(v, int(tail[1:])) if tail[:1] == "p" and tail[1:].isdigit()
                  else _worst(v))
    return out


class Mode:
    """The paper mode of one cell: the program's set-up of the configuration (its own
    ``presets.config_setup``, inside set-up), the disturbance pool [B, H, nx], episodes of
    ``run_paper_closed_loop_lanes`` over B lanes with the traffic's compaction caps, and the
    check of the kept steps."""

    def __init__(self, config: dict, traffic: dict, device: str):
        from tube_mpc_tpu_torch.presets import config_setup
        from tube_mpc_tpu_torch.runners import parse_compact_caps
        from tube_mpc_tpu_torch.tube import lane_closed_loop
        from tube_mpc_tpu_torch.utils.config import parse_config

        self.config, self.traffic, self.device = config, traffic, device
        cfg = parse_config(config["values"])
        if cfg.paper_dubins_mode is False or cfg.adaptation.adapt_nominal:
            raise ValueError("the paper mode runs paper-path configurations")
        self.H, self.N = cfg.system.task_horizon_H, cfg.system.horizon_N
        self.precision = cfg.dtype
        self.B = int(traffic["batch"])
        self.setup = config_setup(cfg, N=self.N, H=self.H, device=device, dtype=torch.float32)
        self.nx = self.setup.system.nx
        self.aux_caps, self.nom_caps = parse_compact_caps(traffic["compact_caps"])
        dist = config["values"]["system"]["disturbance"]
        self.w_low = torch.tensor(dist["w_low"], dtype=torch.float32, device=device)
        self.w_high = torch.tensor(dist["w_high"], dtype=torch.float32, device=device)
        self.loop = lane_closed_loop
        # the module attribute that the traced run wraps to time the solves
        self.solve_owner, self.solve_attr = lane_closed_loop, "tube_ilqr_solve_lanes"

    sampler = staticmethod(Sampler)

    def draw(self, generator: torch.Generator, steps: int) -> Tensor:
        """Disturbances [B, steps, nx], uniform in the configuration's box."""
        u = torch.rand((self.B, steps, self.nx), generator=generator, device=self.device)
        return self.w_low + (self.w_high - self.w_low) * u

    def episode(self, w: Tensor, sampler: Optional[Sampler] = None):
        """One call of the entry over w [B, steps, nx]; returns its ClosedLoopLog."""
        s = self.setup
        with self._observed(sampler):
            return self.loop.run_paper_closed_loop_lanes(
                s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
                bp=s.bp, x0=s.x0, target=s.target, w_seqs=w, eps=s.eps,
                barrier_type=s.barrier_type, device=self.device,
                nom_compact_caps=self.nom_caps, aux_compact_caps=self.aux_caps)

    @contextlib.contextmanager
    def _observed(self, sampler: Optional[Sampler]):
        if sampler is None:
            yield
            return
        run_steps = self.loop.run_steps
        self.loop.run_steps = lambda step, *a, **k: run_steps(sampler.wrap(step), *a, **k)
        try:
            yield
        finally:
            self.loop.run_steps = run_steps

    @staticmethod
    def failed_lanes(log) -> Tensor:
        """Lanes whose last step's tube loss is not finite."""
        return ~torch.isfinite(log.loss[:, -1])

    def check(self, records: List[Dict[str, Tensor]], generator: torch.Generator,
              samples: int, candidate=None) -> Dict[str, float]:
        """The numbers compared: start_gap over every kept step 0, the step numbers over
        ``samples`` kept (step, lane) pairs drawn with ``generator`` (see ``judged``)."""
        start, lanes = self.judged(records, generator, samples, candidate)
        return dict(start_gap=start, **reduce(lanes))

    def judged(self, records: List[Dict[str, Tensor]], generator: torch.Generator,
               samples: int, candidate=None):
        """start_gap over every kept step 0, and judge_lanes' numbers of ``samples`` kept
        (step, lane) pairs drawn with ``generator``, each pair alone; the reference on the
        run's device (after the window, once the program's state is freed). ``candidate``
        is what is judged: the program (None), or a stand-in in its place (``Control``)."""
        candidate = candidate or Program()
        rec = merge(records)
        pick = torch.randperm(rec["w"].shape[0], generator=generator)[:samples]
        start = {k: v[rec["t"] == 0].to(self.device) for k, v in rec.items()}
        rec = {k: v[pick].to(self.device) for k, v in rec.items()}
        tube = PaperTube(self.config, torch.float64, self.device)
        alg = PaperTube(self.config, self.precision, self.device)
        return (start_gap(tube, candidate.initial(start)),
                judge_lanes(tube, alg, rec, candidate.answers(rec)))


class Program:
    """The program's own answers, as kept during the window."""

    initial = staticmethod(lambda rec: rec)
    answers = staticmethod(program_answers)


class Control:
    """The reference in ``dtype`` put in the program's place: its own initial carry, and its
    own step from the program's kept state_t."""

    def __init__(self, config: dict, dtype: torch.dtype, device="cpu"):
        self.tube = PaperTube(config, dtype, device)

    def initial(self, rec: Dict[str, Tensor]) -> Dict[str, Tensor]:
        st = self.tube.init_state(rec["w"].shape[0])
        return {**rec, **{f"st.{k}": v for k, v in zip(STATE_FIELDS, st)}}

    def answers(self, rec: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return reference_answers(self.tube, rec)
