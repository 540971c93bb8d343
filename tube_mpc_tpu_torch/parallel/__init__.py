from .mesh import SCENARIO_AXIS, init_distributed, make_mesh, replicated, scenario_sharding
from .scenarios import (
    TubeStats,
    run_population_adaptation,
    tube_verification,
    vmap_paper_closed_loop,
)

__all__ = [
    "SCENARIO_AXIS", "make_mesh", "scenario_sharding", "replicated", "init_distributed",
    "vmap_paper_closed_loop", "tube_verification", "TubeStats", "run_population_adaptation",
]
