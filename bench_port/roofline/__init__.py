"""The kernels' yardstick: for each lane kernel of a configuration, the bytes it must move
and the operations its plain version performs, per lane and launch, frozen as data in
``<config>.json`` (written by ``generate.py``), and the bound they set on one H100."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

HERE = Path(__file__).resolve().parent


def table(config: str) -> dict:
    return json.loads((HERE / f"{config}.json").read_text())


def bound_s(tab: dict, kernel: str, lanes_launched: int) -> Optional[float]:
    """The least time ``lanes_launched`` lane-launches of ``kernel`` can take: the larger
    of their bytes at the card's memory rate and their operations at its peak rate."""
    k = tab["kernels"].get(kernel)
    if k is None:
        return None
    return max(k["bytes_per_lane"] * lanes_launched / tab["hbm_bytes_per_s"],
               k["ops_per_lane"] * lanes_launched / tab["peak_ops_per_s"])


def lanes_of(by_width: Dict[Tuple[str, int], int], kernel: str) -> int:
    """Σ lanes × launches of ``kernel`` over its launch widths."""
    return sum(w * n for (k, w), n in by_width.items() if k == kernel)
