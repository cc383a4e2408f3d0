"""Force-field container (lidp_tpu/forcefield.py: ForceField).

Only the container is ported in this slice: the panel engine
(parallel/shard.py) reads it.  The dense route (`compute_forces`) is not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from lidp_tpu_torch.ops.ewald import EwaldParams
from lidp_tpu_torch.ops.pair import PairParams
from lidp_tpu_torch.ops.polarization import PolarizationSettings


@dataclasses.dataclass(frozen=True)
class ForceField:
    pair: PairParams
    ewald: Optional[EwaldParams] = None
    polar: Optional[PolarizationSettings] = None
    qqrd2e: float = 1.0
