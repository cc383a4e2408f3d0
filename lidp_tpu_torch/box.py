"""Orthogonal periodic box helpers (lidp_tpu/box.py, orthogonal part)."""

from __future__ import annotations

import torch


def minimum_image(delta: torch.Tensor, lengths) -> torch.Tensor:
    """Minimum-image displacement: delta - L*round(delta/L).

    `torch.round` rounds half to even, as `jnp.round` does, so a pair at
    exactly half a box length folds the same way in both packages.
    """
    return delta - lengths * torch.round(delta / lengths)
