"""Orthogonal simulation box (lidp_tpu/box.py, orthogonal part).

`Box` holds the faces as tensors and the per-dimension periodicity as a
static tuple.  Non-periodic dimensions get an effective image length of
1e30 (`img_lengths`), so the minimum image is the identity there and
roll-stencil cell pairs that wrap across an open face reject themselves
through the cutoff test.  Triclinic cells, shrink-wrapped faces
(`ShrinkSpec`, `reset_box`) are not ported: `Box.create` raises on a tilt.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_BIG = 1.0e30


@dataclasses.dataclass(frozen=True)
class Box:
    lo: torch.Tensor   # (3,)
    hi: torch.Tensor   # (3,)
    periodic: tuple = (True, True, True)

    # the JAX Box carries tilt factors; the port's is always orthogonal
    triclinic = False

    @property
    def lengths(self) -> torch.Tensor:
        return self.hi - self.lo

    @property
    def img_lengths(self) -> torch.Tensor:
        """Effective lengths for minimum-image math: L on periodic dims,
        1e30 (=> identity fold) on non-periodic dims."""
        if all(self.periodic):
            return self.lengths
        pm = torch.tensor(self.periodic, device=self.lo.device)
        return torch.where(pm, self.hi - self.lo, _BIG)

    @property
    def volume(self) -> torch.Tensor:
        L = self.lengths
        return L[0] * L[1] * L[2]

    @staticmethod
    def create(lo, hi, dtype=None, periodic=(True, True, True), tilt=None,
               force_triclinic=False, device="cpu") -> "Box":
        if force_triclinic or (tilt is not None
                               and any(float(v) != 0.0 for v in tilt)):
            raise NotImplementedError(
                "triclinic boxes are not ported (ROADMAP queue 1 item 5, "
                "breadth)")
        def t(a):
            if not isinstance(a, torch.Tensor):
                a = np.array(a)
                if a.dtype.kind != "f":
                    a = a.astype(float)
            return torch.as_tensor(a, dtype=dtype, device=device)

        return Box(lo=t(lo), hi=t(hi),
                   periodic=tuple(bool(p) for p in periodic))


def minimum_image(delta: torch.Tensor, lengths) -> torch.Tensor:
    """Minimum-image displacement: delta - L*round(delta/L).

    `torch.round` rounds half to even, as `jnp.round` does, so a pair at
    exactly half a box length folds the same way in both packages.
    """
    return delta - lengths * torch.round(delta / lengths)


def wrap(x: torch.Tensor, box: Box, image: torch.Tensor):
    """Remap positions into the primary box, accumulating the int32 (N,3)
    image flags; only periodic dimensions are remapped (Domain::pbc)."""
    L = box.lengths
    shift = torch.floor((x - box.lo) / L).to(torch.int32)
    if not all(box.periodic):
        shift = shift * torch.tensor(box.periodic, dtype=torch.int32,
                                     device=x.device)
    return x - shift.to(x.dtype) * L, image + shift


def unwrap(x: torch.Tensor, box: Box, image: torch.Tensor) -> torch.Tensor:
    """Unwrapped coordinates from wrapped positions and image flags
    (Domain::unmap)."""
    return x + image.to(x.dtype) * box.lengths
