"""Orthogonal simulation box (lidp_tpu/box.py, orthogonal part).

`Box` holds the faces as tensors and the per-dimension periodicity as a
static tuple.  Non-periodic dimensions get an effective image length of
1e30 (`img_lengths`), so the minimum image is the identity there and
roll-stencil cell pairs that wrap across an open face reject themselves
through the cutoff test.  Shrink-wrapped faces (`boundary s` and `m`) are
`ShrinkSpec` and `reset_box` (Domain::reset_box, domain.cpp:358), a masked
min/max on the device.  Triclinic cells are not ported: `Box.create`
raises on a tilt (ROADMAP queue 1 item 6.4).
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
                "triclinic boxes are not ported (ROADMAP queue 1 item 6.4, "
                "triclinic boxes)")
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


@dataclasses.dataclass(frozen=True)
class ShrinkSpec:
    """Static shrink-wrap configuration (Domain::reset_box, domain.cpp:358).

    Per face: 0 = fixed or periodic (left), 2 = 's' (the atoms' extent
    -/+ small), 3 = 'm' (like 's' but never inside the created box's
    face).  `small` is 1e-4 of the created box length (set_initial_box,
    domain.cpp:204)."""

    lo_style: tuple   # (3,) int face codes
    hi_style: tuple
    small: tuple      # (3,) float
    min_lo: tuple     # (3,) the created box's faces, for 'm'
    min_hi: tuple

    @property
    def active(self) -> bool:
        return any(s in (2, 3) for s in self.lo_style + self.hi_style)


def reset_box(x, mask, box: Box, spec: ShrinkSpec) -> Box:
    """Shrink-wrap the box faces to the extent of the unmasked atoms: a
    masked min and max on the device, no host read."""
    ext_lo = torch.amin(torch.where(mask[:, None], x, _BIG), dim=0)
    ext_hi = torch.amax(torch.where(mask[:, None], x, -_BIG), dim=0)
    los, his = [], []
    for d in range(3):
        lo_d, hi_d = box.lo[d], box.hi[d]
        if spec.lo_style[d] == 2:
            lo_d = ext_lo[d] - spec.small[d]
        elif spec.lo_style[d] == 3:
            lo_d = torch.clamp(ext_lo[d] - spec.small[d], max=spec.min_lo[d])
        if spec.hi_style[d] == 2:
            hi_d = ext_hi[d] + spec.small[d]
        elif spec.hi_style[d] == 3:
            hi_d = torch.clamp(ext_hi[d] + spec.small[d], min=spec.min_hi[d])
        los.append(lo_d)
        his.append(hi_d)
    return Box(lo=torch.stack(los), hi=torch.stack(his),
               periodic=box.periodic)
