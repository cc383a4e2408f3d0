"""System state: a structure of per-atom tensors (lidp_tpu/state.py).

`System` is a plain dataclass of tensors plus the box; `step` is a Python
int, so advancing it never touches the device.  Padded atoms have
`mask == False` and zero weight in every reduction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lidp_tpu_torch import resolve_device
from lidp_tpu_torch.box import Box


@dataclasses.dataclass(frozen=True)
class System:
    x: torch.Tensor       # (N,3) positions, wrapped; a rigid body's atoms
                          # stay unwrapped (x = R d + xcm)
    v: torch.Tensor       # (N,3) velocities
    q: torch.Tensor       # (N,)  charges
    type: torch.Tensor    # (N,)  int32, 1-based like LAMMPS (0 = padding)
    mol: torch.Tensor     # (N,)  int32 molecule ids (0 = no molecule)
    alpha: torch.Tensor   # (N,)  static polarizability
    mu: torch.Tensor      # (N,3) induced dipoles
    image: torch.Tensor   # (N,3) int32 image flags
    mask: torch.Tensor    # (N,)  bool, True for real atoms
    box: Box
    step: int = 0

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dtype(self):
        return self.x.dtype

    def replace(self, **kw) -> "System":
        return dataclasses.replace(self, **kw)


def make_system(x, *, box: Box, v=None, q=None, type=None, mol=None,
                alpha=None, image=None, mask=None, dtype=None,
                device="cuda") -> System:
    """A System on `device` from numpy arrays (or tensors); absent fields
    are zeros, types default to 1 and the mask to all True."""
    device = resolve_device(device)
    if dtype is None and not isinstance(x, torch.Tensor):
        dtype = torch.float64 if np.asarray(x).dtype == np.float64 \
            else torch.float32
    x = torch.as_tensor(x, dtype=dtype, device=device)
    n = x.shape[0]
    dtype = x.dtype

    def arr(a, shape, d=dtype):
        if a is None:
            return torch.zeros(shape, dtype=d, device=device)
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, device=device).to(d).reshape(shape)

    return System(
        x=x, v=arr(v, (n, 3)), q=arr(q, (n,)),
        type=arr(type if type is not None else np.ones(n), (n,),
                 torch.int32),
        mol=arr(mol, (n,), torch.int32), alpha=arr(alpha, (n,)),
        mu=torch.zeros((n, 3), dtype=dtype, device=device),
        image=arr(image, (n, 3), torch.int32),
        mask=(torch.ones((n,), dtype=torch.bool, device=device)
              if mask is None else arr(mask, (n,), torch.bool)),
        box=Box(lo=box.lo.to(device=device, dtype=dtype),
                hi=box.hi.to(device=device, dtype=dtype),
                periodic=box.periodic),
        step=0)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static host-side metadata of a system.  `special_idx` holds the
    1-2/1-3/1-4 exclusion lists as a padded (N, S) int32 array of 0-based
    neighbour indices with parallel (N, S) int8 level codes; unused slots
    hold -1."""

    natoms: int
    ntypes: int
    mass: np.ndarray                             # (ntypes+1,), index 0 unused
    special_idx: Optional[np.ndarray] = None     # (N, S) int32
    special_level: Optional[np.ndarray] = None   # (N, S) int8
    tags: Optional[np.ndarray] = None            # (N,) original atom ids
