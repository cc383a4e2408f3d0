"""Slot-space LJ/NVE runner (lidp_tpu/integrate/slot_runner.py).

The generic Runner keeps the state in atom order and gathers it into the
cell-slot grid for every force evaluation.  Between neighbor rebuilds the
integrator is pure elementwise math, so atom ORDER is irrelevant: this
runner keeps positions, velocities and forces in the cell-slot layout
itself (LAMMPS' Atom::sort locality idea, atom.cpp:1783, taken to its
conclusion) and calls the slot-space kernel (ops/cell_kernels.py
slot_lj_forces).  Per step nothing is gathered; the one re-gather into slot
order happens at a rebuild (every `rebuild_every` steps, `neigh_modify
every N check no` semantics, neighbor.cpp:1933).

Scope: single LJ type, NVE, orthogonal periodic box, float32, unit masses —
the bench/in.lj configuration.  Everything else uses the generic Runner.
The step loop reads nothing back from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from lidp_tpu_torch.forcefield import pair_only_result
from lidp_tpu_torch.ops.cell_kernels import (lj_par, sentinel_scalars,
                                             slot_lj_forces, slot_sentinels)
from lidp_tpu_torch.ops.cells import CellConfig, build_cells


@dataclasses.dataclass(frozen=True)
class SlotCarry:
    x: Any          # (nbx,nby,nbz,cap,3) f32 slot positions (sentinel empties)
    v: Any          # (nbx,nby,nbz,cap,3)
    f: Any          # force carry (same shape)
    invm: Any       # (nbx,nby,nbz,cap) 0 for empty slots
    aid: Any        # (nbx,nby,nbz,cap) int32 atom id, == n for empty
    step: int
    overflow: Any   # () bool (sticky across rebuilds)


@dataclasses.dataclass(frozen=True)
class SlotNeighbor:
    """Duck-types the overflow attribute of the generic Runner's carry."""
    overflow: Any


@dataclasses.dataclass
class SlotRunner:
    ff: Any
    neighbor_cfg: CellConfig
    dt: float
    ftm2v: float
    n: int
    rebuild_every: int = 20
    # the kernel's scalars (ops/cell_kernels.lj_par), formed at setup: the
    # box and the pair table are fixed for this runner
    _par: Any = dataclasses.field(default=None, init=False, repr=False)

    # ---- helpers ----
    def _sentinels(self, box):
        cfg = self.neighbor_cfg
        return slot_sentinels(box, self.ff.pair, (*cfg.nbins, cfg.cap))

    def _slotify(self, x_flat, v_flat, invm_flat, aid_flat, mask_flat, box):
        """Gather flat (M,) arrays into the (nbx,nby,nbz,cap) slot layout.
        Paid once per rebuild, not per step."""
        cells = build_cells(x_flat, mask_flat, box, self.neighbor_cfg)
        aos = cells.atom_of_slot
        m = x_flat.shape[0]
        amax = torch.clamp(aos, max=m - 1).long()
        valid = aos < m
        sent = self._sentinels(box)
        zero = torch.zeros_like(sent)
        xs = torch.where(valid[..., None], x_flat[amax],
                         torch.stack([sent, zero, zero], dim=-1))
        vs = torch.where(valid[..., None], v_flat[amax], 0.0)
        im = torch.where(valid, invm_flat[amax], 0.0)
        aid = torch.where(valid, aid_flat[amax], self.n)
        return xs, vs, im, aid, cells.overflow

    def _force(self, carry, box, need_ev):
        if self._par is None:
            self._par = lj_par(box, self.ff.pair,
                               sentinel_scalars(box, self.ff.pair)[0])
        grids = [carry.x[..., d] for d in range(3)]
        fg, evdwl, vir = slot_lj_forces(grids, box, self.ff.pair,
                                        need_ev=need_ev, par=self._par)
        return torch.stack(fg, dim=-1), evdwl, vir

    def _vv_step(self, carry, box, rebuild):
        dtf = 0.5 * self.dt * self.ftm2v
        a = (dtf * carry.invm)[..., None]
        v = carry.v + a * carry.f
        x = carry.x + self.dt * v
        step = carry.step + 1
        if rebuild:
            # wrap + re-bin from the (arbitrary-order) flat slot view;
            # identity flows through aid.  The force carry is not re-slotted:
            # it is overwritten below before anything reads it.
            xf = x.reshape(-1, 3)
            maskf = carry.aid.reshape(-1) < self.n
            L = box.lengths.to(torch.float32)
            lo = box.lo.to(torch.float32)
            xf = torch.where(maskf[:, None],
                             xf - torch.floor((xf - lo) / L) * L, xf)
            xs, vs, im, aid, ovf = self._slotify(
                xf, v.reshape(-1, 3), carry.invm.reshape(-1),
                carry.aid.reshape(-1), maskf, box)
            carry = SlotCarry(x=xs, v=vs, f=carry.f, invm=im, aid=aid,
                              step=step, overflow=carry.overflow | ovf)
        else:
            carry = dataclasses.replace(carry, x=x, v=v, step=step)
        f, _, _ = self._force(carry, box, need_ev=False)
        v = carry.v + (dtf * carry.invm)[..., None] * f
        return dataclasses.replace(carry, v=v, f=f)

    # ---- public interface (duck-types Runner) ----
    def setup(self, sys):
        """Slot the system and evaluate the initial forces.  Returns (sys,
        res, SlotNeighbor, carry): `carry` is the `istate` that `run`
        takes."""
        f32 = torch.float32
        dev = sys.x.device
        self._par = None
        invm = torch.ones((self.n,), dtype=f32, device=dev)   # in.lj: mass 1
        aid = torch.arange(self.n, dtype=torch.int32, device=dev)
        xs, vs, im, aidg, ovf = self._slotify(
            sys.x.to(f32), sys.v.to(f32), invm, aid, sys.mask, sys.box)
        carry = SlotCarry(x=xs, v=vs, f=torch.zeros_like(xs), invm=im,
                          aid=aidg, step=int(sys.step), overflow=ovf)
        f, evdwl, vir = self._force(carry, sys.box, need_ev=True)
        carry = dataclasses.replace(carry, f=f)
        sys2, res = self._reconstruct(sys, carry, evdwl, vir)
        return sys2, res, SlotNeighbor(overflow=carry.overflow), carry

    def _reconstruct(self, sys, carry, evdwl, vir):
        """Scatter slot state back to atom order (once per run call)."""
        aidf = carry.aid.reshape(-1).long()
        # empty slots hold n: they land in one spare row that is cut off
        tgt = torch.clamp(aidf, max=self.n)
        dtype = sys.x.dtype

        def scat(g):
            out = torch.zeros((self.n + 1, 3), dtype=torch.float32,
                              device=g.device)
            out[tgt] = g.reshape(-1, 3)
            return out[:self.n].to(dtype)

        sys2 = sys.replace(x=scat(carry.x), v=scat(carry.v), step=carry.step)
        res = pair_only_result(sys, scat(carry.f), evdwl.to(dtype),
                               torch.zeros((), dtype=dtype,
                                           device=sys.x.device),
                               vir.to(dtype))
        return sys2, res

    def run(self, sys, res, nlist, istate, nsteps: int):
        """Advance nsteps from the slot carry `istate`: blocks of
        rebuild_every - 1 quiet steps and one rebuild step, counted from
        the start of this call; then the remainder as quiet steps; then one
        energy-bearing force pass."""
        every = self.rebuild_every
        nblocks, rem = divmod(nsteps, every)
        box = sys.box
        carry = istate
        for _ in range(nblocks):
            for _ in range(every - 1):
                carry = self._vv_step(carry, box, rebuild=False)
            carry = self._vv_step(carry, box, rebuild=True)
        for _ in range(rem):
            carry = self._vv_step(carry, box, rebuild=False)
        f, evdwl, vir = self._force(carry, box, need_ev=True)
        carry = dataclasses.replace(carry, f=f)
        sys2, res = self._reconstruct(sys, carry, evdwl, vir)
        return sys2, res, SlotNeighbor(overflow=carry.overflow), carry
