"""Single-type LJ cell kernels: CUDA wrappers and their plain PyTorch
versions (counterpart of lidp_tpu/ops/pallas_pair.py).

  * slot_lj_forces      — LJ forces purely in cell-slot space, for the
                          slot-order state of integrate/slot_runner.py
                          (pallas_pair.py:257; csrc/slot_lj_forces.cu)
  * cell_pair_forces_lj — the same forces from atom order through a Cells
                          grid, a drop-in for ops/cells.cell_pair_forces
                          (pallas_pair.py:340 cell_pair_forces_pallas;
                          csrc/cell_pair_forces_lj.cu)

Each wrapper keeps the JAX function's signature and returns.  On a CPU
tensor it runs the plain version; on a CUDA tensor it launches the
hand-written kernel or raises — there is no fallback.  The kernels are
float32 only, as in the JAX package: a float64 operand raises TypeError.
That is no gap: a float64, multi-type or coulomb system is routed to
ops/cells.cell_pair_forces (plain PyTorch, on the GPU too) by
forcefield.compute_forces, which is the JAX package's own routing.  Each
wrapper counts its launches in `<wrapper>.launches`.

The periodic image of a neighbour cell is a shift of +-L by cell index, not
a minimum image, so every dimension needs at least 3 bins.  Empty slots
carry far-apart sentinel coordinates (`slot_sentinels`) in place of a
validity mask: base + spacing*k in x, 0 in y and z, with spacing > 2*cut +
max(L) so that no pair with a sentinel passes rsq < cutsq, shifted or not.

The plain versions walk the Newton half stencil (own-cell upper triangle
plus 13 offsets, full-weight tallies) with rolled grids, as the TPU
functions do; the CUDA kernels evaluate the full 27-cell stencil at half
weight (csrc/lj_cell.cuh says why), so the two agree to rounding only.
"""

from __future__ import annotations

import torch

from lidp_tpu_torch.box import Box
from lidp_tpu_torch.ops.cells import _HALF_OFFSETS, Cells, _roll
from lidp_tpu_torch.ops.panel import _check, _launch, _stream

NPAR = 8                  # csrc/lj_cell.cuh: lj3 lj4 offset cutsq L(3) floor
ZC = 4                    # csrc/lj_cell.cuh: own z-cells per CTA
MAX_SMEM = 232_448        # bytes of shared memory a block can use on sm_90
ATOM_SENTINEL = 1.0e15    # csrc/lj_cell.cuh ATOM_SENTINEL


def supported(p, ntypes_gt_one: bool, coul: bool) -> bool:
    """Whether the LJ cell kernels cover this pair style: one atom type and
    no coulomb (the port's PairParams has no charmm switch)."""
    return (not ntypes_gt_one) and (not coul)


def sentinel_scalars(box: Box, p):
    """(base, spacing) of the empty-slot sentinels, float32 0-d tensors."""
    f32 = torch.float32
    L = box.lengths.to(f32)
    lo = box.lo.to(f32)
    cutf = torch.sqrt(p.cut_ljsq[1, 1]).to(f32)
    spacing = 2.0 * cutf + torch.max(L) + 1.0
    corner = torch.maximum(torch.max(torch.abs(lo)),
                           torch.max(torch.abs(lo + L)))
    return corner + 2.0 * cutf + spacing, spacing


def slot_sentinels(box: Box, p, shape):
    """Sentinel x coordinates base + spacing*k, k the linear slot index,
    float32 of `shape` (nbx,nby,nbz,cap)."""
    base, spacing = sentinel_scalars(box, p)
    nslots = shape[0] * shape[1] * shape[2] * shape[3]
    lin = torch.arange(nslots, dtype=torch.float32, device=base.device)
    return base + spacing * lin.reshape(shape)


def lj_par(box: Box, p, floor=None):
    """The kernels' NPAR float32 scalars as one device tensor, built
    without a host read: lj3 lj4 offset cutsq Lx Ly Lz sent_floor."""
    f32 = torch.float32
    head = torch.stack([p.lj3[1, 1], p.lj4[1, 1], p.offset[1, 1],
                        p.cut_ljsq[1, 1]]).to(f32)
    if floor is None:
        floor = head.new_full((1,), ATOM_SENTINEL)
    return torch.cat([head, box.lengths.to(f32), floor.reshape(1)])


# ------------------------------ plain path ------------------------------

def _wrap_shift(nb, o, ax, device):
    """-1/0/+1 per cell along axis ax: the box lengths a roll by offset o
    carries the neighbour across (pallas_pair.py _wrap_shift_np)."""
    idx = torch.arange(nb, device=device) + o
    s = (idx >= nb).to(torch.float32) - (idx < 0).to(torch.float32)
    shape = [1, 1, 1, 1]
    shape[ax] = nb
    return s.reshape(shape)


def _stencil_plain(xs, L, lj3, lj4, off, cutsq, need_ev):
    """LJ on sentinel-filled slot grids xs = [x, y, z] (nbx,nby,nbz,cap):
    (force grids x3, evdwl, virial6), Newton half stencil."""
    nbins, cap = xs[0].shape[:3], xs[0].shape[3]
    if min(nbins) < 3:
        raise ValueError(f"the LJ cell kernels need >= 3 bins in every "
                         f"dimension, got {tuple(nbins)}")
    dev = xs[0].device
    fs = [torch.zeros_like(xs[0]) for _ in range(3)]
    acc = xs[0].new_zeros((7,))
    ar = torch.arange(cap, device=dev)
    tri = ar[None, :] > ar[:, None]                 # cols > rows
    for o in [(0, 0, 0)] + _HALF_OFFSETS:
        d3 = []
        for d in range(3):
            nb = _roll(xs[d], o, -1)
            if o[d]:
                nb = nb + _wrap_shift(nbins[d], o[d], d, dev) * L[d]
            d3.append(xs[d][..., :, None] - nb[..., None, :])
        dx, dy, dz = d3
        rsq = dx * dx + dy * dy + dz * dz
        ok = rsq < cutsq
        if o == (0, 0, 0):
            ok = ok & tri
        rsq = torch.where(ok, rsq, 1.0)
        r2inv = 1.0 / rsq
        r6inv = r2inv * r2inv * r2inv
        fpair = torch.where(
            ok, r6inv * (12.0 * lj3 * r6inv - 6.0 * lj4) * r2inv, 0.0)
        ps = (fpair * dx, fpair * dy, fpair * dz)
        for d in range(3):
            fs[d] = fs[d] + ps[d].sum(-1) - _roll(ps[d].sum(-2), o, +1)
        if need_ev:
            philj = torch.where(ok, r6inv * (lj3 * r6inv - lj4) - off, 0.0)
            px, py, pz = ps
            acc = acc + torch.stack([
                philj.sum(), (px * dx).sum(), (py * dy).sum(),
                (pz * dz).sum(), (px * dy).sum(), (px * dz).sum(),
                (py * dz).sum()])
    return fs, acc[0], acc[1:7]


def _lj_scalars32(p):
    return (t[1, 1].to(torch.float32)
            for t in (p.lj3, p.lj4, p.offset, p.cut_ljsq))


def slot_lj_forces_plain(grids, box: Box, p, need_ev: bool = True):
    """Plain version of slot_lj_forces, any device."""
    lj3, lj4, off, cutsq = _lj_scalars32(p)
    return _stencil_plain([g.to(torch.float32) for g in grids],
                          box.lengths.to(torch.float32), lj3, lj4, off,
                          cutsq, need_ev)


def cell_pair_forces_lj_plain(x, mask, cells: Cells, box: Box, p,
                              need_ev: bool = True):
    """Plain version of cell_pair_forces_lj, any device: slotify with
    sentinels, the stencil, one gather back to atom order."""
    n = x.shape[0]
    aos = cells.atom_of_slot
    amax = torch.clamp(aos, max=n - 1).long()
    valid = aos < n
    x32 = x.to(torch.float32)
    sent = slot_sentinels(box, p, aos.shape)
    xs = [torch.where(valid, x32[:, d][amax], sent if d == 0 else 0.0)
          for d in range(3)]
    lj3, lj4, off, cutsq = _lj_scalars32(p)
    fs, evdwl, vir = _stencil_plain(xs, box.lengths.to(torch.float32), lj3,
                                    lj4, off, cutsq, need_ev)
    # masked atoms name the slot past the grid: clamp, then zero them
    soa = torch.clamp(cells.slot_of_atom, max=aos.numel() - 1).long()
    f = torch.stack([g.reshape(-1)[soa] for g in fs], dim=-1)
    f = torch.where(mask[:, None], f, 0.0).to(x.dtype)
    return (f, evdwl.to(x.dtype), torch.zeros((), dtype=x.dtype,
                                              device=x.device),
            vir.to(x.dtype))


# ------------------------------ CUDA path -------------------------------

def _grid_dims(name, shape):
    if len(shape) != 4 or min(shape) < 1:
        raise ValueError(f"{name}: expected a (nbx,nby,nbz,cap) grid, got "
                         f"{tuple(shape)}")
    nbx, nby, nbz, cap = shape
    if min(nbx, nby, nbz) < 3:
        raise ValueError(f"{name}: needs >= 3 bins in every dimension, got "
                         f"{(nbx, nby, nbz)}")
    if 4 * 3 * 9 * (ZC + 2) * cap > MAX_SMEM:
        raise ValueError(f"{name}: cap {cap} does not fit shared memory")
    return nbx, nby, nbz, cap


def _ev_buffers(shape, need_ev, device):
    """(partials, acc): per-CTA partials and the 8 reduced scalars; without
    need_ev the kernel writes neither and acc is the zeros returned."""
    nbx, nby, nbz, _ = shape
    acc = torch.zeros((8,), dtype=torch.float32, device=device)
    if not need_ev:
        return None, acc
    nblocks = nbx * nby * (-(-nbz // ZC))
    return torch.empty((nblocks, 8), dtype=torch.float32, device=device), acc


def _check_par(name, par, device):
    if par.dtype != torch.float32 or tuple(par.shape) != (NPAR,) \
            or not par.is_contiguous():
        raise ValueError(f"{name}: par must be {NPAR} contiguous float32 "
                         f"values (lj_par)")
    if par.device != device:
        raise ValueError(f"{name}: the kernel's scalars lie on {par.device}, "
                         f"the coordinates on {device}")


def _uniform_stride(name, g):
    """Element stride s of a grid laid out as a contiguous array read at
    every s-th element (1: contiguous; 3: one column of a (...,cap,3)
    array)."""
    s = g.stride(-1)
    want = [s]
    for size in reversed(g.shape[1:]):
        want.insert(0, want[0] * size)
    if s < 1 or tuple(g.stride()) != tuple(want):
        raise ValueError(f"{name}: grid strides {g.stride()} are not a "
                         f"uniformly strided {tuple(g.shape)} layout")
    return s


def slot_lj_forces(grids, box: Box, p, need_ev: bool = True, par=None):
    """LJ forces purely in slot space.  grids = three (nbx,nby,nbz,cap)
    float32 slot-coordinate grids whose empty slots carry the sentinels of
    `slot_sentinels`.  Returns (force grids x3, evdwl, virial6) in slot
    order; with need_ev=False the last two are zeros.

    On CUDA the grids may be separate contiguous tensors or the three
    columns of one (...,cap,3) tensor, and the force grids returned are the
    columns of one such tensor.  `par` is `lj_par(box, p, base)` when the
    caller has it already (the box and the table do not change in a run)."""
    if grids[0].device.type == "cpu":
        return slot_lj_forces_plain(grids, box, p, need_ev=need_ev)
    name = "slot_lj_forces"
    gx, gy, gz = grids
    dev = gx.device
    if par is None:
        par = lj_par(box, p, sentinel_scalars(box, p)[0])
    _check_par(name, par, dev)
    for t in (gx, gy, gz):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
    shape = _grid_dims(name, gx.shape)
    stride = _uniform_stride(name, gx)
    for g in (gy, gz):
        if g.shape != gx.shape or _uniform_stride(name, g) != stride:
            raise ValueError(f"{name}: the three grids differ in layout")
    fout = torch.empty((*shape, 3), dtype=torch.float32, device=dev)
    partials, acc = _ev_buffers(shape, need_ev, dev)
    _launch(name, "PPPIIIIIPIPPPP", dev, gx.data_ptr(), gy.data_ptr(),
            gz.data_ptr(), stride, *shape, par.data_ptr(), int(need_ev),
            fout.data_ptr(), partials.data_ptr() if need_ev else None,
            acc.data_ptr(), _stream(gx))
    slot_lj_forces.launches += 1
    return [fout[..., 0], fout[..., 1], fout[..., 2]], acc[0], acc[1:7]


slot_lj_forces.launches = 0


def cell_pair_forces_lj(x, mask, cells: Cells, box: Box, p,
                        need_ev: bool = True):
    """Drop-in LJ replacement for ops/cells.cell_pair_forces (single type,
    no coulomb, float32, orthogonal periodic box, >= 3 bins a side).
    Returns (f (N,3), evdwl, ecoul = 0, virial6) in atom order; masked
    atoms get zero force.  When the grid has overflowed (which the runners
    report), the atoms that found no slot get zero force here."""
    if x.device.type == "cpu":
        return cell_pair_forces_lj_plain(x, mask, cells, box, p,
                                         need_ev=need_ev)
    name = "cell_pair_forces_lj"
    aos = cells.atom_of_slot
    _check(name, torch.float32, x)
    n = x.shape[0]
    if tuple(x.shape) != (n, 3) or n < 1:
        raise ValueError(f"{name}: x must be (N,3), got {tuple(x.shape)}")
    if aos.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError(f"{name}: atom_of_slot must be int32 and mask bool")
    if tuple(mask.shape) != (n,) or aos.device != x.device \
            or mask.device != x.device:
        raise ValueError(f"{name}: mask must be (N,), on x's device like "
                         f"atom_of_slot")
    if not (aos.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    shape = _grid_dims(name, aos.shape)
    par = lj_par(box, p)
    f = torch.zeros((n, 3), dtype=torch.float32, device=x.device)
    partials, acc = _ev_buffers(shape, need_ev, x.device)
    _launch(name, "PPPIIIIIPIPPPP", x.device, x.data_ptr(), aos.data_ptr(),
            mask.data_ptr(), n, *shape, par.data_ptr(), int(need_ev),
            f.data_ptr(), partials.data_ptr() if need_ev else None,
            acc.data_ptr(), _stream(x))
    cell_pair_forces_lj.launches += 1
    return f, acc[0], acc[7], acc[1:7]


cell_pair_forces_lj.launches = 0

# every wrapper of this module that launches a kernel, by name
WRAPPERS = {w.__name__: w for w in (slot_lj_forces, cell_pair_forces_lj)}
