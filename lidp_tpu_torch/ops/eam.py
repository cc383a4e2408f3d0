"""EAM (embedded atom method): pair_style eam, eam/alloy and eam/fs
(lidp_tpu/ops/eam.py).

The reference's MANYBODY/pair_eam.cpp as two passes over the rolled cell
grid with the Newton half stencil:

  pass 1: rho_i = sum_j rho(r_ij)          (density accumulation)
  embed:  F'(rho_i), E_embed = F(rho_i)    (per-atom spline)
  pass 2: fpair = -(F'_i rho'(r) + F'_j rho'(r) + phi'(r))/r, evdwl = phi(r)

The tables are built on the host in numpy exactly as the JAX package
builds them, so the coefficients come out equal bit for bit: funcfl and
setfl reading (pair_eam.cpp read_file, pair_eam_alloy.cpp and
pair_eam_fs.cpp read_file), z2r = 27.2*0.529*Z_i(r)*Z_j(r) for funcfl
(:683), the reference's finite-difference cubic spline (interpolate(),
:720-750), and its refit of each splined r-function to K uniform segments
of degree-D polynomials (least squares on 20,000 points).  The JAX package
evaluates a segment by a one-hot matmul (a TPU device: the product
multiplies one coefficient by 1.0 and adds zeros); here the segment's
coefficient row is gathered directly, which gives the same values and
builds no (pairs x K) tensor, and Horner runs in the same order.  The
per-atom embedding keeps the exact reference spline with its linear
extension above rho_max.

Plain PyTorch on the card too: the JAX package computes EAM in XLA, with
no Pallas kernel (ROADMAP queue 2 names a CUDA kernel for the two passes
as a candidate).  Orthogonal boxes only, at least 3 bins in every
dimension that has more than one, as the cell grid of ops/cells.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch import resolve_device
from lidp_tpu_torch.box import Box, minimum_image
from lidp_tpu_torch.ops.cells import Cells, _roll, half_offsets

# the most (cells x cap x neighbour slots) slot pairs one group of
# stencil offsets forms at once: 2^25, ~270 MB a float64 tensor, about
# five of them live at once (the JAX package's grouping, 512 // cap
# offsets, only changes the order of the sums).  in.eam's 32,000 atoms
# (12^3 cells of cap 32, 24.8 M slot pairs) take one group: fewer groups
# are fewer launches, and on an H100 the float32 term took 11.9 ms a call
# against 20.5 ms in groups of 2^23 and 52.1 ms in groups of 2^21
# (scripts/profile_torch_eam.py)
GROUP_PAIRS = 1 << 25


# ---------------------------------------------------------------- tables

def read_funcfl(path: str):
    """Parse a funcfl (pair_style eam) file: a comment line; `Z mass
    a0 lattice`; `nrho drho nr dr cut`; then nrho F(rho), nr Z(r) and nr
    rho(r) values."""
    with open(path) as fh:
        fh.readline()                       # comment
        parts = fh.readline().split()
        mass = float(parts[1])
        nums = []
        for line in fh:
            nums.extend(float(v) for v in line.split())
    it = iter(nums)
    nrho = int(next(it)); drho = next(it)
    nr = int(next(it)); dr = next(it); cut = next(it)
    rest = list(it)
    frho = np.array(rest[:nrho])
    zr = np.array(rest[nrho:nrho + nr])
    rhor = np.array(rest[nrho + nr:nrho + 2 * nr])
    return dict(nrho=nrho, drho=drho, nr=nr, dr=dr, cut=cut,
                frho=frho, zr=zr, rhor=rhor, mass=mass)


def read_setfl(path: str, fs: bool = False):
    """Parse a setfl (eam/alloy) file — pair_eam_alloy.cpp::read_file.

    Layout: 3 comment lines; `Nelem name1..nameN`; `nrho drho nr dr cut`;
    per element: header (atomic number, mass, lattice const, structure),
    nrho F(rho) values, nr rho(r) values; then nr r*phi values for each
    element pair i>=j (lower triangle, row-major).

    fs=True parses the Finnis-Sinclair variant
    (pair_eam_fs.cpp::read_file:195-206): each element block carries
    nelem density arrays rhor[i][j] — the density function of element i
    toward element j; rhor is then a flat list of nelem*nelem arrays
    indexed i*nelem + j."""
    with open(path) as fh:
        for _ in range(3):
            fh.readline()
        parts = fh.readline().split()
        nelem = int(parts[0])
        names = parts[1:1 + nelem]
        toks = fh.read().split()
    it = iter(toks)
    nrho = int(next(it)); drho = float(next(it))
    nr = int(next(it)); dr = float(next(it)); cut = float(next(it))
    mass, frho, rhor = [], [], []
    for _ in range(nelem):
        next(it)                       # atomic number
        mass.append(float(next(it)))
        next(it); next(it)             # lattice constant, structure
        frho.append(np.array([float(next(it)) for _ in range(nrho)]))
        for _j in range(nelem if fs else 1):
            rhor.append(np.array([float(next(it)) for _ in range(nr)]))
    z2r = {}
    for i in range(nelem):
        for j in range(i + 1):
            z2r[(i, j)] = np.array([float(next(it)) for _ in range(nr)])
    return dict(nelem=nelem, names=names, nrho=nrho, drho=drho, nr=nr, dr=dr,
                cut=cut, mass=mass, frho=frho, rhor=rhor, z2r=z2r)


def lammps_spline(f: np.ndarray, delta: float) -> np.ndarray:
    """Exact PairEAM::interpolate coefficients; returns (n+1, 7), 1-indexed."""
    n = len(f)
    sp = np.zeros((n + 1, 7))
    sp[1:, 6] = f
    sp[1, 5] = sp[2, 6] - sp[1, 6]
    sp[2, 5] = 0.5 * (sp[3, 6] - sp[1, 6])
    sp[n - 1, 5] = 0.5 * (sp[n, 6] - sp[n - 2, 6])
    sp[n, 5] = sp[n, 6] - sp[n - 1, 6]
    for m in range(3, n - 1):
        sp[m, 5] = ((sp[m - 2, 6] - sp[m + 2, 6])
                    + 8.0 * (sp[m + 1, 6] - sp[m - 1, 6])) / 12.0
    for m in range(1, n):
        sp[m, 4] = (3.0 * (sp[m + 1, 6] - sp[m, 6]) - 2.0 * sp[m, 5]
                    - sp[m + 1, 5])
        sp[m, 3] = sp[m, 5] + sp[m + 1, 5] - 2.0 * (sp[m + 1, 6] - sp[m, 6])
    sp[n, 4] = 0.0
    sp[n, 3] = 0.0
    sp[:, 2] = sp[:, 5] / delta
    sp[:, 1] = 2.0 * sp[:, 4] / delta
    sp[:, 0] = 3.0 * sp[:, 3] / delta
    return sp


def spline_value(sp: np.ndarray, delta: float, x: np.ndarray):
    """Evaluate value exactly like the reference kernel (p = x/delta + 1)."""
    n = sp.shape[0] - 1
    p = x / delta + 1.0
    m = np.minimum(np.maximum(p.astype(int), 1), n - 1)
    p = np.minimum(p - m, 1.0)
    c = sp[m]
    return ((c[:, 3] * p + c[:, 4]) * p + c[:, 5]) * p + c[:, 6]


def spline_deriv(sp: np.ndarray, delta: float, x: np.ndarray):
    n = sp.shape[0] - 1
    p = x / delta + 1.0
    m = np.minimum(np.maximum(p.astype(int), 1), n - 1)
    p = np.minimum(p - m, 1.0)
    c = sp[m]
    return (c[:, 0] * p + c[:, 1]) * p + c[:, 2]


def _fit_segments(xs, ys, nseg, deg, xmax):
    """Least-squares degree-`deg` polynomials per uniform segment of
    [0, xmax]."""
    coeffs = np.zeros((nseg, deg + 1))
    seg = np.minimum((xs / xmax * nseg).astype(int), nseg - 1)
    for s in range(nseg):
        m = seg == s
        xi = xs[m] / xmax * nseg - s          # [0,1)
        V = np.vander(xi, deg + 1, increasing=True)
        coeffs[s] = np.linalg.lstsq(V, ys[m], rcond=None)[0]
    return coeffs


def _fit_functions(sp, dr, cut, nseg, deg):
    """The segment coefficients of a splined r-function's value and
    derivative, side by side: (nseg, 2*(deg+1))."""
    xs = np.linspace(0.0, cut, 20000, endpoint=False) + cut / 40000.0
    return np.concatenate(
        [_fit_segments(xs, f, nseg, deg, cut)
         for f in (spline_value(sp, dr, xs), spline_deriv(sp, dr, xs))],
        axis=1)


@dataclasses.dataclass(frozen=True)
class EAMParams:
    """funcfl (pair_style eam) tables on a device."""
    # per-pair r-functions as segment polynomials over [0, cut]
    seg_coeffs: torch.Tensor    # (K, 4*(D+1)): rho, rhop, z2, z2p stacked
    frho_spline: torch.Tensor   # (nrho+1, 7) exact embedding spline
    cut: torch.Tensor
    cutsq: torch.Tensor
    drho: torch.Tensor
    rhomax: torch.Tensor
    nseg: int = 64
    deg: int = 7
    nrho: int = 500


@dataclasses.dataclass(frozen=True)
class EAMAlloyParams:
    """setfl (eam/alloy, eam/fs) tables — pair_eam_alloy.cpp.

    Per-element rho/rho' and per-element-pair z2/z2' segment polynomials;
    per-element embedding splines; LAMMPS-type -> element map from the
    `pair_coeff * * file El1 El2 ... [NULL]` grammar (a NULL type maps to
    element 0, as in the JAX package)."""
    seg_rho: torch.Tensor       # (nelem or nelem^2, K, 2*(D+1)): rho, rhop
    seg_z2: torch.Tensor        # (npair, K, 2*(D+1)): z2, z2p; i*(i+1)/2+j
    frho_spline: torch.Tensor   # (nelem, nrho+1, 7)
    type2elem: torch.Tensor     # (ntypes+1,) int64
    cut: torch.Tensor
    cutsq: torch.Tensor
    drho: torch.Tensor
    rhomax: torch.Tensor
    nseg: int = 64
    deg: int = 7
    nrho: int = 500
    nelem: int = 1
    # Finnis-Sinclair (pair_eam_fs.cpp): seg_rho holds nelem*nelem tables
    # flat-indexed src*nelem + dst; the density at atom i due to neighbour
    # j reads [ej*nelem + ei] (type2rhor[jtype][itype], pair_eam.cpp:205)
    fs: bool = False


def _scalars(d, dtype, dev):
    def t(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    cut = d["cut"]
    return dict(cut=t(cut), cutsq=t(cut * cut), drho=t(d["drho"]),
                rhomax=t((d["nrho"] - 1) * d["drho"]))


def build_eam_params(path: str, dtype=torch.float32, device="cuda", nseg=64,
                     deg=7):
    """The funcfl tables of `path` on `device`: (EAMParams, the file's
    mass)."""
    dev = resolve_device(device)
    d = read_funcfl(path)
    z2r = 27.2 * 0.529 * d["zr"] * d["zr"]
    sp_f = lammps_spline(d["frho"], d["drho"])
    coeffs = np.concatenate(
        [_fit_functions(lammps_spline(f, d["dr"]), d["dr"], d["cut"], nseg,
                        deg) for f in (d["rhor"], z2r)], axis=1)
    return EAMParams(
        seg_coeffs=torch.as_tensor(coeffs, dtype=dtype, device=dev),
        frho_spline=torch.as_tensor(sp_f, dtype=dtype, device=dev),
        **_scalars(d, dtype, dev), nseg=nseg, deg=deg, nrho=d["nrho"],
    ), d["mass"]


def build_eam_alloy_params(path: str, elem_for_type, dtype=torch.float32,
                           device="cuda", nseg=64, deg=7, fs=False):
    """elem_for_type: list of element names (or None for NULL), one per
    LAMMPS type 1..ntypes.  Returns (EAMAlloyParams, mass_per_type[T+1])
    on `device`; an unknown element name raises ValueError."""
    dev = resolve_device(device)
    d = read_setfl(path, fs=fs)
    cut, dr = d["cut"], d["dr"]
    seg_rho = [_fit_functions(lammps_spline(d["rhor"][e], dr), dr, cut,
                              nseg, deg)
               for e in range(d["nelem"] ** 2 if fs else d["nelem"])]
    frho = [lammps_spline(d["frho"][e], d["drho"])
            for e in range(d["nelem"])]
    seg_z2 = [_fit_functions(lammps_spline(d["z2r"][(i, j)], dr), dr, cut,
                             nseg, deg)
              for i in range(d["nelem"]) for j in range(i + 1)]

    t2e = np.zeros(len(elem_for_type) + 1, np.int64)
    mass_t = np.zeros(len(elem_for_type) + 1)
    for t, name in enumerate(elem_for_type, start=1):
        if name is None or name == "NULL":
            continue
        if name not in d["names"]:
            raise ValueError(f"element {name} not in {path}: {d['names']}")
        e = d["names"].index(name)
        t2e[t] = e
        mass_t[t] = d["mass"][e]

    def tab(a):
        return torch.as_tensor(np.stack(a), dtype=dtype, device=dev)

    return EAMAlloyParams(
        seg_rho=tab(seg_rho), seg_z2=tab(seg_z2), frho_spline=tab(frho),
        type2elem=torch.as_tensor(t2e, device=dev),
        **_scalars(d, dtype, dev), nseg=nseg, deg=deg, nrho=d["nrho"],
        nelem=d["nelem"], fs=fs,
    ), mass_t


# ------------------------------------------------------------ evaluation

def _segments(r, p):
    """The segment index (int64) of each r and its local coordinate xi in
    [0, 1): s = clamp(trunc(r/cut*K), 0, K-1), xi = r/cut*K - s."""
    t = r / p.cut * p.nseg
    s = torch.clamp(t.to(torch.int32), 0, p.nseg - 1)
    return s.long(), t - s.to(r.dtype)


def _horner(table, k, row, xi, deg):
    """Function k of the coefficient rows `table` (rows x nfun*(deg+1)) at
    the gathered rows `row`: the segment's row gathered, then Horner from
    the highest power down (the JAX package's _horner order)."""
    c = table[:, k * (deg + 1):(k + 1) * (deg + 1)][row]
    acc = c[..., deg]
    for j in range(deg - 1, -1, -1):
        acc = acc * xi + c[..., j]
    return acc


def _embedding(rho_atom, spline, mask, p):
    """F'(rho) and the summed embedding energy of the unmasked atoms by
    the exact reference spline (`spline`: (N, 7) rows already selected
    per atom's element, or the single table), with the linear extension
    above rho_max."""
    pr = rho_atom / p.drho + 1.0
    m = torch.clamp(pr.to(torch.int32), 1, p.nrho - 1).long()
    frac = torch.clamp(pr - m.to(rho_atom.dtype), max=1.0)
    c = spline(m)
    fp = (c[:, 0] * frac + c[:, 1]) * frac + c[:, 2]
    phi = ((c[:, 3] * frac + c[:, 4]) * frac + c[:, 5]) * frac + c[:, 6]
    phi = phi + torch.where(rho_atom > p.rhomax, fp * (rho_atom - p.rhomax),
                            0.0)
    return fp, torch.sum(torch.where(mask, phi, 0.0))


class _Pairs:
    """The pairs of one group of offsets that lie inside the cutoff, in
    the row-major order of the group's (cells, cap, G*cap) block: their
    flat positions there, the flat slot of each centre atom (cell*cap +
    slot) and of each neighbour column (cell*G*cap + column), r, and the
    block's shape."""

    def __init__(self, flat, ctr, nbr, r, shape):
        self.flat, self.ctr, self.nbr, self.r = flat, ctr, nbr, r
        self.shape = shape


class _Grid:
    """The slot grid of one evaluation: per-slot coordinates, the half
    stencil in groups of offsets, the live pairs of a group and the
    neighbour side's sums rolled home.  The table evaluations run on the
    live pairs alone (a few percent of the slot pairs at in.eam's
    density) and their results go back into the dense block by position,
    so the sums run over the same block, in the same order, as when every
    slot pair is evaluated and masked."""

    def __init__(self, x, cells: Cells, box: Box, cutsq):
        n = x.shape[0]
        aos = cells.atom_of_slot
        self.n, self.aos = n, aos
        self.cap = cap = aos.shape[-1]
        self.amax = torch.clamp(aos, max=n - 1).long()
        self.valid = aos < n
        self.xs = [self.slotify(x[:, d]) for d in range(3)]
        self.L = box.img_lengths
        self.cutsq = cutsq
        offs = [(0, 0, 0)] + half_offsets(aos.shape[:3])
        g = max(1, min(len(offs), GROUP_PAIRS // (self.valid.numel() * cap)))
        self.groups = [offs[i:i + g] for i in range(0, len(offs), g)]
        ar = torch.arange(cap, device=x.device)
        self.tri = ar[:, None] < ar[None, :]
        # slot -> atom gather for the results (masked atoms name the slot
        # past the grid: clamped, then zeroed by the caller's mask)
        self.soa = torch.clamp(cells.slot_of_atom, max=aos.numel() - 1).long()

    def slotify(self, a, fill=0.0):
        return torch.where(self.valid, a[self.amax], fill)

    def atoms(self, a):
        return a.reshape(-1)[self.soa]

    @staticmethod
    def nbr(a, offs):
        """The neighbour cells' slots of each offset side by side:
        (cells, G*cap)."""
        return torch.cat([_roll(a, o, -1) for o in offs], dim=-1)

    def pairs(self, offs):
        """The minimum-image displacements of a group's live pairs (dx,
        dy, dz of the pairs with both slots live, i < j within the own
        cell, inside the cutoff) and their _Pairs."""
        d = [minimum_image(
            xs[..., :, None] - self.nbr(xs, offs)[..., None, :], self.L[k])
             for k, xs in enumerate(self.xs)]
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        ok = (self.valid[..., :, None]
              & self.nbr(self.valid, offs)[..., None, :])
        if (0, 0, 0) in offs:
            gi = offs.index((0, 0, 0))
            blk = torch.ones((self.cap, len(offs) * self.cap),
                             dtype=torch.bool, device=rsq.device)
            blk[:, gi * self.cap:(gi + 1) * self.cap] = self.tri
            ok = ok & blk
        ok = ok & (rsq < self.cutsq)
        flat = torch.nonzero(ok.reshape(-1)).squeeze(1)
        width = len(offs) * self.cap
        row = flat // width
        pr = _Pairs(flat, row, row // self.cap * width + flat % width,
                    torch.sqrt(rsq.reshape(-1)[flat]), rsq.shape)
        return [a.reshape(-1)[flat] for a in d], pr

    @staticmethod
    def expand(vals, pr):
        """Live-pair values back into the group's dense block, zeros
        elsewhere."""
        out = vals.new_zeros(pr.shape.numel())
        out[pr.flat] = vals
        return out.reshape(pr.shape)

    def at_pairs(self, a, offs, pr):
        """A per-slot array at the centre and at the neighbour slot of
        each live pair."""
        return (a.reshape(-1)[pr.ctr],
                self.nbr(a, offs).reshape(-1)[pr.nbr])

    def home(self, px, offs):
        """The neighbour side's partial sums of a group rolled home:
        (cells, G*cap) summed over the centre slots -> (cells, cap)."""
        sx = torch.sum(px, dim=-2)
        cap = self.cap
        out = torch.zeros(self.aos.shape, dtype=px.dtype, device=px.device)
        for g, o in enumerate(offs):
            out = out + _roll(sx[..., g * cap:(g + 1) * cap], o, +1)
        return out


def _force_pass(grid, pair_terms, mask, need_ev):
    """Pass 2 on every group: pair_terms(offs, pairs) -> (psip without
    the pair term, z2, z2') of the group's live pairs; the Newton half sum
    of the forces, the pair energy and the six virial sums under need_ev.
    Returns (f in atom order, evdwl, virial6)."""
    aos = grid.aos
    dtype = grid.xs[0].dtype
    fx = torch.zeros(aos.shape, dtype=dtype, device=aos.device)
    fy, fz = torch.zeros_like(fx), torch.zeros_like(fx)
    zero = fx.new_zeros(())
    evdwl, vir = zero, [zero] * 6
    for offs in grid.groups:
        (dx, dy, dz), pr = grid.pairs(offs)
        emb, z2, z2p = pair_terms(offs, pr)
        recip = 1.0 / pr.r
        phi = z2 * recip
        phip = z2p * recip - phi * recip
        fpair = -(emb + phip) * recip
        px, py, pz = fpair * dx, fpair * dy, fpair * dz
        if need_ev:
            evdwl = evdwl + torch.sum(phi)
            terms = (px * dx, py * dy, pz * dz, px * dy, px * dz, py * dz)
            vir = [v + torch.sum(t) for v, t in zip(vir, terms)]
        for fa, pa in ((fx, px), (fy, py), (fz, pz)):
            pa = grid.expand(pa, pr)
            fa += pa.sum(-1) - grid.home(pa, offs)
    f = torch.stack([grid.atoms(fx), grid.atoms(fy), grid.atoms(fz)], -1)
    return torch.where(mask[:, None], f, 0.0), evdwl, torch.stack(vir)


def eam_cell_forces(x, mask, cells: Cells, box: Box, p: EAMParams,
                    need_ev: bool = True):
    """Two-pass funcfl EAM on the rolled cell grid with the Newton half
    stencil (npair_half_bin_newton.cpp analog): densities and pair forces
    are symmetric for one element, so each stencil pair is evaluated once
    and the j side's share rolls back to its home cell.  need_ev=False
    skips the pair energy and virial sums (the embedding energy is a free
    by-product of pass 1 and is always returned).  Returns (f, evdwl,
    virial6)."""
    grid = _Grid(x, cells, box, p.cutsq)
    tab, deg = p.seg_coeffs, p.deg

    # pass 1: densities (Newton: both sides of each half pair)
    rho_slots = torch.zeros(grid.aos.shape, dtype=x.dtype, device=x.device)
    for offs in grid.groups:
        _, pr = grid.pairs(offs)
        s, xi = _segments(pr.r, p)
        rho_r = grid.expand(_horner(tab, 0, s, xi, deg), pr)
        rho_slots = rho_slots + rho_r.sum(-1) + grid.home(rho_r, offs)

    # the embedding: the exact reference spline, per-atom gathers
    fp_atom, e_embed = _embedding(grid.atoms(rho_slots),
                                  lambda m: p.frho_spline[m], mask, p)
    fp_slots = grid.slotify(fp_atom)

    # pass 2: forces and the pair energy (Newton half sum)
    def pair_terms(offs, pr):
        s, xi = _segments(pr.r, p)
        rhop, z2, z2p = (_horner(tab, k, s, xi, deg) for k in (1, 2, 3))
        fp_i, fp_j = grid.at_pairs(fp_slots, offs, pr)
        return (fp_i + fp_j) * rhop, z2, z2p

    f, evdwl, vir = _force_pass(grid, pair_terms, mask, need_ev)
    return f, evdwl + e_embed, vir


def eam_alloy_cell_forces(x, type_, mask, cells: Cells, box: Box,
                          p: EAMAlloyParams, need_ev: bool = True):
    """Multi-element setfl EAM (eam/alloy, eam/fs) on the rolled cell grid
    with the Newton half stencil.

    Each pair gathers the coefficient row of its elements' table
    (pair_eam_alloy.cpp's type2rhor/type2z2r indirection): the table index
    times K plus the segment.  The JAX package evaluates every table on
    every pair and keeps the pair's by select masks, which adds zeros to
    the same value.  Newton halving: the i side accumulates rho of j's
    element (of the table j -> i under fs) while rho of i's element rolls
    back to j (densities are element-asymmetric, forces are symmetric)."""
    grid = _Grid(x, cells, box, p.cutsq)
    K, deg, ne = p.nseg, p.deg, p.nelem
    rho_tab = p.seg_rho.reshape(-1, p.seg_rho.shape[-1])
    z2_tab = p.seg_z2.reshape(-1, p.seg_z2.shape[-1])
    elem_atom = p.type2elem[type_.long()]
    esl = grid.slotify(elem_atom, 0)

    def rho_rows(ei, ej, s):
        """The rows of the density i <- j (read at j's table, j -> i under
        fs) and j <- i."""
        if p.fs:
            return (ej * ne + ei) * K + s, (ei * ne + ej) * K + s
        return ej * K + s, ei * K + s

    # pass 1: densities (i gains rho(ej), j gains rho(ei))
    rho_slots = torch.zeros(grid.aos.shape, dtype=x.dtype, device=x.device)
    for offs in grid.groups:
        _, pr = grid.pairs(offs)
        s, xi = _segments(pr.r, p)
        row_j, row_i = rho_rows(*grid.at_pairs(esl, offs, pr), s)
        rho_j = grid.expand(_horner(rho_tab, 0, row_j, xi, deg), pr)
        rho_i = grid.expand(_horner(rho_tab, 0, row_i, xi, deg), pr)
        rho_slots = rho_slots + rho_j.sum(-1) + grid.home(rho_i, offs)

    # the embedding: each atom's element's spline
    fp_atom, e_embed = _embedding(
        grid.atoms(rho_slots), lambda m: p.frho_spline[elem_atom, m], mask,
        p)
    fp_slots = grid.slotify(fp_atom)

    # pass 2: forces and the pair energy (Newton half sum)
    def pair_terms(offs, pr):
        s, xi = _segments(pr.r, p)
        ei, ej = grid.at_pairs(esl, offs, pr)
        row_j, row_i = rho_rows(ei, ej, s)
        hi, lo = torch.maximum(ei, ej), torch.minimum(ei, ej)
        row_z = (hi * (hi + 1) // 2 + lo) * K + s
        rhop_j = _horner(rho_tab, 1, row_j, xi, deg)
        rhop_i = _horner(rho_tab, 1, row_i, xi, deg)
        z2, z2p = (_horner(z2_tab, k, row_z, xi, deg) for k in (0, 1))
        # pair_eam.cpp:286-292: psip = fp_i*rhop_j + fp_j*rhop_i + phip
        fp_i, fp_j = grid.at_pairs(fp_slots, offs, pr)
        return fp_i * rhop_j + fp_j * rhop_i, z2, z2p

    f, evdwl, vir = _force_pass(grid, pair_terms, mask, need_ev)
    return f, evdwl + e_embed, vir
