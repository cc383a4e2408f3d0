"""O(N^2) panel kernels of the polarizable step: CUDA wrappers and their
plain PyTorch versions.

Counterparts of lidp_tpu/ops/pallas_panel.py's kernels on the single-device
panel path:

  * eind_panel      — E_ind = -T.mu, once per CG matvec   (pallas_panel.py:194)
  * pair_wolf_panel — LJ + coul/long pair forces fused with the Wolf static
                      field E0, once per step             (pallas_panel.py:1386)
  * dipole_panel    — charge-dipole + dipole-dipole forces, u_ef, u_dd,
                      pairwise virial rows, once per step (pallas_panel.py:1140)
  * pair_panel      — the pair forces without E0; coul=False leaves LJ only
                                                          (pallas_panel.py:1458)
  * wolf_panel      — the Wolf static field E0 alone      (pallas_panel.py:993)
  * eind_panel_df, pair_panel_df, dipole_panel_df — the f64-grade twins
                      (pallas_panel.py:359, 640, 892): double-f32 emulation
                      on the TPU, native float64 here

Each wrapper keeps the JAX function's signature and returns, including the
`cols=`/`row0=` strip form (rows are one strip of the atom axis, columns
the full axis, row0 the strip's global offset; the `*_df` wrappers take it
too).  On a CPU tensor it runs the plain version; on a CUDA tensor it
launches the hand-written kernel in csrc/<name>.cu or raises — there is no
fallback.  The f32 wrappers take float32 operands only and the `*_df` ones
float64 only; the other dtype raises TypeError, nothing is cast.  Each
counts its launches in `<wrapper>.launches`, and those of them that
launched the strip kernel in `<wrapper>.launches_strip`.

The plain versions (`*_plain`) repeat the kernels' arithmetic (rsqrt then
r = rsq*rinv, the A&S erfc, the TPU kernels' masking) in any dtype, over
column chunks of `chunk` columns to bound memory; with `chunk=col_chunk`
they are the port's column-chunk scan path (parallel/shard.py).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from lidp_tpu_torch.ops.pair import EWALD_F, erfc_as

DAMP_NONE = 0
DAMP_EXP = 1
CHUNK = 2048          # default column chunk of the plain versions
MAX_T1 = 16           # type-table edge the pair kernel holds in shared memory
MAX_S = 16            # special-list width the pair kernel holds in registers
ROWS_PER_CTA = 32     # csrc/panel_common.cuh ROWS
EIND_TILE = 128       # csrc/eind_panel.cuh BT: atoms per tile of the whole panel
# The exact damping skip of the eind kernels, u = pd*r: at and beyond it
# 1 - t1*t2 and 1 - t1*(t2 + pd^3/6 rsq r) round to exactly 1 in the dtype,
# separately rounded or contracted to an FMA, so a warp whose pairs all lie
# beyond it sets l1 = l2 = 1 without the exponential.  The last u where
# either differs from 1 is 25.36 in float32 and 47.27 in float64; the
# margin covers an exp a few ulps off (tests/test_torch_eind_symmetric.py).
EIND_SKIP_U = {torch.float32: 27.0, torch.float64: 49.0}
# The whole dipole panel's exact skips (csrc/dipole_panel.cuh): a warp whose
# pairs of one vote all lie outside the charge-dipole block (cutoff,
# molecule, masks) skips it, and likewise the dipole-dipole block; the
# results are bit for bit those without the skips.  False turns them off,
# for measurement.
DIPOLE_SKIP = True
# The exact skips of the whole panels on the pair template
# (csrc/pair_panel.cuh: the pair kernels and wolf_panel): the warp vote on
# the outer cutoff, and the tile-pair test on the tiles' coordinate boxes;
# the results are bit for bit those without them.  False turns one off,
# for measurement.
PAIR_SKIP = True
PAIR_CULL = True


# ------------------------------ plain path ------------------------------

def _mi(d, L, Linv):
    """Minimum image d - L*round(d/L) with a precomputed 1/L."""
    return d - L * torch.round(d * Linv)


def _geom(xr, xc, L):
    """(nrows, c) minimum-image dx, dy, dz, rsq of rows against columns."""
    Linv = 1.0 / L
    dx = _mi(xr[:, 0:1] - xc[None, :, 0], L[0], Linv[0])
    dy = _mi(xr[:, 1:2] - xc[None, :, 1], L[1], Linv[1])
    dz = _mi(xr[:, 2:3] - xc[None, :, 2], L[2], Linv[2])
    return dx, dy, dz, dx * dx + dy * dy + dz * dz


def _col_chunks(npad, chunk):
    step = chunk or CHUNK
    for c0 in range(0, npad, step):
        yield c0, min(c0 + step, npad)


def _not_self(nrows, row0, c0, c1, device):
    gi = row0 + torch.arange(nrows, device=device)
    return gi[:, None] != torch.arange(c0, c1, device=device)[None, :]


def _damping(r, rsq, pd, damping_type):
    """Thole damping l1, l2 in the kernels' form (pallas_panel.py:130)."""
    if damping_type == DAMP_EXP:
        t1 = torch.exp(-pd * r)
        t2 = 1.0 + pd * r + 0.5 * pd * pd * rsq
        return 1.0 - t1 * t2, 1.0 - t1 * (t2 + (pd**3 / 6.0) * rsq * r)
    one = torch.ones_like(r)
    return one, one


def eind_panel_plain(x, alpha_eff, mu, L, pd, *, damping_type=DAMP_EXP,
                     cols=None, row0=0, chunk=None):
    """E_ind = -T.mu; (nrows, 3).  alpha_eff folds the atom mask; the rows'
    mu is never read."""
    xc, ac, muc = (x, alpha_eff, mu) if cols is None else cols
    out = x.new_zeros((x.shape[0], 3))
    for c0, c1 in _col_chunks(xc.shape[0], chunk):
        dx, dy, dz, rsq = _geom(x, xc[c0:c1], L)
        pm = (_not_self(x.shape[0], row0, c0, c1, x.device)
              & (ac[None, c0:c1] != 0.0) & (alpha_eff[:, None] != 0.0))
        rsq = torch.where(pm, rsq, 1.0)
        rinv = torch.rsqrt(rsq)
        r = rsq * rinv
        r2inv = rinv * rinv
        r3inv = r2inv * rinv
        r5inv = r3inv * r2inv
        l1, l2 = _damping(r, rsq, pd, damping_type)
        m = muc[c0:c1]
        mjx, mjy, mjz = m[None, :, 0], m[None, :, 1], m[None, :, 2]
        mdotd = mjx * dx + mjy * dy + mjz * dz
        a1 = torch.where(pm, -3.0 * (l2 * r5inv) * mdotd, 0.0)
        a2 = torch.where(pm, l1 * r3inv, 0.0)
        out[:, 0] -= torch.sum(a1 * dx + a2 * mjx, dim=1)
        out[:, 1] -= torch.sum(a1 * dy + a2 * mjy, dim=1)
        out[:, 2] -= torch.sum(a1 * dz + a2 * mjz, dim=1)
    return out


def _pair_plain(x, q, typef, mol, maskf, tabs, L, cut_coulsq, qqrd2e,
                g_ewald, sp, cols, row0, chunk, coul, wolf):
    """The pair panel's arithmetic: (f, evdwl, ecoul, vir6, e0 or None).
    cols = (x, q, typef, mol or None, maskf) of the full axis."""
    xc, qc, tc, molc, mc = ((x, q, typef, mol, maskf) if cols is None
                            else cols)
    nrows = x.shape[0]
    ti = typef.long()[:, None]
    tcl = tc.long()
    f_shift = -1.0 / cut_coulsq
    f = x.new_zeros((nrows, 3))
    e0 = x.new_zeros((nrows, 3)) if wolf else None
    acc = x.new_zeros((8,))
    for c0, c1 in _col_chunks(xc.shape[0], chunk):
        dx, dy, dz, rsq = _geom(x, xc[c0:c1], L)
        pm = (_not_self(nrows, row0, c0, c1, x.device)
              & (mc[None, c0:c1] != 0.0))
        tj = tcl[None, c0:c1]
        lj3, lj4 = tabs[0][ti, tj], tabs[1][ti, tj]
        off, cut_ljsq = tabs[2][ti, tj], tabs[3][ti, tj]
        rsq = torch.where(pm, rsq, 1.0)
        in_range = (rsq < tabs[4][ti, tj]) & pm
        lj_mask = in_range & (rsq < cut_ljsq)
        if sp is not None:
            gj = torch.arange(c0, c1, device=x.device)
            for s in range(sp.shape[1]):
                lj_mask &= sp[:, s:s + 1] != gj[None, :]
        r2inv = 1.0 / rsq
        r6inv = r2inv * r2inv * r2inv
        forcelj = torch.where(lj_mask,
                              r6inv * (12.0 * lj3 * r6inv - 6.0 * lj4), 0.0)
        evdwl = torch.where(lj_mask, r6inv * (lj3 * r6inv - lj4) - off, 0.0)
        qj = qc[None, c0:c1]
        if coul or wolf:
            rinv = torch.rsqrt(rsq)
        if coul:
            coul_mask = in_range & (rsq < cut_coulsq)
            r = rsq * rinv
            grij = g_ewald * r
            expm2 = torch.exp(-grij * grij)
            erfc = erfc_as(grij, expm2)
            prefactor = qqrd2e * q[:, None] * qj * rinv
            forcecoul = torch.where(
                coul_mask, prefactor * (erfc + EWALD_F * grij * expm2), 0.0)
            ecoul = torch.where(coul_mask, prefactor * erfc, 0.0)
        else:
            forcecoul = torch.zeros_like(forcelj)
            ecoul = torch.zeros_like(evdwl)
        fpair = (forcecoul + forcelj) * r2inv
        px, py, pz = fpair * dx, fpair * dy, fpair * dz
        f += torch.stack([px.sum(1), py.sum(1), pz.sum(1)], dim=1)
        acc += torch.stack([
            evdwl.sum(), ecoul.sum(), (px * dx).sum(), (py * dy).sum(),
            (pz * dz).sum(), (px * dy).sum(), (px * dz).sum(),
            (py * dz).sum()])
        if wolf:
            # Wolf static field, intermolecular only, <= cutoff
            mi_, mj = mol[:, None], molc[None, c0:c1]
            winc = pm & (rsq <= cut_coulsq) & ((mi_ != mj) | (mi_ == 0.0))
            efq = torch.where(winc, (r2inv + f_shift) * rinv, 0.0) * qj
            e0 += torch.stack([(efq * dx).sum(1), (efq * dy).sum(1),
                               (efq * dz).sum(1)], dim=1)
    acc = 0.5 * acc
    return f, acc[0], acc[1], acc[2:8], e0


def pair_wolf_panel_plain(x, q, typef, mol, maskf, tabs, L, cut_coulsq,
                          qqrd2e, g_ewald, sp=None, cols=None, row0=0, *,
                          chunk=None):
    """Dense LJ + coul/long pair panel fused with the Wolf static field.

    Returns (f (nrows,3), evdwl, ecoul, vir6, e0 (nrows,3) UNSCALED — the
    caller multiplies by sqrt(qqrd2e)).  tabs (5,T1,T1) = [lj3 lj4 offset
    cut_ljsq cutsq]; the outer cutoff is cutsq of the pair's two types, as
    in the JAX package's scan path (the kernels take only a table whose
    live type pairs share one cutsq, and apply max(tabs[4])).  sp
    (nrows, S): special-neighbour global indices excluded from the LJ term
    in-pass.  cols = (x, q, typef, mol, maskf)."""
    return _pair_plain(x, q, typef, mol, maskf, tabs, L, cut_coulsq, qqrd2e,
                       g_ewald, sp, cols, row0, chunk, True, True)


def pair_panel_plain(x, q, typef, maskf, tabs, L, cut_coulsq, qqrd2e,
                     g_ewald, sp=None, cols=None, row0=0, *, coul=True,
                     chunk=None):
    """Dense LJ (+ coul/long) pair panel: (f (nrows,3), evdwl, ecoul, vir6)
    with half-weight tallies; coul=False leaves LJ only.
    cols = (x, q, typef, maskf)."""
    if cols is not None:
        xc, qc, tc, mc = cols
        cols = (xc, qc, tc, None, mc)
    return _pair_plain(x, q, typef, None, maskf, tabs, L, cut_coulsq, qqrd2e,
                       g_ewald, sp, cols, row0, chunk, coul, False)[:4]


def pair_panel_df_plain(x, q, typef, maskf, tabs64, L, cut_coulsq, qqrd2e,
                        g_ewald, sp=None, mol=None, cols=None, row0=0, *,
                        chunk=None):
    """The plain pair panel under pair_panel_df's signature: with mol the
    return gains the unscaled Wolf field e0 as a 5th element and cols is
    (x, q, typef, maskf, mol)."""
    if mol is None:
        return pair_panel_plain(x, q, typef, maskf, tabs64, L, cut_coulsq,
                                qqrd2e, g_ewald, sp=sp, cols=cols, row0=row0,
                                chunk=chunk)
    if cols is not None:
        xc, qc, tc, mc, molc = cols
        cols = (xc, qc, tc, molc, mc)
    return _pair_plain(x, q, typef, mol, maskf, tabs64, L, cut_coulsq,
                       qqrd2e, g_ewald, sp, cols, row0, chunk, True, True)


def wolf_panel_plain(x, q, mol, maskf, L, cut_coulsq, cols=None, row0=0, *,
                     chunk=None):
    """Damped-shifted (Wolf) static field E0, (nrows, 3), UNSCALED: pairs
    with rsq <= cut_coulsq between different molecules (or mol_i == 0).
    cols = (x, q, mol, maskf)."""
    xc, qc, molc, mc = (x, q, mol, maskf) if cols is None else cols
    nrows = x.shape[0]
    f_shift = -1.0 / cut_coulsq
    e0 = x.new_zeros((nrows, 3))
    mi_ = mol[:, None]
    for c0, c1 in _col_chunks(xc.shape[0], chunk):
        dx, dy, dz, rsq = _geom(x, xc[c0:c1], L)
        inc = (_not_self(nrows, row0, c0, c1, x.device)
               & (mc[None, c0:c1] != 0.0) & (rsq <= cut_coulsq)
               & ((mi_ != molc[None, c0:c1]) | (mi_ == 0.0)))
        rsq = torch.where(inc, rsq, 1.0)
        rinv = torch.rsqrt(rsq)
        efq = torch.where(inc, (rinv * rinv + f_shift) * rinv, 0.0) \
            * qc[None, c0:c1]
        e0 += torch.stack([(efq * dx).sum(1), (efq * dy).sum(1),
                           (efq * dz).sum(1)], dim=1)
    return e0


def dipole_panel_plain(x, q, mol, alpha_eff, mu, maskf, L, pd, cut_coulsq,
                       qqrd2e, *, damping_type=DAMP_EXP, cols=None, row0=0,
                       chunk=None):
    """Charge-dipole + dipole-dipole forces.  Returns (fpol (nrows,3),
    u_ef, u_dd, vir6_pairwise)."""
    xc, qc, molc, ac, muc, mc = ((x, q, mol, alpha_eff, mu, maskf)
                                 if cols is None else cols)
    nrows = x.shape[0]
    sqrt_q = math.sqrt(qqrd2e)
    f_shift = -1.0 / cut_coulsq
    mlx, mly, mlz = mu[:, 0:1], mu[:, 1:2], mu[:, 2:3]
    qi, mi_, ai = q[:, None], mol[:, None], alpha_eff[:, None]
    fpol = x.new_zeros((nrows, 3))
    acc = x.new_zeros((8,))
    for c0, c1 in _col_chunks(xc.shape[0], chunk):
        dx, dy, dz, rsq = _geom(x, xc[c0:c1], L)
        pm = (_not_self(nrows, row0, c0, c1, x.device)
              & (mc[None, c0:c1] != 0.0))
        rsq = torch.where(pm, rsq, 1.0)
        rinv = torch.rsqrt(rsq)
        r = rsq * rinv
        r2inv = rinv * rinv
        r3inv = r2inv * rinv
        xsq, ysq, zsq = dx * dx, dy * dy, dz * dz
        qj, mj = qc[None, c0:c1], molc[None, c0:c1]
        cd = pm & (rsq < cut_coulsq) & ((mi_ != mj) | (mi_ == 0.0))
        mxx = (-2.0 * xsq + ysq + zsq) * r2inv + f_shift * (ysq + zsq)
        myy = (-2.0 * ysq + xsq + zsq) * r2inv + f_shift * (xsq + zsq)
        mzz = (-2.0 * zsq + xsq + ysq) * r2inv + f_shift * (xsq + ysq)
        mxy = -3.0 * dx * dy * r2inv - f_shift * dx * dy
        mxz = -3.0 * dx * dz * r2inv - f_shift * dx * dz
        myz = -3.0 * dy * dz * r2inv - f_shift * dy * dz
        m = muc[c0:c1]
        mcx, mcy, mcz = m[None, :, 0], m[None, :, 1], m[None, :, 2]
        cf_j = torch.where(cd, qj * sqrt_q * r3inv, 0.0)
        cf_i = torch.where(cd, qi * sqrt_q * r3inv, 0.0)
        fcdx = cf_j * (mxx * mlx + mxy * mly + mxz * mlz) \
            - cf_i * (mxx * mcx + mxy * mcy + mxz * mcz)
        fcdy = cf_j * (mxy * mlx + myy * mly + myz * mlz) \
            - cf_i * (mxy * mcx + myy * mcy + myz * mcz)
        fcdz = cf_j * (mxz * mlx + myz * mly + mzz * mlz) \
            - cf_i * (mxz * mcx + myz * mcy + mzz * mcz)
        ef_t = torch.where(cd, (r2inv + f_shift) * rinv * sqrt_q, 0.0) * qj
        u_ef = -torch.sum(mlx * ef_t * dx + mly * ef_t * dy
                          + mlz * ef_t * dz)

        dd = pm & (ai != 0.0) & (ac[None, c0:c1] != 0.0)
        r5inv = r3inv * r2inv
        r7inv = r5inv * r2inv
        pdotp = mlx * mcx + mly * mcy + mlz * mcz
        pidotr = mlx * dx + mly * dy + mlz * dz
        pjdotr = mcx * dx + mcy * dy + mcz * dz
        if damping_type == DAMP_EXP:
            t1 = torch.exp(-pd * r)
            t2 = 1.0 + pd * r + 0.5 * pd * pd * rsq
            t3 = t2 + (pd**3 / 6.0) * rsq * r
            pre1 = 3.0 * r5inv * pdotp * (1.0 - t1 * t2) \
                - 15.0 * r7inv * pidotr * pjdotr * (1.0 - t1 * t3)
            pre2 = 3.0 * r5inv * pjdotr * (1.0 - t1 * t3)
            pre3 = 3.0 * r5inv * pidotr * (1.0 - t1 * t3)
            pre4 = -pdotp * r3inv * (-t1 * (pd * rinv + pd * pd)
                                     + t1 * pd * t2 * rinv)
            pre5 = 3.0 * pidotr * pjdotr * r5inv * (
                -t1 * (pd * rinv + pd * pd + 0.5 * r * pd**3)
                + t1 * pd * t3 * rinv)
            u_dd_pair = r3inv * pdotp * (1.0 - t1 * t2) \
                - 3.0 * r5inv * pidotr * pjdotr * (1.0 - t1 * t3)
            pre1 = pre1 + pre4 + pre5
        else:
            pre1 = 3.0 * r5inv * pdotp - 15.0 * r7inv * pidotr * pjdotr
            pre2 = 3.0 * r5inv * pjdotr
            pre3 = 3.0 * r5inv * pidotr
            u_dd_pair = r3inv * pdotp - 3.0 * r5inv * pidotr * pjdotr
        pre1 = torch.where(dd, pre1, 0.0)
        pre2 = torch.where(dd, pre2, 0.0)
        pre3 = torch.where(dd, pre3, 0.0)
        fpx = fcdx + pre1 * dx + pre2 * mlx + pre3 * mcx
        fpy = fcdy + pre1 * dy + pre2 * mly + pre3 * mcy
        fpz = fcdz + pre1 * dz + pre2 * mlz + pre3 * mcz
        u_dd = 0.5 * torch.sum(torch.where(dd, u_dd_pair, 0.0))
        fpol += torch.stack([fpx.sum(1), fpy.sum(1), fpz.sum(1)], dim=1)
        acc += torch.stack([
            u_ef, u_dd,
            0.5 * (dx * fpx).sum(), 0.5 * (dy * fpy).sum(),
            0.5 * (dz * fpz).sum(), 0.5 * (dx * fpy).sum(),
            0.5 * (dx * fpz).sum(), 0.5 * (dy * fpz).sum()])
    return fpol, acc[0], acc[1], acc[2:8]


# the f64-grade names: the plain versions are dtype-generic
eind_panel_df_plain = eind_panel_plain
dipole_panel_df_plain = dipole_panel_plain


# ------------------------------ CUDA path -------------------------------

_CTYPES = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float,
           "D": ctypes.c_double}


@functools.lru_cache(maxsize=None)
def _cfn(name: str, sig: str, entry: str):
    """The C entry lidp_<entry> of lib<name>.so, with argtypes from `sig`
    (P pointer, I int, F float, D double)."""
    from lidp_tpu_torch.kernels import build

    fn = getattr(build.library(name), f"lidp_{entry}")
    fn.argtypes = [_CTYPES[c] for c in sig]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, sig, device, *args, entry=None):
    """Launch lidp_<entry or name> of lib<name>.so on `device` (its current
    stream is the last argument)."""
    with torch.cuda.device(device):
        err = _cfn(name, sig, entry or name)(*args)
    if err:
        raise RuntimeError(f"{entry or name}: kernel launch failed with CUDA "
                           f"error {err}")


def _check(name, dtype, *ts):
    """The kernels take contiguous tensors of their own dtype (float32 for
    the f32 kernels, float64 for the *_df ones) on one CUDA device."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _check_shapes(name, *pairs):
    """Each (tensor, shape) pair must match; the panel must not be empty."""
    for t, shape in pairs:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if 0 in shape:
            raise ValueError(f"{name}: empty panel")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _scalar_code(dtype):
    """ctypes code of a kernel's scalar arguments."""
    return "F" if dtype == torch.float32 else "D"


def _eind_cuda(wrapper, dtype, x, alpha_eff, mu, L, pd, damping_type, cols,
               row0, stats=None):
    """The whole-panel kernel and its sum for cols=None, else the strip
    kernel.  stats, an int64 (2,) device tensor, gains (warp votes, votes
    that skipped the exponential)."""
    name = wrapper.__name__
    xc, ac, muc = (x, alpha_eff, mu) if cols is None else cols
    nrows, npad = x.shape[0], xc.shape[0]
    _check(name, dtype, x, alpha_eff, xc, ac, muc, L)
    _check_shapes(name, (x, (nrows, 3)), (alpha_eff, (nrows,)),
                  (xc, (npad, 3)), (ac, (npad,)), (muc, (npad, 3)),
                  (L, (3,)))
    c = _scalar_code(dtype)
    out = torch.empty((nrows, 3), dtype=dtype, device=x.device)
    head = (float(pd), int(damping_type), EIND_SKIP_U[dtype])
    tail = (out.data_ptr(), None if stats is None else stats.data_ptr(),
            _stream(x))
    if cols is None:
        nT = -(-npad // EIND_TILE)
        part = torch.empty((nT, nT + 1, 3, EIND_TILE), dtype=dtype,
                           device=x.device)
        _launch(name, f"PPPIP{c}I{c}IPPPP", x.device, x.data_ptr(),
                alpha_eff.data_ptr(), mu.data_ptr(), npad, L.data_ptr(),
                *head, nT, part.data_ptr(), *tail, entry=name + "_whole")
    else:
        _launch(name, f"PPIIPPPIP{c}I{c}PPP", x.device, x.data_ptr(),
                alpha_eff.data_ptr(), nrows, int(row0), xc.data_ptr(),
                ac.data_ptr(), muc.data_ptr(), npad, L.data_ptr(), *head,
                *tail)
        wrapper.launches_strip += 1
    wrapper.launches += 1
    return out


def eind_skip_share(x, alpha_eff, mu, L, pd, *, damping_type=DAMP_EXP,
                    cols=None, row0=0):
    """One launch of eind_panel (float32) or eind_panel_df (float64) on CUDA
    tensors that also counts the warp votes on the damping skip: (votes,
    votes that skipped the exponential).  For measurement; it counts as a
    launch of the wrapper."""
    wrapper = eind_panel_df if x.dtype == torch.float64 else eind_panel
    stats = torch.zeros(2, dtype=torch.int64, device=x.device)
    _eind_cuda(wrapper, x.dtype, x, alpha_eff, mu, L, pd, damping_type, cols,
               row0, stats=stats)
    votes, skipped = stats.tolist()
    return votes, skipped


def eind_panel(x, alpha_eff, mu, L, pd, *, damping_type=DAMP_EXP,
               cols=None, row0=0):
    """E_ind = -T.mu; (nrows, 3) out.  On CUDA (csrc/eind_panel.cu) the
    whole panel (cols=None) takes the kernel that computes each pair once
    for both atoms, a row strip the one-sided strip kernel."""
    if x.device.type == "cpu":
        return eind_panel_plain(x, alpha_eff, mu, L, pd,
                                damping_type=damping_type, cols=cols,
                                row0=row0)
    return _eind_cuda(eind_panel, torch.float32, x, alpha_eff, mu, L, pd,
                      damping_type, cols, row0)


eind_panel.launches = 0
eind_panel.launches_strip = 0     # of them, launches of the strip kernel


def eind_panel_df(x, alpha_eff, mu, L, pd, *, damping_type=DAMP_EXP,
                  cols=None, row0=0):
    """E_ind = -T.mu at f64 grade: float64 operands (csrc/eind_panel_df.cu
    on CUDA, routed as eind_panel)."""
    if x.device.type == "cpu":
        return eind_panel_df_plain(x, alpha_eff, mu, L, pd,
                                   damping_type=damping_type, cols=cols,
                                   row0=row0)
    return _eind_cuda(eind_panel_df, torch.float64, x, alpha_eff, mu, L, pd,
                      damping_type, cols, row0)


eind_panel_df.launches = 0
eind_panel_df.launches_strip = 0


def _symmetric_tables(name, tabs):
    """The whole-panel pair kernel evaluates each pair once for both atoms
    from tabs[k][t_i, t_j]: it takes only tables equal to their transpose
    (as every mixing rule makes them; the row form and the plain version
    index each row's own).  Checked once for each table tensor and
    version: one read of the device."""
    for t, v in _SYMMETRIC:
        if t is tabs and v == tabs._version:
            return
    if not torch.equal(tabs[:4], tabs[:4].transpose(1, 2)):
        raise ValueError(f"{name}: the whole-panel kernel takes symmetric "
                         f"type tables (tabs[k] equal to its transpose)")
    _SYMMETRIC.append((tabs, tabs._version))
    del _SYMMETRIC[:-8]


_SYMMETRIC = []     # (tabs, version) of the tables found symmetric


def _pair_cuda(wrapper, dtype, x, q, typef, mol, maskf, tabs, L, cut_coulsq,
               qqrd2e, g_ewald, sp, cols, row0, coul, wolf, stats=None):
    """Checks, buffers and launch of the pair kernels; cols = (x, q, typef,
    mol or None, maskf).  For cols=None the whole-panel kernel with its
    tile boxes, tile-pair test (a flag for each tile pair) and list of the
    kept ones, slot sum and scalar sum, else the strip kernel and its
    scalar sum.  Returns (f, evdwl, ecoul, vir6, e0 or None).  stats, an
    int64 (3,) device tensor, gains (warp votes, votes that skipped, tile
    pairs dropped) of the whole kernel."""
    name = wrapper.__name__
    xc, qc, tc, molc, mc = ((x, q, typef, mol, maskf) if cols is None
                            else cols)
    nrows, npad = x.shape[0], xc.shape[0]
    mols = (mol, molc) if wolf else ()
    _check(name, dtype, x, q, typef, xc, qc, tc, mc, tabs, L, *mols)
    _check_shapes(name, (x, (nrows, 3)), (q, (nrows,)), (typef, (nrows,)),
                  (xc, (npad, 3)), (qc, (npad,)), (tc, (npad,)),
                  (mc, (npad,)), (L, (3,)),
                  *((m, (k,)) for m, k in zip(mols, (nrows, npad))))
    if tabs.dim() != 3 or tabs.shape[0] != 5 \
            or tabs.shape[1] != tabs.shape[2] or tabs.shape[1] > MAX_T1:
        raise ValueError(f"{name}: tabs must be (5, T1, T1) with "
                         f"T1 <= {MAX_T1}, got {tuple(tabs.shape)}")
    t1 = tabs.shape[1]
    S = 0
    sp_ptr = None
    if sp is not None:
        sp = sp.to(device=x.device, dtype=torch.int32).contiguous()
        S = sp.shape[1]
        if sp.shape[0] != nrows or S > MAX_S:
            raise ValueError(f"{name}: sp must be (nrows, S<={MAX_S}), got "
                             f"{tuple(sp.shape)}")
        sp_ptr = sp.data_ptr() if S else None
    f = torch.empty((nrows, 3), dtype=dtype, device=x.device)
    e0 = torch.empty_like(f) if wolf else None
    acc = torch.empty((8,), dtype=dtype, device=x.device)
    c = _scalar_code(dtype)
    scalars = (float(cut_coulsq), float(qqrd2e), float(g_ewald))
    molp = mol.data_ptr() if wolf else None
    e0p = e0.data_ptr() if wolf else None
    if cols is None:
        _symmetric_tables(name, tabs)
        bt = whole_tile(name)
        nT = -(-npad // bt)
        boxes = torch.empty((nT, 8), dtype=dtype, device=x.device)
        part = torch.empty((nT, nT + 1, 6 if wolf else 3, bt), dtype=dtype,
                           device=x.device)
        partials = torch.empty((nT * (nT + 1) // 2, 8), dtype=dtype,
                               device=x.device)
        kept = torch.empty((nT * (nT + 1) // 2,), dtype=torch.uint8,
                           device=x.device)
        tlist = torch.empty((nT * (nT + 1) // 2 + 2,), dtype=torch.int32,
                            device=x.device)
        _launch(name, f"PPPPPPIIPIP{c}{c}{c}IIIIPPPPPPPPPP", x.device,
                x.data_ptr(), q.data_ptr(), typef.data_ptr(), molp,
                maskf.data_ptr(), sp_ptr, S, npad, tabs.data_ptr(), t1,
                L.data_ptr(), *scalars, int(bool(coul)), int(PAIR_SKIP),
                int(PAIR_CULL), nT, boxes.data_ptr(), part.data_ptr(),
                partials.data_ptr(), kept.data_ptr(), tlist.data_ptr(),
                f.data_ptr(), e0p, acc.data_ptr(),
                None if stats is None else stats.data_ptr(), _stream(x),
                entry=name + "_whole")
    else:
        partials = torch.empty((-(-nrows // ROWS_PER_CTA), 8), dtype=dtype,
                               device=x.device)
        head = (x.data_ptr(), q.data_ptr(), typef.data_ptr())
        cols_p = (xc.data_ptr(), qc.data_ptr(), tc.data_ptr())
        if name == "pair_panel":
            _launch(name, f"PPPPIIIPPPPIPIP{c}{c}{c}IPPPP", x.device, *head,
                    sp_ptr, S, nrows, int(row0), *cols_p, mc.data_ptr(),
                    npad, tabs.data_ptr(), t1, L.data_ptr(), *scalars,
                    int(bool(coul)), f.data_ptr(), partials.data_ptr(),
                    acc.data_ptr(), _stream(x))
        else:
            _launch(name, f"PPPPPIIIPPPPPIPIP{c}{c}{c}PPPPP", x.device,
                    *head, molp, sp_ptr, S, nrows, int(row0), *cols_p,
                    molc.data_ptr() if wolf else None, mc.data_ptr(), npad,
                    tabs.data_ptr(), t1, L.data_ptr(), *scalars,
                    f.data_ptr(), e0p, partials.data_ptr(), acc.data_ptr(),
                    _stream(x))
        wrapper.launches_strip += 1
    wrapper.launches += 1
    return f, acc[0], acc[1], acc[2:8], e0


def pair_skip_share(x, q, typef, mol, maskf, tabs, L, cut_coulsq, qqrd2e,
                    g_ewald, sp=None, *, coul=True):
    """One launch of the whole pair kernel on CUDA tensors that also counts
    its skips: (warp votes, votes that skipped, tile pairs dropped, tile
    pairs).  float32 with mol: pair_wolf_panel; float32 without:
    pair_panel (coul as given); float64: pair_panel_df (the field with
    mol).  For measurement; it counts as a launch of the wrapper."""
    wolf = mol is not None
    if x.dtype == torch.float64:
        wrapper = pair_panel_df
    else:
        wrapper = pair_wolf_panel if wolf else pair_panel
    stats = torch.zeros(3, dtype=torch.int64, device=x.device)
    _pair_cuda(wrapper, x.dtype, x, q, typef, mol, maskf, tabs, L,
               cut_coulsq, qqrd2e, g_ewald, sp, None, 0,
               coul or wrapper is not pair_panel, wolf, stats=stats)
    votes, skipped, dropped = stats.tolist()
    nT = -(-x.shape[0] // whole_tile(wrapper.__name__))
    return votes, skipped, dropped, nT * (nT + 1) // 2


def pair_wolf_panel(x, q, typef, mol, maskf, tabs, L, cut_coulsq, qqrd2e,
                    g_ewald, sp=None, cols=None, row0=0):
    """Fused LJ + coul/long pair panel and Wolf static field (see
    pair_wolf_panel_plain).  On CUDA (csrc/pair_wolf_panel.cu) the whole
    panel (cols=None) takes the kernel that computes each pair once for
    both atoms, and symmetric type tables; a row strip the one-sided strip
    kernel.  Atom types must lie in [0, T1)."""
    if x.device.type == "cpu":
        return pair_wolf_panel_plain(x, q, typef, mol, maskf, tabs, L,
                                     cut_coulsq, qqrd2e, g_ewald, sp=sp,
                                     cols=cols, row0=row0)
    return _pair_cuda(pair_wolf_panel, torch.float32, x, q, typef, mol,
                      maskf, tabs, L, cut_coulsq, qqrd2e, g_ewald, sp, cols,
                      row0, True, True)


pair_wolf_panel.launches = 0
pair_wolf_panel.launches_strip = 0


def pair_panel(x, q, typef, maskf, tabs, L, cut_coulsq, qqrd2e, g_ewald,
               sp=None, cols=None, row0=0, *, coul=True):
    """LJ (+ coul/long) pair panel without the Wolf field (see
    pair_panel_plain; csrc/pair_panel.cu on CUDA, routed as
    pair_wolf_panel)."""
    if x.device.type == "cpu":
        return pair_panel_plain(x, q, typef, maskf, tabs, L, cut_coulsq,
                                qqrd2e, g_ewald, sp=sp, cols=cols, row0=row0,
                                coul=coul)
    if cols is not None:
        xc, qc, tc, mc = cols
        cols = (xc, qc, tc, None, mc)
    return _pair_cuda(pair_panel, torch.float32, x, q, typef, None, maskf,
                      tabs, L, cut_coulsq, qqrd2e, g_ewald, sp, cols, row0,
                      coul, False)[:4]


pair_panel.launches = 0
pair_panel.launches_strip = 0


def pair_panel_df(x, q, typef, maskf, tabs64, L, cut_coulsq, qqrd2e, g_ewald,
                  sp=None, mol=None, cols=None, row0=0):
    """LJ + coul/long pair panel at f64 grade: float64 operands
    (csrc/pair_panel_df.cu on CUDA, routed as pair_wolf_panel).  Returns
    (f, evdwl, ecoul, vir6); with mol (nrows,) the fused Wolf static field
    e0 (nrows, 3), UNSCALED, is a 5th element.  cols = (x, q, typef,
    maskf[, mol])."""
    if x.device.type == "cpu":
        return pair_panel_df_plain(x, q, typef, maskf, tabs64, L, cut_coulsq,
                                   qqrd2e, g_ewald, sp=sp, mol=mol,
                                   cols=cols, row0=row0)
    wolf = mol is not None
    if cols is not None:
        xc, qc, tc, mc = cols[:4]
        cols = (xc, qc, tc, cols[4] if wolf else None, mc)
    out = _pair_cuda(pair_panel_df, torch.float64, x, q, typef, mol, maskf,
                     tabs64, L, cut_coulsq, qqrd2e, g_ewald, sp, cols, row0,
                     True, wolf)
    return out if wolf else out[:4]


pair_panel_df.launches = 0
pair_panel_df.launches_strip = 0


def _wolf_cuda(x, q, mol, maskf, L, cut_coulsq, cols, row0, stats=None):
    """For cols=None the whole-panel kernel (the pair template's, the field
    alone) with its tile boxes, tile-pair test, list of the kept tile pairs
    and slot sum, else the strip kernel.  stats, an int64 (3,) device
    tensor, gains (warp votes, votes that skipped, tile pairs dropped) of
    the whole kernel."""
    xc, qc, molc, mc = (x, q, mol, maskf) if cols is None else cols
    nrows, npad = x.shape[0], xc.shape[0]
    _check("wolf_panel", torch.float32, x, mol, xc, qc, molc, mc, L)
    _check_shapes("wolf_panel", (x, (nrows, 3)), (mol, (nrows,)),
                  (xc, (npad, 3)), (qc, (npad,)), (molc, (npad,)),
                  (mc, (npad,)), (L, (3,)))
    out = torch.empty((nrows, 3), dtype=torch.float32, device=x.device)
    if cols is None:
        bt = whole_tile("wolf_panel")
        nT = -(-npad // bt)
        npairs = nT * (nT + 1) // 2
        boxes = torch.empty((nT, 8), dtype=torch.float32, device=x.device)
        part = torch.empty((nT, nT + 1, 3, bt), dtype=torch.float32,
                           device=x.device)
        kept = torch.empty((npairs,), dtype=torch.uint8, device=x.device)
        tlist = torch.empty((npairs + 2,), dtype=torch.int32,
                            device=x.device)
        _launch("wolf_panel", "PPPPIPFIIIPPPPPPP", x.device, x.data_ptr(),
                q.data_ptr(), mol.data_ptr(), maskf.data_ptr(), npad,
                L.data_ptr(), float(cut_coulsq), int(PAIR_SKIP),
                int(PAIR_CULL), nT, boxes.data_ptr(), part.data_ptr(),
                kept.data_ptr(), tlist.data_ptr(), out.data_ptr(),
                None if stats is None else stats.data_ptr(), _stream(x),
                entry="wolf_panel_whole")
    else:
        _launch("wolf_panel", "PPIIPPPPIPFPP", x.device, x.data_ptr(),
                mol.data_ptr(), nrows, int(row0), xc.data_ptr(),
                qc.data_ptr(), molc.data_ptr(), mc.data_ptr(), npad,
                L.data_ptr(), float(cut_coulsq), out.data_ptr(), _stream(x))
        wolf_panel.launches_strip += 1
    wolf_panel.launches += 1
    return out


def wolf_skip_share(x, q, mol, maskf, L, cut_coulsq):
    """One launch of the whole wolf_panel kernel on CUDA tensors that also
    counts its skips: (warp votes, votes that skipped, tile pairs dropped,
    tile pairs).  For measurement; it counts as a launch of the
    wrapper."""
    stats = torch.zeros(3, dtype=torch.int64, device=x.device)
    _wolf_cuda(x, q, mol, maskf, L, cut_coulsq, None, 0, stats=stats)
    votes, skipped, dropped = stats.tolist()
    nT = -(-x.shape[0] // whole_tile("wolf_panel"))
    return votes, skipped, dropped, nT * (nT + 1) // 2


def wolf_panel(x, q, mol, maskf, L, cut_coulsq, cols=None, row0=0):
    """Damped-shifted (Wolf) static field E0, (nrows, 3), UNSCALED (see
    wolf_panel_plain).  On CUDA (csrc/wolf_panel.cu) the whole panel
    (cols=None) takes the pair template's kernel for the field alone, which
    computes each pair once for both atoms; a row strip the one-sided strip
    kernel.  q is read through the columns only, as in the TPU kernel (in
    the whole panel rows and columns are one array)."""
    if x.device.type == "cpu":
        return wolf_panel_plain(x, q, mol, maskf, L, cut_coulsq, cols=cols,
                                row0=row0)
    return _wolf_cuda(x, q, mol, maskf, L, cut_coulsq, cols, row0)


wolf_panel.launches = 0
wolf_panel.launches_strip = 0


@functools.lru_cache(maxsize=None)
def whole_tile(name):
    """Atoms per tile of wrapper `name`'s whole-panel dipole, pair or Wolf
    kernel, as its source sets it (csrc/dipole_panel.cuh DipoleTile,
    csrc/pair_panel.cuh WholeTile; exported as lidp_<name>_whole_tile)."""
    return _cfn(name, "", f"{name}_whole_tile")()


def _dipole_cuda(wrapper, dtype, x, q, mol, alpha_eff, mu, maskf, L, pd,
                 cut_coulsq, qqrd2e, damping_type, cols, row0, stats=None):
    """The whole-panel kernel, its slot sum and scalar sum for cols=None,
    else the strip kernel and its scalar sum.  stats, an int64 (3,) device
    tensor, gains (warp votes, votes that skipped the charge-dipole block,
    votes that skipped the dipole-dipole block) of the whole kernel."""
    name = wrapper.__name__
    xc, qc, molc, ac, muc, mc = ((x, q, mol, alpha_eff, mu, maskf)
                                 if cols is None else cols)
    nrows, npad = x.shape[0], xc.shape[0]
    _check(name, dtype, x, q, mol, alpha_eff, mu, xc, qc, molc, ac, muc, mc,
           L)
    _check_shapes(name, (x, (nrows, 3)), (q, (nrows,)), (mol, (nrows,)),
                  (alpha_eff, (nrows,)), (mu, (nrows, 3)), (xc, (npad, 3)),
                  (qc, (npad,)), (molc, (npad,)), (ac, (npad,)),
                  (muc, (npad, 3)), (mc, (npad,)), (L, (3,)))
    f = torch.empty((nrows, 3), dtype=dtype, device=x.device)
    acc = torch.empty((8,), dtype=dtype, device=x.device)
    c = _scalar_code(dtype)
    scal = (float(pd), float(cut_coulsq), math.sqrt(qqrd2e),
            int(damping_type))
    stream = _stream(x)
    if cols is None:
        bt = whole_tile(name)
        nT = -(-npad // bt)
        part = torch.empty((nT, nT + 1, 3, bt), dtype=dtype, device=x.device)
        partials = torch.empty((nT * (nT + 1) // 2, 8), dtype=dtype,
                               device=x.device)
        _launch(name, f"PPPPPPIP{c}{c}{c}IIIPPPPPP", x.device, x.data_ptr(),
                q.data_ptr(), mol.data_ptr(), alpha_eff.data_ptr(),
                mu.data_ptr(), maskf.data_ptr(), npad, L.data_ptr(), *scal,
                int(DIPOLE_SKIP), nT, part.data_ptr(), partials.data_ptr(),
                f.data_ptr(), acc.data_ptr(),
                None if stats is None else stats.data_ptr(), stream,
                entry=name + "_whole")
    else:
        partials = torch.empty((-(-nrows // ROWS_PER_CTA), 8), dtype=dtype,
                               device=x.device)
        _launch(name, f"PPPPPIIPPPPPPIP{c}{c}{c}IPPPP", x.device,
                x.data_ptr(), q.data_ptr(), mol.data_ptr(),
                alpha_eff.data_ptr(), mu.data_ptr(), nrows, int(row0),
                xc.data_ptr(), qc.data_ptr(), molc.data_ptr(), ac.data_ptr(),
                muc.data_ptr(), mc.data_ptr(), npad, L.data_ptr(), *scal,
                f.data_ptr(), partials.data_ptr(), acc.data_ptr(), stream)
        wrapper.launches_strip += 1
    wrapper.launches += 1
    return f, acc[0], acc[1], acc[2:8]


def dipole_skip_share(x, q, mol, alpha_eff, mu, maskf, L, pd, cut_coulsq,
                      qqrd2e, *, damping_type=DAMP_EXP):
    """One launch of the whole dipole_panel (float32) or dipole_panel_df
    (float64) kernel on CUDA tensors that also counts its warp votes:
    (votes, votes that skipped the charge-dipole block, votes that skipped
    the dipole-dipole block).  For measurement; it counts as a launch of
    the wrapper."""
    wrapper = dipole_panel_df if x.dtype == torch.float64 else dipole_panel
    stats = torch.zeros(3, dtype=torch.int64, device=x.device)
    _dipole_cuda(wrapper, x.dtype, x, q, mol, alpha_eff, mu, maskf, L, pd,
                 cut_coulsq, qqrd2e, damping_type, None, 0, stats=stats)
    votes, cd_skipped, dd_skipped = stats.tolist()
    return votes, cd_skipped, dd_skipped


def dipole_panel(x, q, mol, alpha_eff, mu, maskf, L, pd, cut_coulsq, qqrd2e,
                 *, damping_type=DAMP_EXP, cols=None, row0=0):
    """Charge-dipole + dipole-dipole forces; returns (fpol (nrows,3), u_ef,
    u_dd, vir6_pairwise).  On CUDA (csrc/dipole_panel.cu) the whole panel
    (cols=None) takes the kernel that computes each pair once for both
    atoms, a row strip the one-sided strip kernel."""
    if x.device.type == "cpu":
        return dipole_panel_plain(x, q, mol, alpha_eff, mu, maskf, L, pd,
                                  cut_coulsq, qqrd2e,
                                  damping_type=damping_type, cols=cols,
                                  row0=row0)
    return _dipole_cuda(dipole_panel, torch.float32, x, q, mol, alpha_eff,
                        mu, maskf, L, pd, cut_coulsq, qqrd2e, damping_type,
                        cols, row0)


dipole_panel.launches = 0
dipole_panel.launches_strip = 0   # of them, launches of the strip kernel


def dipole_panel_df(x, q, mol, alpha_eff, mu, maskf, L, pd, cut_coulsq,
                    qqrd2e, *, damping_type=DAMP_EXP, cols=None, row0=0):
    """Charge-dipole + dipole-dipole forces at f64 grade: float64 operands
    (csrc/dipole_panel_df.cu on CUDA, routed as dipole_panel); returns as
    dipole_panel."""
    if x.device.type == "cpu":
        return dipole_panel_df_plain(x, q, mol, alpha_eff, mu, maskf, L, pd,
                                     cut_coulsq, qqrd2e,
                                     damping_type=damping_type, cols=cols,
                                     row0=row0)
    return _dipole_cuda(dipole_panel_df, torch.float64, x, q, mol, alpha_eff,
                        mu, maskf, L, pd, cut_coulsq, qqrd2e, damping_type,
                        cols, row0)


dipole_panel_df.launches = 0
dipole_panel_df.launches_strip = 0

# every wrapper that launches a kernel, by name
WRAPPERS = {w.__name__: w for w in (
    eind_panel, pair_wolf_panel, dipole_panel, pair_panel, wolf_panel,
    eind_panel_df, pair_panel_df, dipole_panel_df)}
