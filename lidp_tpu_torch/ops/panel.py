"""O(N^2) panel kernels of the polarizable step: CUDA wrappers and their
plain PyTorch versions.

Counterparts of lidp_tpu/ops/pallas_panel.py's f32 kernels on the
single-device panel path:

  * eind_panel      — E_ind = -T.mu, once per CG matvec   (pallas_panel.py:194)
  * pair_wolf_panel — LJ + coul/long pair forces fused with the Wolf static
                      field E0, once per step             (pallas_panel.py:1386)
  * dipole_panel    — charge-dipole + dipole-dipole forces, u_ef, u_dd,
                      pairwise virial rows, once per step (pallas_panel.py:1140)

Each wrapper keeps the JAX function's signature and returns, including the
`cols=`/`row0=` strip form (rows are one strip of the atom axis, columns
the full axis, row0 the strip's global offset).  On a CPU tensor it runs
the plain version; on a CUDA tensor it launches the hand-written kernel in
csrc/<name>.cu (float32 only) or raises — there is no fallback.  Each
counts its launches in `<wrapper>.launches`.

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


def pair_wolf_panel_plain(x, q, typef, mol, maskf, tabs, L, cut_coulsq,
                          qqrd2e, g_ewald, sp=None, cols=None, row0=0, *,
                          chunk=None):
    """Dense LJ + coul/long pair panel fused with the Wolf static field.

    Returns (f (nrows,3), evdwl, ecoul, vir6, e0 (nrows,3) UNSCALED — the
    caller multiplies by sqrt(qqrd2e)).  tabs (5,T1,T1) = [lj3 lj4 offset
    cut_ljsq cutsq]; the outer cutoff is the single max(tabs[4]).  sp
    (nrows, S): special-neighbour global indices excluded from the LJ term
    in-pass."""
    xc, qc, tc, molc, mc = ((x, q, typef, mol, maskf) if cols is None
                            else cols)
    nrows = x.shape[0]
    ti = typef.long()[:, None]
    tcl = tc.long()
    cutsq_u = torch.max(tabs[4])
    f_shift = -1.0 / cut_coulsq
    f = x.new_zeros((nrows, 3))
    e0 = x.new_zeros((nrows, 3))
    acc = x.new_zeros((8,))
    for c0, c1 in _col_chunks(xc.shape[0], chunk):
        dx, dy, dz, rsq = _geom(x, xc[c0:c1], L)
        pm = (_not_self(nrows, row0, c0, c1, x.device)
              & (mc[None, c0:c1] != 0.0))
        tj = tcl[None, c0:c1]
        lj3, lj4 = tabs[0][ti, tj], tabs[1][ti, tj]
        off, cut_ljsq = tabs[2][ti, tj], tabs[3][ti, tj]
        rsq = torch.where(pm, rsq, 1.0)
        in_range = (rsq < cutsq_u) & pm
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
        coul_mask = in_range & (rsq < cut_coulsq)
        rinv = torch.rsqrt(rsq)
        r = rsq * rinv
        grij = g_ewald * r
        expm2 = torch.exp(-grij * grij)
        erfc = erfc_as(grij, expm2)
        qj = qc[None, c0:c1]
        prefactor = qqrd2e * q[:, None] * qj * rinv
        forcecoul = torch.where(
            coul_mask, prefactor * (erfc + EWALD_F * grij * expm2), 0.0)
        ecoul = torch.where(coul_mask, prefactor * erfc, 0.0)
        fpair = (forcecoul + forcelj) * r2inv
        px, py, pz = fpair * dx, fpair * dy, fpair * dz
        f += torch.stack([px.sum(1), py.sum(1), pz.sum(1)], dim=1)
        acc += torch.stack([
            evdwl.sum(), ecoul.sum(), (px * dx).sum(), (py * dy).sum(),
            (pz * dz).sum(), (px * dy).sum(), (px * dz).sum(),
            (py * dz).sum()])
        # Wolf static field, intermolecular only, <= cutoff
        mi_, mj = mol[:, None], molc[None, c0:c1]
        winc = pm & (rsq <= cut_coulsq) & ((mi_ != mj) | (mi_ == 0.0))
        efq = torch.where(winc, (r2inv + f_shift) * rinv, 0.0) * qj
        e0 += torch.stack([(efq * dx).sum(1), (efq * dy).sum(1),
                           (efq * dz).sum(1)], dim=1)
    acc = 0.5 * acc
    return f, acc[0], acc[1], acc[2:8], e0


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


# ------------------------------ CUDA path -------------------------------

_CTYPES = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}


@functools.lru_cache(maxsize=None)
def _cfn(name: str, sig: str):
    """The C entry lidp_<name> of lib<name>.so, with argtypes from `sig`
    (P pointer, I int, F float)."""
    from lidp_tpu_torch.kernels import build

    fn = getattr(build.library(name), f"lidp_{name}")
    fn.argtypes = [_CTYPES[c] for c in sig]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, sig, device, *args):
    """Launch on `device` (its current stream is the last argument)."""
    with torch.cuda.device(device):
        err = _cfn(name, sig)(*args)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def _check(name, *ts):
    """The kernels take contiguous float32 tensors on one CUDA device."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if t.dtype == torch.float64:
            raise NotImplementedError(
                f"{name}: float64 on CUDA needs the fp64 panel kernels "
                "(eind_panel_df, pair_panel_df, dipole_panel_df), which are "
                "ported in a later slice; use panel='scan' for the plain "
                "float64 path")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
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


def eind_panel(x, alpha_eff, mu, L, pd, *, damping_type=DAMP_EXP,
               cols=None, row0=0):
    """E_ind = -T.mu; (nrows, 3) out (csrc/eind_panel.cu on CUDA)."""
    if x.device.type == "cpu":
        return eind_panel_plain(x, alpha_eff, mu, L, pd,
                                damping_type=damping_type, cols=cols,
                                row0=row0)
    xc, ac, muc = (x, alpha_eff, mu) if cols is None else cols
    nrows, npad = x.shape[0], xc.shape[0]
    _check("eind_panel", x, alpha_eff, xc, ac, muc, L)
    _check_shapes("eind_panel", (x, (nrows, 3)), (alpha_eff, (nrows,)),
                  (xc, (npad, 3)), (ac, (npad,)), (muc, (npad, 3)),
                  (L, (3,)))
    out = torch.empty((nrows, 3), dtype=torch.float32, device=x.device)
    _launch("eind_panel", "PPIIPPPIPFIPP", x.device,
            x.data_ptr(), alpha_eff.data_ptr(), nrows, int(row0),
            xc.data_ptr(), ac.data_ptr(), muc.data_ptr(), npad,
            L.data_ptr(), float(pd), int(damping_type), out.data_ptr(),
            _stream(x))
    eind_panel.launches += 1
    return out


eind_panel.launches = 0


def pair_wolf_panel(x, q, typef, mol, maskf, tabs, L, cut_coulsq, qqrd2e,
                    g_ewald, sp=None, cols=None, row0=0):
    """Fused LJ + coul/long pair panel and Wolf static field (see
    pair_wolf_panel_plain; csrc/pair_wolf_panel.cu on CUDA).  Atom types
    must lie in [0, T1)."""
    if x.device.type == "cpu":
        return pair_wolf_panel_plain(x, q, typef, mol, maskf, tabs, L,
                                     cut_coulsq, qqrd2e, g_ewald, sp=sp,
                                     cols=cols, row0=row0)
    xc, qc, tc, molc, mc = ((x, q, typef, mol, maskf) if cols is None
                            else cols)
    nrows, npad = x.shape[0], xc.shape[0]
    _check("pair_wolf_panel", x, q, typef, mol, xc, qc, tc, molc, mc, tabs,
           L)
    _check_shapes("pair_wolf_panel", (x, (nrows, 3)), (q, (nrows,)),
                  (typef, (nrows,)), (mol, (nrows,)), (xc, (npad, 3)),
                  (qc, (npad,)), (tc, (npad,)), (molc, (npad,)),
                  (mc, (npad,)), (L, (3,)))
    if tabs.dim() != 3 or tabs.shape[0] != 5 \
            or tabs.shape[1] != tabs.shape[2] or tabs.shape[1] > MAX_T1:
        raise ValueError(f"pair_wolf_panel: tabs must be (5, T1, T1) with "
                         f"T1 <= {MAX_T1}, got {tuple(tabs.shape)}")
    t1 = tabs.shape[1]
    S = 0
    sp_ptr = None
    if sp is not None:
        sp = sp.to(device=x.device, dtype=torch.int32).contiguous()
        S = sp.shape[1]
        if sp.shape[0] != nrows or S > MAX_S:
            raise ValueError(f"pair_wolf_panel: sp must be (nrows, S<="
                             f"{MAX_S}), got {tuple(sp.shape)}")
        sp_ptr = sp.data_ptr() if S else None
    nb = -(-nrows // ROWS_PER_CTA)
    f = torch.empty((nrows, 3), dtype=torch.float32, device=x.device)
    e0 = torch.empty_like(f)
    partials = torch.empty((nb, 8), dtype=torch.float32, device=x.device)
    acc = torch.empty((8,), dtype=torch.float32, device=x.device)
    _launch("pair_wolf_panel", "PPPPPIIIPPPPPIPIPFFFPPPPP", x.device,
            x.data_ptr(), q.data_ptr(), typef.data_ptr(), mol.data_ptr(),
            sp_ptr, S, nrows, int(row0), xc.data_ptr(), qc.data_ptr(),
            tc.data_ptr(), molc.data_ptr(), mc.data_ptr(), npad,
            tabs.data_ptr(), t1, L.data_ptr(), float(cut_coulsq),
            float(qqrd2e), float(g_ewald), f.data_ptr(), e0.data_ptr(),
            partials.data_ptr(), acc.data_ptr(), _stream(x))
    pair_wolf_panel.launches += 1
    return f, acc[0], acc[1], acc[2:8], e0


pair_wolf_panel.launches = 0


def dipole_panel(x, q, mol, alpha_eff, mu, maskf, L, pd, cut_coulsq, qqrd2e,
                 *, damping_type=DAMP_EXP, cols=None, row0=0):
    """Charge-dipole + dipole-dipole forces; returns (fpol (nrows,3), u_ef,
    u_dd, vir6_pairwise) (csrc/dipole_panel.cu on CUDA)."""
    if x.device.type == "cpu":
        return dipole_panel_plain(x, q, mol, alpha_eff, mu, maskf, L, pd,
                                  cut_coulsq, qqrd2e,
                                  damping_type=damping_type, cols=cols,
                                  row0=row0)
    xc, qc, molc, ac, muc, mc = ((x, q, mol, alpha_eff, mu, maskf)
                                 if cols is None else cols)
    nrows, npad = x.shape[0], xc.shape[0]
    _check("dipole_panel", x, q, mol, alpha_eff, mu, xc, qc, molc, ac, muc,
           mc, L)
    _check_shapes("dipole_panel", (x, (nrows, 3)), (q, (nrows,)),
                  (mol, (nrows,)), (alpha_eff, (nrows,)), (mu, (nrows, 3)),
                  (xc, (npad, 3)), (qc, (npad,)), (molc, (npad,)),
                  (ac, (npad,)), (muc, (npad, 3)), (mc, (npad,)),
                  (L, (3,)))
    nb = -(-nrows // ROWS_PER_CTA)
    f = torch.empty((nrows, 3), dtype=torch.float32, device=x.device)
    partials = torch.empty((nb, 8), dtype=torch.float32, device=x.device)
    acc = torch.empty((8,), dtype=torch.float32, device=x.device)
    _launch("dipole_panel", "PPPPPIIPPPPPPIPFFFIPPPP", x.device,
            x.data_ptr(), q.data_ptr(), mol.data_ptr(),
            alpha_eff.data_ptr(), mu.data_ptr(), nrows, int(row0),
            xc.data_ptr(), qc.data_ptr(), molc.data_ptr(), ac.data_ptr(),
            muc.data_ptr(), mc.data_ptr(), npad, L.data_ptr(), float(pd),
            float(cut_coulsq), math.sqrt(qqrd2e), int(damping_type),
            f.data_ptr(), partials.data_ptr(), acc.data_ptr(), _stream(x))
    dipole_panel.launches += 1
    return f, acc[0], acc[1], acc[2:8]


dipole_panel.launches = 0
