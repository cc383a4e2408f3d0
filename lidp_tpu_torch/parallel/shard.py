"""The polarizable MD step on the panel engine, single device
(lidp_tpu/parallel/shard.py build_sharded_polar_step with mesh=None).

One step is velocity-Verlet with one force evaluation: the fused LJ +
coul/long pair panel and Wolf static field E0 (pair_wolf_panel), the sparse
special-bond correction, the reciprocal Ewald sum as [N,K] matmuls, the CG
dipole solve with one eind_panel matvec per iteration, then the dipole
forces and epol (dipole_panel).  Without polarization settings the step is
the pair panel (pair_panel) with the correction and the Ewald sum.

panel="kernel" runs the O(N^2) phases through the ops/panel.py wrappers
(the CUDA kernels on a GPU, their plain versions on the CPU): the f32
kernels in a float32 build, the f64-grade `*_df` kernels in a float64 one.
panel="scan" runs the plain versions directly over column chunks of
`col_chunk` columns in any dtype, which is the JAX package's column-chunk
scan path.  The plain versions take a per-type outer cutoff (cutsq of the
pair's two types); the pair kernels take one for all live type pairs, so a
CUDA build with panel="kernel" raises on any other table.

`make_host_phases` hands out the same force phases one by one, whole or as
row strips, for a host-driven evaluation (parallel/fast_polar.py
HostPolarForces).

The collectives of the multi-device path (all_gather, psum) are the
identity on one device and do not appear here; the panel functions keep
their `cols=`/`row0=` strip form for the multi-GPU slice.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from lidp_tpu_torch.box import minimum_image
from lidp_tpu_torch.forcefield import ForceField
from lidp_tpu_torch.ops import panel as panel_ops
from lidp_tpu_torch.ops.polarization import (PolarizationSettings,
                                             scf_solve_cg)

# (nloc, K) working-set cap of one Ewald k-block (shard.py:590-614)
EWALD_BLOCK_ELEMS = 64_000_000


def _pad_and_chunk(n: int, ndev: int, target: int):
    """Pad the atom count to a multiple of lcm(ndev, csz), csz a multiple
    of 256 (the column chunk of the scan path)."""
    csz = max(256, (target // 256) * 256)
    if n <= csz:
        csz = max(256, -(-n // 256) * 256)
    block = (ndev * csz) // math.gcd(ndev, csz)
    npad = -(-n // block) * block
    return npad, csz, npad // csz


def _wolf_df_adapter(x, q, typef, mol, maskf, tabs, L, cut_coulsq, qqrd2e,
                     g_ewald, sp=None, cols=None, row0=0):
    """pair_panel_df(mol=...) under pair_wolf_panel's argument order."""
    if cols is not None:
        xc, qc, tc, molc, mc = cols
        cols = (xc, qc, tc, mc, molc)
    return panel_ops.pair_panel_df(x, q, typef, maskf, tabs, L, cut_coulsq,
                                   qqrd2e, g_ewald, sp=sp, mol=mol,
                                   cols=cols, row0=row0)


def _pair_df_adapter(x, q, typef, maskf, tabs, L, cut_coulsq, qqrd2e,
                     g_ewald, sp=None, cols=None, row0=0, *, coul=True):
    """pair_panel_df under pair_panel's signature (it has no LJ-only form;
    a float64 kernel build takes it only with coulomb)."""
    return panel_ops.pair_panel_df(x, q, typef, maskf, tabs, L, cut_coulsq,
                                   qqrd2e, g_ewald, sp=sp, cols=cols,
                                   row0=row0)


def _fdotr(xw, f):
    """The 6 F.r virial terms of wrapped coordinates xw and forces f."""
    return torch.stack([
        torch.sum(xw[:, 0] * f[:, 0]), torch.sum(xw[:, 1] * f[:, 1]),
        torch.sum(xw[:, 2] * f[:, 2]), torch.sum(xw[:, 0] * f[:, 1]),
        torch.sum(xw[:, 0] * f[:, 2]), torch.sum(xw[:, 1] * f[:, 2])])


class PolarStep(nn.Module):
    """Velocity-Verlet step of the (polarizable) LJ + coul/long system.

    forward(x, v, f_prev, q, type, mol, alpha, mu, mass, mask)
        -> (x, v, mu, f, energies)
    init(x, q, type, mol, alpha, mu, mask) -> (f, mu, energies)

    All per-atom tensors span the padded axis (npad, ...); energies holds
    0-d tensors evdwl, ecoul, elong, epol, a (6,) virial and the int
    scf_iters.  Force-field tables, k-space tables, the box and the special
    lists are buffers.
    """

    def __init__(self, ff: ForceField, s: Optional[PolarizationSettings], *,
                 n: int, npad: int, csz: int, dt: float, ftm2v: float, dtype,
                 device, panel: str):
        super().__init__()
        pair, ew = ff.pair, ff.ewald
        if not pair.coul and (ew is not None or s is not None):
            raise NotImplementedError(
                "an LJ-only pair table runs without k-space and without "
                "polarization")
        if panel not in ("kernel", "scan"):
            raise ValueError(f"panel must be 'kernel' or 'scan', not {panel!r}")
        cq = pair.cutsq[1:, 1:].detach().cpu().numpy()
        if (panel == "kernel" and torch.device(device).type == "cuda"
                and not np.all((cq == cq.max()) | (cq == 0.0))):
            raise ValueError(
                "the pair kernels take one outer cutoff for every live type "
                "pair; pass panel='scan' for a per-type outer cutoff (the "
                "plain path forms cutsq per pair, as the JAX scan path does)")
        if (panel == "kernel" and dtype == torch.float64 and not pair.coul
                and torch.device(device).type == "cuda"):
            raise NotImplementedError(
                "a float64 LJ-only pair table has no f64-grade kernel "
                "(pair_panel_df always computes coulomb); pass panel='scan' "
                "for the plain path on a GPU")
        self.n, self.npad, self.csz = n, npad, csz
        self.dt, self.dtf = dt, 0.5 * dt * ftm2v
        self.s = s
        self.coul = bool(pair.coul)
        self.cut_coulsq = pair.cut_coulsq
        self.pair_qqrd2e = pair.qqrd2e
        self.g_ewald = pair.g_ewald
        self.qqrd2e = ff.qqrd2e
        self.has_ewald = ew is not None
        if ew is not None:
            self.qscale, self.ew_g = ew.qscale, ew.g_ewald
            self.qsum, self.qsqsum = ew.qsum, ew.qsqsum
        self.volume = None

        def buf(t):
            return t.to(device=device, dtype=dtype)

        # [lj3 lj4 offset cut_ljsq cutsq], the pair kernel's table operand
        self.register_buffer("tabs", buf(torch.stack(
            [pair.lj3, pair.lj4, pair.offset, pair.cut_ljsq, pair.cutsq])))
        self.register_buffer("special_lj", buf(pair.special_lj))
        self.register_buffer("special_coul", buf(pair.special_coul))
        if ew is not None:
            self.register_buffer("hvecs", buf(ew.hvecs))
            self.register_buffer("kcoeff", buf(ew.kcoeff))
            self.register_buffer("kvirial", buf(ew.kvirial))
        self.register_buffer("box_lengths", None)
        self.register_buffer("vir_xshift", None)
        self.register_buffer("sp_idx", None)
        self.register_buffer("sp_lvl", None)

        # the plain (column-chunk scan) panels, in any dtype
        plain = dict(
            pair_wolf=functools.partial(panel_ops.pair_wolf_panel_plain,
                                        chunk=csz),
            pair=functools.partial(panel_ops.pair_panel_plain, chunk=csz),
            wolf=functools.partial(panel_ops.wolf_panel_plain, chunk=csz),
            eind=functools.partial(panel_ops.eind_panel_plain, chunk=csz),
            dipole=functools.partial(panel_ops.dipole_panel_plain, chunk=csz))
        f32 = dict(pair_wolf=panel_ops.pair_wolf_panel,
                   pair=panel_ops.pair_panel, wolf=panel_ops.wolf_panel,
                   eind=panel_ops.eind_panel, dipole=panel_ops.dipole_panel)
        # self._k: the fused step's panels.  self._base: the panels of the
        # host phases pair_real/wolf/eind/dipole, which in a float64 build
        # are the plain ones as in the JAX package (its f64 build scans);
        # the f64-grade kernels are the *_df phases.
        self.has_df = (panel == "kernel" and dtype == torch.float64
                       and self.coul)
        if panel == "scan":
            self._k = self._base = plain
        elif dtype == torch.float32:
            self._k = self._base = f32
        else:
            # a float64 LJ-only table (CPU only, see above) has no f64-grade
            # kernel and scans, as in the JAX package
            self._base = plain
            self._k = dict(plain)
            if self.has_df:
                self._k.update(pair_wolf=_wolf_df_adapter,
                               pair=_pair_df_adapter,
                               eind=panel_ops.eind_panel_df,
                               dipole=panel_ops.dipole_panel_df)
        # the float32 matvec of the mixed-precision inner CG
        self._eind32 = (panel_ops.eind_panel if panel == "kernel"
                        else plain["eind"])

    # --- binding (static per build: the box is NVE-constant) ---

    def bind_box(self, L, xshift=None):
        """Box edge lengths of the origin-based orthogonal box.  xshift
        (npad, 3), optional: a frozen stored-coordinate wrap offset for the
        polar F.r virial (the reference wraps at read_data and then only at
        reneighbouring); the default wraps anew at every evaluation."""
        dtype, device = self.tabs.dtype, self.tabs.device
        self.box_lengths = torch.as_tensor(np.asarray(L, np.float64),
                                           dtype=dtype, device=device)
        self.volume = float(np.prod(np.asarray(L, np.float64)))
        self.vir_xshift = (None if xshift is None else torch.as_tensor(
            np.asarray(xshift, np.float64), dtype=dtype, device=device))

    def bind_special(self, idx, lvl):
        """(n, S) special lists (topology.special_lists), padded to npad
        rows whose slots hold n, the index of a masked padded atom."""
        pad_rows = self.npad - idx.shape[0]
        if pad_rows:
            idx = np.concatenate(
                [idx, np.full((pad_rows, idx.shape[1]), self.n, idx.dtype)])
            lvl = np.concatenate(
                [lvl, np.zeros((pad_rows, lvl.shape[1]), lvl.dtype)])
        dev = self.tabs.device
        self.sp_idx = torch.as_tensor(idx, dtype=torch.int32, device=dev)
        self.sp_lvl = torch.as_tensor(lvl, dtype=torch.int64, device=dev)

    # --- force phases ---

    @staticmethod
    def _rows(strip):
        """(row slice, row0, is_strip) of the whole block (strip None) or of
        the row strip [i0, i0 + ns)."""
        if strip is None:
            return slice(None), 0, False
        i0, ns = int(strip[0]), int(strip[1])
        return slice(i0, i0 + ns), i0, True

    def _ewald_kblock(self, x, q, hv, kc, kv):
        """Per-k-block reciprocal Ewald energy/forces/virial."""
        c0 = 4.0 * math.pi * self.qscale / self.volume
        phases = x @ hv.T
        cph, sph = torch.cos(phases), torch.sin(phases)
        sre = q @ cph
        sim = q @ sph
        sk2 = sre * sre + sim * sim
        e = c0 * torch.sum(kc * sk2)
        w1 = kc * sre * 2.0 * c0
        w2 = kc * sim * 2.0 * c0
        fk = ((sph * w1[None, :] - cph * w2[None, :]) @ hv) * q[:, None]
        vk = c0 * (sk2 @ kv)
        return fk, e, vk

    def _ewald_self(self):
        return (self.qsqsum * self.qscale * self.ew_g / math.sqrt(math.pi)
                + 0.5 * math.pi * self.qscale
                / (self.ew_g**2 * self.volume) * self.qsum * self.qsum)

    def _ewald(self, x, q):
        """(fk, e_k, vk) over all k, in blocks above EWALD_BLOCK_ELEMS."""
        K, nloc = self.hvecs.shape[0], x.shape[0]
        if nloc * K <= EWALD_BLOCK_ELEMS:
            return self._ewald_kblock(x, q, self.hvecs, self.kcoeff,
                                      self.kvirial)
        kb = max(128, EWALD_BLOCK_ELEMS // max(nloc, 1))
        fk = torch.zeros_like(x)
        e = x.new_zeros(())
        vk = x.new_zeros((6,))
        for k0 in range(0, K, kb):
            sl = slice(k0, k0 + kb)
            fb, eb, vb = self._ewald_kblock(x, q, self.hvecs[sl],
                                            self.kcoeff[sl],
                                            self.kvirial[sl])
            fk, e, vk = fk + fb, e + eb, vk + vb
        return fk, e, vk

    def _special_correction(self, x, q, type_, strip=None):
        """Sparse special-bond contributions, O(N*S): ADDS factor_lj * E
        for the pairs the dense pass excluded from LJ, and applies the
        kspace-present coulomb convention forcecoul -= (1-factor)*prefactor
        (...polarization.cpp:262-278).  Returns (df, dev, dec, dvir) of the
        whole block or of the row strip."""
        rs, _, _ = self._rows(strip)
        L = self.box_lengths
        sp_idx, sp_lvl = self.sp_idx[rs], self.sp_lvl[rs]
        xr, qr, tr = x[rs], q[rs], type_[rs]
        jvalid = sp_idx < self.n
        jc = torch.clamp(sp_idx, max=self.npad - 1).long()
        sdx = minimum_image(xr[:, 0:1] - x[:, 0][jc], L[0])
        sdy = minimum_image(xr[:, 1:2] - x[:, 1][jc], L[1])
        sdz = minimum_image(xr[:, 2:3] - x[:, 2][jc], L[2])
        srsq = torch.where(jvalid, sdx * sdx + sdy * sdy + sdz * sdz, 1.0)
        sr2inv = 1.0 / srsq
        ti, tj = tr[:, None], type_[jc]
        lj3, lj4, off, cut_ljsq, cutsq = (t[ti, tj] for t in self.tabs)
        flj = self.special_lj[sp_lvl]
        fcl = self.special_coul[sp_lvl]
        in_rng = jvalid & (srsq < cutsq)
        lj_m = in_rng & (srsq < cut_ljsq)
        r6inv = sr2inv * sr2inv * sr2inv
        forcelj = r6inv * (12.0 * lj3 * r6inv - 6.0 * lj4)
        evdwl_full = r6inv * (lj3 * r6inv - lj4) - off
        dflj = torch.where(lj_m, flj * forcelj, 0.0)
        devd = torch.where(lj_m, flj * evdwl_full, 0.0)
        cm = in_rng & (srsq < self.cut_coulsq)
        prefac = self.pair_qqrd2e * qr[:, None] * q[jc] / torch.sqrt(srsq)
        dfc = torch.where(cm, -(1.0 - fcl) * prefac, 0.0)
        fpair_c = (dflj + dfc) * sr2inv
        df = torch.stack([torch.sum(fpair_c * sdx, dim=1),
                          torch.sum(fpair_c * sdy, dim=1),
                          torch.sum(fpair_c * sdz, dim=1)], dim=-1)
        wks = 0.5 * fpair_c
        dvir = torch.stack([
            torch.sum(wks * sdx * sdx), torch.sum(wks * sdy * sdy),
            torch.sum(wks * sdz * sdz), torch.sum(wks * sdx * sdy),
            torch.sum(wks * sdx * sdz), torch.sum(wks * sdy * sdz)])
        return df, 0.5 * torch.sum(devd), 0.5 * torch.sum(dfc), dvir

    def _nonpolar_forces(self, x, q, type_, mask, with_kspace=True,
                         strip=None, wolf_mol=None, k=None):
        """Pair panel + special correction + reciprocal Ewald.  Returns
        (f, evdwl, ecoul, elong, vir), and with wolf_mol the Wolf static
        field e0 as a 6th element (from the pair pass itself where the pair
        table has coulomb).  with_kspace=False skips the Ewald sum, which
        the host-driven evaluation runs as separate k-blocks; a row strip
        requires it.  k: the panel functions (default the fused step's)."""
        k = self._k if k is None else k
        dt_ = x.dtype
        rs, row0, is_strip = self._rows(strip)
        typef, maskf = type_.to(dt_), mask.to(dt_)
        sp_rows = None if self.sp_idx is None else self.sp_idx[rs]
        common = (self.tabs, self.box_lengths, self.cut_coulsq,
                  self.pair_qqrd2e, self.g_ewald)
        e0 = None
        if wolf_mol is not None and self.coul:
            molf = wolf_mol.to(dt_)
            cols = (x, q, typef, molf, maskf) if is_strip else None
            f, evdwl, ecoul, vir, e0 = k["pair_wolf"](
                x[rs], q[rs], typef[rs], molf[rs], maskf[rs], *common,
                sp=sp_rows, cols=cols, row0=row0)
            e0 = e0 * math.sqrt(self.qqrd2e)
        else:
            cols = (x, q, typef, maskf) if is_strip else None
            f, evdwl, ecoul, vir = k["pair"](
                x[rs], q[rs], typef[rs], maskf[rs], *common, sp=sp_rows,
                cols=cols, row0=row0, coul=self.coul)
        if self.sp_idx is not None:
            df, dev, dec, dvir = self._special_correction(x, q, type_,
                                                          strip=strip)
            f, evdwl, ecoul, vir = f + df, evdwl + dev, ecoul + dec, vir + dvir
        elong = x.new_zeros(())
        if is_strip and with_kspace:
            raise ValueError("a row strip requires with_kspace=False "
                             "(the Ewald sum runs as k-blocks)")
        if self.has_ewald and with_kspace:
            fk, e_k, vk = self._ewald(x, q)
            elong = e_k - self._ewald_self()
            # the k-space virial is the per-k terms only (ewald.cpp:466-474)
            f, vir = f + fk, vir + vk
        if wolf_mol is not None:
            if e0 is None:
                e0 = self._wolf_field(x, q, wolf_mol, mask, k=k)
            return f, evdwl, ecoul, elong, vir, e0
        return f, evdwl, ecoul, elong, vir

    def _wolf_field(self, x, q, mol, mask, strip=None, k=None):
        """Shifted-force (Wolf) static field E0 (unit-folded)."""
        k = self._k if k is None else k
        dt_ = x.dtype
        rs, row0, is_strip = self._rows(strip)
        molf, maskf = mol.to(dt_), mask.to(dt_)
        cols = (x, q, molf, maskf) if is_strip else None
        e0 = k["wolf"](x[rs], q[rs], molf[rs], maskf[rs], self.box_lengths,
                       self.cut_coulsq, cols=cols, row0=row0)
        return e0 * math.sqrt(self.qqrd2e)

    def _e_ind_of(self, x, alpha, mask, mu, strip=None, compute_dtype=None,
                  k=None):
        """E_ind = -T.mu (matrix-free panel contraction).  compute_dtype
        torch.float32 in a float64 build runs the float32 panel (the inner
        matvec of the mixed-precision solve) and returns float32."""
        k = self._k if k is None else k
        rs, row0, is_strip = self._rows(strip)
        ae = torch.where(mask, alpha, 0.0)
        L = self.box_lengths
        fn = k["eind"]
        if compute_dtype is not None and compute_dtype != L.dtype:
            x, ae, mu, L = (t.to(compute_dtype) for t in (x, ae, mu, L))
            fn = self._eind32
        cols = (x, ae, mu) if is_strip else None
        return fn(x[rs], ae[rs], mu[rs], L, self.s.polar_damp,
                  damping_type=self.s.damping_type, cols=cols, row0=row0)

    def _vir_wrap(self, x, rows=None):
        """Coordinates for the F.r virial: x plus the frozen shift of
        bind_box (of the row strip `rows`, a slice, when given), else x
        wrapped into the box."""
        if self.vir_xshift is not None:
            return x + (self.vir_xshift if rows is None
                        else self.vir_xshift[rows])
        L = self.box_lengths
        return x - torch.floor(x / L) * L

    def _dipole_forces(self, x, q, mol, alpha, mu, mask, strip=None, k=None):
        """Charge-dipole + dipole-dipole forces, epol and the F.r virial
        over wrapped coordinates (the reference's virial_fdotr_compute), of
        the whole block or of the row strip."""
        k = self._k if k is None else k
        dt_ = x.dtype
        rs, row0, is_strip = self._rows(strip)
        ae = torch.where(mask, alpha, 0.0)
        molf, maskf = mol.to(dt_), mask.to(dt_)
        cols = (x, q, molf, ae, mu, maskf) if is_strip else None
        fpol, u_ef, u_dd, _ = k["dipole"](
            x[rs], q[rs], molf[rs], ae[rs], mu[rs], maskf[rs],
            self.box_lengths, self.s.polar_damp, self.cut_coulsq,
            self.qqrd2e, damping_type=self.s.damping_type, cols=cols,
            row0=row0)
        vir_pol = _fdotr(self._vir_wrap(x[rs], rs if is_strip else None),
                         fpol)
        ar, mur = alpha[rs], mu[rs]
        polar = ar != 0.0
        u_self = 0.5 * torch.sum(torch.where(
            polar, torch.sum(mur * mur, dim=1)
            / torch.where(polar, ar, 1.0), 0.0))
        return fpol, u_self + u_ef + u_dd, vir_pol

    def init(self, x, q, type_, mol, alpha, mu_init, mask):
        """One full force (+ SCF) evaluation (Verlet::setup analog).

        The SCF mode is the settings': zodid takes mu = mu0 (the previous
        dipoles with use_previous, else polar_gamma alpha E0);
        fixed_iteration runs iterations_max sweeps mu = alpha (E0 +
        E_ind(mu)) from mu0, one eind panel each; otherwise CG.  polar_gs
        runs CG too, as the JAX panel step does: it has no Gauss-Seidel
        branch (that sweep is the dense route's)."""
        s = self.s
        if s is None:
            f, evdwl, ecoul, elong, vir = self._nonpolar_forces(
                x, q, type_, mask)
            return f, mu_init, dict(
                evdwl=evdwl, ecoul=ecoul, elong=elong,
                epol=x.new_zeros(()), virial=vir, scf_iters=0)
        f, evdwl, ecoul, elong, vir, e0 = self._nonpolar_forces(
            x, q, type_, mask, wolf_mol=mol)
        a = alpha[:, None]
        mu0 = mu_init if s.use_previous else s.polar_gamma * a * e0
        if s.zodid:
            mu_new, scf_iters = mu0, 0
        elif s.fixed_iteration:
            mu_new = mu0
            for _ in range(s.iterations_max):
                mu_new = a * (e0 + self._e_ind_of(x, alpha, mask, mu_new))
            scf_iters = s.iterations_max
        else:
            mu_new, scf_iters, _ = scf_solve_cg(
                e0, alpha, lambda m: -self._e_ind_of(x, alpha, mask, m), s,
                mu_init=(mu_init if s.use_previous else None),
                n_total=self.n)
        fpol, epol, vir_pol = self._dipole_forces(x, q, mol, alpha, mu_new,
                                                  mask)
        return f + fpol, mu_new, dict(
            evdwl=evdwl, ecoul=ecoul, elong=elong, epol=epol,
            virial=vir + vir_pol, scf_iters=scf_iters)

    def forward(self, x, v, f_prev, q, type_, mol, alpha, mu, mass, mask):
        """Velocity-Verlet with force carry: one force evaluation per step
        (Verlet::run semantics)."""
        pos = mass > 0
        minv = torch.where(pos, 1.0 / torch.where(pos, mass, 1.0), 0.0)
        kick = (self.dtf * minv)[:, None]
        live = mask[:, None]
        v = torch.where(live, v + kick * f_prev, 0.0)
        x = x + self.dt * v
        f_new, mu2, energies = self.init(x, q, type_, mol, alpha, mu, mask)
        v = torch.where(live, v + kick * f_new, 0.0)
        return x, v, mu2, f_new, energies

    # --- host-driven phases ---

    def make_host_phases(self, strips: int = 1) -> dict:
        """The force phases as separate callables for a host-driven
        evaluation (parallel/fast_polar.py HostPolarForces): the same math
        as `init`, one phase per call.

        strips == 1: nonpolar, pair_real (no k-space), wolf, eind, eind32,
        eind32_full, dipole over the whole block.  strips > 1 splits every
        O(N^2) phase into that many row strips: the strip phases take a
        leading row offset i0 and return strip-shaped results, which the
        caller concatenates; eind32_full stays whole.  With k-space:
        ewald_kblock, ewald_eself, ewald_tables.  A float64 kernel build
        with coulomb adds the f64-grade kernel phases pair_df,
        pair_wolf_df, eind_df, dipole_df, whole or as row strips like the
        others.

        In a float64 kernel build pair_real/wolf/eind/dipole are the plain
        column-chunk versions (wolf_panel has no float64 kernel), as in the
        JAX package: on a GPU they launch no kernel and are there for
        comparison, not for speed; the kernels are the *_df phases."""
        base = self._base
        f32 = torch.float32
        polar = self.s is not None
        if strips == 1:
            phases = dict(
                nonpolar=functools.partial(self._nonpolar_forces, k=base),
                pair_real=functools.partial(self._nonpolar_forces,
                                            with_kspace=False, k=base))
            if polar:
                phases.update(
                    wolf=functools.partial(self._wolf_field, k=base),
                    eind=functools.partial(self._e_ind_of, k=base),
                    eind32=functools.partial(self._e_ind_of, k=base,
                                             compute_dtype=f32),
                    dipole=functools.partial(self._dipole_forces, k=base))
        else:
            if self.npad % strips:
                raise ValueError(f"npad {self.npad} is not a multiple of "
                                 f"{strips} strips")
            ns = self.npad // strips
            phases = dict(
                strips=strips,
                pair_real=lambda i0, x, q, t, m: self._nonpolar_forces(
                    x, q, t, m, with_kspace=False, strip=(i0, ns), k=base))
            if polar:
                phases.update(
                    wolf=lambda i0, x, q, mol, m: self._wolf_field(
                        x, q, mol, m, strip=(i0, ns), k=base),
                    eind=lambda i0, x, a, m, mu: self._e_ind_of(
                        x, a, m, mu, strip=(i0, ns), k=base),
                    eind32=lambda i0, x, a, m, mu: self._e_ind_of(
                        x, a, m, mu, strip=(i0, ns), compute_dtype=f32,
                        k=base),
                    dipole=lambda i0, x, q, mol, a, mu, m:
                        self._dipole_forces(x, q, mol, a, mu, m,
                                            strip=(i0, ns), k=base))
        if polar:
            phases["eind32_full"] = functools.partial(
                self._e_ind_of, k=base, compute_dtype=f32)
        if self.has_ewald:
            phases["ewald_kblock"] = self._ewald_kblock
            phases["ewald_eself"] = self._ewald_self
            phases["ewald_tables"] = (self.hvecs, self.kcoeff, self.kvirial)
        if self.has_df:
            df = self._k
            if strips == 1:
                phases["pair_df"] = functools.partial(
                    self._nonpolar_forces, with_kspace=False, k=df)
            else:
                phases["pair_df"] = (
                    lambda i0, x, q, t, m: self._nonpolar_forces(
                        x, q, t, m, with_kspace=False, strip=(i0, ns), k=df))
            if polar and strips == 1:
                phases["pair_wolf_df"] = (
                    lambda x, q, t, mol, m: self._nonpolar_forces(
                        x, q, t, m, with_kspace=False, wolf_mol=mol, k=df))
                phases["eind_df"] = functools.partial(self._e_ind_of, k=df)
                phases["dipole_df"] = functools.partial(self._dipole_forces,
                                                        k=df)
            elif polar:
                phases["pair_wolf_df"] = (
                    lambda i0, x, q, t, mol, m: self._nonpolar_forces(
                        x, q, t, m, with_kspace=False, strip=(i0, ns),
                        wolf_mol=mol, k=df))
                phases["eind_df"] = (
                    lambda i0, x, a, m, mu: self._e_ind_of(
                        x, a, m, mu, strip=(i0, ns), k=df))
                phases["dipole_df"] = (
                    lambda i0, x, q, mol, a, mu, m: self._dipole_forces(
                        x, q, mol, a, mu, m, strip=(i0, ns), k=df))
        return phases


def build_sharded_polar_step(mesh, ff: ForceField,
                             s: Optional[PolarizationSettings], *, n: int,
                             dt: float, ftm2v: float, col_chunk: int = 4096,
                             dtype=torch.float32, panel: str = "kernel",
                             device="cuda") -> PolarStep:
    """The single-device PolarStep module (mesh must be None; the sharded
    multi-GPU path is a later slice).  s None builds the non-polar step.
    Its `npad` is the padded atom count every per-atom tensor spans; bind
    the box (`bind_box`) and, with bonds, the special lists
    (`bind_special`) before the first call."""
    from lidp_tpu_torch import resolve_device

    if mesh is not None:
        raise NotImplementedError("the multi-device panel engine is not "
                                  "ported yet; pass mesh=None")
    if ff.pair.excl_mol:
        raise NotImplementedError("excl_mol on the panel engine is not "
                                  "ported (ROADMAP queue 1 item 6, breadth); "
                                  "the dense route takes it")
    device = resolve_device(device)
    if device.type == "cuda":
        # full-precision matmuls for the Ewald [N,K] products in both
        # dtypes: the JAX package runs them at Precision.HIGHEST
        # (shard.py:363-366); TF32 keeps ~3 digits and would put O(0.1 rad)
        # errors into the phases
        torch.backends.cuda.matmul.allow_tf32 = False
    npad, csz, _ = _pad_and_chunk(n, 1, col_chunk)
    return PolarStep(ff, s, n=n, npad=npad, csz=csz, dt=dt, ftm2v=ftm2v,
                     dtype=dtype, device=device, panel=panel)
