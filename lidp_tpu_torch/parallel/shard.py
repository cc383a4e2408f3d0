"""The polarizable MD step on the panel engine, single device
(lidp_tpu/parallel/shard.py build_sharded_polar_step with mesh=None).

One step is velocity-Verlet with one force evaluation: the fused LJ +
coul/long pair panel and Wolf static field E0 (pair_wolf_panel), the sparse
special-bond correction, the reciprocal Ewald sum as [N,K] matmuls, the CG
dipole solve with one eind_panel matvec per iteration, then the dipole
forces and epol (dipole_panel).

panel="kernel" runs the O(N^2) phases through the ops/panel.py wrappers
(the CUDA kernels on a GPU, float32 only; their plain versions on the CPU);
panel="scan" runs the plain versions directly over column chunks of
`col_chunk` columns in any dtype, which is the JAX package's column-chunk
scan path and the port's float64 path on the GPU.

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


class PolarStep(nn.Module):
    """Velocity-Verlet step of the polarizable LJ + coul/long system.

    forward(x, v, f_prev, q, type, mol, alpha, mu, mass, mask)
        -> (x, v, mu, f, energies)
    init(x, q, type, mol, alpha, mu, mask) -> (f, mu, energies)

    All per-atom tensors span the padded axis (npad, ...); energies holds
    0-d tensors evdwl, ecoul, elong, epol, a (6,) virial and the int
    scf_iters.  Force-field tables, k-space tables, the box and the special
    lists are buffers.
    """

    def __init__(self, ff: ForceField, s: PolarizationSettings, *, n: int,
                 npad: int, csz: int, dt: float, ftm2v: float, dtype,
                 device, panel: str):
        super().__init__()
        pair, ew = ff.pair, ff.ewald
        if not pair.coul or ew is None or s is None:
            raise NotImplementedError(
                "the panel engine port covers the polarizable coul/long "
                "step with Ewald k-space only")
        if s.zodid or s.fixed_iteration or s.polar_gs:
            raise NotImplementedError(
                "zodid, fixed_iteration and polar_gs SCF modes are not "
                "ported yet; the CG solve is")
        cq = pair.cutsq[1:, 1:].detach().cpu().numpy()
        if not np.all((cq == cq.max()) | (cq == 0.0)):
            raise ValueError("the pair panel requires a uniform outer cutoff")
        if panel not in ("kernel", "scan"):
            raise ValueError(f"panel must be 'kernel' or 'scan', not {panel!r}")
        if panel == "kernel" and torch.device(device).type == "cuda" \
                and dtype != torch.float32:
            raise NotImplementedError(
                "a float64 build on CUDA needs the fp64 panel kernels "
                "(eind_panel_df, pair_panel_df, dipole_panel_df), which come "
                "in a later slice; build with panel='scan' for the plain "
                "float64 path")
        self.n, self.npad, self.csz = n, npad, csz
        self.dt, self.dtf = dt, 0.5 * dt * ftm2v
        self.s = s
        self.cut_coulsq = pair.cut_coulsq
        self.pair_qqrd2e = pair.qqrd2e
        self.g_ewald = pair.g_ewald
        self.qqrd2e = ff.qqrd2e
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
        self.register_buffer("hvecs", buf(ew.hvecs))
        self.register_buffer("kcoeff", buf(ew.kcoeff))
        self.register_buffer("kvirial", buf(ew.kvirial))
        self.register_buffer("box_lengths", None)
        self.register_buffer("sp_idx", None)
        self.register_buffer("sp_lvl", None)

        if panel == "kernel":
            self._pair_wolf = panel_ops.pair_wolf_panel
            self._eind = panel_ops.eind_panel
            self._dipole = panel_ops.dipole_panel
        else:
            self._pair_wolf = functools.partial(
                panel_ops.pair_wolf_panel_plain, chunk=csz)
            self._eind = functools.partial(panel_ops.eind_panel_plain,
                                           chunk=csz)
            self._dipole = functools.partial(panel_ops.dipole_panel_plain,
                                             chunk=csz)

    # --- binding (static per build: the box is NVE-constant) ---

    def bind_box(self, L):
        """Box edge lengths of the origin-based orthogonal box."""
        self.box_lengths = torch.as_tensor(
            np.asarray(L, np.float64), dtype=self.tabs.dtype,
            device=self.tabs.device)
        self.volume = float(np.prod(np.asarray(L, np.float64)))

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

    def _special_correction(self, x, q, type_):
        """Sparse special-bond contributions, O(N*S): ADDS factor_lj * E
        for the pairs the dense pass excluded from LJ, and applies the
        kspace-present coulomb convention forcecoul -= (1-factor)*prefactor
        (...polarization.cpp:262-278).  Returns (df, dev, dec, dvir)."""
        L = self.box_lengths
        jvalid = self.sp_idx < self.n
        jc = torch.clamp(self.sp_idx, max=self.npad - 1).long()
        sdx = minimum_image(x[:, 0:1] - x[:, 0][jc], L[0])
        sdy = minimum_image(x[:, 1:2] - x[:, 1][jc], L[1])
        sdz = minimum_image(x[:, 2:3] - x[:, 2][jc], L[2])
        srsq = torch.where(jvalid, sdx * sdx + sdy * sdy + sdz * sdz, 1.0)
        sr2inv = 1.0 / srsq
        ti, tj = type_[:, None], type_[jc]
        lj3, lj4, off, cut_ljsq, cutsq = (t[ti, tj] for t in self.tabs)
        flj = self.special_lj[self.sp_lvl]
        fcl = self.special_coul[self.sp_lvl]
        in_rng = jvalid & (srsq < cutsq)
        lj_m = in_rng & (srsq < cut_ljsq)
        r6inv = sr2inv * sr2inv * sr2inv
        forcelj = r6inv * (12.0 * lj3 * r6inv - 6.0 * lj4)
        evdwl_full = r6inv * (lj3 * r6inv - lj4) - off
        dflj = torch.where(lj_m, flj * forcelj, 0.0)
        devd = torch.where(lj_m, flj * evdwl_full, 0.0)
        cm = in_rng & (srsq < self.cut_coulsq)
        prefac = self.pair_qqrd2e * q[:, None] * q[jc] / torch.sqrt(srsq)
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

    def _nonpolar_forces(self, x, q, type_, mask, mol):
        """Pair panel + Wolf E0 + special correction + reciprocal Ewald.
        Returns (f, evdwl, ecoul, elong, vir, e0)."""
        dt_ = x.dtype
        f, evdwl, ecoul, vir, e0 = self._pair_wolf(
            x, q, type_.to(dt_), mol.to(dt_), mask.to(dt_), self.tabs,
            self.box_lengths, self.cut_coulsq, self.pair_qqrd2e,
            self.g_ewald, sp=self.sp_idx)
        if self.sp_idx is not None:
            df, dev, dec, dvir = self._special_correction(x, q, type_)
            f, evdwl, ecoul, vir = f + df, evdwl + dev, ecoul + dec, vir + dvir
        fk, e_k, vk = self._ewald(x, q)
        elong = e_k - self._ewald_self()
        # the k-space virial is the per-k terms only (ewald.cpp:466-474)
        return (f + fk, evdwl, ecoul, elong, vir + vk,
                e0 * math.sqrt(self.qqrd2e))

    def _e_ind_of(self, x, alpha_eff, mu):
        """E_ind = -T.mu (matrix-free panel contraction)."""
        return self._eind(x, alpha_eff, mu, self.box_lengths,
                          self.s.polar_damp, damping_type=self.s.damping_type)

    def _vir_wrap(self, x):
        L = self.box_lengths
        return x - torch.floor(x / L) * L

    def _dipole_forces(self, x, q, mol, alpha, alpha_eff, mu, mask):
        """Charge-dipole + dipole-dipole forces, epol and the F.r virial
        over wrapped coordinates (the reference's virial_fdotr_compute)."""
        dt_ = x.dtype
        fpol, u_ef, u_dd, _ = self._dipole(
            x, q, mol.to(dt_), alpha_eff, mu, mask.to(dt_), self.box_lengths,
            self.s.polar_damp, self.cut_coulsq, self.qqrd2e,
            damping_type=self.s.damping_type)
        xw = self._vir_wrap(x)
        vir_pol = torch.stack([
            torch.sum(xw[:, 0] * fpol[:, 0]), torch.sum(xw[:, 1] * fpol[:, 1]),
            torch.sum(xw[:, 2] * fpol[:, 2]), torch.sum(xw[:, 0] * fpol[:, 1]),
            torch.sum(xw[:, 0] * fpol[:, 2]),
            torch.sum(xw[:, 1] * fpol[:, 2])])
        polar = alpha != 0.0
        u_self = 0.5 * torch.sum(torch.where(
            polar, torch.sum(mu * mu, dim=1)
            / torch.where(polar, alpha, 1.0), 0.0))
        return fpol, u_self + u_ef + u_dd, vir_pol

    def init(self, x, q, type_, mol, alpha, mu_init, mask):
        """One full force + SCF evaluation (Verlet::setup analog)."""
        s = self.s
        f, evdwl, ecoul, elong, vir, e0 = self._nonpolar_forces(
            x, q, type_, mask, mol)
        ae = torch.where(mask, alpha, 0.0)
        mu_new, scf_iters, _ = scf_solve_cg(
            e0, alpha, lambda m: -self._e_ind_of(x, ae, m), s,
            mu_init=(mu_init if s.use_previous else None), n_total=self.n)
        fpol, epol, vir_pol = self._dipole_forces(x, q, mol, alpha, ae,
                                                  mu_new, mask)
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


def build_sharded_polar_step(mesh, ff: ForceField,
                             s: Optional[PolarizationSettings], *, n: int,
                             dt: float, ftm2v: float, col_chunk: int = 4096,
                             dtype=torch.float32, panel: str = "kernel",
                             device="cuda") -> PolarStep:
    """The single-device PolarStep module (mesh must be None; the sharded
    multi-GPU path is a later slice).  Its `npad` is the padded atom count
    every per-atom tensor spans; bind the box (`bind_box`) and, with bonds,
    the special lists (`bind_special`) before the first call."""
    from lidp_tpu_torch import resolve_device

    if mesh is not None:
        raise NotImplementedError("the multi-device panel engine is not "
                                  "ported yet; pass mesh=None")
    device = resolve_device(device)
    if device.type == "cuda":
        # full-f32 matmuls for the Ewald [N,K] products: the JAX package
        # runs them at Precision.HIGHEST (shard.py:363-366); TF32 keeps
        # ~3 digits and would put O(0.1 rad) errors into the phases
        torch.backends.cuda.matmul.allow_tf32 = False
    npad, csz, _ = _pad_and_chunk(n, 1, col_chunk)
    return PolarStep(ff, s, n=n, npad=npad, csz=csz, dt=dt, ftm2v=ftm2v,
                     dtype=dtype, device=device, panel=panel)
