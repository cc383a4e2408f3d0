"""Host-driven force + SCF evaluation of the polarizable step
(lidp_tpu/parallel/fast_polar.py: prescan, aligned_npad, HostPolarForces).

HostPolarForces runs one force evaluation phase by phase from
PolarStep.make_host_phases(): the pair pass, the Ewald k-blocks, the Wolf
field, the CG dipole solve with the loop on the host, the dipole forces.
It is the path of the reference's own `polar_precision 1e-11` regime: in a
float64 build on a GPU the O(N^2) passes go through the f64-grade kernels
(the `*_df` phases), and `mixed=True` solves the dipoles by iterative
refinement — float32 CG sweeps on the float32 eind kernel inside, one
float64 residual pass per refinement outside.

The production runner around it (FastPolarRunner: rigid/nve, thermo, dump)
is a later slice.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from lidp_tpu_torch.parallel.shard import _pad_and_chunk

DENSE_PATH_MAX_ATOMS = 4096     # above this the script engine leaves the
                                # dense (N,3,N,3) route for the panel engine
_COL_CHUNK = 4096
# (npad, kb) working-set cap of one host-driven Ewald k-block
EWALD_HOST_BLOCK_ELEMS = 13_000_000
INNER_CG_MAX = 60               # float32 sweeps per refinement pass
OUTER_MAX = 8                   # refinement passes


def _env_mode() -> str:
    """LIDP_FAST_POLAR: "0" disables, "1" forces (any size), unset = auto."""
    return os.environ.get("LIDP_FAST_POLAR", "")


def prescan(script, n: int) -> bool:
    """Cheap eligibility check on a raw parsed script, before anything is
    built: may this simulation run on the panel engine (and so should its
    atom axis be padded to the panel alignment)?  Conservative: every
    condition the force/integrator composition needs that is visible on
    the script."""
    if _env_mode() == "0":
        return False
    p = getattr(script, "pair", None)
    if p is None or not str(getattr(p, "name", "")).endswith(
            "/polarization"):
        return False
    if not (n > DENSE_PATH_MAX_ATOMS or _env_mode() == "1"):
        return False
    ks = getattr(script, "kspace", None)
    if ks is not None and not str(ks[0]).startswith("ewald"):
        return False
    tilt = getattr(script, "box_tilt", None)
    if tilt is not None and np.any(np.asarray(tilt) != 0.0):
        return False
    if not all(getattr(script, "periodic", (True, True, True))):
        return False
    # integration fixes the panel engine composes with; anything else
    # (thermostats, constraints, walls, ...) stays on the dense path
    for f in getattr(script, "fixes", {}).values():
        if f.style not in ("nve", "rigid/nve", "rigid/nve/small"):
            return False
    # bonded force terms are outside the panel engine (special-bond pair
    # exclusions ARE handled, via the sparse correction pass)
    if getattr(script, "bond_style", None) not in (None, "zero"):
        return False
    for attr in ("angle_style", "dihedral_style", "improper_style"):
        if getattr(script, attr, None) not in (None, "zero"):
            return False
    if getattr(script, "neigh_exclude_types", None):
        return False
    if int(getattr(script, "n_shard_devices", 0) or 0) > 1:
        return False
    return True


def aligned_npad(n: int) -> int:
    npad, _, _ = _pad_and_chunk(n, 1, _COL_CHUNK)
    return npad


class HostPolarForces:
    """Host-driven per-phase force evaluation.

    phases: the dict of PolarStep.make_host_phases().  Each call returns
    (f, mu, energies); energies carries evdwl/ecoul/elong/epol/virial/
    scf_iters like PolarStep.init, and scf_converged.

    mixed: solve the dipoles by mixed-precision iterative refinement (for
    float64 builds).  use_df: run the O(N^2) passes through the f64-grade
    kernel phases (pair_wolf_df/pair_df, eind_df, dipole_df); the default
    is "they are present", which a float64 kernel build provides because
    the card has native float64.  use_df=False runs the pair_real/wolf/
    eind/dipole phases, which in a float64 build are the plain column-chunk
    versions: on a GPU that route launches no float64 kernel and its time
    is not a kernel's.  After a mixed solve `outer_passes` holds the
    refinement passes of the last call and `inner_iters` the float32 sweeps
    of each.  timing: bracket the phases with CUDA events (host
    clock on the CPU) and keep the milliseconds of the last call by label
    in `last_timing`.
    """

    def __init__(self, phases: dict, settings, natoms: int, *,
                 mixed: bool = False, use_df: Optional[bool] = None,
                 timing: bool = False):
        self.ph = phases
        self.s = settings
        self.natoms = natoms
        self.mixed = mixed
        self.timing = timing
        self.use_df = "pair_df" in phases if use_df is None else use_df
        self.last_timing: dict = {}
        self.outer_passes = 0
        self.inner_iters: list = []
        self._kblocks = None

    # -- the inner float32 CG --------------------------------------------
    def _inner_cg_device(self, r064, x32, alpha32, mask, sa32):
        """The inner float32 CG of one refinement pass on B d = r0, every
        matvec the float32 eind panel.  At most INNER_CG_MAX sweeps; stops
        at rs <= 1e-12 rs0 or when the residual stagnates (rs2 >= 0.999
        rs).  The loop condition is read to the host once per sweep.
        Returns (d in r064's dtype, sweeps)."""
        eind32 = self.ph["eind32_full"]
        r0 = r064.to(torch.float32)

        def B32(y_):
            return y_ + sa32 * (-eind32(x32, alpha32, mask, sa32 * y_))

        rs0 = torch.sum(r0 * r0)
        thresh = 1e-12 * (rs0 + 1e-30)
        d, rr, pp, rs = torch.zeros_like(r0), r0, r0, rs0
        alive = torch.ones((), dtype=torch.bool, device=r0.device)
        k = 0
        while k < INNER_CG_MAX and bool(alive & (rs > thresh)):
            Bp = B32(pp)
            den = torch.sum(pp * Bp)
            al = rs / torch.where(den != 0, den, 1.0)
            d = d + al * pp
            rr = rr - al * Bp
            rs2 = torch.sum(rr * rr)
            ok = torch.isfinite(rs2) & (rs2 < 0.999 * rs)
            pp = rr + (rs2 / torch.where(rs != 0, rs, 1.0)) * pp
            rs = torch.where(ok, rs2, rs)
            alive = alive & ok
            k += 1
        return d.to(r064.dtype), k

    # -- phase helpers ----------------------------------------------------
    def _striped(self, fn, *args):
        """fn over the whole block, or strip by strip with the per-row
        results concatenated and the scalars summed."""
        S = self.ph.get("strips", 1)
        if S == 1:
            return fn(*args)
        npad = int(args[0].shape[0])
        ns = npad // S
        outs = [fn(si * ns, *args) for si in range(S)]
        if not isinstance(outs[0], tuple):
            return torch.cat(outs, dim=0)
        merged = []
        for leaf in zip(*outs):
            if leaf[0].dim() and leaf[0].shape[0] == ns:
                merged.append(torch.cat(leaf, dim=0))
            else:
                merged.append(sum(leaf[1:], leaf[0]))
        return tuple(merged)

    def _tick_factory(self, device):
        """tick(label) closes the interval since the last tick; done()
        reads the intervals into `last_timing` (milliseconds by label)."""
        if not self.timing:
            return (lambda label: None), (lambda: None)
        marks = []
        cuda = device.type == "cuda"

        def stamp():
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                return ev
            return time.perf_counter()

        marks.append((None, stamp()))

        def tick(label):
            marks.append((label, stamp()))

        def done():
            if cuda:
                torch.cuda.synchronize(device)
            out = {}
            for (_, a), (label, b) in zip(marks, marks[1:]):
                ms = a.elapsed_time(b) if cuda else 1e3 * (b - a)
                out[label] = out.get(label, 0.0) + ms
            self.last_timing = out
            for label, ms in out.items():
                print(f"  phase {label:12s} {ms:10.3f} ms", flush=True)

        return tick, done

    def _ewald_blocks(self, npad, dtype):
        """The k-space tables cut into zero-padded blocks of kb k-vectors,
        kb = min(K, EWALD_HOST_BLOCK_ELEMS // npad) rounded up to 128."""
        if self._kblocks is None or self._kblocks[0] != (npad, dtype):
            hv, kc, kv = self.ph["ewald_tables"]
            K = hv.shape[0]
            kb = max(128, min(K, EWALD_HOST_BLOCK_ELEMS // max(npad, 1)))
            kb = -(-kb // 128) * 128
            blocks = []
            for k0 in range(0, K, kb):
                nk = min(k0 + kb, K) - k0
                hvb = hv.new_zeros((kb, 3), dtype=dtype)
                kcb = hv.new_zeros((kb,), dtype=dtype)
                kvb = hv.new_zeros((kb, 6), dtype=dtype)
                hvb[:nk] = hv[k0:k0 + nk]
                kcb[:nk] = kc[k0:k0 + nk]
                kvb[:nk] = kv[k0:k0 + nk]
                blocks.append((hvb, kcb, kvb))
            self._kblocks = ((npad, dtype), blocks)
        return self._kblocks[1]

    # -- the evaluation ---------------------------------------------------
    def __call__(self, x, q, typ, mol, alpha, mu_prev, mask):
        """One full force + SCF evaluation at positions x: the math of
        PolarStep.init, host-driven per phase."""
        ph = self.ph
        s = self.s
        use_df = self.use_df
        tick, done = self._tick_factory(x.device)

        e0 = None
        if "ewald_kblock" in ph:
            if use_df and "pair_wolf_df" in ph:
                # fused pair + Wolf field: one geometry pass serves both
                # pre-SCF O(N^2) phases
                f, evdwl, ecoul, elong, vir, e0 = self._striped(
                    ph["pair_wolf_df"], x, q, typ, mol, mask)
            elif use_df:
                f, evdwl, ecoul, elong, vir = self._striped(
                    ph["pair_df"], x, q, typ, mask)
            else:
                f, evdwl, ecoul, elong, vir = self._striped(
                    ph["pair_real"], x, q, typ, mask)
            tick("pair_real")
            e_k = x.new_zeros(())
            vk = x.new_zeros((6,))
            for hvb, kcb, kvb in self._ewald_blocks(int(x.shape[0]),
                                                    x.dtype):
                fb, eb, vb = ph["ewald_kblock"](x, q, hvb, kcb, kvb)
                f = f + fb
                e_k = e_k + eb
                vk = vk + vb
            elong = e_k - ph["ewald_eself"]()
            vir = vir + vk
            tick("ewald_k")
        else:
            f, evdwl, ecoul, elong, vir = ph["nonpolar"](x, q, typ, mask)
            tick("nonpolar")
        if e0 is None:
            e0 = self._striped(ph["wolf"], x, q, mol, mask)
            tick("wolf")

        # --- host-driven CG (ops/polarization.py scf_solve_cg math) ---
        sa = torch.sqrt(alpha)[:, None]

        if use_df and "eind_df" in ph:
            def B(y):
                return y + sa * (-self._striped(ph["eind_df"], x, alpha,
                                                mask, sa * y))
        else:
            def B(y):
                return y + sa * (-self._striped(ph["eind"], x, alpha, mask,
                                                sa * y))

        b = sa * e0
        if s.use_previous:
            y = torch.where(sa > 0, mu_prev / torch.where(sa > 0, sa, 1.0),
                            0.0)
        else:
            y = s.polar_gamma * sa * e0
        prec2 = float(s.polar_precision) ** 2
        n3 = 3.0 * self.natoms
        if self.mixed and "eind32_full" in ph:
            x32 = x.to(torch.float32)
            alpha32 = alpha.to(torch.float32)
            sa32 = sa.to(torch.float32)
            it = 0
            change = float("inf")
            outer = 0
            self.inner_iters = []
            while outer < OUTER_MAX and not (change <= prec2):
                r = b - B(y)           # ONE f64 panel pass per refinement
                tick("eind_f64")
                outer += 1
                it += 1
                d, k = self._inner_cg_device(r, x32, alpha32, mask, sa32)
                tick("inner_cg")
                self.inner_iters.append(k)
                it += k + 1
                change = float(torch.sum((d * sa) ** 2)) / n3
                y = y + d
            self.outer_passes = outer
            converged = change <= prec2
        else:
            r = b - B(y)
            p = r
            rs = float(torch.sum(r * r))
            rs0 = float(torch.sum(b * b)) + 1e-30
            change = float("inf")
            it = 0
            while not (change <= prec2) and it < s.iterations_max:
                Bp = B(p)
                denom = float(torch.sum(p * Bp))
                alpha_cg = rs / (denom if denom != 0 else 1.0)
                y = y + alpha_cg * p
                r = r - alpha_cg * Bp
                rs2, dchange = torch.stack([
                    torch.sum(r * r),
                    torch.sum((alpha_cg * p * sa) ** 2)]).tolist()
                beta = rs2 / (rs if rs != 0 else 1.0)
                change = dchange / n3
                p = r + beta * p
                rs = rs2
                it += 1
            converged = (change <= prec2) or (rs <= 1e-5 * rs0)
        mu = sa * y
        if not converged:
            mu = alpha[:, None] * e0     # reference divergence fallback
        tick("cg_rest")
        if use_df and "dipole_df" in ph:
            fpol, epol, vir_pol = self._striped(
                ph["dipole_df"], x, q, mol, alpha, mu, mask)
        else:
            fpol, epol, vir_pol = self._striped(
                ph["dipole"], x, q, mol, alpha, mu, mask)
        tick("dipole")
        f = f + fpol
        done()
        en = dict(evdwl=evdwl, ecoul=ecoul, elong=elong, epol=epol,
                  virial=vir + vir_pol, scf_iters=it,
                  scf_converged=converged)
        return f, mu, en
