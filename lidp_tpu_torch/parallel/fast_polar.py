"""The production fast path of the polarizable pair style at scale
(lidp_tpu/parallel/fast_polar.py): prescan, aligned_npad, HostPolarForces,
FastPolarRunner and maybe_attach.

FastPolarRunner is a drop-in Runner (integrate/driver.py) whose force
evaluation is the panel engine's (parallel/shard.py PolarStep), composed
with the integrator fixes the engine takes: nve and rigid/nve.  It runs in
one of two modes:

  * fused (the default on a GPU): each step is the integrator's initial
    half, one PolarStep.init (the CUDA kernels, CG on the device with its
    stopping test read once per iteration) and the final half, in a Python
    loop in place of the JAX package's lax.scan;
  * host (LIDP_FAST_POLAR_MODE=host): the force evaluation phase by phase
    through HostPolarForces with the mixed-precision dipole solve and the
    dipole-history predictor (LIDP_PREDICT, default order 2).  The JAX
    package takes it for float64 on a TPU; here it is an option.

HostPolarForces runs one force evaluation phase by phase from
PolarStep.make_host_phases(): the pair pass, the Ewald k-blocks, the Wolf
field, the CG dipole solve with the loop on the host, the dipole forces.
It is the path of the reference's own `polar_precision 1e-11` regime: in a
float64 build on a GPU the O(N^2) passes go through the f64-grade kernels
(the `*_df` phases), and `mixed=True` solves the dipoles by iterative
refinement — float32 CG sweeps on the float32 eind kernel inside, one
float64 residual pass per refinement outside.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from lidp_tpu_torch import resolve_device
from lidp_tpu_torch.forcefield import ForceResult
from lidp_tpu_torch.parallel.shard import (_pad_and_chunk,
                                           build_sharded_polar_step)

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
    # (thermostats, constraints, walls, ...) stays on the dense path.  The
    # output fixes sample the state between run chunks and compose with
    # any runner; the JAX package's prescan sends them off the panel
    # engine too (ROADMAP queue 3 item 27)
    from lidp_tpu_torch.styles.fix_output import OUTPUT_STYLES

    for f in getattr(script, "fixes", {}).values():
        if f.style not in ("nve", "rigid/nve", "rigid/nve/small") \
                + OUTPUT_STYLES:
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


# --------------------------------------------------------------------------
# the runner
# --------------------------------------------------------------------------


class FastPolarRunner:
    """Drop-in Runner (same setup/run interface as integrate/driver.py
    Runner) that evaluates forces through the panel engine.  Composes with
    the inner Runner's integrator (nve / rigid/nve) and serves everything
    else from the inner Runner.

    The step is built with panel="kernel" (the CUDA kernels on a GPU, their
    plain versions on the CPU); on a GPU that build raises where the live
    type pairs' outer cutoffs differ (the pair kernels take one).
    panel="scan" runs the plain versions, on a GPU only when asked for:
    the comparison route, or the route for a per-type outer cutoff.
    Forces are computed at x - box_lo, so the atoms' coordinates may stay
    unwrapped (rigid bodies keep them so): the panels' minimum image and
    the Ewald phases are periodic."""

    # dipole-history extrapolation coefficients for the SCF initial guess
    # of host mode (Lagrange through the last p converged dipole sets; rows
    # sum to 1 so a cold replicated history reduces to plain warm start).
    # CG still iterates to the unchanged convergence criterion: the
    # predictor only moves the starting point (cf. Kolafa ASPC, J Comput
    # Chem 25:335).
    _PREDICT_COEF = {1: (1.0,), 2: (2.0, -1.0), 3: (3.0, -3.0, 1.0)}

    def __init__(self, inner, *, ff, pol, n: int, npad: int, dt: float,
                 ftm2v: float, box_lo, box_lengths, sp_lists=None,
                 dtype=None, log=None, device="cuda", panel="kernel"):
        device = resolve_device(device)
        self._inner = inner
        self.ff = ff
        self.natoms = n
        self._log = log or (lambda *a: None)
        if dtype is None:
            dtype = torch.float32
        step = build_sharded_polar_step(
            None, ff, pol, n=n, dt=dt, ftm2v=ftm2v, col_chunk=_COL_CHUNK,
            dtype=dtype, panel=panel, device=device)
        if step.npad != npad:
            raise ValueError(
                f"fast-polar padding mismatch: sim npad {npad} != panel "
                f"npad {step.npad}")
        # frozen stored-coordinate shift for the polar fdotr virial (the
        # reference's wrap-at-read_data convention)
        xsh = getattr(ff, "polar_xshift", None)
        step.bind_box(box_lengths,
                      xshift=None if xsh is None else np.asarray(xsh))
        if sp_lists is not None:
            step.bind_special(*sp_lists)
        self.step = step
        self._lo = torch.as_tensor(np.asarray(box_lo, np.float64),
                                   dtype=dtype, device=device)
        self.mode = "fused"
        mode_env = os.environ.get("LIDP_FAST_POLAR_MODE", "")
        if mode_env in ("host", "fused"):
            self.mode = mode_env
        self._hpf = None
        self._mu_hist = None
        if self.mode == "host":
            # the JAX package's strip rule: keep each O(N^2) phase of a
            # large system to a row strip
            strips = 8 if npad > 32768 else 1
            while npad % strips:
                strips //= 2
            self._hpf = HostPolarForces(
                step.make_host_phases(strips=max(1, strips)), pol, n,
                mixed=True)

    # everything the fast path doesn't own is served by the inner Runner
    def __getattr__(self, name):
        if name.startswith("__") or name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    # -- force evaluation -------------------------------------------------
    def _result(self, sys, f, mu, en, diverged):
        zero = sys.x.new_zeros(())
        return ForceResult(
            f=f, evdwl=en["evdwl"], ecoul=en["ecoul"], elong=en["elong"],
            epol=en["epol"], ebond=zero, virial=en["virial"], mu=mu,
            scf_iters=en["scf_iters"],
            scf_diverged=torch.full((), diverged, dtype=torch.bool,
                                    device=sys.x.device))

    def _fast_res(self, sys):
        f, mu, en = self.step.init(sys.x - self._lo, sys.q, sys.type,
                                   sys.mol, sys.alpha, sys.mu, sys.mask)
        return self._result(sys, f, mu, en, False)

    def _host_res(self, sys):
        f, mu, en = self._hpf(sys.x - self._lo, sys.q, sys.type, sys.mol,
                              sys.alpha, sys.mu, sys.mask)
        return self._result(sys, f, mu, en, not en["scf_converged"])

    def forces(self, sys):
        """One force + SCF evaluation at sys's positions, in the runner's
        mode: a ForceResult."""
        return self._host_res(sys) if self.mode == "host" \
            else self._fast_res(sys)

    # -- Runner interface --------------------------------------------------
    def setup(self, sys):
        """Initial force evaluation and the integrator's setup hook.
        Returns (sys, res, None, istate)."""
        res = self.forces(sys)
        sys = sys.replace(mu=res.mu)
        integ = self._inner.integ
        if integ.init_state_res is not None:
            sys, istate = integ.init_state_res(sys, res, integ.params)
        else:
            sys, istate = integ.init_state(sys, res.f, integ.params)
        return sys, res, None, istate

    def run(self, sys, res, nlist, istate, nsteps: int, part_ms=None):
        """Advance nsteps; returns (sys, res, None, istate).  part_ms, a
        dict: add to it each step's CUDA-event milliseconds of the
        integrator's initial half, the force evaluation and the final half
        ("initial", "forces", "final"), synchronising every step."""
        integ = self._inner.integ
        ip = integ.params
        coef = (1.0,)
        if self.mode == "host":
            order = int(os.environ.get("LIDP_PREDICT", "2"))
            coef = self._PREDICT_COEF.get(order, (1.0,))
        hist = self._mu_hist
        parts = ("initial", "forces", "final")
        for _ in range(nsteps):
            if part_ms is not None:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
            sys, istate = integ.initial(sys, res, ip, istate)
            sys = sys.replace(step=sys.step + 1)
            if part_ms is not None:
                ev[1].record()
            if self.mode == "host" and hist is not None \
                    and len(hist) == len(coef):
                sys = sys.replace(mu=sum(c * h for c, h in zip(coef, hist)))
            res = self.forces(sys)
            sys = sys.replace(mu=res.mu)
            if self.mode == "host":
                hist = ([res.mu] + (hist or [res.mu] * len(coef)))[
                    :len(coef)]
            if part_ms is not None:
                ev[2].record()
            sys, istate = integ.final(sys, res, ip, istate)
            if part_ms is not None:
                ev[3].record()
                torch.cuda.synchronize()
                for k, a, b in zip(parts, ev, ev[1:]):
                    part_ms[k] = part_ms.get(k, 0.0) + a.elapsed_time(b)
        self._mu_hist = hist
        return sys, res, None, istate


def maybe_attach(runner, *, script, ff, pol, sys, n, npad, dt, ftm2v,
                 dtype, sp_lists=None, log=None):
    """Final eligibility gate, after the script front end assembled the
    real Runner: a FastPolarRunner around it, or None where the panel
    engine cannot take the simulation.  A failure to build the step or its
    kernels raises: the port has no dense path to fall back to."""
    if pol is None or not prescan(script, n):
        return None
    # composition limits: the panel engine owns the whole force evaluation
    if (runner.post_force is not None or runner.post_integrate is not None
            or runner.end_of_step is not None or runner.shrink is not None
            or getattr(runner, "tmd_hook", None) is not None):
        return None
    for attr in ("pppm", "msm", "ewald6", "pppm_disp", "eam", "tip4p",
                 "dpd", "cmap", "adapt"):
        if getattr(ff, attr, None) is not None:
            return None
    # the bonded terms (tuples, empty for none)
    if any(getattr(ff, attr, ()) for attr in ("bond", "angle", "dihedral",
                                              "improper")):
        return None
    if getattr(ff, "hbond", ()) or getattr(ff, "extra_pairs", ()):
        return None
    if ff.pair is None or not ff.pair.coul:
        return None
    if sys.box.triclinic:
        return None
    box_lo = sys.box.lo.detach().cpu().numpy()
    box_len = sys.box.hi.detach().cpu().numpy() - box_lo
    fr = FastPolarRunner(
        runner, ff=ff, pol=pol, n=n, npad=npad, dt=dt, ftm2v=ftm2v,
        box_lo=box_lo, box_lengths=box_len, sp_lists=sp_lists, dtype=dtype,
        log=log, device=sys.x.device)
    if log:
        log(f"fast-polar engine: {fr.mode} mode, {n} atoms (padded {npad})")
    return fr
