"""fix pour: granular insertion (fix_pour.cpp, ATOM mode;
lidp_tpu/pour.py).

Insertion runs on the host between run chunks: every `nfreq` steps (from
the free-fall time across the insertion region, fix_pour.cpp:190-209) up
to `nper` particles (the volume-fraction count, :224-259) are placed at a
square-biased height with overlap rejection against the atoms near the
region (:466-545), given the free-fall velocity (:560-575), and written
into padded atom slots the Simulation keeps from setup (its npad counts
the whole insertion budget).

The RanPark draw order is the reference's: the height, each attempt's
coordinates (with the cylinder's rejection loop), then per inserted atom
vx, vy and the density.  The overlap test of an attempt takes every near
atom at once (numpy), with the same distances and the same verdict as a
loop over them.

The reference inserts in pre_exchange, after initial_integrate of the
event step; the run inserts at the chunk boundary before it, so the new
atoms are wound back by one half-kick and drift (x -= dt v, v -= dtf g,
Simulation._pour_events) and the step's own initial_integrate lands them
on the reference's state (their contact forces are zero: no overlap)."""

from __future__ import annotations

import dataclasses

import numpy as np

from lidp_tpu_torch.rng import RanPark


@dataclasses.dataclass
class PourFix:
    ninsert: int
    ntype: int
    rng: RanPark
    region_style: int        # 1 = block, 2 = z cylinder
    xlo: float = 0.0
    xhi: float = 0.0
    ylo: float = 0.0
    yhi: float = 0.0
    zlo: float = 0.0
    zhi: float = 0.0
    xc: float = 0.0
    yc: float = 0.0
    rc: float = 0.0
    radius_one: float = 0.5
    radius_lo: float = 0.5
    radius_hi: float = 0.5
    dstyle: str = "one"      # one | range
    density_lo: float = 1.0
    density_hi: float = 1.0
    volfrac: float = 0.25
    maxattempt: int = 50
    rate: float = 0.0
    vxlo: float = 0.0
    vxhi: float = 0.0
    vylo: float = 0.0
    vyhi: float = 0.0
    vz: float = 0.0
    grav: float = 0.0        # -magnitude * ftm2v
    dt: float = 0.0
    nfirst: int = 0
    nper: int = 0
    nfreq: int = 0
    ninserted: int = 0
    nevents: int = 0
    periodic: tuple = (True, True, True)
    box_lo: tuple = (0.0, 0.0, 0.0)
    box_hi: tuple = (0.0, 0.0, 0.0)

    def finish_setup(self, step_now):
        """nfreq, nper and nfirst (fix_pour.cpp:190-263, 3d)."""
        v_rel = self.vz - self.rate
        delta = self.zhi - self.zlo
        t = (-v_rel - np.sqrt(v_rel * v_rel - 2.0 * self.grav * delta)) \
            / self.grav
        self.nfreq = int(t / self.dt + 0.5)
        self.nfirst = step_now + 1
        if self.region_style == 1:
            dy = max(self.yhi - self.ylo, 1.0)
            volume = (self.xhi - self.xlo) * dy * (self.zhi - self.zlo)
        else:
            volume = np.pi * self.rc ** 2 * (self.zhi - self.zlo)
        volume_one = 4.0 / 3.0 * np.pi * self.rmax ** 3
        self.nper = int(self.volfrac * volume / volume_one)
        if self.nper == 0:
            raise ValueError("Fix pour insertion count per timestep is 0")

    @property
    def rmax(self):
        return self.radius_one if self.dstyle == "one" else self.radius_hi

    # ---- per-event helpers, in the reference's draw order ----

    def _xyz_random(self, h):
        u = self.rng.uniform
        if self.region_style == 1:
            return np.array([self.xlo + u() * (self.xhi - self.xlo),
                             self.ylo + u() * (self.yhi - self.ylo), h])
        while True:
            r1 = u() - 0.5
            r2 = u() - 0.5
            if r1 * r1 + r2 * r2 < 0.25:
                break
        return np.array([self.xc + 2.0 * r1 * self.rc,
                         self.yc + 2.0 * r2 * self.rc, h])

    def _radius_sample(self):
        if self.dstyle == "one":
            return self.radius_one
        return self.radius_lo + self.rng.uniform() * (self.radius_hi
                                                      - self.radius_lo)

    def _min_image(self, d):
        """d (M,3) minimum-imaged over the periodic dimensions."""
        L = np.asarray(self.box_hi) - np.asarray(self.box_lo)
        for k in range(3):
            if self.periodic[k]:
                d[:, k] -= L[k] * np.round(d[:, k] / L[k])
        return d

    def next_event(self):
        """The next insertion step (next_reneighbor), or None."""
        if self.ninserted >= self.ninsert:
            return None
        return self.nfirst + self.nevents * self.nfreq

    def _outside(self, dim, value, lo, hi):
        """Which values lie outside [lo, hi] in dimension dim (arrays of
        one length), the periodic wrap of lo or hi past the box face
        included, as the JAX package's per-atom test decides it."""
        plain = (value < lo) | (value > hi)
        if not self.periodic[dim]:
            return plain
        blo = self.box_lo[dim]
        prd = self.box_hi[dim] - blo
        below = lo < blo
        above = hi > self.box_hi[dim]
        c1 = below & (value > hi) & (value < lo + prd)
        c2 = ~below & above & (value > hi - prd) & (value < lo)
        return np.where(below & above, False, c1 | c2 | plain)

    def insert(self, step, x, v, radius, rmass, mask, n_real):
        """One insertion event at `step` (the caller sits at step - 1).
        Writes the new atoms into the host arrays in place (the first free
        slots from n_real) and returns their slots."""
        rmax = self.rmax
        nnew = min(self.nper, self.ninsert - self.ninserted)
        lo_c = self.zlo + (step - self.nfirst) * self.dt * self.rate
        hi_c = self.zhi + (step - self.nfirst) * self.dt * self.rate

        # the atoms overlapping the region grown by their radius and rmax
        # (:415-440)
        idx = np.nonzero(mask)[0]
        px, rad = x[idx], radius[idx]
        delta = rad + rmax
        far = np.zeros(len(idx), bool)
        if self.region_style == 1:
            far |= self._outside(0, px[:, 0], self.xlo - delta,
                                 self.xhi + delta)
            far |= self._outside(1, px[:, 1], self.ylo - delta,
                                 self.yhi + delta)
        else:
            d2 = self._min_image(np.stack(
                [px[:, 0] - self.xc, px[:, 1] - self.yc,
                 np.zeros(len(idx))], axis=1))
            far |= d2[:, 0] ** 2 + d2[:, 1] ** 2 > (self.rc + delta) ** 2
        far |= self._outside(2, px[:, 2], lo_c - delta, hi_c + delta)
        near = np.concatenate([px[~far], rad[~far, None]], axis=1)
        near = np.concatenate([near, np.zeros((nnew, 4))])
        nnear = int((~far).sum())

        rows = []
        nsuccess = 0
        attempt = 0
        maxiter = nnew * self.maxattempt
        slot = n_real
        while nsuccess < nnew:
            rn = self.rng.uniform()
            h = hi_c - rn * rn * (hi_c - lo_c)
            radtmp = self._radius_sample()
            success = False
            while attempt < maxiter:
                attempt += 1
                coord = self._xyz_random(h)
                d = self._min_image(coord[None, :] - near[:nnear, :3])
                rsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
                if not np.any(rsq <= (radtmp + near[:nnear, 3]) ** 2):
                    success = True
                    break
            if not success:
                break
            nsuccess += 1
            near[nnear] = (coord[0], coord[1], coord[2], radtmp)
            nnear += 1
            u = self.rng.uniform
            vnew = np.array([
                self.vxlo + u() * (self.vxhi - self.vxlo),
                self.vylo + u() * (self.vyhi - self.vylo),
                -np.sqrt(self.vz ** 2
                         + 2.0 * self.grav * (coord[2] - hi_c))])
            denstmp = self.density_lo + u() * (self.density_hi
                                               - self.density_lo)
            while slot < len(mask) and mask[slot]:
                slot += 1
            if slot >= len(mask):
                raise RuntimeError("fix pour: padded capacity exhausted")
            x[slot] = coord
            v[slot] = vnew
            radius[slot] = radtmp
            rmass[slot] = 4.0 * np.pi / 3.0 * radtmp ** 3 * denstmp
            mask[slot] = True
            rows.append(slot)
        self.ninserted += nsuccess
        self.nevents += 1
        return rows


def parse_pour(spec, script, grav_mag, ftm2v):
    """fix ID group pour N type seed region R [diam|dens|vol|rate|vel]
    (fix_pour.cpp:49-118 and its options :860-1020, ATOM mode)."""
    a = list(spec.args)
    ninsert, ntype, seed = int(a[0]), int(a[1]), int(a[2])
    pf = PourFix(ninsert=ninsert, ntype=ntype, rng=RanPark(seed),
                 region_style=1)
    i = 3
    while i < len(a):
        k = a[i]
        if k == "region":
            rname = a[i + 1]
            reg = script.regions[rname]
            s3 = np.asarray(script._region_spacing(rname), float)
            if isinstance(reg, tuple) and reg and reg[0] == "cylinder":
                if reg[1] != "z":
                    raise ValueError(
                        "Must use a z-axis cylinder region with fix pour")
                pf.region_style = 2
                pf.xc = float(reg[2]) * s3[0]
                pf.yc = float(reg[3]) * s3[1]
                pf.rc = float(reg[4]) * s3[0]
                pf.zlo = float(reg[5]) * s3[2]
                pf.zhi = float(reg[6]) * s3[2]
            elif isinstance(reg[0], str):
                raise ValueError(f"fix pour region {rname}: a block or a "
                                 "z cylinder")
            else:
                b = np.asarray(reg, float) * np.repeat(s3, 2)
                pf.region_style = 1
                (pf.xlo, pf.xhi, pf.ylo, pf.yhi,
                 pf.zlo, pf.zhi) = [float(vv) for vv in b]
            i += 2
        elif k == "diam":
            if a[i + 1] == "one":
                pf.dstyle = "one"
                pf.radius_one = 0.5 * float(a[i + 2])
                i += 3
            elif a[i + 1] == "range":
                pf.dstyle = "range"
                pf.radius_lo = 0.5 * float(a[i + 2])
                pf.radius_hi = 0.5 * float(a[i + 3])
                i += 4
            else:
                raise NotImplementedError(f"fix pour diam {a[i + 1]}")
        elif k == "dens":
            pf.density_lo = float(a[i + 1])
            pf.density_hi = float(a[i + 2])
            i += 3
        elif k == "vol":
            pf.volfrac = float(a[i + 1])
            pf.maxattempt = int(a[i + 2])
            i += 3
        elif k == "rate":
            pf.rate = float(a[i + 1])
            i += 2
        elif k == "vel":
            pf.vxlo, pf.vxhi = float(a[i + 1]), float(a[i + 2])
            pf.vylo, pf.vyhi = float(a[i + 3]), float(a[i + 4])
            pf.vz = float(a[i + 5])
            i += 6
        elif k in ("mol", "molfrac", "rigid", "shake", "id", "ignore"):
            raise NotImplementedError(f"fix pour {k} (MOLECULE mode)")
        else:
            raise ValueError(f"fix pour keyword {k}")
    pf.grav = -grav_mag * ftm2v
    pf.dt = script.dt
    pf.box_lo = tuple(float(v) for v in script.box_lo)
    pf.box_hi = tuple(float(v) for v in script.box_hi)
    pf.periodic = tuple(st[0] == "p" for st in script.boundary_styles)
    pf.finish_setup(int(script.step))
    return pf
