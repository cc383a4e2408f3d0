"""The granular route's assembly (lidp_tpu/sim.py _build_granular_sim,
_parse_wall_gran and _region_gran_contacts): atom_style sphere data with
a pair gran/* style, bench/in.chute's stack.

`build_granular_sim` pads the atoms by the insertion budget of every fix
pour (their slots exist from setup, masked, and join group all), takes
fix freeze, gravity (chute or vector), nve/sphere or nvt/sphere, wall/gran,
wall/gran/region and pour, neigh_modify exclude group, the cell grid at
twice the largest radius (a pour's included) plus the skin with cap slack
5, the shrink-wrapped box of an `s` or `m` face, and the sphere computes,
then sets the run up (integrate/gran_runner.py).  A fix, compute or
keyword the JAX package's granular route drops unread raises."""

from __future__ import annotations

import numpy as np
import torch

from lidp_tpu_torch.integrate.gran_runner import GranRunner, WallGranFix
from lidp_tpu_torch.ops import granular as gran
from lidp_tpu_torch.ops.cells import CellConfig

_DROPPED = "ROADMAP queue 3 item 26, values JAX's thermo row lacks"
_SKIPPED = "ROADMAP queue 3 item 25, keywords JAX skips"
# the compute styles the granular route reads (the JAX package's tables)
GRAN_COMPUTES = ("erotate/sphere", "temp/sphere", "erotate/sphere/atom",
                 "contact/atom", "reduce")


def parse_wall_gran(script, spec, groups, u, device):
    """fix ID group wall/gran pairstyle kn kt gamman gammat xmu dampflag
    wallstyle args [wiggle dim amp period | shear dim vshear]
    (fix_wall_gran.cpp:49-190), and wall/gran/region with wallstyle
    `region ID` (fix_wall_gran_region.cpp)."""
    a = list(spec.args)
    kind = a[0]
    if kind not in ("hooke", "hooke/history", "hertz/history"):
        raise ValueError(f"fix wall/gran interaction style {kind}")
    kn, kt, gamman, gammat, xmu = gran.gran_coeffs(a[1:7])
    if kind == "hertz/history":
        kn /= u.nktv2p
        kt /= u.nktv2p
    kw = dict(kind=kind, kn=kn, kt=kt, gamman=gamman, gammat=gammat,
              xmu=xmu, gmask=torch.as_tensor(groups[spec.group],
                                             device=device),
              time_origin=int(script.step))
    i = 7
    style = a[i]
    if style in ("xplane", "yplane", "zplane"):
        kw["wallstyle"] = style
        kw["lo"] = -1.0e30 if a[i + 1] == "NULL" else float(a[i + 1])
        kw["hi"] = 1.0e30 if a[i + 2] == "NULL" else float(a[i + 2])
        i += 3
    elif style == "zcylinder":
        kw["wallstyle"] = style
        kw["cylradius"] = float(a[i + 1])
        i += 2
    elif style == "region":
        kw["wallstyle"] = "region"
        gen = region_gran_contacts(script, a[i + 1])
        kw["region_contacts"] = gen
        kw["n_contacts"] = len(gen(torch.zeros((1, 3), dtype=torch.float64)))
        i += 2
    else:
        raise ValueError(f"fix wall/gran wallstyle {style}")
    while i < len(a):
        if a[i] == "wiggle":
            kw["wiggle"] = True
            kw["axis"] = "xyz".index(a[i + 1])
            kw["amplitude"] = float(a[i + 2])
            kw["omega_w"] = 2.0 * np.pi / float(a[i + 3])
            i += 4
        elif a[i] == "shear":
            kw["wshear"] = True
            kw["axis"] = "xyz".index(a[i + 1])
            kw["vshear"] = float(a[i + 2])
            i += 3
        else:
            raise ValueError(f"fix wall/gran keyword {a[i]}")
    return WallGranFix(**kw)


def _axis_vec(x, dim, col):
    """An (N,3) tensor of zeros but column dim, which is col."""
    out = torch.zeros_like(x)
    out[:, dim] = col
    return out


def region_gran_contacts(script, rname):
    """The contact sources of fix wall/gran/region: x (N,3) -> [(rdist,
    d wall->atom, ok, rwall)], one per face of the region, as
    Region::surface_interior finds them (region_block.cpp,
    region_sphere.cpp:115, region_cylinder.cpp:223; a flat face's rwall
    None, the sphere's -R, the cylinder's shell -2R).  Static regions
    only."""
    reg = script.regions[rname]
    s3 = np.asarray(script._region_spacing(rname), float)
    if isinstance(reg[0], str) and reg[0] == "sphere":
        c = np.asarray(reg[1:4], float) * s3
        rad = float(reg[4]) * s3[0]

        def gen(x):
            d = x - torch.as_tensor(c, dtype=x.dtype, device=x.device)
            dist = torch.sqrt(torch.sum(d * d, 1))
            inside = (dist <= rad) & (dist > 0.0)
            dl = d * (1.0 - rad / torch.where(dist > 0, dist, 1.0))[:, None]
            rw = torch.full((x.shape[0],), -rad, dtype=x.dtype,
                            device=x.device)
            return [(torch.where(inside, rad - dist, -1.0), dl, inside, rw)]
        return gen
    if isinstance(reg[0], str) and reg[0] == "cylinder":
        axis = "xyz".index(reg[1])
        o1, o2 = [d for d in range(3) if d != axis]
        c1v, c2v = float(reg[2]) * s3[o1], float(reg[3]) * s3[o2]
        rad = float(reg[4]) * s3[o1]
        lo_a = float(reg[5]) * s3[axis]
        hi_a = float(reg[6]) * s3[axis]

        def gen(x):
            d1 = x[:, o1] - c1v
            d2 = x[:, o2] - c2v
            dist = torch.sqrt(d1 * d1 + d2 * d2)
            inside = ((dist <= rad) & (x[:, axis] >= lo_a)
                      & (x[:, axis] <= hi_a))
            shell_ok = inside & (dist > 0.0)
            scale = 1.0 - rad / torch.where(dist > 0, dist, 1.0)
            dl = torch.zeros_like(x)
            dl[:, o1] = d1 * scale
            dl[:, o2] = d2 * scale
            rw = torch.full((x.shape[0],), -2.0 * rad, dtype=x.dtype,
                            device=x.device)
            out = [(torch.where(shell_ok, rad - dist, -1.0), dl, shell_ok,
                    rw)]
            for coord, sgn in ((lo_a, 1.0), (hi_a, -1.0)):
                rf = (x[:, axis] - coord) * sgn
                out.append((torch.where(inside, rf, -1.0),
                            _axis_vec(x, axis, rf * sgn), inside, None))
            return out
        return gen
    if isinstance(reg[0], str):
        raise NotImplementedError(
            f"fix wall/gran/region on region style {reg[0]} (block, sphere "
            "and cylinder, as the JAX package; ROADMAP queue 1 item 6, "
            "breadth)")
    # block: an infinite face is no wall
    b = np.asarray(reg, float) * np.repeat(s3, 2)

    def gen(x):
        inside = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        for dim in range(3):
            if np.isfinite(b[2 * dim]):
                inside &= x[:, dim] >= b[2 * dim]
            if np.isfinite(b[2 * dim + 1]):
                inside &= x[:, dim] <= b[2 * dim + 1]
        out = []
        for dim in range(3):
            for coord, sgn in ((b[2 * dim], 1.0), (b[2 * dim + 1], -1.0)):
                if not np.isfinite(coord):
                    continue
                rf = (x[:, dim] - coord) * sgn
                out.append((torch.where(inside, rf, -1.0),
                            _axis_vec(x, dim, rf * sgn), inside, None))
        return out
    return gen


def _gravity(spec):
    """fix gravity magnitude chute ANGLE | vector X Y Z: (magnitude, the
    (3,) acceleration); fix_gravity.cpp:313's chute: theta = 180 - angle,
    phi = 0."""
    mag = float(spec.args[0])
    if spec.args[1] == "chute":
        th = np.deg2rad(180.0 - float(spec.args[2]))
        return mag, mag * np.array([np.sin(th), 0.0, np.cos(th)])
    if spec.args[1] == "vector":
        d3 = np.array([float(v) for v in spec.args[2:5]])
        return mag, mag * d3 / np.linalg.norm(d3)
    raise NotImplementedError(
        f"fix gravity style {spec.args[1]} (chute and vector, as the JAX "
        "package; ROADMAP queue 1 item 6, breadth)")


def _shrink(script):
    """The granular route's ShrinkSpec (the JAX package's sim.py
    :850-861): small 1e-4 of the box's length now, the `m` faces' limits
    the box's faces now, whatever made the box."""
    from lidp_tpu_torch.box import ShrinkSpec

    code = {"p": 0, "f": 0, "s": 2, "m": 3}
    lo_c = tuple(code[st[0]] for st in script.boundary_styles)
    hi_c = tuple(code[st[1]] for st in script.boundary_styles)
    if not any(c in (2, 3) for c in lo_c + hi_c):
        return None
    return ShrinkSpec(
        lo_style=lo_c, hi_style=hi_c,
        small=tuple(float(v) for v in 1.0e-4 * (script.box_hi
                                                - script.box_lo)),
        min_lo=tuple(float(v) for v in script.box_lo),
        min_hi=tuple(float(v) for v in script.box_hi))


def _nvt_sphere(script, spec, u, rmass, active, radius, n, dim_, dtype,
                device):
    """fix ID group nvt/sphere temp Tstart Tstop Tdamp
    (fix_nvt_sphere.cpp): the chain's dof are compute temp/sphere's, 2 dim
    a finite-radius atom and dim a point atom, less dim."""
    from lidp_tpu_torch.integrate.nvt import NVTParams

    a = list(spec.args)
    if len(a) != 4 or a[0] != "temp":
        raise NotImplementedError(
            f"fix nvt/sphere {' '.join(a)}: temp Tstart Tstop Tdamp alone "
            f"(the JAX package reads no other keyword; {_SKIPPED})")
    ng = int(np.count_nonzero(active[:n]))
    nfin = int(np.count_nonzero(active[:n] & (radius[:n] > 0)))
    gdof = (2 * dim_ * nfin + dim_ * (ng - nfin)) - dim_
    return NVTParams.create(
        script.dt, u.ftm2v, rmass, float(a[1]), float(a[3]), dof=gdof,
        boltz=u.boltz, mvv2e=u.mvv2e, t_stop=float(a[2]), dtype=dtype,
        device=device)


def build_granular_sim(script, u, dtype, device):
    """The Simulation of a pair gran/* script, set up (the JAX package's
    _build_granular_sim with its from_script padding)."""
    from lidp_tpu_torch.box import Box
    from lidp_tpu_torch.pour import parse_pour
    from lidp_tpu_torch.sim import Simulation
    from lidp_tpu_torch.state import make_system
    from lidp_tpu_torch.thermo import ThermoParams

    if script.radius is None:
        raise ValueError("pair gran/* requires atom_style sphere data")
    n = script.x.shape[0]
    dim_ = script.dimension
    fixes = list(script.fixes.values())
    # fix pour: the whole insertion budget in padded slots from setup
    npad = n + sum(int(f.args[0]) for f in fixes if f.style == "pour")

    def pad(a, fill=0.0):
        a = np.asarray(a)
        out = np.full((npad,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return out

    # inserted atoms join group all at insertion: its mask covers the
    # padded slots (the System's mask gates the atoms that exist)
    groups = {k: pad(v, False) for k, v in script.groups.items()}
    groups["all"] = np.ones(npad, bool)
    radius = pad(script.radius, 0.0)
    rmass = pad(script.rmass, 1.0)
    box = Box.create(script.box_lo, script.box_hi, dtype=dtype,
                     periodic=script.periodic, tilt=script.box_tilt,
                     device=device)
    sys = make_system(
        pad(script.x), box=box, v=pad(script.v), q=pad(script.q),
        type=pad(script.type, 0), mol=pad(script.mol, 0),
        alpha=pad(script.alpha_type[script.type]),
        image=pad(script.image, 0), mask=np.arange(npad) < n, dtype=dtype,
        device=device).replace(step=int(script.step))

    frozen = np.zeros(npad, bool)
    active = np.ones(npad, bool)
    grav = np.zeros(3)
    grav_mag = 0.0
    nvt_spec = None
    walls = []
    pour_specs = []
    for spec in fixes:
        if spec.style == "freeze":
            frozen = np.asarray(groups[spec.group], bool)
        elif spec.style in ("wall/gran", "wall/gran/region"):
            walls.append(parse_wall_gran(script, spec, groups, u, device))
        elif spec.style == "pour":
            pour_specs.append(spec)
        elif spec.style == "gravity":
            grav_mag, grav = _gravity(spec)
        elif spec.style in ("nve/sphere", "nvt/sphere"):
            active = np.asarray(groups[spec.group], bool)
            if spec.style == "nvt/sphere":
                nvt_spec = spec
        elif spec.style not in ("print", "ave/time"):
            raise NotImplementedError(
                f"fix style {spec.style} on granular systems (the JAX "
                "package's granular route takes freeze, gravity, "
                "nve/sphere, nvt/sphere, wall/gran, wall/gran/region, "
                "pour, print and ave/time)")
    if script._thermo_temp is not None:
        raise NotImplementedError(
            f"thermo_modify temp on a granular system (the JAX package's "
            f"granular route ignores it; {_SKIPPED})")
    excl = None
    if script.neigh_exclude_group is not None:
        excl = np.asarray(groups[script.neigh_exclude_group], bool)
    if script.neigh_exclude_types or script.neigh_exclude_mol:
        raise NotImplementedError(
            "neigh_modify exclude type|molecule on a granular system (the "
            f"JAX package's granular route ignores them; {_SKIPPED})")

    kind = script.pair.name[len("gran/"):]
    gp = gran.make_gran_params(script.gran_args, radius, rmass, frozen,
                               excl=excl, dt=script.dt, dtype=dtype,
                               kind=kind, device=device)
    pours = []
    if pour_specs:
        if grav_mag <= 0.0:
            raise ValueError("No fix gravity defined for fix pour")
        pours = [parse_pour(spec, script, grav_mag, u.ftm2v)
                 for spec in pour_specs]

    L = script.box_hi - script.box_lo
    rad_max = float(np.max(script.radius)) if n else 0.0
    for pf in pours:
        rad_max = max(rad_max, pf.radius_one, pf.radius_hi)
    ncfg = CellConfig.for_box(L, 2.0 * rad_max + script.skin,
                              density=(npad if pours else n)
                              / float(np.prod(L)), cap_slack=5.0)
    nvt = None
    if nvt_spec is not None:
        nvt = _nvt_sphere(script, nvt_spec, u, rmass, active, radius, n,
                          dim_, dtype, device)
    runner = GranRunner(
        gp=gp, neighbor_cfg=ncfg, dt=script.dt, ftm2v=u.ftm2v,
        gmask=torch.as_tensor(active, device=device),
        grav=torch.as_tensor(grav, dtype=dtype, device=device),
        skin=script.skin, shrink=_shrink(script),
        rebuild_every=script.neigh_every, delay=script.neigh_delay,
        check=script.neigh_check, nvt=nvt, walls=tuple(walls),
        omega0=torch.as_tensor(pad(script.omega, 0.0), dtype=dtype,
                               device=device))

    norm = script._thermo_norm
    tp = ThermoParams.create(
        rmass, dof=dim_ * n - dim_, units=u,
        norm=(u.name == "lj") if norm is None else norm, natoms=n,
        dim=dim_, dtype=dtype, device=device)
    sim = Simulation(script, sys, runner, tp, n)
    sim.pour_fixes = pours
    sim.gran_radius, sim.gran_rmass = gp.radius, gp.rmass
    for cid, spec_c in script.computes.items():
        gname, style = spec_c[0], spec_c[1]
        gm = groups[gname]
        if style not in GRAN_COMPUTES:
            raise NotImplementedError(
                f"compute {cid} {style} on a granular system (the JAX "
                f"package's granular route reads the sphere computes and "
                f"reduce alone; {_DROPPED})")
        if style == "erotate/sphere":
            sim.erotate_computes[cid] = gm
        elif style == "temp/sphere":
            sim.tempsphere_computes[cid] = gm
        elif style == "reduce":
            for tok in spec_c[2]["inputs"]:
                ref = script.computes.get(tok[2:].split("[")[0])
                if not tok.startswith("c_") or ref is None or ref[1] not in (
                        "erotate/sphere/atom", "contact/atom"):
                    raise NotImplementedError(
                        f"compute reduce input {tok} on a granular system "
                        "(erotate/sphere/atom and contact/atom: ROADMAP "
                        "queue 1 item 6, breadth)")
            sim.reduce_computes[cid] = (gm, spec_c[2])
        else:
            sim.peratom_computes[cid] = (gm, style, spec_c[2])
    sim.sys, sim.res, sim.nlist, sim.istate = runner.setup(sys)
    if bool(sim.nlist.overflow):
        raise RuntimeError("granular cell capacity overflow at setup")
    return sim
