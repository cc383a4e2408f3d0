"""The port's bonded terms (lidp_tpu_torch/ops/bonded.py) and their builders
(lidp_tpu_torch/styles/bonded_builders.py) against the JAX package's,
float64 on the CPU.

Each case builds the same style from the same script state in both
packages (a stand-in for the interpreter: the term lists, the coefficient
lines, the atom types and charges), checks that the port's builder gives
the JAX builder's tables bit for bit, then evaluates each package's params
on the same random geometry: four-atom chains in a periodic box of
9 x 10 x 11, wrapped into the box, so that many terms cross its faces.
The forces, the energy and the virial agree at rel 1e-10 of the largest
entry of each.  Every bond style (table from a file written to tmp_path,
quartic with and without its lj/cut pair subtraction, hybrid), every angle
style (table, hybrid), every dihedral style (charmm with its weighted 1-4
term, hybrid) and every improper style (umbrella through autograd,
hybrid); charmmfsw's 1-4 form from the JAX params.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from lidp_tpu.box import Box as JBox  # noqa: E402
from lidp_tpu.ops import bonded as jb  # noqa: E402
from lidp_tpu.styles import bonded_builders as jbb  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.box import Box  # noqa: E402
from lidp_tpu_torch.ops import bonded as tb  # noqa: E402
from lidp_tpu_torch.styles import bonded_builders as tbb  # noqa: E402
from lidp_tpu_torch.units import REAL  # noqa: E402

L = np.array([9.0, 10.0, 11.0])
NMOL = 24
TOL = 1e-10


def _chains(seed=7):
    """NMOL four-atom chains (bond 1.0-1.6, bend 60-150 degrees) from
    random points of the box, wrapped into it: (x (4*NMOL, 3), the chains'
    atom indices (NMOL, 4))."""
    rng = np.random.RandomState(seed)
    xs = []
    for _ in range(NMOL):
        p = [rng.uniform(0, 1, 3) * L]
        prev = None
        while len(p) < 4:
            u = rng.normal(size=3)
            u /= np.linalg.norm(u)
            if prev is not None:
                c = float(np.dot(-prev, u))
                if not np.cos(np.deg2rad(150)) < c < np.cos(np.deg2rad(60)):
                    continue
            p.append(p[-1] + rng.uniform(1.0, 1.6) * u)
            prev = u
        xs += p
    x = np.array(xs)
    x = x - np.floor(x / L) * L
    return x, np.arange(4 * NMOL).reshape(NMOL, 4)


X, CHAINS = _chains()
NATOMS = X.shape[0]
TYPES = np.random.RandomState(3).randint(1, 4, NATOMS)
Q = np.random.RandomState(4).uniform(-0.5, 0.5, NATOMS)


def _script(tmp_path, **kw):
    """The interpreter state the builders read (1-based term lists)."""
    ch = CHAINS + 1
    rng = np.random.RandomState(11)
    base = dict(
        root=str(tmp_path), ntypes=3, type=TYPES, q=Q, _pair_shift=False,
        _bonds=np.concatenate([ch[:, :2], ch[:, 1:3], ch[:, 2:]]),
        _angles=np.concatenate([ch[:, :3], ch[:, 1:]]),
        _dihedrals=ch, _impropers=ch[:, [1, 0, 2, 3]],
        pair_coeffs14={(2, 2): (0.3, 2.9), (1, 3): (0.05, 3.3)})
    base["_bond_types"] = rng.randint(1, 3, len(base["_bonds"]))
    base["_angle_types"] = rng.randint(1, 3, len(base["_angles"]))
    base["_dihedral_types"] = rng.randint(1, 3, NMOL)
    base["_improper_types"] = rng.randint(1, 3, NMOL)
    base.update(kw)
    return SimpleNamespace(**base)


def _jbox():
    return JBox.create([0.0, 0.0, 0.0], L)


def _tbox():
    return Box.create([0.0, 0.0, 0.0], L, dtype=torch.float64)


def _fields(p):
    import dataclasses

    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


def _same_tables(jp, tp):
    """The port's params hold the JAX builder's tables bit for bit."""
    for name, v in _fields(jp).items():
        w = getattr(tp, name)
        if v is None:
            assert w is None, name
            continue
        a = np.asarray(v)
        b = w.numpy() if torch.is_tensor(w) else np.asarray(w)
        if a.dtype.kind in "iu":
            b = b.astype(a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)


def _close(got, want, msg):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    big = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * big,
                               err_msg=msg)


def _compare(jfn, tfn, jps, tps, tag, x=X):
    """Each pair of params: the terms' outputs on positions x agree (f,
    energy, virial, and whatever follows)."""
    assert len(jps) == len(tps) > 0
    xt = torch.as_tensor(x)
    for jp, tp in zip(jps, tps):
        assert jp.style == tp.style
        _same_tables(jp, tp)
        jout = jax.jit(jfn)(jnp.asarray(x), _jbox(), jp)
        tout = tfn(xt, _tbox(), tp)
        assert len(jout) == len(tout)
        for k, (a, b) in enumerate(zip(tout, jout)):
            _close(a, b, f"{tag} {jp.style} output {k}")
        # the energy and the force are those of one function: the port's
        # forces balance
        np.testing.assert_allclose(tout[0].sum(0).numpy(), 0.0,
                                   atol=1e-9 * float(tout[0].abs().max()))


# ---------------------------------- bonds ----------------------------------

BOND_CASES = {
    "harmonic": ("harmonic", [], {1: [300.0, 1.1], 2: [150.0, 1.4]}),
    "fene": ("fene", [], {1: [30.0, 2.2, 1.0, 1.0], 2: [20.0, 2.5, 0.5,
                                                         1.1]}),
    "fene/expand": ("fene/expand", [], {1: [30.0, 2.2, 1.0, 0.9, 0.1],
                                        2: [20.0, 2.5, 0.5, 1.0, -0.1]}),
    "morse": ("morse", [], {1: [5.0, 1.5, 1.2], 2: [3.0, 2.0, 1.3]}),
    "nonlinear": ("nonlinear", [], {1: [5.0, 1.2, 1.5], 2: [3.0, 1.3, 2.0]}),
    "gromos": ("gromos", [], {1: [40.0, 1.2], 2: [60.0, 1.35]}),
    "quartic": ("quartic", [], {1: [120.0, -0.55, 0.25, 1.8, 3.0],
                                2: [100.0, -0.5, 0.2, 1.7, 2.0]}),
    "zero": ("zero", [], {1: [], 2: []}),
    "table": ("table", ["linear", "101"], {1: ["bond.table", "B1"],
                                          2: ["bond.table", "B2"]}),
    "hybrid": ("hybrid", ["harmonic", "morse"],
               {1: ["harmonic", 300.0, 1.1], 2: ["morse", 3.0, 2.0, 1.3]}),
}


def _write_tables(tmp_path):
    """bond.table (B1 uniform in r, B2 not) and angle.table (A1, A2)."""
    r = np.linspace(0.8, 2.0, 101)
    r2 = 0.8 + 1.2 * np.linspace(0.0, 1.0, 101) ** 1.3
    lines = []
    for name, rr, k, r0 in (("B1", r, 200.0, 1.2), ("B2", r2, 90.0, 1.4)):
        lines += [name, f"N {len(rr)}", ""]
        lines += [f"{i + 1} {float(v)!r} {float(k * (v - r0) ** 2)!r} "
                  f"{float(-2.0 * k * (v - r0))!r}"
                  for i, v in enumerate(rr)]
        lines.append("")
    (tmp_path / "bond.table").write_text("\n".join(lines))
    th = np.linspace(0.0, 180.0, 181)
    lines = []
    for name, k, t0 in (("A1", 50.0, 110.0), ("A2", 30.0, 95.0)):
        d = np.deg2rad(th - t0)
        lines += [name, f"N {len(th)}", ""]
        lines += [f"{i + 1} {float(v)!r} {float(k * dd * dd)!r} "
                  f"{float(-2.0 * k * dd * np.pi / 180.0)!r}"
                  for i, (v, dd) in enumerate(zip(th, d))]
        lines.append("")
    (tmp_path / "angle.table").write_text("\n".join(lines))


@pytest.mark.parametrize("case", list(BOND_CASES))
def test_bond_styles_match_jax(tmp_path, case):
    _write_tables(tmp_path)
    style, args, coeffs = BOND_CASES[case]
    s = _script(tmp_path, bond_style=style, bond_style_args=args,
                bond_coeffs=coeffs)
    keep = np.ones(len(s._bonds), bool)
    keep[::5] = False        # bonds a constraint fix takes out
    jps = jbb.build_bond_params(s, jnp.float64, keep)
    tps = tbb.build_bond_params(s, torch.float64, keep)
    _compare(jb.bond_forces, tb.bond_forces, jps, tps, "bond")


@pytest.mark.parametrize("subtract", [False, True])
def test_bond_quartic_full_matches_jax(tmp_path, subtract):
    """quartic's bond part and its lj/cut pair subtraction, split out."""
    style, args, coeffs = BOND_CASES["quartic"]
    s = _script(tmp_path, bond_style=style, bond_style_args=args,
                bond_coeffs=coeffs)
    tables = None
    if subtract:
        eps = np.array([[0, 0, 0, 0], [0, 1.0, 0.8, 0.9], [0, 0.8, 1.1, 0.7],
                        [0, 0.9, 0.7, 0.6]])
        sig = np.full((4, 4), 1.05)
        tables = (eps, sig, np.full((4, 4), 2.5))
    jps = jbb.build_bond_params(s, jnp.float64, None, tables)
    tps = tbb.build_bond_params(s, torch.float64, None, tables)
    # stretch a bond past Rc: broken, masked out
    x = X.copy()
    x[1] = x[0] + np.array([1.9, 0.0, 0.0])
    _compare(jb.bond_quartic_full, tb.bond_quartic_full, jps, tps,
             "quartic full", x=x)
    _compare(jb.bond_forces, tb.bond_forces, jps, tps, "quartic", x=x)


# ---------------------------------- angles ---------------------------------

ANGLE_CASES = {
    "harmonic": ("harmonic", [], {1: [50.0, 110.0], 2: [30.0, 95.0]}),
    "charmm": ("charmm", [], {1: [50.0, 110.0, 20.0, 2.1],
                              2: [30.0, 95.0, 0.0, 0.0]}),
    "cosine": ("cosine", [], {1: [50.0], 2: [30.0]}),
    "cosine/squared": ("cosine/squared", [], {1: [50.0, 110.0],
                                              2: [30.0, 95.0]}),
    "cosine/delta": ("cosine/delta", [], {1: [50.0, 110.0],
                                          2: [30.0, 95.0]}),
    "cosine/periodic": ("cosine/periodic", [], {1: [50.0, 1, 3],
                                                2: [30.0, -1, 4]}),
    "zero": ("zero", [], {1: [], 2: []}),
    "table": ("table", ["linear", "181"], {1: ["angle.table", "A1"],
                                          2: ["angle.table", "A2"]}),
    "hybrid": ("hybrid", ["charmm", "cosine/periodic"],
               {1: ["charmm", 50.0, 110.0, 20.0, 2.1],
                2: ["cosine/periodic", 30.0, -1, 2]}),
}


@pytest.mark.parametrize("case", list(ANGLE_CASES))
def test_angle_styles_match_jax(tmp_path, case):
    _write_tables(tmp_path)
    style, args, coeffs = ANGLE_CASES[case]
    s = _script(tmp_path, angle_style=style, angle_style_args=args,
                angle_coeffs=coeffs)
    keep = np.ones(len(s._angles), bool)
    keep[::7] = False
    jps = jbb.build_angle_params(s, jnp.float64, keep)
    tps = tbb.build_angle_params(s, torch.float64, keep)
    _compare(jb.angle_forces, tb.angle_forces, jps, tps, "angle")


# -------------------------------- dihedrals --------------------------------

DIHEDRAL_CASES = {
    "opls": ("opls", [], {1: [1.3, -0.05, 0.2, 0.1], 2: [0.5, 0.3, -0.2,
                                                         0.05]}),
    "harmonic": ("harmonic", [], {1: [1.2, 1, 2], 2: [0.7, -1, 3]}),
    "charmm": ("charmm", [], {1: [0.6, 3, 180, 1.0], 2: [2.5, 2, 0, 0.5]}),
    "multi/harmonic": ("multi/harmonic", [], {1: [1.0, -0.5, 0.3, 0.2,
                                                  -0.1],
                                              2: [0.4, 0.2, -0.3, 0.1,
                                                  0.05]}),
    "helix": ("helix", [], {1: [1.0, 0.5, 0.3], 2: [0.2, 0.8, 0.1]}),
    "zero": ("zero", [], {1: [], 2: []}),
    "hybrid": ("hybrid", ["charmm", "opls"],
               {1: ["charmm", 0.6, 3, 180, 0.5],
                2: ["opls", 1.3, -0.05, 0.2, 0.1]}),
}


def _pair_tables():
    eps = np.array([[0, 0, 0, 0], [0, 0.1, 0.12, 0.08], [0, 0.12, 0.2, 0.1],
                    [0, 0.08, 0.1, 0.05]])
    sig = np.array([[0, 0, 0, 0], [0, 3.0, 3.1, 3.2], [0, 3.1, 3.3, 3.0],
                    [0, 3.2, 3.0, 3.5]])
    return eps, sig


@pytest.mark.parametrize("case", list(DIHEDRAL_CASES))
def test_dihedral_styles_match_jax(tmp_path, case):
    style, args, coeffs = DIHEDRAL_CASES[case]
    s = _script(tmp_path, dihedral_style=style, dihedral_style_args=args,
                dihedral_coeffs=coeffs)
    eps, sig = _pair_tables()
    jps = jbb.build_dihedral_params(s, jnp.float64, REAL, eps, sig)
    tps = tbb.build_dihedral_params(s, torch.float64, REAL, eps, sig)
    _compare(jb.dihedral_forces, tb.dihedral_forces, jps, tps, "dihedral")
    charmm = [(j, t) for j, t in zip(jps, tps) if j.style == "charmm"]
    assert bool(charmm) == (case in ("charmm", "hybrid"))
    if charmm:
        _compare(jb.charmm_14_forces, tb.charmm_14_forces,
                 [j for j, _ in charmm], [t for _, t in charmm], "1-4")


@pytest.mark.parametrize("dihedflag", [0, 1])
def test_charmmfsw_14_form_matches_jax(tmp_path, dihedflag):
    """charmmfsw's 1-4 form (its offsets; the shifted coulomb with the
    charmmfsh pair, plain 1/r with coul/long) from the JAX params."""
    import dataclasses

    s = _script(tmp_path, dihedral_style="charmm", dihedral_style_args=[],
                dihedral_coeffs=DIHEDRAL_CASES["charmm"][2])
    eps, sig = _pair_tables()
    jp = dataclasses.replace(
        jbb.build_dihedral_params(s, jnp.float64, REAL, eps, sig)[0],
        style="charmmfsw", cut_lj_inner14=8.0, cut_lj14=10.0,
        cut_coul14=12.0, dihedflag=dihedflag)
    tp = convert.bonded_from_numpy(
        tb.DihedralParams, {k: (v if k == "style" or v is None
                                else np.array(v))
                            for k, v in _fields(jp).items()}, device="cpu")
    _compare(jb.charmm_14_forces, tb.charmm_14_forces, [jp], [tp], "fsw 1-4")
    _compare(jb.dihedral_forces, tb.dihedral_forces, [jp], [tp], "fsw")


# -------------------------------- impropers --------------------------------

IMPROPER_CASES = {
    "harmonic": ("harmonic", [], {1: [20.0, 0.0], 2: [40.0, 35.0]}),
    "cvff": ("cvff", [], {1: [2.0, -1, 2], 2: [1.0, 1, 3]}),
    "umbrella": ("umbrella", [], {1: [5.0, 30.0], 2: [3.0, 0.0]}),
    "zero": ("zero", [], {1: [], 2: []}),
    "hybrid": ("hybrid", ["harmonic", "umbrella"],
               {1: ["harmonic", 20.0, 10.0], 2: ["umbrella", 5.0, 40.0]}),
}


@pytest.mark.parametrize("case", list(IMPROPER_CASES))
def test_improper_styles_match_jax(tmp_path, case):
    style, args, coeffs = IMPROPER_CASES[case]
    s = _script(tmp_path, improper_style=style, improper_style_args=args,
                improper_coeffs=coeffs)
    jps = jbb.build_improper_params(s, jnp.float64)
    tps = tbb.build_improper_params(s, torch.float64)
    _compare(jb.improper_forces, tb.improper_forces, jps, tps, "improper")


def test_closed_forms_are_energy_gradients():
    """The closed-form forces of the angle, dihedral and improper terms
    equal -dE/dx by torch.autograd of the port's own energies, and their
    virial the sum of x (x) f over the unwrapped chain."""
    rng = np.random.RandomState(2)
    x = torch.tensor(X, requires_grad=True)
    box = _tbox()
    i4 = torch.as_tensor(CHAINS)
    t = torch.as_tensor(rng.randint(1, 3, NMOL))
    dp = tb.DihedralParams(
        idx=i4, dtype_=t, c1=torch.tensor([0.0, 0.6, 2.5]),
        c2=torch.tensor([0.0, 3.0, 2.0]), c3=torch.tensor([0.0, 3.1, 0.0]),
        c4=torch.zeros(3), style="charmm")
    ip = tb.ImproperParams(idx=i4[:, [1, 0, 2, 3]], itype=t,
                           k=torch.tensor([0.0, 20.0, 40.0]),
                           chi0=torch.tensor([0.0, 0.3, -0.5]))
    ap = tb.AngleParams(idx=i4[:, :3], atype=t,
                        k=torch.tensor([0.0, 50.0, 30.0]),
                        theta0=torch.tensor([0.0, 1.9, 1.6]),
                        k_ub=torch.tensor([0.0, 20.0, 5.0]),
                        r_ub=torch.tensor([0.0, 2.1, 2.4]), style="charmm")
    for fn, p in ((tb.dihedral_forces, dp), (tb.improper_forces, ip),
                  (tb.angle_forces, ap)):
        f, e, _ = fn(x, box, p)
        (g,) = torch.autograd.grad(e, x)
        _close(f.detach(), -g.numpy(), fn.__name__)
