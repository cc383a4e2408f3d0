"""pair_style eam, eam/alloy and eam/fs through the port (ops/eam.py, the
cell grid's two passes, and bench/in.eam from a script) against the JAX
package's, on the CPU, both packages in one process:

  * the potentials are chip_smoke's synthetic files (eam_funcfl_case,
    eam_setfl_case), written from closed forms in place of Cu_u3.eam,
    AlCu.eam.alloy and CuZr_mm.eam.fs, which are not in the repo;
  * the readers and every table (the splines, the segment coefficients,
    the masses, the type -> element map) equal to JAX's bit for bit in
    float64, and convert.eam_from_numpy's copy of JAX's params equal to
    the port's own;
  * eam_cell_forces and eam_alloy_cell_forces (alloy and fs) on a jittered
    fcc block of 5^3 unit cells (500 atoms, 3 bins a side at cut + skin)
    with each package's own cells: forces within rel 1e-10 of max |f|,
    energy and virial within rel 1e-10, need_ev on and off, in float64;
    float32 within 1e-5;
  * EAM_SCRIPT cut to the 5^3 region, `thermo 1`, `run 3`, through
    `python -m lidp_tpu` and `python -m lidp_tpu_torch -device cpu` for
    each style: every row within rel 1e-8 of max(1, |value|), the bar of
    the earlier slices;
  * the port against itself: a single-element setfl written from the
    synthetic funcfl gives the funcfl rows at rel 1e-12; forces are -grad E
    by central differences (the JAX package's own bar); the synthetic Cu
    lattice is bound, stable and conserves TotEng within 2e-4 over 20
    steps in float64;
  * the errors: triclinic with EAM, a box under 3 cells a side, EAM on the
    dense route, and pair_coeff's wrong element count and unknown element.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time, as the port's other parity files: under
# pytest-xdist torch's threads spin on the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu.box import Box as JBox  # noqa: E402
from lidp_tpu.forcefield import ForceField as JForceField  # noqa: E402
from lidp_tpu.forcefield import compute_forces as jcompute  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu.ops import cells as jcells  # noqa: E402
from lidp_tpu.ops import eam as jeam  # noqa: E402
from lidp_tpu.state import make_system as jmake_system  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.box import Box  # noqa: E402
from lidp_tpu_torch.forcefield import (ForceField, compute_forces,  # noqa: E402
                                       pair_route)
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.ops import cells as tcells  # noqa: E402
from lidp_tpu_torch.ops import eam as team  # noqa: E402
from lidp_tpu_torch.state import make_system  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("eam", "alloy", "fs")
COLS = ("temp", "epair", "etotal", "press")
ROWS = 1e-8
NSTEP = 3
A0 = 3.615
SKIN = 1.0
# the 5^3 region of in.eam's 20^3 (its `variable x index 1` scales it)
SMALL = dict(x="0.25", y="0.25", z="0.25")


def small_text(text, nstep=NSTEP):
    """An EAM script with a row each step and `run nstep`, its lines at
    16 digits."""
    return text.replace("thermo\t\t50", "thermo 1\nthermo_modify format "
                        "float %.16g").replace("run\t\t100",
                                               f"run\t\t{nstep}")


def script_text(kind):
    if kind == "eam":
        return chip_smoke.EAM_SCRIPT
    return chip_smoke.eam_alloy_script(fs=kind == "fs")


@pytest.fixture(scope="module")
def pots(tmp_path_factory):
    """The directory holding the three synthetic potentials, and their
    paths by kind."""
    d = tmp_path_factory.mktemp("eam_pots")
    return d, {"eam": chip_smoke.eam_funcfl_case(str(d)),
               "alloy": chip_smoke.eam_setfl_case(str(d)),
               "fs": chip_smoke.eam_setfl_case(str(d), fs=True)}


def _lattice(n_side=5, a=A0, jitter=0.1, seed=7):
    """fcc block of n_side^3 unit cells, each site jittered up to
    +-jitter A from the seed; (x, L, types 1/2 drawn from the seed)."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    x = ((g[:, None, :] + base[None]) * a).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    x = x + rng.uniform(-jitter, jitter, x.shape)
    L = n_side * a
    return np.mod(x, L), L, rng.integers(1, 3, len(x)).astype(np.int32)


def _jax_params(kind, path, dtype):
    if kind == "eam":
        return jeam.build_eam_params(path, dtype=dtype)
    return jeam.build_eam_alloy_params(path, ["Cu", "Al"], dtype=dtype,
                                       fs=kind == "fs")


def _port_params(kind, path, dtype):
    if kind == "eam":
        return team.build_eam_params(path, dtype=dtype, device="cpu")
    return team.build_eam_alloy_params(path, ["Cu", "Al"], dtype=dtype,
                                       device="cpu", fs=kind == "fs")


def _jax_forces(kind, p, x, L, types, dtype, need_ev=True, cut=None):
    n = len(x)
    box = JBox.create(np.zeros(3), np.full(3, L), dtype=dtype)
    cfg = jcells.CellConfig.for_box(np.full(3, L), cut or
                                    float(p.cut) + SKIN,
                                    density=n / L ** 3, cap_slack=1.7)
    xj = jnp.asarray(x, dtype)
    mask = jnp.ones(n, bool)
    cells = jcells.build_cells(xj, mask, box, cfg)
    if kind == "eam":
        out = jeam.eam_cell_forces(xj, mask, cells, box, p, need_ev=need_ev)
    else:
        out = jeam.eam_alloy_cell_forces(xj, jnp.asarray(types), mask, cells,
                                         box, p, need_ev=need_ev)
    return [np.asarray(o) for o in out]


def _port_forces(kind, p, x, L, types, dtype, need_ev=True, cut=None):
    n = len(x)
    box = Box.create(np.zeros(3), np.full(3, L), dtype=dtype)
    cfg = tcells.CellConfig.for_box(np.full(3, L), cut or
                                    float(p.cut) + SKIN,
                                    density=n / L ** 3, cap_slack=1.7)
    xt = torch.as_tensor(x, dtype=dtype)
    mask = torch.ones(n, dtype=torch.bool)
    cells = tcells.build_cells(xt, mask, box, cfg)
    if kind == "eam":
        out = team.eam_cell_forces(xt, mask, cells, box, p, need_ev=need_ev)
    else:
        out = team.eam_alloy_cell_forces(xt, torch.as_tensor(types), mask,
                                         cells, box, p, need_ev=need_ev)
    return [o.numpy() for o in out]


# ------------------------------------------------------------- tables

@pytest.mark.parametrize("kind", KINDS)
def test_readers_and_tables_match_jax_bit_for_bit(pots, kind):
    path = pots[1][kind]
    if kind == "eam":
        dj, dt = jeam.read_funcfl(path), team.read_funcfl(path)
    else:
        dj = jeam.read_setfl(path, fs=kind == "fs")
        dt = team.read_setfl(path, fs=kind == "fs")
    assert dj.keys() == dt.keys()
    for k in dj:
        a, b = dj[k], dt[k]
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        elif isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            for u, v in zip(a, b, strict=True):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    pj, mj = _jax_params(kind, path, jnp.float64)
    pt, mt = _port_params(kind, path, torch.float64)
    np.testing.assert_array_equal(np.asarray(mj), np.asarray(mt))
    fields = {f: np.asarray(getattr(pj, f)) for f in pj.__dataclass_fields__}
    for name, want in fields.items():
        got = getattr(pt, name)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, want, err_msg=name)
    # convert's copy of JAX's params is the port's own
    pc = convert.eam_from_numpy(fields, device="cpu")
    assert type(pc) is type(pt)
    for name in pt.__dataclass_fields__:
        a, b = getattr(pc, name), getattr(pt, name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name


def test_splines_and_fit_match_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    f = np.cumsum(rng.uniform(-1.0, 1.0, 200))
    sj, st = jeam.lammps_spline(f, 0.05), team.lammps_spline(f, 0.05)
    np.testing.assert_array_equal(sj, st)
    xs = rng.uniform(0.0, 9.9, 3000)
    np.testing.assert_array_equal(jeam.spline_value(sj, 0.05, xs),
                                  team.spline_value(st, 0.05, xs))
    np.testing.assert_array_equal(jeam.spline_deriv(sj, 0.05, xs),
                                  team.spline_deriv(st, 0.05, xs))
    ys = np.sin(xs)
    np.testing.assert_array_equal(jeam._fit_segments(xs, ys, 16, 5, 9.9),
                                  team._fit_segments(xs, ys, 16, 5, 9.9))


# ---------------------------------------------------------- cell forces

@pytest.mark.parametrize("need_ev", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_cell_forces_match_jax_float64(pots, kind, need_ev):
    path = pots[1][kind]
    x, L, types = _lattice()
    pj, _ = _jax_params(kind, path, jnp.float64)
    pt, _ = _port_params(kind, path, torch.float64)
    fj, ej, vj = _jax_forces(kind, pj, x, L, types, jnp.float64, need_ev)
    ft, et, vt = _port_forces(kind, pt, x, L, types, torch.float64, need_ev)
    fmax = np.abs(fj).max()
    assert fmax > 0.1
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-10 * fmax)
    assert et == pytest.approx(float(ej), rel=1e-10)
    if need_ev:
        np.testing.assert_allclose(vt, vj, rtol=0,
                                   atol=1e-10 * np.abs(vj).max())
    else:
        assert not np.any(vt) and not np.any(vj)


@pytest.mark.parametrize("kind", KINDS)
def test_cell_forces_match_jax_float32(pots, kind):
    path = pots[1][kind]
    x, L, types = _lattice(seed=11)
    pj, _ = _jax_params(kind, path, jnp.float32)
    pt, _ = _port_params(kind, path, torch.float32)
    fj, ej, vj = _jax_forces(kind, pj, x, L, types, jnp.float32)
    ft, et, vt = _port_forces(kind, pt, x, L, types, torch.float32)
    assert ft.dtype == np.float32
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-5 * np.abs(fj).max())
    assert et == pytest.approx(float(ej), rel=1e-5)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5 * np.abs(vj).max())


def test_grouping_changes_only_the_order_of_the_sums(pots, monkeypatch):
    """One offset a group against all 14 in one: the same forces to the
    order of the sums."""
    path = pots[1]["alloy"]
    x, L, types = _lattice(seed=5)
    pt, _ = _port_params("alloy", path, torch.float64)
    whole = _port_forces("alloy", pt, x, L, types, torch.float64)
    monkeypatch.setattr(team, "GROUP_PAIRS", 1)
    single = _port_forces("alloy", pt, x, L, types, torch.float64)
    np.testing.assert_allclose(single[0], whole[0], rtol=0,
                               atol=1e-12 * np.abs(whole[0]).max())
    assert single[1] == pytest.approx(whole[1], rel=1e-13)


@pytest.mark.parametrize("kind", KINDS)
def test_forces_are_minus_the_energy_gradient(pots, kind):
    """Central differences of the port's float64 energy at a few
    coordinates against its forces, at the JAX package's own bar
    (tests/test_eam_alloy.py: 1e-5 of max(1, |f|))."""
    path = pots[1][kind]
    x, L, types = _lattice(seed=13)
    pt, _ = _port_params(kind, path, torch.float64)
    f = _port_forces(kind, pt, x, L, types, torch.float64)[0]
    rng = np.random.default_rng(2)
    h = 1e-5
    for i, d in zip(rng.integers(0, len(x), 4), rng.integers(0, 3, 4)):
        e = []
        for sgn in (1.0, -1.0):
            xs = x.copy()
            xs[i, d] += sgn * h
            e.append(float(_port_forces(kind, pt, xs, L, types,
                                        torch.float64)[1]))
        fd = -(e[0] - e[1]) / (2.0 * h)
        assert abs(fd - f[i, d]) < 1e-5 * max(1.0, abs(f[i, d])), (i, d)


# --------------------------------------------------- the synthetic potential

def _lattice_energy(path, a):
    """E_pair per atom of the perfect fcc lattice at constant a (5^3
    unit cells, cells of the bare cutoff so that 3 fit a side)."""
    x, L, types = _lattice(a=a, jitter=0.0)
    p, _ = _port_params("eam", path, torch.float64)
    _, e, _ = _port_forces("eam", p, x, L, types, torch.float64,
                           cut=float(p.cut))
    return float(e) / len(x)


def test_synthetic_lattice_is_bound(pots):
    assert _lattice_energy(pots[1]["eam"], A0) < 0.0


def test_synthetic_lattice_is_stable(pots):
    path = pots[1]["eam"]
    e0 = _lattice_energy(path, A0)
    assert e0 < _lattice_energy(path, 3.50)
    assert e0 < _lattice_energy(path, 3.75)


def _port_run(directory, text, dtype=torch.float64, variables=SMALL):
    path = Path(directory) / "in.port"
    path.write_text(text)
    s = tscript.LammpsScript(dtype=dtype, device="cpu")
    s.variables.update(variables)
    s.file(str(path))
    return s


def test_synthetic_funcfl_conserves_energy(pots):
    """Path X64's float64 run at 5^3, 20 steps: TotEng within 2e-4
    relative of step 0's at every step (JAX's tests/test_eam_bench.py
    bar; the synthetic tables fit their segments well enough that the
    drift is velocity Verlet's own at in.eam's 5 fs, which falls as
    dt^2)."""
    s = _port_run(pots[0], small_text(chip_smoke.EAM_SCRIPT, nstep=20))
    e = np.array([r["etotal"] for r in s.thermo_rows])
    assert len(e) == 21
    assert np.max(np.abs(e - e[0])) < 2e-4 * abs(e[0])


# ----------------------------------------------------------- the scripts

def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        filter(None, (str(ROOT), os.environ.get("PYTHONPATH")))))


@pytest.fixture(scope="module")
def cli_rows(pots):
    """Each style's small script through both CLIs on the CPU, the six
    processes at once: {kind: (jax rows, port rows)}."""
    d = pots[0]
    procs = {}
    for kind in KINDS:
        (d / f"in.{kind}").write_text(small_text(script_text(kind)))
        for pkg, extra in (("lidp_tpu", []),
                           ("lidp_tpu_torch", ["-device", "cpu"])):
            args = [sys.executable, "-m", pkg, "-in", f"in.{kind}", "-log",
                    f"log.{kind}.{pkg}"] + extra
            for k, v in SMALL.items():
                args += ["-var", k, v]
            procs[kind, pkg] = subprocess.Popen(
                args, cwd=d, env=_env(), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    out = {}
    for (kind, pkg), proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (kind, pkg, err[-3000:])
        out.setdefault(kind, []).append(chip_smoke.log_rows(
            (d / f"log.{kind}.{pkg}").read_text().splitlines()))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_cli_rows_match_jax(cli_rows, kind):
    rows_j, rows_t = cli_rows[kind]
    assert len(rows_t) == NSTEP + 1
    assert rows_t[0]["temp"] == pytest.approx(1600.0, rel=1e-9)
    chip_smoke.rows_agree(kind, rows_t, rows_j, [ROWS] * (NSTEP + 1),
                          cols=COLS)


def test_set_type_fraction_matches_jax(pots):
    d = pots[0]
    text = chip_smoke.eam_alloy_script().split("pair_style")[0]
    path = d / "in.types"
    path.write_text(text)
    sj = jscript.LammpsScript(dtype=jnp.float64)
    st = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    for s in (sj, st):
        s.variables.update(SMALL)
        s.file(str(path))
    np.testing.assert_array_equal(np.asarray(st.type), np.asarray(sj.type))
    frac = float(np.mean(st.type == 2))
    assert 0.4 < frac < 0.6


def test_routes_and_the_grid(pots):
    for kind, route in (("eam", "eam_cell_forces"),
                        ("alloy", "eam_alloy_cell_forces"),
                        ("fs", "eam_alloy_cell_forces")):
        s = _port_run(pots[0], small_text(script_text(kind), nstep=0))
        sim = s._sim
        assert sim.runner.ff.pair is None
        assert pair_route(sim.sys, sim.runner.ff, sim.nlist.nlist) == route
        cfg = sim.runner.neighbor_cfg
        assert cfg.nbins == (3, 3, 3) and cfg.cap == 32
        assert cfg.cutneigh == pytest.approx(5.95)
        # the masses come from the potential file (funcfl's header; each
        # type's element under setfl)
        want = {"eam": [63.55], "alloy": [63.55, 26.98],
                "fs": [63.55, 26.98]}[kind]
        np.testing.assert_array_equal(s.mass_type[1:], want)


def test_setfl_from_funcfl_gives_the_funcfl_rows(pots, tmp_path):
    """A single-element setfl written from the synthetic funcfl
    (z2r = 27.2*0.529*Z^2, everything else copied) gives the funcfl rows
    at rel 1e-12, as JAX's test_eam_alloy.py claims for its own."""
    d = team.read_funcfl(pots[1]["eam"])
    z2r = 27.2 * 0.529 * d["zr"] * d["zr"]
    lines = ["converted from the synthetic funcfl", "#", "#", "1 Cu",
             f"{d['nrho']} {d['drho']!r} {d['nr']} {d['dr']!r} "
             f"{d['cut']!r}", f"29 {d['mass']!r} 3.615 fcc"]
    for arr in (d["frho"], d["rhor"], z2r):
        lines += [" ".join(repr(float(v)) for v in arr[i:i + 5])
                  for i in range(0, len(arr), 5)]
    (tmp_path / "Cu1.eam.alloy").write_text("\n".join(lines) + "\n")
    Path(tmp_path / chip_smoke.EAM_FILE).write_text(
        Path(pots[1]["eam"]).read_text())
    func = _port_run(tmp_path, small_text(chip_smoke.EAM_SCRIPT))
    alloy = _port_run(tmp_path, small_text(chip_smoke.EAM_SCRIPT.replace(
        f"pair_style\team\npair_coeff\t1 1 {chip_smoke.EAM_FILE}",
        "pair_style\team/alloy\npair_coeff\t* * Cu1.eam.alloy Cu")))
    chip_smoke.rows_agree("setfl", alloy.thermo_rows, func.thermo_rows,
                          [1e-12] * (NSTEP + 1), cols=COLS)


# --------------------------------------------------------------- errors

def test_triclinic_with_eam_raises_jax_message(pots, tmp_path):
    msg = "triclinic \\+ eam: the EAM cell kernel is orthogonal-only"
    s = _port_run(pots[0], small_text(chip_smoke.EAM_SCRIPT).split(
        "run\t\t")[0])
    s.box_tilt = np.array([0.5, 0.0, 0.0])
    with pytest.raises(NotImplementedError, match=msg):
        s.one("run 0")
    # the JAX package's own, from a data file with a tilt
    (tmp_path / chip_smoke.EAM_FILE).write_text(
        Path(pots[1]["eam"]).read_text())
    (tmp_path / "data.tri").write_text(
        "tilted\n\n4 atoms\n1 atom types\n\n0 7.23 xlo xhi\n0 7.23 ylo yhi\n"
        "0 7.23 zlo zhi\n0.5 0 0 xy xz yz\n\nMasses\n\n1 63.55\n\n"
        "Atoms # atomic\n\n1 1 0 0 0\n2 1 1.8 1.8 0\n3 1 1.8 0 1.8\n"
        "4 1 0 1.8 1.8\n")
    (tmp_path / "in.tri").write_text(
        "units metal\natom_style atomic\nboundary p p p\nread_data data.tri"
        f"\npair_style eam\npair_coeff 1 1 {chip_smoke.EAM_FILE}\n"
        "fix 1 all nve\nrun 0\n")
    sj = jscript.LammpsScript(dtype=jnp.float64)
    with pytest.raises(NotImplementedError, match=msg):
        sj.file(str(tmp_path / "in.tri"))


def test_box_under_three_cells_raises(pots):
    small = dict(x="0.1", y="0.1", z="0.1")      # 2^3 cells, L = 7.23 A
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1 item 5, neighbour lists"):
        _port_run(pots[0], small_text(chip_smoke.EAM_SCRIPT, nstep=0),
                  variables=small)


def test_dense_route_raises_jax_message(pots):
    x, L, types = _lattice()
    msg = "pair_style eam requires the cell path"
    pt, _ = _port_params("eam", pots[1]["eam"], torch.float64)
    sys_ = make_system(x, box=Box.create(np.zeros(3), np.full(3, L),
                                         dtype=torch.float64),
                       dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match=msg):
        compute_forces(sys_, ForceField(pair=None, eam=pt), nlist=None)
    pj, _ = _jax_params("eam", pots[1]["eam"], jnp.float64)
    sj = jmake_system(x, box=JBox.create(np.zeros(3), np.full(3, L),
                                         dtype=jnp.float64),
                      dtype=jnp.float64)
    with pytest.raises(NotImplementedError, match=msg):
        jcompute(sj, JForceField(pair=None, eam=pj), nlist=None)


@pytest.mark.parametrize("coeff,msg", [
    ("* * {f} Cu", "needs 2 element names, got 1"),
    ("* * {f} Cu Zr", "element Zr not found in"),
    ("1 1 {f} Cu Al", "pair_coeff must be \\* \\*")])
def test_alloy_pair_coeff_errors_as_jax(pots, coeff, msg):
    d, files = pots
    name = Path(files["alloy"]).name
    for s in (jscript.LammpsScript(dtype=jnp.float64),
              tscript.LammpsScript(dtype=torch.float64, device="cpu")):
        s.root = str(d)
        for line in ("units metal", "lattice fcc 3.615",
                     "region box block 0 3 0 3 0 3", "create_box 2 box",
                     "create_atoms 1 box", "pair_style eam/alloy"):
            s.one(line)
        with pytest.raises(ValueError, match=msg):
            s.one("pair_coeff " + coeff.format(f=name))


def test_cli_without_a_gpu_raises(pots):
    """The entry point runs on the card unless asked for the CPU: with no
    GPU here, EAM_SCRIPT without -device cpu raises."""
    d = pots[0]
    (d / "in.gpu").write_text(small_text(chip_smoke.EAM_SCRIPT, nstep=0))
    args = [sys.executable, "-m", "lidp_tpu_torch", "-in", "in.gpu"]
    for k, v in SMALL.items():
        args += ["-var", k, v]
    res = subprocess.run(args, cwd=d, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
