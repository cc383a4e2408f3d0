"""Non-periodic boundaries and the shrink-wrapped box in the port
(lidp_tpu_torch/box.py ShrinkSpec and reset_box, integrate/driver.py
Runner(shrink=), sim.py shrink_spec, io/script.py boundary) against the
JAX package (lidp_tpu/box.py, lidp_tpu/integrate/driver.py, its sim.py
and script.py), float64 on the CPU, both in one process:

  * reset_box on random atom extents, some atoms masked, for every face
    code (0 fixed or periodic, 2 `s`, 3 `m`, with the `m` limit binding
    and not), the faces equal to JAX's bit for bit;
  * the boundary grammar (p, f, s, m and the two-letter per-face forms)
    giving JAX's face styles and periodicity, and its errors raising as
    JAX's do (p paired with another style, an unknown letter);
  * a 2d LJ case (hex lattice, a top layer pulled up by `velocity ramp
    ... sum yes`, `neigh_modify delay 0 every 1 check yes`) under `s s
    p`, `m m p` and `fs sm p`: above a dense cap mocked to 100 atoms it
    takes the cell grid, whose box the Runner resets at every rebuild
    (four in 60 steps), and under the cap the dense route (reset at
    setup only, as in JAX); every row within rel 1e-8 of max(1, |value|)
    of JAX's, x within 1e-8, the final box within 1e-10, the ShrinkSpec
    equal to JAX's;
  * a box whose reset at setup leaves a bin thinner than cut + skin: the
    grid's sticky overflow aborts the run with JAX's message, in both;
  * a read_data box under `boundary s s p`: no ShrinkSpec in either
    package (only create_box's box is wrapped), the rows equal.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time, as the port's other parity files
torch.set_num_threads(1)

from lidp_tpu import box as jbox  # noqa: E402
from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch import box as tbox  # noqa: E402
from lidp_tpu_torch import sim as tsim  # noqa: E402
from lidp_tpu_torch.integrate import driver as tdriver  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar  # noqa: E402

ROWS = 1e-8
X_TOL = 1e-8

# (lo codes, hi codes) of the three dimensions
FACE_CODES = {
    "fixed": ((0, 0, 0), (0, 0, 0)),
    "s": ((2, 2, 2), (2, 2, 2)),
    "m": ((3, 3, 3), (3, 3, 3)),
    "mixed": ((2, 3, 0), (3, 0, 2)),
    "per-face": ((0, 2, 3), (2, 3, 0)),
}


@pytest.mark.parametrize("name", list(FACE_CODES))
@pytest.mark.parametrize("seed", [0, 1])
def test_reset_box_matches_jax(name, seed):
    """Random extents inside and outside the created box (seed 0 inside,
    so `m` keeps the created faces; seed 1 past them), a quarter of the
    atoms masked with coordinates far outside that must not count."""
    lo_c, hi_c = FACE_CODES[name]
    rng = np.random.default_rng(seed)
    n = 64
    c_lo, c_hi = np.array([0.0, -1.0, 2.0]), np.array([10.0, 7.0, 5.0])
    spread = 0.8 if seed == 0 else 1.3
    mid, half = 0.5 * (c_lo + c_hi), 0.5 * (c_hi - c_lo)
    x = mid + spread * half * rng.uniform(-1.0, 1.0, (n, 3))
    mask = np.ones(n, bool)
    mask[::4] = False
    x[~mask] = 1e6 * rng.choice([-1.0, 1.0], (int((~mask).sum()), 3))
    small = tuple(1e-4 * (c_hi - c_lo))
    box_lo, box_hi = c_lo - 0.3, c_hi + 0.2
    jspec = jbox.ShrinkSpec(lo_style=lo_c, hi_style=hi_c, small=small,
                            min_lo=tuple(c_lo), min_hi=tuple(c_hi))
    tspec = tbox.ShrinkSpec(lo_style=lo_c, hi_style=hi_c,
                            small=tuple(map(float, small)),
                            min_lo=tuple(map(float, c_lo)),
                            min_hi=tuple(map(float, c_hi)))
    assert tspec.active == jspec.active == (name != "fixed")
    jb = jbox.reset_box(jnp.asarray(x), jnp.asarray(mask),
                        jbox.Box.create(box_lo, box_hi, jnp.float64,
                                        periodic=(False,) * 3), jspec)
    tb = tbox.reset_box(torch.as_tensor(x), torch.as_tensor(mask),
                        tbox.Box.create(box_lo, box_hi, torch.float64,
                                        periodic=(False,) * 3), tspec)
    for k in ("lo", "hi"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)))
    assert tb.periodic == (False,) * 3
    # the `m` faces never move inside the created box
    for d in range(3):
        if lo_c[d] == 3:
            assert float(tb.lo[d]) <= c_lo[d]
        if hi_c[d] == 3:
            assert float(tb.hi[d]) >= c_hi[d]


GRAMMAR = ["p p p", "f f f", "s s p", "p s p", "m m m", "fs sm p", "fm s f",
           "s p", "f s m p"]
GRAMMAR_ERRORS = ["ps p p", "p sp p", "x p p", "p q s"]


@pytest.mark.parametrize("line", GRAMMAR)
def test_boundary_grammar_matches_jax(line):
    js = jscript.LammpsScript(dtype=jnp.float64)
    ts = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    js.one(f"boundary {line}")
    ts.one(f"boundary {line}")
    assert [tuple(f) for f in ts.boundary_styles] == [
        tuple(f) for f in js.boundary_styles]
    assert ts.periodic == js.periodic


@pytest.mark.parametrize("line", GRAMMAR_ERRORS)
def test_boundary_errors_match_jax(line):
    with pytest.raises(ValueError) as jerr:
        jscript.LammpsScript(dtype=jnp.float64).one(f"boundary {line}")
    with pytest.raises(ValueError) as terr:
        tscript.LammpsScript(dtype=torch.float64,
                             device="cpu").one(f"boundary {line}")
    assert str(terr.value) == str(jerr.value)


LJ2D = """units lj
dimension 2
boundary {b}
atom_style atomic
neighbor 0.3 bin
neigh_modify delay 0 every 1 check yes
lattice hex 0.93
region box block 0 12 0 8 -0.25 0.25
create_box 2 box
create_atoms 1 box
mass * 1.0
pair_style lj/cut 2.5
pair_coeff * * 1.0 1.0 2.5
region top block INF INF 7.25 INF INF INF
group top region top
set group top type 2
velocity all create 1.0 4711 loop geom
velocity top ramp vy 0.3 0.6 y 7.25 8 sum yes
fix 1 all nve
fix 2 all enforce2d
timestep 0.005
thermo 10
run 60
"""
BOUNDARIES = ("s s p", "m m p", "fs sm p")


def _rows_agree(trows, jrows):
    assert len(trows) == len(jrows) > 1
    for tr, jr in zip(trows, jrows):
        assert tr["step"] == jr["step"]
        for k, v in tr.items():
            if k in jr and isinstance(v, float):
                assert abs(v - jr[k]) <= ROWS * max(1.0, abs(jr[k])), (
                    tr["step"], k, v, jr[k])


def _both(text, monkeypatch, cap=None):
    """The text through both packages' LammpsScript, the dense cap mocked
    to `cap` in both; returns (jax script, port script, the port's
    rebuilds)."""
    if cap is not None:
        monkeypatch.setattr(jsim, "DENSE_PATH_MAX_ATOMS", cap)
        monkeypatch.setattr(fast_polar, "DENSE_PATH_MAX_ATOMS", cap)
    rebuilds = []
    real = tdriver._rebuild

    def counted(*a, **kw):
        rebuilds.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tdriver, "_rebuild", counted)
    js = jscript.LammpsScript(dtype=jnp.float64, log=lambda line: None)
    js.execute(text.splitlines())
    ts = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                              log=lambda line: None)
    ts.execute(text.splitlines())
    return js, ts, len(rebuilds)


def _same_run(js, ts):
    _rows_agree(ts.thermo_rows, js.thermo_rows)
    tsim_, jsim_ = ts._sim, js._sim
    n = tsim_.natoms
    assert n == jsim_.natoms
    assert float(np.abs(tsim_.sys.x[:n].numpy()
                        - np.asarray(jsim_.sys.x)[:n]).max()) <= X_TOL
    for k in ("lo", "hi"):
        np.testing.assert_allclose(getattr(tsim_.sys.box, k).numpy(),
                                   np.asarray(getattr(jsim_.sys.box, k)),
                                   rtol=0, atol=1e-10)
    # the spec the Runner resets the box with is JAX's
    jspec, tspec = jsim_.runner.shrink, tsim_.runner.shrink
    for f in ("lo_style", "hi_style", "small", "min_lo", "min_hi"):
        assert tuple(getattr(tspec, f)) == tuple(
            float(v) if isinstance(v, float) else v
            for v in getattr(jspec, f))
    assert tsim.shrink_spec(ts) == tspec


@pytest.mark.parametrize("b", BOUNDARIES)
def test_cells_shrink_wrap_matches_jax(b, monkeypatch):
    """Above the mocked cap: the cell grid, its box reset at each of its
    rebuilds; the box moved from its setup reset with the pulled layer."""
    js, ts, rebuilds = _both(LJ2D.format(b=b), monkeypatch, cap=100)
    assert tuple(ts._sim.runner.neighbor_cfg.nbins) == (4, 5, 1)
    assert js._sim.runner.neighbor_cfg is not None
    assert rebuilds >= 3
    _same_run(js, ts)
    rows = ts.thermo_rows
    assert rows[-1]["ly"] > rows[0]["ly"] + 0.05
    assert ts._sim.sys.box.periodic == (False, False, True)


@pytest.mark.parametrize("b", BOUNDARIES)
def test_dense_shrink_wrap_matches_jax(b, monkeypatch):
    """Under the cap: the dense route, the box reset once at setup, as
    the JAX Runner resets it (no rebuild on the dense route)."""
    js, ts, rebuilds = _both(LJ2D.format(b=b), monkeypatch)
    assert ts._sim.runner.neighbor_cfg is None
    assert rebuilds == 0
    _same_run(js, ts)
    rows = ts.thermo_rows
    assert rows[-1]["ly"] == rows[0]["ly"]


ABORT = """units lj
dimension 2
boundary s s p
atom_style atomic
lattice hex 0.93
region box block 0 7.6 0 6 -0.25 0.25
create_box 1 box
create_atoms 1 box
mass * 1.0
pair_style lj/cut 2.5
pair_coeff * * 1.0 1.0 2.5
fix 1 all nve
thermo 5
run 5
"""


def test_a_bin_under_the_cutoff_aborts_as_jax(monkeypatch):
    """The grid is sized on the created box, 3 bins of 2.82 along x; the
    setup's reset to the lattice's extent leaves bins of 2.79 under cut +
    skin (2.8): the sticky overflow aborts the run in both packages, with
    JAX's message."""
    monkeypatch.setattr(jsim, "DENSE_PATH_MAX_ATOMS", 50)
    monkeypatch.setattr(fast_polar, "DENSE_PATH_MAX_ATOMS", 50)
    for s in (jscript.LammpsScript(dtype=jnp.float64),
              tscript.LammpsScript(dtype=torch.float64, device="cpu")):
        with pytest.raises(RuntimeError, match="cell capacity overflow"):
            s.execute(ABORT.splitlines())
        assert s._sim.runner.neighbor_cfg.nbins[0] == 3


def test_read_data_box_is_not_wrapped(tmp_path):
    """Only a create_box box is shrink-wrapped in the JAX package (its
    _apply_initial_box, which sets _created_box, runs in create_box): a
    read_data box under `boundary s s p` keeps the data file's faces, in
    both packages, with the rows equal (ROADMAP queue 3 item 23)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(1.0, 9.0, (24, 3))
    lines = ["LAMMPS data file", "", "24 atoms", "1 atom types", "",
             "0.0 10.0 xlo xhi", "0.0 10.0 ylo yhi", "0.0 10.0 zlo zhi",
             "", "Masses", "", "1 1.0", "", "Atoms", ""]
    lines += [f"{i + 1} 1 {p[0]:.10f} {p[1]:.10f} {p[2]:.10f}"
              for i, p in enumerate(x)]
    (tmp_path / "data.np").write_text("\n".join(lines) + "\n")
    text = ("units lj\natom_style atomic\nboundary s s p\n"
            "read_data data.np\npair_style lj/cut 2.5\n"
            "pair_coeff 1 1 1.0 1.0\nvelocity all create 1.0 991\n"
            "fix 1 all nve\nthermo 5\nrun 10\n")
    (tmp_path / "in.np").write_text(text)
    js = jscript.LammpsScript(dtype=jnp.float64, log=lambda line: None)
    js.file(str(tmp_path / "in.np"))
    ts = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                              log=lambda line: None)
    ts.file(str(tmp_path / "in.np"))
    assert js._sim.runner.shrink is None and ts._sim.runner.shrink is None
    assert tsim.shrink_spec(ts) is None
    for k, want in (("lo", 0.0), ("hi", 10.0)):
        assert np.all(getattr(ts._sim.sys.box, k).numpy() == want)
    _rows_agree(ts.thermo_rows, js.thermo_rows)
