"""The port's ewald/disp dispersion and point-dipole functions
(lidp_tpu_torch/ops/ewald.py: newton_g6, setup_dispersion, ewald6_forces,
dispersion_real, ewald_dipole_forces, dipole_real), the long-dispersion
pair kinds (ops/pair.py lj/long, buck/long; ops/cells.py) and
pair_style lj/long/coul/long and buck/long/coul/long from a script,
against the JAX package's, float64 on the CPU, both sides in one process:

  * newton_g6 and setup_dispersion's g6, k set and coefficients (the
    func12 branch) on three boxes: equal to JAX's (the same host numpy);
  * ewald6_forces on the setup and on Ewald6Params carried across by
    convert.ewald6_from_numpy, dispersion_real, ewald_dipole_forces and
    dipole_real on tests/test_dispersion.py's seeded cases: within rel
    1e-10 (f of its largest entry);
  * the real-space complement plus the k-space sum against a converged
    direct lattice sum (tests/test_dispersion.py's bar, 5e-4);
  * lj/long/coul/long with ewald/disp and buck/long/coul/long with
    ewald/disp on the point-charge fluid (chip_smoke.point_charge_script
    on fluid_script_case(n_side=5), the dense route, 4 steps), and
    lj/long/coul/long on its cell grid (`neighbor 0.1 bin`, the dense cap
    mocked to 300 in both packages): rows within rel 1e-8 of max(1,
    |value|) (plus chip_smoke.CANCEL_REL of what the special correction
    cancels on the grid), final x and v within 1e-8;
  * on the cell grid, step 0 against dense_forces with the special codes
    (chip_smoke.cells_step0_vs_dense): the sparse special correction's
    plain LJ share is what the lj/long kind needs, as in the JAX package
    (lidp_tpu/ops/bonded.py:248-291).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu.ops import ewald as jewald  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.ops import ewald as tewald  # noqa: E402
from tests.torch_kspace_cases import (  # noqa: E402
    buck_long, close, fluid_long, rows_match, run, scalar_close)

NSTEP = 4
BOXES = {"cubic": (7.0, 7.0, 7.0), "long": (6.5, 7.5, 11.0),
         "flat": (10.0, 9.0, 5.5)}


def _disp_system(seed=3, n=40, L=7.0, sep=0.9):
    """tests/test_dispersion.py's system: n atoms in an L box, no pair
    nearer than sep, per-atom B_i = sqrt(4 eps sigma^6)."""
    from scipy.spatial import cKDTree

    rng = np.random.RandomState(seed)
    x = rng.uniform(0, L, size=(n, 3))
    for _ in range(200):
        pairs = cKDTree(x, boxsize=L).query_pairs(sep, output_type="ndarray")
        if not len(pairs):
            break
        x[pairs[:, 0]] = rng.uniform(0, L, size=(len(pairs[:, 0]), 3))
    eps = rng.uniform(0.5, 1.5, size=n)
    sig = rng.uniform(0.9, 1.1, size=n)
    return x, np.sqrt(4.0 * eps * sig**6), L


# ------------------------------- the setup --------------------------------

@pytest.mark.parametrize("args", [(1e-4, 100.0, 100, 3.0, 343.0),
                                  (1e-5, 2.5e4, 1500, 6.0, 27000.0),
                                  (3e-3, 7.0, 40, 2.5, 343.0)])
def test_newton_g6_matches_jax(args):
    assert tewald.newton_g6(*args) == jewald.newton_g6(*args)


@pytest.mark.parametrize("accuracy", [1e-4, 1e-6])
@pytest.mark.parametrize("box", list(BOXES))
def test_setup_dispersion_matches_jax(box, accuracy):
    _, b, _ = _disp_system()
    kw = dict(accuracy_rel=accuracy, qqrd2e=1.0, b_atom=b, natoms=len(b),
              cutoff=3.0, box_lengths=BOXES[box])
    j, t = jewald.setup_dispersion(**kw), tewald.setup_dispersion(**kw)
    assert (t.g6, t.nbox, t.bsum, t.bsbsum, t.volume) == \
        (j.g6, j.nbox, j.bsum, j.bsbsum, j.volume)
    for k in ("hvecs", "kcoeff6", "kvirial6"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), k)
    assert len(t.hvecs) > 10


def test_setup_dispersion_g6_given():
    _, b, _ = _disp_system()
    kw = dict(accuracy_rel=1e-4, qqrd2e=1.0, b_atom=b, natoms=len(b),
              cutoff=3.0, box_lengths=BOXES["long"], g6=0.61)
    j, t = jewald.setup_dispersion(**kw), tewald.setup_dispersion(**kw)
    assert t.g6 == j.g6 == 0.61 and t.nbox == j.nbox
    np.testing.assert_array_equal(t.kcoeff6, j.kcoeff6)


# ----------------------------- the functions ------------------------------

@pytest.fixture(scope="module")
def disp_case():
    x, b, L = _disp_system()
    s = jewald.setup_dispersion(accuracy_rel=1e-5, qqrd2e=1.0, b_atom=b,
                                natoms=len(x), cutoff=3.0,
                                box_lengths=[L] * 3)
    want = [np.asarray(v) for v in jewald.ewald6_forces(
        jnp.asarray(x), jnp.asarray(b), L**3, s)]
    return x, b, L, s, want


@pytest.mark.parametrize("form", ["setup", "params"])
def test_ewald6_forces_matches_jax(disp_case, form):
    x, b, L, s, (fj, ej, vj) = disp_case
    if form == "params":
        jp = jewald.Ewald6Params.from_setup(s)
        s = convert.ewald6_from_numpy(
            {k: np.asarray(getattr(jp, k)) for k in
             ("hvecs", "kcoeff6", "kvirial6", "g6", "bsum", "bsbsum")},
            device="cpu")
        assert isinstance(s, tewald.Ewald6Params)
    f, e, vir = tewald.ewald6_forces(torch.as_tensor(x), torch.as_tensor(b),
                                     L**3, s)
    assert f.dtype == torch.float64 and f.shape == fj.shape
    close(f, fj, 1e-10, "f")
    scalar_close(e, ej, 1e-10, "edisp")
    close(vir, vj, 1e-10, "virial")
    assert np.abs(fj).max() > 1e-3 and abs(float(ej)) > 1e-3


def test_dispersion_real_matches_jax(disp_case):
    x, b, L, s, _ = disp_case
    d = x[:, None, :] - x[None, :, :]
    d -= L * np.round(d / L)
    iu = np.triu_indices(len(x), 1)
    r2 = np.sum(d * d, axis=-1)[iu]
    bij = (b[:, None] * b[None, :])[iu]
    ej, fj = (np.asarray(v) for v in jewald.dispersion_real(
        jnp.asarray(r2), jnp.asarray(bij), s.g6))
    e, f = tewald.dispersion_real(torch.as_tensor(r2), torch.as_tensor(bij),
                                  s.g6)
    np.testing.assert_allclose(e.numpy(), ej, rtol=1e-10, atol=0)
    np.testing.assert_allclose(f.numpy(), fj, rtol=1e-10, atol=0)


def test_dispersion_total_matches_direct_sum(disp_case):
    """The port's real-space complement within the cutoff plus its k-space
    sum against the converged -B_i B_j / r^6 lattice sum
    (tests/test_dispersion.py's bar)."""
    x, b, L, s, _ = disp_case
    d = x[:, None, :] - x[None, :, :]
    d -= L * np.round(d / L)
    iu = np.triu_indices(len(x), 1)
    r2 = np.sum(d * d, axis=-1)[iu]
    bij = (b[:, None] * b[None, :])[iu]
    inrc = r2 < 9.0
    e_real, _ = tewald.dispersion_real(torch.as_tensor(r2[inrc]),
                                       torch.as_tensor(bij[inrc]), s.g6)
    _, e_k, _ = tewald.ewald6_forces(torch.as_tensor(x), torch.as_tensor(b),
                                     L**3, s)
    direct = 0.0
    nimg = 6
    for sh in np.array([(i, j, k) for i in range(-nimg, nimg + 1)
                        for j in range(-nimg, nimg + 1)
                        for k in range(-nimg, nimg + 1)], float) * L:
        dd = x[:, None, :] - x[None, :, :] + sh
        rr = np.sum(dd * dd, axis=-1)
        if not sh.any():
            np.fill_diagonal(rr, np.inf)
        direct += -0.5 * np.sum(b[:, None] * b[None, :] / rr**3)
    total = float(e_real.sum()) + float(e_k)
    assert abs(total - direct) < 5e-4 * abs(direct), (total, direct)


@pytest.fixture(scope="module")
def dipole_case():
    """tests/test_dispersion.py's point-dipole case: 24 dipoles, no pair
    nearer than 1.2, net moment zero."""
    x, _, L = _disp_system(seed=11, n=24, L=8.0, sep=1.2)
    mu = np.random.RandomState(12).normal(size=(24, 3))
    mu -= mu.mean(axis=0)
    s = jewald.setup_ewald_disp(accuracy_rel=1e-8, qqrd2e=1.0,
                                q=np.ones(24), natoms=24, cutoff=3.9,
                                box_lengths=[L] * 3, g_ewald=1.0)
    return x, mu, L, s


@pytest.mark.parametrize("scale", [1.0, 332.06371])
def test_ewald_dipole_forces_matches_jax(dipole_case, scale):
    x, mu, L, s = dipole_case
    fj, ej = (np.asarray(v) for v in jewald.ewald_dipole_forces(
        jnp.asarray(x), jnp.asarray(mu), L**3, s, scale=scale))
    ts = tewald.setup_ewald_disp(accuracy_rel=1e-8, qqrd2e=1.0,
                                 q=np.ones(24), natoms=24, cutoff=3.9,
                                 box_lengths=[L] * 3, g_ewald=1.0)
    np.testing.assert_array_equal(ts.hvecs, s.hvecs)
    for form in (ts, tewald.EwaldParams.from_setup(ts, 1.0)):
        f, e = tewald.ewald_dipole_forces(torch.as_tensor(x),
                                          torch.as_tensor(mu), L**3, form,
                                          scale=scale)
        close(f, fj, 1e-10, "f")
        scalar_close(e, ej, 1e-10, "edip")
    assert np.abs(fj).max() > 1e-3


def test_dipole_real_matches_jax(dipole_case):
    x, mu, L, _ = dipole_case
    d = x[:, None, :] - x[None, :, :]
    d -= L * np.round(d / L)
    iu = np.triu_indices(len(x), 1)
    args = (d[iu], mu[iu[0]], mu[iu[1]])
    for g in (1.0, 1.35):
        want = np.asarray(jewald.dipole_real(*map(jnp.asarray, args), g))
        got = tewald.dipole_real(*map(torch.as_tensor, args), g)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


# ------------------------------ the scripts -------------------------------

CASES = {
    "lj_long_ewald": (fluid_long("lj/long/coul/long long long 6.0 6.5"),
                      None),
    "buck_long_ewald": (buck_long(), None),
    "lj_long_cells": (fluid_long("lj/long/coul/long long long 6.0 6.5",
                                 extra="neighbor 0.1 bin\n"), 300),
}


@pytest.fixture(scope="module")
def fluid(tmp_path_factory):
    d = tmp_path_factory.mktemp("fluid")
    chip_smoke.fluid_script_case(str(d), n_side=5)
    return d


@pytest.fixture(scope="module")
def runs(fluid):
    return {case: tuple(run(pkg, fluid, text, nstep=NSTEP, cap=cap,
                            name=f"{case}.{pkg}")
                        for pkg in ("jax", "torch"))
            for case, (text, cap) in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_script_matches_jax(runs, case):
    js, ts = runs[case]
    sim = ts._sim
    ff = sim.runner.ff
    kind = "buck/long" if case.startswith("buck") else "lj/long"
    assert ff.pair.kind == kind and ff.ewald6 is not None
    jp = js._sim.runner.ff
    assert ff.ewald6.g6 == float(jp.ewald6.g6) == ff.pair.g6 \
        == ff.ewald.g_ewald == ff.pair.g_ewald
    np.testing.assert_array_equal(ff.b_atom.numpy(), np.asarray(jp.b_atom))
    cells = CASES[case][1] is not None
    assert (sim.runner.neighbor_cfg is not None) == cells
    assert len(ts.thermo_rows) == NSTEP + 1
    assert abs(ts.thermo_rows[0]["elong"]) > 1.0
    rows_match(case, ts, js,
               cancel=chip_smoke.cancelled(sim) if cells else None)


def test_cells_special_correction_holds_lj_long(runs, fluid):
    """Step 0 of the lj/long fluid on the cell grid (its sparse special
    correction) against dense_forces with the special codes, at rel 1e-9
    plus CANCEL_REL of the cancelled magnitude."""
    _, ts = runs["lj_long_cells"]
    # a fresh Simulation at step 0 of the same input
    ts0 = run("torch", fluid, CASES["lj_long_cells"][0], nstep=0, cap=300,
              name="cells0")
    assert ts0._sim.runner.ff.sp_idx is not None
    chip_smoke.cells_step0_vs_dense("lj/long", ts0, ts0._sim.natoms)
