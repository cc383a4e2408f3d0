"""The port's dispersion mesh (lidp_tpu_torch/ops/pppm.py setup_pppm_disp,
pppm_disp_forces; kspace_style pppm/disp from a script) against the JAX
package's, float64 on the CPU, both sides in one process:

  * setup_pppm_disp's g6 and grid equal to JAX's, with and without a
    pinned g6 (kspace_modify gewald/disp);
  * pppm_disp_forces on tests/test_pppm_disp.py's seeded case (48 atoms,
    an 8 A box) and on a non-cubic box: f within 1e-10 of max |f|, the
    energy and the virial within rel 1e-10 of JAX's; its setup and
    PPPMDispParams carried across by convert.pppm_disp_from_numpy give the
    same bits;
  * the port's mesh against the port's exact-k ewald6_forces at JAX's
    bars (tests/test_pppm_disp.py): energy rel 1e-6, forces rms 1e-6,
    virial 2e-6 of max(1, |virial|);
  * lj/long/coul/long and buck/long/coul/long with pppm/disp on the
    point-charge fluid (fluid_script_case(n_side=5), the dense route, 4
    steps), the first with `kspace_modify gewald/disp 0.3`: rows within
    rel 1e-8 of max(1, |value|), final x and v within 1e-8;
  * pppm/disp with a pair style without a dispersion sum raises the JAX
    package's NotImplementedError in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu.ops import ewald as jewald  # noqa: E402
from lidp_tpu.ops import pppm as jpppm  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.ops import ewald as tewald  # noqa: E402
from lidp_tpu_torch.ops import pppm as tpppm  # noqa: E402
from tests.torch_kspace_cases import (  # noqa: E402
    buck_long, close, fluid_long, rows_match, run, scalar_close)

NSTEP = 4


def _system(seed=7, n=48, L=(8.0, 8.0, 8.0)):
    """tests/test_pppm_disp.py's system: B_i = sqrt(4 eps sigma^6)."""
    rng = np.random.RandomState(seed)
    L = np.asarray(L, float)
    x = rng.uniform(0, 1, size=(n, 3)) * L
    eps = rng.uniform(0.5, 1.5, size=n)
    sig = rng.uniform(0.9, 1.1, size=n)
    return x, np.sqrt(4.0 * eps * sig**6), L


def _setup_kw(b, L, **kw):
    return dict(accuracy_rel=1e-6, qqrd2e=1.0, b_atom=b, natoms=len(b),
                cutoff=3.0, box_lengths=L, **kw)


@pytest.mark.parametrize("g6", [None, 0.9])
@pytest.mark.parametrize("L", [(8.0, 8.0, 8.0), (7.0, 9.5, 12.0)])
def test_setup_pppm_disp_matches_jax(L, g6):
    _, b, L = _system(L=L)
    j = jpppm.setup_pppm_disp(**_setup_kw(b, L, g6=g6))
    t = tpppm.setup_pppm_disp(**_setup_kw(b, L, g6=g6))
    assert (t.g6, t.grid, t.order, t.bsum, t.bsbsum) == \
        (j.g6, tuple(j.grid), j.order, j.bsum, j.bsbsum)
    assert all(tpppm._factorable(n) for n in t.grid)


@pytest.fixture(scope="module", params=["cubic", "box"])
def mesh_case(request):
    L = (8.0, 8.0, 8.0) if request.param == "cubic" else (7.0, 9.5, 12.0)
    x, b, L = _system(L=L)
    es = jewald.setup_dispersion(**_setup_kw(b, L))
    ps = jpppm.setup_pppm_disp(**_setup_kw(b, L, g6=es.g6))
    want = [np.asarray(v) for v in jpppm.pppm_disp_forces(
        jnp.asarray(x), jnp.asarray(b), list(L), ps)]
    return x, b, L, ps, want


def test_pppm_disp_forces_match_jax(mesh_case):
    x, b, L, ps, (fj, ej, vj) = mesh_case
    jp = jpppm.PPPMDispParams.from_setup(ps)
    tp = convert.pppm_disp_from_numpy(
        {f.name: np.asarray(getattr(jp, f.name))
         for f in dataclasses.fields(jp)})
    assert tp == tpppm.PPPMDispParams.from_setup(ps)
    got = [tpppm.pppm_disp_forces(torch.as_tensor(x), torch.as_tensor(b),
                                  torch.as_tensor(L), s) for s in (ps, tp)]
    for a, c in zip(*got):
        assert torch.equal(a, c)
    f, e, vir = got[0]
    assert f.dtype == torch.float64 and f.shape == fj.shape
    close(f, fj, 1e-10, "f")
    scalar_close(e, ej, 1e-10, "edisp")
    close(vir, vj, 1e-10, "virial")
    assert np.abs(fj).max() > 1e-3 and abs(float(ej)) > 1e-3


def test_pppm_disp_against_ewald6(mesh_case):
    """The port's mesh against the port's exact-k sum at
    tests/test_pppm_disp.py's bars."""
    x, b, L, ps, _ = mesh_case
    es = tewald.setup_dispersion(**_setup_kw(b, L))
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    fk, ek, vk = tewald.ewald6_forces(xt, bt, float(np.prod(L)), es)
    fm, em, vm = tpppm.pppm_disp_forces(xt, bt, torch.as_tensor(L), ps)
    assert float(ek) != 0.0
    assert abs(float(em) - float(ek)) < 1e-6 * abs(float(ek))
    scale = float(torch.sqrt(torch.mean(torch.sum(fk**2, dim=1))))
    err = float(torch.sqrt(torch.mean(torch.sum((fm - fk) ** 2, dim=1))))
    assert err < 1e-6 * scale, (err, scale)
    assert float((vm - vk).abs().max()) < 2e-6 * max(
        1.0, float(vk.abs().max()))


def test_charge_mesh_helpers_keep_pppm(mesh_case):
    """The charge mesh through the shared stencil and mode lattice gives
    the JAX package's pppm_forces on the same case (rel 1e-10)."""
    x, b, L, _, _ = mesh_case
    q = b - b.mean()
    s = jpppm.setup_pppm(accuracy_rel=1e-5, qqrd2e=1.0, q=q, natoms=len(q),
                         cutoff=3.0, box_lengths=L)
    args = (1.0, float(np.sum(q * q)), float(np.sum(q)))
    fj, ej, vj = (np.asarray(v) for v in jpppm.pppm_forces(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(L), s, *args))
    f, e, vir = tpppm.pppm_forces(torch.as_tensor(x), torch.as_tensor(q),
                                  torch.as_tensor(L), s, *args)
    close(f, fj, 1e-10, "f")
    scalar_close(e, ej, 1e-10, "elong")
    close(vir, vj, 1e-10, "virial")


# ------------------------------ the scripts -------------------------------

CASES = {
    "lj_long": fluid_long("lj/long/coul/long long long 6.0 6.5",
                          "pppm/disp 1e-4", "kspace_modify gewald/disp 0.3\n"),
    "buck_long": buck_long("pppm/disp 1e-4"),
}


@pytest.fixture(scope="module")
def fluid(tmp_path_factory):
    d = tmp_path_factory.mktemp("fluid")
    chip_smoke.fluid_script_case(str(d), n_side=5)
    return d


@pytest.fixture(scope="module")
def runs(fluid):
    return {case: tuple(run(pkg, fluid, text, nstep=NSTEP,
                            name=f"{case}.{pkg}")
                        for pkg in ("jax", "torch"))
            for case, text in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_script_matches_jax(runs, case):
    js, ts = runs[case]
    ff, jf = ts._sim.runner.ff, js._sim.runner.ff
    assert ff.pppm_disp is not None and ff.ewald6 is None
    assert ff.pppm is not None and ff.ewald is None
    assert ff.pppm_disp.grid == tuple(jf.pppm_disp.grid)
    assert ff.pppm_disp.g6 == ff.pair.g6 == jf.pppm_disp.g6
    if case == "lj_long":
        assert ff.pppm_disp.g6 == 0.3
    assert ts._sim.runner.neighbor_cfg is None
    rows_match(case, ts, js)


def test_pppm_disp_needs_a_dispersion_style(fluid):
    """pppm/disp with lj/cut/coul/long: both packages raise the JAX
    package's NotImplementedError."""
    text = chip_smoke.point_charge_script().replace(
        "kspace_style ewald/disp 1e-4", "kspace_style pppm/disp 1e-4")
    for pkg in ("jax", "torch"):
        with pytest.raises(NotImplementedError,
                           match="pppm/disp needs a \\*/long/\\* dispersion"):
            run(pkg, fluid, text, nstep=0, name=f"nodisp.{pkg}")
