"""pair_style dpd and dpd/tstat in the port (lidp_tpu_torch/ops/dpd.py
dpd_noise, dpd_forces; convert.dpd_from_numpy; styles/pair_builders.py
_build_dpd_pair) against the JAX package's (lidp_tpu/ops/dpd.py), float64
on the CPU:

  * the noise: the port's symmetric (N,N) matrix (threefry.normal of
    fold_in(PRNGKey(seed), step), then (A + A^T)/sqrt(2)) against JAX's
    jax.random.normal draw symmetrized, within rel 1e-13 in float64 and
    1e-5 in float32 (torch's erfinv against XLA's; the bits of the
    uniforms are equal), and exactly symmetric;
  * dpd_forces on a seeded 80-bead system with special codes: f, E_vdwl
    and the virial within 1e-10 of JAX's (dpd and dpd/tstat), and the sum
    of the forces zero to 1e-12 of max |f| (theta_ij == theta_ji);
  * tests/test_pair_breadth2.py's conservative golden (gamma 0) at its
    bars and at rel 1e-8 of JAX's rows; a dpd/tstat run and a dpd run
    from rest at rel 1e-8 of JAX's rows over 20 steps, E_vdwl 0 under
    dpd/tstat, the total momentum conserved to 1e-10.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

from lidp_tpu import box as jbox  # noqa: E402
from lidp_tpu.ops import dpd as jdpd  # noqa: E402
from lidp_tpu_torch import box as tbox  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.ops import dpd as tdpd  # noqa: E402
from scripts.gen_breadth_goldens import write_data  # noqa: E402
from tests.test_torch_pair_scripts import _agree_with_jax, _run  # noqa: E402


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed,step", [(34387, 0), (48291, 17), (7, 123456)])
def test_noise_matches_jax(seed, step, dtype):
    n = 97
    key = jax.random.fold_in(jax.random.PRNGKey(seed),
                             jnp.asarray(step, jnp.int32))
    a = jax.random.normal(key, (n, n), dtype)
    ref = np.asarray((a + a.T) * (1.0 / jnp.sqrt(jnp.asarray(2.0, dtype))))
    td = torch.float64 if dtype == np.float64 else torch.float32
    got = tdpd.dpd_noise(seed, step, n, td, "cpu").numpy()
    assert np.array_equal(got, got.T)
    rel = 1e-13 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel)


def _dpd_case(tstat, n=80, L=5.0, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, L, (n, 3))
    v = rs.normal(size=(n, 3))
    typ = rs.randint(1, 3, n).astype(np.int32)
    code = np.zeros((n, n), np.int8)
    for i in range(0, n - 1, 2):
        code[i, i + 1] = code[i + 1, i] = 1
    a0 = np.array([[0, 0, 0], [0, 25.0, 30.0], [0, 30.0, 20.0]])
    gam = np.array([[0, 0, 0], [0, 4.5, 4.0], [0, 4.0, 3.5]])
    cut = np.array([[0, 0, 0], [0, 1.0, 1.1], [0, 1.1, 0.9]])
    pj = jdpd.DPDParams(
        a0=jnp.asarray(0.0 * a0 if tstat else a0), gamma=jnp.asarray(gam),
        sigma=jnp.asarray(np.sqrt(2.0 * 1.3 * gam)),
        cut=jnp.asarray(np.where(cut > 0, cut, 1.0)),
        cutsq=jnp.asarray(cut * cut),
        special_lj=jnp.asarray([1.0, 0.5, 0.0, 0.0]),
        dtinvsqrt=jnp.asarray(1.0 / np.sqrt(0.04)), seed=34387, tstat=tstat)
    pt = convert.dpd_from_numpy(
        {k: np.asarray(getattr(pj, k)) for k in
         ("a0", "gamma", "sigma", "cut", "cutsq", "special_lj", "dtinvsqrt",
          "seed", "tstat")}, device="cpu")
    return x, v, typ, code, L, pj, pt


@pytest.mark.parametrize("tstat", [False, True], ids=["dpd", "dpd/tstat"])
def test_dpd_forces_match_jax(tstat):
    x, v, typ, code, L, pj, pt = _dpd_case(tstat)
    mask = np.ones(len(x), bool)
    mask[-3:] = False
    ref = jdpd.dpd_forces(jnp.asarray(x), jnp.asarray(v), jnp.asarray(typ),
                          jnp.asarray(mask),
                          jbox.Box.create(np.zeros(3), np.full(3, L)), pj,
                          11, sp_code=jnp.asarray(code))
    got = tdpd.dpd_forces(torch.as_tensor(x), torch.as_tensor(v),
                          torch.as_tensor(typ), torch.as_tensor(mask),
                          tbox.Box.create(np.zeros(3), np.full(3, L)), pt,
                          11, sp_code=torch.as_tensor(code))
    for g, r, what in zip(got, ref, ("f", "evdwl", "virial")):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-10 * max(np.abs(r).max(), 1.0),
                                   err_msg=what)
    f = got[0].numpy()
    assert np.abs(f.sum(0)).max() <= 1e-12 * np.abs(f).max()
    assert (float(got[1]) == 0.0) == tstat


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    d = tmp_path_factory.mktemp("dpd")
    write_data(str(d / "data.breadth"))
    return d


HEAD = """units lj
atom_style charge
read_data data.breadth
"""


def test_dpd_conservative_golden(box):
    """tests/test_pair_breadth2.py's gamma 0 golden (the stochastic and
    drag terms vanish: LAMMPS's rows to every printed digit)."""
    text = (HEAD + "pair_style dpd 1.0 2.0 48291\npair_coeff 1 1 25.0 0.0\n"
            "pair_coeff 1 2 30.0 0.0\npair_coeff 2 2 20.0 0.0\n"
            "comm_modify vel yes\nvelocity all create 1.0 87287 loop geom\n"
            "timestep 0.02\nfix 1 all nve\nthermo 4\nrun 8\n")
    ts = _run("torch", box, text, "dpd")
    got = {int(r["step"]): r for r in ts.thermo_rows}
    ref = {0: (1.0, 5.63921149449, 3.61242796562),
           4: (0.91918324406, 5.75784340296, 3.60994606899),
           8: (0.714693089437, 6.06132641206, 3.6271520407)}
    for step, (temp, pe, pr) in ref.items():
        assert got[step]["temp"] == pytest.approx(temp, rel=2e-6), step
        assert got[step]["pe"] == pytest.approx(pe, rel=2e-6), step
        assert got[step]["press"] == pytest.approx(pr, rel=2e-5), step
    _agree_with_jax(ts, _run("jax", box, text, "dpd"))


@pytest.mark.parametrize("style", [
    "dpd 1.0 2.0 48291\npair_coeff * * 25.0 4.5",
    "dpd/tstat 1.0 1.0 2.0 937123\npair_coeff * * 4.5"],
    ids=["dpd", "dpd/tstat"])
def test_dpd_runs_match_jax(box, style):
    text = (HEAD + f"pair_style {style}\ncomm_modify vel yes\n"
            + ("velocity all create 3.0 87287 loop geom\n"
               if "tstat" in style else "")
            + "timestep 0.02\nfix 1 all nve\nthermo 5\n"
            "thermo_style custom step temp pe evdwl ke press\nrun 20\n")
    ts = _run("torch", box, text, "dpdrun")
    _agree_with_jax(ts, _run("jax", box, text, "dpdrun"),
                    cols=("temp", "pe", "evdwl", "press"))
    sim = ts._sim
    n = sim.natoms
    m = np.where(np.asarray(ts.type) == 1, 1.0, 1.5)[:, None]
    p = (m * sim.sys.v[:n].numpy()).sum(0)
    assert np.abs(p).max() < 1e-10
    if "tstat" in style:
        assert all(r["evdwl"] == 0.0 for r in ts.thermo_rows)
    else:
        assert ts.thermo_rows[0]["temp"] == 0.0 < ts.thermo_rows[-1]["temp"]
