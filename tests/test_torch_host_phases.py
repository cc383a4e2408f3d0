"""The port's host-phase force evaluation (PolarStep.make_host_phases +
lidp_tpu_torch.parallel.fast_polar.HostPolarForces) against the JAX
package's (make.host_phases + lidp_tpu.parallel.fast_polar.HostPolarForces)
on the synthetic 375-atom fluid, on the CPU, with the force-field tables
carried across by lidp_tpu_torch.convert.

float64 against the JAX scan path: evdwl/ecoul/elong rel 1e-10, epol and
the virial rel 1e-8, f and mu to 1e-8*max (BASELINE.md's 1e-8 bar), the
pure CG's iteration count equal; the mixed-precision solve converged, with
the same number of float64 refinement passes and its total count within 2
(its float32 sums run in another order).  float32 against JAX
panel="pallas" (interpret mode) with the tolerances of
test_torch_polar_step.py::test_f32_init_matches_jax_pallas.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.models import polar_bench  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar, shard  # noqa: E402

N_SIDE = 5


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _xshift(sysd, npad):
    """A frozen wrap offset that differs from re-wrapping: the wrap of the
    initial positions plus one more box length for every 7th atom."""
    x, L = sysd["x"], sysd["L"]
    sh = np.zeros((npad, 3))
    sh[:len(x)] = -np.floor(x / L) * L
    sh[:len(x):7] += L
    return sh


def _jax_build(dtype, panel, precision, polar=True, coul=True, strips=1,
               xshift=False):
    """The JAX step on the synthetic system.  Returns a dict with the host
    phases, the init function, the settings, the padded arrays (jnp), the
    port's ForceField converted from the JAX tables, n and npad."""
    from lidp_tpu import topology, units
    from lidp_tpu.forcefield import ForceField
    from lidp_tpu.ops import polarization as pol
    from lidp_tpu.ops.ewald import EwaldParams, setup_ewald_disp
    from lidp_tpu.ops.pair import make_pair_params
    from lidp_tpu.parallel import shard as jshard

    sysd = polar_bench.synthetic_system(N_SIDE)
    u = units.REAL
    n = sysd["x"].shape[0]
    es = setup_ewald_disp(accuracy_rel=polar_bench.EWALD_ACCURACY,
                          qqrd2e=u.qqr2e, q=sysd["q"], natoms=n,
                          cutoff=sysd["cut_coul"], box_lengths=sysd["L"])
    pair = make_pair_params(sysd["eps"], sysd["sig"], sysd["cut"],
                            cut_coul=sysd["cut_coul"], coul=coul,
                            qqrd2e=u.qqr2e, g_ewald=es.g_ewald, dtype=dtype)
    ew = EwaldParams.from_setup(es, u.qqr2e, dtype=dtype) if coul else None
    s = pol.PolarizationSettings(
        iterations_max=50, damping_type=pol.DAMPING_EXPONENTIAL,
        polar_precision=precision, use_previous=True) if polar else None
    ff = ForceField(pair=pair, ewald=ew, polar=s, qqrd2e=u.qqr2e)
    make, bind_box, npad, bind_special = jshard.build_sharded_polar_step(
        None, ff, s, n=n, dt=polar_bench.DT, ftm2v=u.ftm2v, dtype=dtype,
        panel=panel)
    bind_box(sysd["L"], xshift=_xshift(sysd, npad) if xshift else None)
    bind_special(*topology.special_lists(n, sysd["bonds"]))
    _, init = make(None)

    npd = np.float64 if dtype == jnp.float64 else np.float32

    def pad(a, fill=0.0, dt=npd):
        out = np.full((npad,) + np.shape(a)[1:], fill, dt)
        out[:n] = a
        return jnp.asarray(out)

    arrays = dict(
        x=pad(sysd["x"]), q=pad(sysd["q"]), type=pad(sysd["type"], 0, np.int32),
        mol=pad(sysd["mol"], 0, np.int32), alpha=pad(sysd["alpha"]),
        mu=pad(np.zeros((n, 3))), mask=pad(np.ones(n, bool), False, bool))
    tff = convert.forcefield_from_numpy(
        _fields(pair), None if ew is None else _fields(ew),
        None if s is None else _fields(s), u.qqr2e, device="cpu",
        dtype=torch.float64 if dtype == jnp.float64 else torch.float32)
    return dict(phases=make.host_phases(strips) if polar else None,
                init=init, settings=s, arrays=arrays, tff=tff, n=n,
                npad=npad, sysd=sysd)


def _jax_eval(jb, mixed):
    """One JAX HostPolarForces evaluation; counts the float64 eind passes."""
    from lidp_tpu.parallel.fast_polar import HostPolarForces

    phases = dict(jb["phases"])
    calls = {"eind": 0}
    eind = phases["eind"]

    def counted(*a):
        calls["eind"] += 1
        return eind(*a)

    phases["eind"] = counted
    hpf = HostPolarForces(phases, jb["settings"], jb["n"], mixed=mixed,
                          use_df=False)
    a = jb["arrays"]
    f, mu, en = hpf(a["x"], a["q"], a["type"], a["mol"], a["alpha"],
                    a["mu"], a["mask"])
    rec = {k: np.asarray(v) for k, v in en.items()}
    rec.update(f=np.asarray(f), mu=np.asarray(mu), eind_calls=calls["eind"])
    return rec


def _port_bench(jb, dtype, xshift=False, **kw):
    bench = polar_bench.build_synthetic(N_SIDE, dtype=dtype, device="cpu",
                                        ff=jb["tff"], **kw)
    if xshift:
        bench.step.bind_box(jb["sysd"]["L"],
                            xshift=_xshift(jb["sysd"], bench.npad))
    return bench


def _port_eval(bench, mixed, use_df=None):
    hpf = fast_polar.HostPolarForces(bench.phases, bench.settings,
                                     bench.natoms, mixed=mixed,
                                     use_df=use_df)
    a = bench.arrays
    f, mu, en = hpf(a["x"], a["q"], a["type"], a["mol"], a["alpha"],
                    a["mu"], a["mask"])
    rec = {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
           for k, v in en.items()}
    rec.update(f=f.numpy(), mu=mu.numpy(), outer=hpf.outer_passes)
    return rec


def _check_f64(t, j, n):
    for e in ("evdwl", "ecoul", "elong"):
        assert float(t[e]) == pytest.approx(float(j[e]), rel=1e-10), e
    assert float(t["epol"]) == pytest.approx(float(j["epol"]), rel=1e-8)
    np.testing.assert_allclose(t["virial"], j["virial"], rtol=1e-8,
                               atol=1e-8 * np.abs(j["virial"]).max())
    for a in ("f", "mu"):
        ref = j[a][:n]
        np.testing.assert_allclose(t[a][:n], ref, rtol=0,
                                   atol=1e-8 * np.abs(ref).max(), err_msg=a)
    assert bool(t["scf_converged"]) and bool(j["scf_converged"])


@pytest.fixture(scope="module")
def jax_f64():
    return _jax_build(jnp.float64, "scan", 1e-11, xshift=True)


# (a) float64, the pure CG on the plain phases, with a frozen virial shift
@pytest.mark.parametrize("use_df", [False, None])
def test_f64_pure_cg_matches_jax(jax_f64, use_df):
    j = _jax_eval(jax_f64, mixed=False)
    bench = _port_bench(jax_f64, torch.float64, xshift=True)
    t = _port_eval(bench, mixed=False, use_df=use_df)
    _check_f64(t, j, jax_f64["n"])
    assert int(t["scf_iters"]) == int(j["scf_iters"])


def test_xshift_changes_the_virial_only(jax_f64):
    """The frozen shift enters the polar F.r virial and nothing else."""
    a = _port_eval(_port_bench(jax_f64, torch.float64, xshift=True), False)
    b = _port_eval(_port_bench(jax_f64, torch.float64, xshift=False), False)
    np.testing.assert_array_equal(a["f"], b["f"])
    assert float(a["epol"]) == float(b["epol"])
    assert np.abs(a["virial"] - b["virial"]).max() > 1e-6


# (b) float64, mixed-precision refinement at 1e-11
@pytest.mark.parametrize("use_df", [False, None])
def test_f64_mixed_matches_jax(jax_f64, use_df):
    j = _jax_eval(jax_f64, mixed=True)
    bench = _port_bench(jax_f64, torch.float64, xshift=True)
    t = _port_eval(bench, mixed=True, use_df=use_df)
    _check_f64(t, j, jax_f64["n"])
    assert t["outer"] == j["eind_calls"] and 2 <= t["outer"] <= 4
    assert abs(int(t["scf_iters"]) - int(j["scf_iters"])) <= 2


def test_f64_mixed_agrees_with_pure_cg(jax_f64):
    """Both solves converge the dipoles to 1e-11: the forces then agree to
    1e-8 of the largest (tests/test_host_cg.py:43-73)."""
    pure = _port_eval(_port_bench(jax_f64, torch.float64), False)
    mixed = _port_eval(_port_bench(jax_f64, torch.float64), True)
    for k in ("evdwl", "ecoul", "elong"):
        assert float(mixed[k]) == pytest.approx(float(pure[k]), rel=1e-12)
    assert float(mixed["epol"]) == pytest.approx(float(pure["epol"]),
                                                 rel=1e-9)
    for a in ("f", "mu"):
        np.testing.assert_allclose(mixed[a], pure[a], rtol=1e-8,
                                   atol=1e-8 * np.abs(pure[a]).max())


# (c) float32 against the Pallas kernels in interpret mode
def test_f32_matches_jax_pallas():
    jb = _jax_build(jnp.float32, "pallas", 1e-6)
    j = _jax_eval(jb, mixed=False)
    t = _port_eval(_port_bench(jb, torch.float32), mixed=False)
    n = jb["n"]
    for e in ("evdwl", "ecoul", "elong"):
        assert float(t[e]) == pytest.approx(float(j[e]), rel=5e-6), e
    assert float(t["epol"]) == pytest.approx(float(j["epol"]), rel=1e-4,
                                             abs=2e-2)
    for a in ("f", "mu"):
        ref = j[a][:n]
        np.testing.assert_allclose(t[a][:n], ref, rtol=5e-4,
                                   atol=5e-5 * np.abs(ref).max(), err_msg=a)
    assert abs(int(t["scf_iters"]) - int(j["scf_iters"])) <= 1


# (d) row strips inside the port
def _strips_vs_whole(sysd, dtype, mixed, use_df):
    kw = dict(dtype=dtype, device="cpu", precision=1e-11
              if dtype == torch.float64 else 1e-6)
    recs = []
    for strips in (1, 4):
        bench = polar_bench.build_synthetic(N_SIDE, host_strips=strips, **kw)
        bench.step.bind_box(sysd["L"], xshift=_xshift(sysd, bench.npad))
        recs.append(_port_eval(bench, mixed, use_df=use_df))
    one, four = recs
    assert int(one["scf_iters"]) == int(four["scf_iters"])
    if dtype == torch.float64:
        for k in ("evdwl", "ecoul", "elong", "epol"):
            assert float(four[k]) == pytest.approx(float(one[k]), rel=1e-11)
        np.testing.assert_allclose(four["f"], one["f"], rtol=1e-9, atol=5e-9)
        np.testing.assert_allclose(four["virial"], one["virial"], rtol=1e-9,
                                   atol=1e-9 * np.abs(one["virial"]).max())
    else:
        np.testing.assert_allclose(four["f"], one["f"], rtol=1e-4,
                                   atol=1e-5 * np.abs(one["f"]).max())


@pytest.mark.parametrize("dtype,mixed", [(torch.float64, False),
                                         (torch.float64, True),
                                         (torch.float32, False)])
def test_strips_match_whole(jax_f64, dtype, mixed):
    _strips_vs_whole(jax_f64["sysd"], dtype, mixed, use_df=False)


@pytest.mark.parametrize("mixed", [False, True])
def test_df_strips_match_whole(jax_f64, mixed):
    """The f64-grade phases as row strips (pair_panel_df(mol=),
    eind_panel_df, dipole_panel_df with cols=/row0=) against the whole
    block."""
    _strips_vs_whole(jax_f64["sysd"], torch.float64, mixed, use_df=None)


def test_df_strip_phases_take_a_row_offset(jax_f64):
    bench = polar_bench.build_synthetic(N_SIDE, host_strips=4,
                                        dtype=torch.float64, device="cpu",
                                        precision=1e-11)
    a, ph = bench.arrays, bench.phases
    ns = bench.npad // 4
    for name in ("pair_df", "pair_wolf_df", "eind_df", "dipole_df"):
        assert name in ph, name
    e = ph["eind_df"](ns, a["x"], a["alpha"], a["mask"], a["mu"] + 0.01)
    whole = bench.step._e_ind_of(a["x"], a["alpha"], a["mask"],
                                 a["mu"] + 0.01)
    assert e.shape == (ns, 3)
    np.testing.assert_allclose(e.numpy(), whole[ns:2 * ns].numpy(),
                               rtol=1e-12, atol=1e-15)


def test_strip_phases_need_kspace_free_pair(jax_f64):
    bench = _port_bench(jax_f64, torch.float64)
    a = bench.arrays
    with pytest.raises(ValueError, match="with_kspace=False"):
        bench.step._nonpolar_forces(a["x"], a["q"], a["type"], a["mask"],
                                    strip=(0, 128))
    with pytest.raises(ValueError, match="multiple"):
        bench.step.make_host_phases(strips=3)


# (e) a non-polar force field through PolarStep.init
@pytest.mark.parametrize("dtype,panel,coul", [
    (jnp.float64, "scan", True), (jnp.float32, "pallas", True),
    (jnp.float32, "pallas", False), (jnp.float64, "scan", False)])
def test_nonpolar_init_matches_jax(dtype, panel, coul):
    jb = _jax_build(dtype, panel, 1e-6, polar=False, coul=coul)
    a = jb["arrays"]
    f, _, en = jb["init"](a["x"], a["q"], a["type"], a["mol"], a["alpha"],
                          a["mu"], a["mask"])
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    bench = _port_bench(jb, tdt)
    assert bench.settings is None and "wolf" not in bench.phases
    tf, ten = polar_bench.setup_forces(bench)
    n = jb["n"]
    rel, frtol, fatol = ((1e-10, 0, 1e-8) if tdt == torch.float64
                         else (5e-6, 5e-4, 5e-5))
    for e in ("evdwl", "ecoul", "elong"):
        assert float(ten[e]) == pytest.approx(float(en[e]), rel=rel,
                                              abs=1e-12), e
    assert float(ten["epol"]) == 0.0 and ten["scf_iters"] == 0
    ref = np.asarray(f)[:n]
    np.testing.assert_allclose(tf.numpy()[:n], ref, rtol=frtol,
                               atol=fatol * np.abs(ref).max())
    vref = np.asarray(en["virial"])
    np.testing.assert_allclose(ten["virial"].numpy(), vref, rtol=100 * rel,
                               atol=100 * rel * np.abs(vref).max())


def test_polar_needs_coulomb_and_lj_only_no_kspace():
    sysd = polar_bench.synthetic_system(N_SIDE)
    ff = polar_bench.synthetic_forcefield(sysd, torch.float64, "cpu")
    lj = dataclasses.replace(ff.pair, coul=False)
    with pytest.raises(NotImplementedError, match="LJ-only"):
        shard.build_sharded_polar_step(
            None, dataclasses.replace(ff, pair=lj), ff.polar, n=375, dt=0.5,
            ftm2v=1.0, dtype=torch.float64, device="cpu")


# (f) host_cg_step against the fused step
def test_host_cg_steps_match_fused_f64():
    kw = dict(dtype=torch.float64, device="cpu", precision=1e-11)
    fused = polar_bench.build_synthetic(N_SIDE, **kw)
    host = polar_bench.build_synthetic(N_SIDE, **kw)
    f1, e1 = polar_bench.setup_forces(fused)
    f2, e2 = polar_bench.host_setup_forces(host)
    for k in range(4):
        if k:
            f1, e1 = polar_bench.run_step(fused)
            f2, e2 = polar_bench.host_cg_step(host)
        assert int(e1["scf_iters"]) == int(e2["scf_iters"]), k
        assert e2["scf_converged"]
        for e in ("evdwl", "ecoul", "elong", "epol"):
            assert float(e2[e]) == pytest.approx(float(e1[e]), rel=1e-11), e
        np.testing.assert_allclose(f2.numpy(), f1.numpy(), rtol=1e-9,
                                   atol=1e-11 * f1.abs().max().item())
        for a in ("x", "v", "mu"):
            np.testing.assert_allclose(host.arrays[a].numpy(),
                                       fused.arrays[a].numpy(), rtol=1e-9,
                                       atol=1e-13, err_msg=a)


def test_host_cg_step_without_initial_forces_kicks_with_zero():
    """The first host_cg_step on a fresh bench uses f = 0 for the first
    half kick, as the JAX host_cg_step does."""
    bench = polar_bench.build_synthetic(N_SIDE, dtype=torch.float64,
                                        device="cpu")
    x0, v0 = bench.arrays["x"].clone(), bench.arrays["v"].clone()
    f, en = polar_bench.host_cg_step(bench, zero_init=True)
    np.testing.assert_allclose(bench.arrays["x"].numpy(),
                               (x0 + polar_bench.DT * v0).numpy(), rtol=0,
                               atol=1e-15)
    assert en["scf_converged"] and int(en["scf_iters"]) > 3


# fast_polar's script checks
class _Script:
    def __init__(self, **kw):
        self.pair = type("P", (), {"name": "lj/cut/coul/long/polarization"})()
        self.kspace = ("ewald/disp", 1e-4)
        self.fixes = {}
        self.__dict__.update(kw)


@pytest.mark.parametrize("n,kw,want", [
    (5000, {}, True),
    (4096, {}, False),
    (5000, {"kspace": ("pppm", 1e-4)}, False),
    (5000, {"box_tilt": (0.0, 0.1, 0.0)}, False),
    (5000, {"bond_style": "harmonic"}, False),
    (5000, {"periodic": (True, True, False)}, False),
    (5000, {"pair": type("P", (), {"name": "lj/cut"})()}, False),
])
def test_prescan_matches_jax(monkeypatch, n, kw, want):
    from lidp_tpu.parallel import fast_polar as jfp

    monkeypatch.delenv("LIDP_FAST_POLAR", raising=False)
    script = _Script(**kw)
    assert fast_polar.prescan(script, n) is want
    assert jfp.prescan(script, n) is want


@pytest.mark.parametrize("n", [100, 375, 4097, 10_125, 100_000])
def test_aligned_npad_matches_jax(n):
    from lidp_tpu.parallel import fast_polar as jfp

    assert fast_polar.aligned_npad(n) == jfp.aligned_npad(n)
