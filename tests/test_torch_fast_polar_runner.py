"""The port's FastPolarRunner (lidp_tpu_torch.parallel.fast_polar) against
the JAX package's (lidp_tpu.parallel.fast_polar) on the synthetic 375-atom
fluid (polar_bench.synthetic_system(5)), float64, polar_precision 1e-11,
both packages started from one state: the JAX force-field tables and
rigid-body setup carried across by lidp_tpu_torch.convert.

  * each molecule a rigid body (fix rigid/nve molecule): JAX
    FastPolarRunner(Runner(ff, rigid_nve_integrator(...))) against the
    port's polar_bench.build_rigid, setup + 5 steps, fused and
    LIDP_FAST_POLAR_MODE=host (the mixed-precision solve and the dipole
    predictor): every thermo column (the rigid constraint virial in the
    pressure), x, v, mu and the bodies' quaternions to the 1e-8 bar of
    BASELINE.md:21 (thermo columns rel 1e-8 of max(1, |value|); arrays
    1e-8 of their largest entry);
  * free atoms through nve_integrator in both runners, fused, at the same
    bar;
  * the panel step's zodid, fixed_iteration (3 sweeps) and polar_gs SCF
    modes against JAX build_sharded_polar_step(panel="scan"), init + 2
    steps, at 1e-8;
  * maybe_attach's eligibility on a stub script, and a build failure that
    raises through it; a per-type outer cutoff raises through both on a
    CUDA device rather than switching to the plain route;
  * chip_smoke.py path G's integrator gate (check_rigid_motion): 3
    float32 fused steps against 3 float64 plain-route host-mode steps;
  * the fluid shifted by +L/2 along x and left unwrapped gives the forces
    of the wrapped one to 1e-10 of their largest entry, and the pair
    template's tile-pair test (chip_smoke.far_tile_pairs, the kernel's
    far_tiles) drops no tile pair that holds a pair inside the cutoff on
    the unwrapped coordinates.
"""

import dataclasses
import os
from unittest import mock

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import chip_smoke  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.models import polar_bench  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar  # noqa: E402

N_SIDE = 5
NSTEPS = 5
PRECISION = 1e-11
BAR = 1e-8
COLS = ("etotal", "ke", "pe", "evdwl", "ecoul", "elong", "epol", "temp",
        "press")


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _jax_ff(dtype, **settings):
    """The synthetic fluid's JAX force field at PRECISION, and its tables
    carried across to the port (float64, on the CPU)."""
    from lidp_tpu import units
    from lidp_tpu.forcefield import ForceField
    from lidp_tpu.ops import polarization as pol
    from lidp_tpu.ops.ewald import EwaldParams, setup_ewald_disp
    from lidp_tpu.ops.pair import make_pair_params

    sysd = polar_bench.synthetic_system(N_SIDE)
    u = units.REAL
    n = sysd["x"].shape[0]
    es = setup_ewald_disp(accuracy_rel=polar_bench.EWALD_ACCURACY,
                          qqrd2e=u.qqr2e, q=sysd["q"], natoms=n,
                          cutoff=sysd["cut_coul"], box_lengths=sysd["L"])
    pair = make_pair_params(sysd["eps"], sysd["sig"], sysd["cut"],
                            cut_coul=sysd["cut_coul"], coul=True,
                            qqrd2e=u.qqr2e, g_ewald=es.g_ewald, dtype=dtype)
    ew = EwaldParams.from_setup(es, u.qqr2e, dtype=dtype)
    kw = dict(iterations_max=50, damping_type=pol.DAMPING_EXPONENTIAL,
              polar_precision=PRECISION, use_previous=True)
    s = pol.PolarizationSettings(**{**kw, **settings})
    ff = ForceField(pair=pair, ewald=ew, polar=s, qqrd2e=u.qqr2e)
    tff = convert.forcefield_from_numpy(
        _fields(pair), _fields(ew), _fields(s), u.qqr2e, device="cpu",
        dtype=torch.float64)
    return sysd, ff, tff


def _padded(sysd, npad):
    n = sysd["x"].shape[0]

    def pad(a, fill=0.0):
        a = np.asarray(a)
        out = np.full((npad,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return out

    return {k: pad(sysd[k], f) for k, f in (
        ("x", 0.0), ("v", 0.0), ("q", 0.0), ("type", 0), ("mol", 0),
        ("alpha", 0.0), ("mass", 1.0))} | {"mask": pad(np.ones(n, bool),
                                                       False)}


def _jax_run(mode, rigid):
    """JAX FastPolarRunner: setup + NSTEPS steps, one record per step
    (thermo row, x, v, mu, quat or None).  Returns (records, the JAX
    RigidSetup or None, the port's force field)."""
    from lidp_tpu import units
    from lidp_tpu.box import Box
    from lidp_tpu.integrate import nve, rigid as jrigid
    from lidp_tpu.integrate.driver import (Runner, nve_integrator,
                                           rigid_nve_integrator)
    from lidp_tpu.parallel.fast_polar import FastPolarRunner, aligned_npad
    from lidp_tpu.state import make_system
    from lidp_tpu.thermo import ThermoParams, thermo_row
    from lidp_tpu.topology import special_lists

    sysd, ff, tff = _jax_ff(jnp.float64)
    u = units.REAL
    n = sysd["x"].shape[0]
    npad = aligned_npad(n)
    a = _padded(sysd, npad)
    setup = None
    if rigid:
        setup = jrigid.setup_bodies(a["x"], a["mass"], a["mol"], a["mask"])
        params = jrigid.make_rigid_params(setup, polar_bench.DT, u.ftm2v,
                                          mass_atom=a["mass"])
        integ = rigid_nve_integrator(params, jnp.asarray(a["mass"]))
        dof = 3 * n - 3 - setup.dof_removed
    else:
        integ = nve_integrator(nve.NVEParams.create(
            polar_bench.DT, u.ftm2v, a["mass"]))
        dof = 3 * n - 3
    box = Box.create(np.zeros(3), sysd["L"], dtype=jnp.float64)
    sys = make_system(a["x"], box=box, v=a["v"], q=a["q"], type=a["type"],
                      mol=a["mol"], alpha=a["alpha"], mask=a["mask"],
                      dtype=jnp.float64)
    tp = ThermoParams.create(a["mass"], dof, u, False, n)
    with _mode(mode):
        runner = FastPolarRunner(
            Runner(ff, integ), ff=ff, pol=ff.polar, n=n, npad=npad,
            dt=polar_bench.DT, ftm2v=u.ftm2v, box_lo=np.zeros(3),
            box_lengths=sysd["L"],
            sp_lists=special_lists(n, sysd["bonds"]), dtype=jnp.float64)
    assert runner.mode == mode
    sys, res, nl, ist = runner.setup(sys)
    recs = []
    for k in range(NSTEPS + 1):
        if k:
            sys, res, nl, ist = runner.run(sys, res, nl, ist, 1)
        row = thermo_row(sys, res, tp,
                         extra_virial=getattr(ist, "virial", None))
        recs.append(dict(row={c: float(row[c]) for c in COLS},
                         x=np.asarray(sys.x)[:n], v=np.asarray(sys.v)[:n],
                         mu=np.asarray(sys.mu)[:n],
                         quat=np.asarray(ist.quat) if rigid else None))
    return recs, setup, tff


def _mode(mode):
    """The LIDP_FAST_POLAR_MODE environment of a runner's construction."""
    return mock.patch.dict(os.environ, {"LIDP_FAST_POLAR_MODE": mode})


def _port_run(mode, rigid, setup, tff):
    """The port's runner on the same state: build_rigid with the JAX
    body setup carried across, or build_rigid's system through a
    FastPolarRunner around nve_integrator."""
    from lidp_tpu_torch import units
    from lidp_tpu_torch.integrate import nve, rigid as trigid
    from lidp_tpu_torch.integrate.driver import nve_integrator

    with _mode(mode):
        bench = polar_bench.build_rigid(N_SIDE, dtype=torch.float64,
                                        device="cpu", ff=tff)
    runner = bench.runner
    assert runner.mode == mode
    if rigid:
        tsetup = convert.rigid_setup_from_numpy(_fields(setup))
        params = trigid.make_rigid_params(
            tsetup, polar_bench.DT, units.REAL.ftm2v,
            mass_atom=bench.runner.integ.params.mass_atom.numpy(),
            dtype=torch.float64, device="cpu")
        runner._inner.integ = dataclasses.replace(
            runner._inner.integ, params=params,
            init_state=lambda s, f, p: trigid.init_rigid_state(
                s, f, p, params.mass_atom))
    else:
        mass = bench.runner.integ.params.mass_atom
        runner._inner.integ = nve_integrator(nve.NVEParams.create(
            polar_bench.DT, units.REAL.ftm2v, mass, device="cpu"))
        bench.thermo = dataclasses.replace(bench.thermo,
                                           dof=3.0 * bench.natoms - 3)
    n = bench.natoms
    rows = [polar_bench.setup_rigid(bench)]
    states = [bench.state]
    for _ in range(NSTEPS):
        rows += polar_bench.run_rigid(bench, 1)
        states.append(bench.state)
    recs = []
    for row, (sys, res, ist) in zip(rows, states):
        recs.append(dict(row={c: float(row[c]) for c in COLS},
                         x=sys.x[:n].numpy(), v=sys.v[:n].numpy(),
                         mu=sys.mu[:n].numpy(),
                         quat=ist.quat.numpy() if rigid else None))
    return recs


@pytest.fixture(scope="module")
def runs():
    """{(mode, rigid): (JAX records, port records)}, each run at first
    use."""
    out = {}

    def get(mode, rigid):
        if (mode, rigid) not in out:
            jrecs, setup, tff = _jax_run(mode, rigid)
            out[mode, rigid] = (jrecs, _port_run(mode, rigid, setup, tff))
        return out[mode, rigid]
    return get


def _assert_match(j, t, k):
    for c in COLS:
        a, b = j["row"][c], t["row"][c]
        assert abs(a - b) <= BAR * max(1.0, abs(a)), (k, c, a, b)
    for name in ("x", "v", "mu", "quat"):
        if j[name] is None:
            continue
        np.testing.assert_allclose(t[name], j[name], rtol=0,
                                   atol=BAR * np.abs(j[name]).max(),
                                   err_msg=f"step {k} {name}")


@pytest.mark.parametrize("mode,rigid", [("fused", True), ("host", True),
                                        ("fused", False)],
                         ids=["rigid-fused", "rigid-host", "nve-fused"])
@pytest.mark.parametrize("k", range(NSTEPS + 1))
def test_runner_matches_jax(runs, mode, rigid, k):
    jrecs, trecs = runs(mode, rigid)
    _assert_match(jrecs[k], trecs[k], k)


def test_rigid_bodies_stay_rigid(runs):
    """After 5 steps each body's bond lengths are those of the setup and
    each quaternion has unit norm, in the port's run."""
    jrecs, trecs = runs("fused", True)
    x0 = trecs[0]["x"].reshape(-1, 3, 3)
    x5 = trecs[-1]["x"].reshape(-1, 3, 3)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        d0 = np.linalg.norm(x0[:, a] - x0[:, b], axis=1)
        d5 = np.linalg.norm(x5[:, a] - x5[:, b], axis=1)
        np.testing.assert_allclose(d5, d0, rtol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(trecs[-1]["quat"], axis=1),
                               1.0, atol=1e-14)
    assert not np.array_equal(x5, x0)


# --- the panel step's SCF modes against JAX's scan path --------------------

SCF_MODES = {"zodid": dict(zodid=True),
             "fixed_iteration": dict(fixed_iteration=True, iterations_max=3),
             "polar_gs": dict(polar_gs=True)}


@pytest.fixture(scope="module")
def scf_runs():
    out = {}

    def get(mode):
        if mode not in out:
            out[mode] = _scf_run(SCF_MODES[mode])
        return out[mode]
    return get


def _scf_run(settings):
    """init + 2 velocity-Verlet steps of the free fluid: JAX
    build_sharded_polar_step(panel="scan") and the port's PolarStep."""
    from lidp_tpu import topology, units
    from lidp_tpu.parallel import shard

    sysd, ff, tff = _jax_ff(jnp.float64, **settings)
    u = units.REAL
    n = sysd["x"].shape[0]
    make, bind_box, npad, bind_special = shard.build_sharded_polar_step(
        None, ff, ff.polar, n=n, dt=polar_bench.DT, ftm2v=u.ftm2v,
        dtype=jnp.float64, panel="scan")
    bind_box(sysd["L"])
    bind_special(*topology.special_lists(n, sysd["bonds"]))
    step, init = make(None)
    a = {k: jnp.asarray(v) for k, v in _padded(sysd, npad).items()}
    a["type"] = a["type"].astype(jnp.int32)
    a["mol"] = a["mol"].astype(jnp.int32)
    mu = jnp.zeros((npad, 3))
    f, mu, en = init(a["x"], a["q"], a["type"], a["mol"], a["alpha"], mu,
                     a["mask"])
    jrecs = [dict(f=f, mu=mu, **en)]
    x, v = a["x"], a["v"]
    for _ in range(2):
        x, v, mu, f, en = step(x, v, f, a["q"], a["type"], a["mol"],
                               a["alpha"], mu, a["mass"], a["mask"])
        jrecs.append(dict(f=f, mu=mu, x=x, **en))
    bench = polar_bench.build_synthetic(N_SIDE, dtype=torch.float64,
                                        device="cpu", ff=tff)
    f, en = polar_bench.setup_forces(bench)
    trecs = [dict(f=f, mu=bench.arrays["mu"], **en)]
    for _ in range(2):
        f, en = polar_bench.run_step(bench)
        trecs.append(dict(f=f, mu=bench.arrays["mu"], x=bench.arrays["x"],
                          **en))
    conv = [{k: np.asarray(val) for k, val in r.items()} for r in jrecs]
    tconv = [{k: (val.numpy() if torch.is_tensor(val) else np.asarray(val))
              for k, val in r.items()} for r in trecs]
    return conv, tconv, n


@pytest.mark.parametrize("mode", list(SCF_MODES))
def test_scf_modes_match_jax_scan(scf_runs, mode):
    jrecs, trecs, n = scf_runs(mode)
    for k, (j, t) in enumerate(zip(jrecs, trecs)):
        for e in ("evdwl", "ecoul", "elong", "epol"):
            assert float(t[e]) == pytest.approx(float(j[e]), rel=BAR), (k, e)
        np.testing.assert_allclose(t["virial"], j["virial"], rtol=BAR,
                                   atol=BAR * np.abs(j["virial"]).max())
        for name in ("f", "mu", "x"):
            if name not in j:
                continue
            ref = j[name][:n]
            np.testing.assert_allclose(t[name][:n], ref, rtol=0,
                                       atol=BAR * np.abs(ref).max(),
                                       err_msg=f"{mode} step {k} {name}")
        if mode == "zodid":
            assert int(t["scf_iters"]) == int(j["scf_iters"]) == 0
        elif mode == "fixed_iteration":
            assert int(t["scf_iters"]) == int(j["scf_iters"]) == 3
        else:
            assert abs(int(t["scf_iters"]) - int(j["scf_iters"])) <= 1
            assert int(t["scf_iters"]) > 3


# --- maybe_attach --------------------------------------------------------


class _Fix:
    style = "rigid/nve"


class _Pair:
    name = "lj/cut/coul/long/polarization"


class _Script:
    pair = _Pair()
    kspace = ("ewald/disp", 1e-4)
    box_tilt = None
    periodic = (True, True, True)
    fixes = {"1": _Fix()}
    bond_style = None
    angle_style = dihedral_style = improper_style = None
    neigh_exclude_types = None
    n_shard_devices = 0


def _attach(bench, **kw):
    from lidp_tpu_torch import units

    args = dict(script=_Script(), ff=bench.runner.ff,
                pol=bench.runner.ff.polar, sys=bench.system,
                n=bench.natoms, npad=bench.npad, dt=polar_bench.DT,
                ftm2v=units.REAL.ftm2v, dtype=torch.float64)
    args.update(kw)
    return fast_polar.maybe_attach(bench.runner._inner, **args)


def test_maybe_attach_eligibility(monkeypatch):
    """The eligibility gates return None; an eligible setup attaches a
    FastPolarRunner; a step that fails to build raises through
    maybe_attach (there is no dense path to fall back to)."""
    monkeypatch.delenv("LIDP_FAST_POLAR_MODE", raising=False)
    monkeypatch.setenv("LIDP_FAST_POLAR", "1")
    bench = polar_bench.build_rigid(N_SIDE, dtype=torch.float64,
                                    device="cpu")
    fr = _attach(bench)
    assert isinstance(fr, fast_polar.FastPolarRunner) and fr.mode == "fused"
    assert fr.integ is bench.runner._inner.integ
    assert _attach(bench, pol=None) is None
    monkeypatch.setenv("LIDP_FAST_POLAR", "0")
    assert _attach(bench) is None
    monkeypatch.delenv("LIDP_FAST_POLAR")
    assert _attach(bench) is None            # 375 atoms: the dense route
    assert fast_polar.prescan(_Script(), 10_000) is True
    s2 = _Script()
    s2.fixes = {"1": type("F", (), {"style": "nvt"})()}
    assert fast_polar.prescan(s2, 10_000) is False
    monkeypatch.setenv("LIDP_FAST_POLAR", "1")
    inner = dataclasses.replace(bench.runner._inner,
                                end_of_step=lambda s, r: s)
    assert fast_polar.maybe_attach(
        inner, script=_Script(), ff=bench.runner.ff,
        pol=bench.runner.ff.polar, sys=bench.system, n=bench.natoms,
        npad=bench.npad, dt=polar_bench.DT, ftm2v=1.0,
        dtype=torch.float64) is None
    lj_only = dataclasses.replace(
        bench.runner.ff, pair=dataclasses.replace(bench.runner.ff.pair,
                                                  coul=False))
    assert _attach(bench, ff=lj_only) is None
    with pytest.raises(ValueError, match="padding mismatch"):
        _attach(bench, npad=bench.npad + 256)


def test_per_type_cutoff_raises_on_cuda(monkeypatch):
    """A per-type outer cutoff (cut[1,1] = 7.0 A): the runner's default is
    panel="kernel", which on the CPU runs the plain versions with the
    per-type cutoff, and which for a CUDA device raises through
    FastPolarRunner and maybe_attach, naming panel='scan', before touching
    the device (no quiet switch to the plain route)."""
    import types

    monkeypatch.setenv("LIDP_FAST_POLAR", "1")
    bench = polar_bench.build_rigid(N_SIDE, dtype=torch.float64,
                                    device="cpu")
    cutsq = bench.runner.ff.pair.cutsq.clone()
    cutsq[1, 1] = 49.0
    ff = dataclasses.replace(bench.runner.ff, pair=dataclasses.replace(
        bench.runner.ff.pair, cutsq=cutsq))
    fr = _attach(bench, ff=ff)
    assert fr.step.has_df                 # the float64 kernel route
    assert float(fr.step.tabs[4, 1, 1]) == 49.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    with pytest.raises(ValueError, match="panel='scan'"):
        fast_polar.FastPolarRunner(
            bench.runner._inner, ff=ff, pol=ff.polar, n=bench.natoms,
            npad=bench.npad, dt=polar_bench.DT, ftm2v=1.0,
            box_lo=np.zeros(3), box_lengths=np.ones(3),
            dtype=torch.float64, device="cuda")
    on_cuda = types.SimpleNamespace(
        box=bench.system.box,
        x=types.SimpleNamespace(device=torch.device("cuda")))
    with pytest.raises(ValueError, match="panel='scan'"):
        _attach(bench, ff=ff, sys=on_cuda)


def test_float32_rigid_steps_track_float64(monkeypatch):
    """chip_smoke.py path G's integrator gate on the 375-atom fluid: 3
    float32 fused steps against 3 float64 host-mode steps of the plain
    route (G64's), atom displacements and quaternion changes within 1e-2
    of the plain route's largest (check_rigid_motion)."""
    monkeypatch.delenv("LIDP_FAST_POLAR_MODE", raising=False)
    g = polar_bench.build_rigid(N_SIDE, device="cpu")
    monkeypatch.setenv("LIDP_FAST_POLAR_MODE", "host")
    p = polar_bench.build_rigid(N_SIDE, dtype=torch.float64, device="cpu",
                                precision=PRECISION, panel="scan")
    xq = []
    for bench in (g, p):
        polar_bench.setup_rigid(bench)
        xq.append(chip_smoke.rigid_xq(bench.state, bench.natoms))
        polar_bench.run_rigid(bench, chip_smoke.G64_STEPS)
        xq.append(chip_smoke.rigid_xq(bench.state, bench.natoms))
    chip_smoke.check_rigid_motion(*xq)


# --- unwrapped coordinates ----------------------------------------------


def test_unwrapped_shift_gives_the_wrapped_forces():
    """The fluid moved by +L/2 along x: left unwrapped (half of the atoms
    beyond the box) and wrapped back, the panel engine gives the same
    forces, dipoles and energies; and far_tiles keeps every tile pair that
    holds a pair inside the outer cutoff."""
    bench = polar_bench.build_rigid(8, dtype=torch.float64, device="cpu",
                                    precision=1e-12)
    sys0 = bench.system
    L = sys0.box.lengths
    shift = torch.zeros(3, dtype=torch.float64)
    shift[0] = 0.5 * float(L[0])
    xu = torch.where(sys0.mask[:, None], sys0.x + shift, 0.0)
    xw = torch.where(sys0.mask[:, None], xu - torch.floor(xu / L) * L, 0.0)
    assert bool((xu[:, 0] >= L[0]).any())
    outs = []
    for x in (xu, xw):
        res = bench.runner.forces(sys0.replace(x=x))
        outs.append(res)
    ru, rw = outs
    n = bench.natoms
    for a, b in ((ru.f, rw.f), (ru.mu, rw.mu)):
        np.testing.assert_allclose(a[:n].numpy(), b[:n].numpy(), rtol=0,
                                   atol=1e-10 * float(b[:n].abs().max()))
    for e in ("evdwl", "ecoul", "elong", "epol"):
        assert float(getattr(ru, e)) == pytest.approx(
            float(getattr(rw, e)), rel=1e-10), e
    # the whole pair kernel's tile-pair test on the unwrapped coordinates
    step = bench.runner.step
    rc = float(step.tabs[4].max()) ** 0.5
    tile = 128
    far = chip_smoke.far_tile_pairs(xu.float(), sys0.mask.float(),
                                    L.float(), tile, rc)
    d = xu[:, None, :] - xu[None, :, :]
    d = d - L * torch.round(d / L)
    near = (d * d).sum(-1) < rc * rc
    live = sys0.mask[:, None] & sys0.mask[None, :]
    nT = far.shape[0]
    held = torch.zeros((nT, nT), dtype=torch.bool)
    ti = torch.arange(xu.shape[0]) // tile
    idx = torch.nonzero(near & live)
    held[ti[idx[:, 0]], ti[idx[:, 1]]] = True
    assert not bool((far & held).any())
    assert bool(far.any())
