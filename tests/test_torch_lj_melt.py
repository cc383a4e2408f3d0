"""The port's LJ melt slice as a whole against the JAX package on the CPU:
`lj_melt.build`, `SlotRunner`, the generic `Runner` on cells, `thermo_row`.

The JAX `SlotRunner` runs its Pallas kernel in interpret mode, as in
tests/test_slot_runner.py; the port runs the plain versions of its kernels
(the tensors lie on the CPU).  float32 trajectories of 40 steps with two
rebuilds: etotal and temp rel 1e-5, press rel 1e-4, positions 1e-4 modulo
the box (rounding-level differences between two summation orders, grown
over 40 steps of a melt).  float64: rel 1e-10.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# small tensors: one torch thread per test worker beats several workers
# spinning on the same cores
torch.set_num_threads(1)

from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.forcefield import ForceField  # noqa: E402
from lidp_tpu_torch.integrate import nve as tnve  # noqa: E402
from lidp_tpu_torch.integrate.driver import (RespaRunner, Runner,  # noqa: E402
                                             nve_integrator,
                                             rigid_nve_integrator)
from lidp_tpu_torch.integrate.slot_runner import SlotRunner  # noqa: E402
from lidp_tpu_torch.models import lj_melt  # noqa: E402
from lidp_tpu_torch.ops.cells import CellConfig  # noqa: E402
from lidp_tpu_torch.thermo import ThermoParams, thermo_row  # noqa: E402
from lidp_tpu_torch import units as tunits  # noqa: E402

NSTEPS = 40
EVERY = 16          # rebuilds at steps 16 and 32, then 8 quiet steps
DT = 0.005
COLS = ("temp", "pe", "ke", "etotal", "evdwl", "press", "vol", "density")


def _fields(obj):
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _fluid(dtype):
    """400 atoms on a jittered lattice in a cubic box of 4 bins a side,
    Maxwell velocities at T* = 1.2 with zero total momentum."""
    rs = np.random.RandomState(1)
    Lb = 4 * 2.9
    n = 400
    g = np.stack(np.meshgrid(*[np.linspace(0, Lb, 8, endpoint=False)] * 3),
                 -1).reshape(-1, 3)
    x = g[rs.permutation(512)[:n]] + rs.uniform(0, 0.45, (n, 3))
    v = rs.normal(0, np.sqrt(1.2), (n, 3))
    v -= v.mean(0)
    return x.astype(dtype), v.astype(dtype), Lb, n


def _both(dtype):
    """The fluid as a System, pair table, cell config and thermo params in
    both packages."""
    from lidp_tpu import box as jbox
    from lidp_tpu import thermo as jthermo
    from lidp_tpu import units as junits
    from lidp_tpu.ops import cells as jcells
    from lidp_tpu.ops.pair import make_pair_params as jmake
    from lidp_tpu.state import make_system as jsys

    x, v, Lb, n = _fluid(dtype)
    jd = jnp.float32 if dtype == np.float32 else jnp.float64
    td = torch.float32 if dtype == np.float32 else torch.float64
    eps = np.zeros((2, 2)); sig = np.zeros((2, 2)); cut = np.zeros((2, 2))
    eps[1, 1] = 1.0; sig[1, 1] = 1.0; cut[1, 1] = 2.5
    pj = jmake(eps, sig, cut, dtype=jd)
    cfg = jcells.CellConfig.for_box([Lb] * 3, 2.9, density=n / Lb**3,
                                    cap_slack=3.0)
    sj = jsys(x, box=jbox.Box.create(np.zeros(3), np.full(3, Lb)), v=v,
              dtype=jd)
    tpj = jthermo.ThermoParams.create(np.ones(n), 3 * n - 3, junits.LJ,
                                      norm=True, natoms=n)
    d = {k: v_ for k, v_ in _fields(sj).items() if k != "box"}
    d["box"] = dict(lo=np.asarray(sj.box.lo), hi=np.asarray(sj.box.hi))
    st = convert.system_from_numpy(d, device="cpu")
    pt = convert.pair_from_numpy(_fields(pj), device="cpu", dtype=td)
    tpt = ThermoParams.create(np.ones(n), 3 * n - 3, tunits.LJ, norm=True,
                              natoms=n, dtype=td)
    tcfg = CellConfig(cfg.nbins, cfg.cap, cfg.cutneigh)
    return dict(sys=sj, pair=pj, cfg=cfg, tp=tpj), \
        dict(sys=st, pair=pt, cfg=tcfg, tp=tpt), Lb, n


def _rows_close(rt, rj, rel_e, rel_p):
    assert rt["step"] == int(rj["step"])
    for k in COLS:
        rel = rel_p if k == "press" else rel_e
        assert rt[k] == pytest.approx(float(rj[k]), rel=rel), k
    for k in ("ecoul", "elong", "epol", "emol", "xy"):
        assert rt[k] == 0.0


def _x_close(xt, xj, Lb, tol):
    d = xt.double().numpy() - np.asarray(xj, np.float64)
    d -= Lb * np.round(d / Lb)
    assert np.abs(d).max() <= tol, np.abs(d).max()


@pytest.fixture(scope="module")
def jax_slot_run():
    """The JAX SlotRunner: setup, 40 steps (rebuild every 16)."""
    import jax
    from lidp_tpu import thermo as jthermo
    from lidp_tpu.forcefield import ForceField as JFF
    from lidp_tpu.integrate.slot_runner import SlotRunner as JSlot

    j, t, Lb, n = _both(np.float32)
    r = JSlot(ff=JFF(pair=j["pair"]), neighbor_cfg=j["cfg"], dt=DT,
              ftm2v=1.0, n=n, rebuild_every=EVERY)
    s0, res0, nl0, c0 = r.setup(j["sys"])
    row0 = jax.device_get(jthermo.thermo_row(s0, res0, j["tp"]))
    s1, res1, nl1, c1 = r.run(s0, res0, nl0, c0, NSTEPS)
    row1 = jax.device_get(jthermo.thermo_row(s1, res1, j["tp"]))
    assert not bool(nl1.overflow)
    return dict(t=t, Lb=Lb, n=n, c0=c0, row0=row0, row1=row1,
                f0=np.asarray(res0.f), x1=np.asarray(s1.x),
                v1=np.asarray(s1.v), c1=c1)


@pytest.fixture(scope="module")
def torch_slot_run(jax_slot_run):
    t, n = jax_slot_run["t"], jax_slot_run["n"]
    r = SlotRunner(ff=ForceField(pair=t["pair"]), neighbor_cfg=t["cfg"],
                   dt=DT, ftm2v=1.0, n=n, rebuild_every=EVERY)
    s0, res0, nl0, c0 = r.setup(t["sys"])
    row0 = thermo_row(s0, res0, t["tp"])
    s1, res1, nl1, c1 = r.run(s0, res0, nl0, c0, NSTEPS)
    row1 = thermo_row(s1, res1, t["tp"])
    return dict(runner=r, s0=s0, res0=res0, c0=c0, row0=row0, s1=s1,
                res1=res1, nl1=nl1, c1=c1, row1=row1)


def test_slot_runner_setup_matches_jax(jax_slot_run, torch_slot_run):
    j, t = jax_slot_run, torch_slot_run
    # the slotted state is the same, slot for slot
    for name in ("v", "invm", "aid"):
        np.testing.assert_array_equal(
            getattr(t["c0"], name).numpy(), np.asarray(getattr(j["c0"], name)),
            err_msg=name)
    live = (t["c0"].aid < j["n"]).numpy()
    xt, xj = t["c0"].x.numpy(), np.asarray(j["c0"].x)
    np.testing.assert_array_equal(xt[live], xj[live])
    # the sentinels base + spacing*k may round differently (fused or not)
    np.testing.assert_allclose(xt[~live], xj[~live], rtol=1e-6)
    assert t["c0"].step == 0 and not bool(t["c0"].overflow)
    cc = convert.slot_carry_from_numpy(_fields(j["c0"]), device="cpu")
    assert torch.equal(cc.aid, t["c0"].aid) and cc.step == 0
    assert cc.x.dtype == torch.float32 and cc.overflow.dtype == torch.bool
    _rows_close(t["row0"], j["row0"], 1e-5, 1e-5)
    f0 = t["res0"].f.numpy()
    assert np.abs(f0 - j["f0"]).max() <= 5e-6 * np.abs(j["f0"]).max()
    assert t["res0"].f.dtype == torch.float32


def test_slot_runner_40_steps_match_jax(jax_slot_run, torch_slot_run):
    j, t = jax_slot_run, torch_slot_run
    assert t["s1"].step == NSTEPS == t["c1"].step
    assert not bool(t["nl1"].overflow)
    _rows_close(t["row1"], j["row1"], 1e-5, 1e-4)
    _x_close(t["s1"].x, j["x1"], j["Lb"], 1e-4)
    assert np.abs(t["s1"].v.numpy() - j["v1"]).max() <= 1e-3
    # the melt moved: the comparison is not of two frozen lattices
    assert np.abs(t["s1"].x.numpy() - t["s0"].x.numpy()).max() > 0.1
    # energy conservation over the run (the unshifted cutoff lets etotal
    # step by 0.016 per pair crossing it): 0.01 of a ke of 1.8 per atom
    assert abs(t["row1"]["etotal"] - t["row0"]["etotal"]) < 0.01
    assert t["row0"]["ke"] > 1.5
    # atoms kept their identity through two re-slottings
    aid = t["c1"].aid.reshape(-1)
    live = aid < j["n"]
    assert int(live.sum()) == j["n"]
    assert torch.equal(torch.sort(aid[live]).values,
                       torch.arange(j["n"], dtype=torch.int32))


def test_slot_runner_run_counts_from_call_start(torch_slot_run):
    """Rebuild steps are counted from the start of each run call: two calls
    of 20 (one rebuild each, at their 16th step) differ from one call of 40
    (rebuilds at 16 and 32) only by rounding."""
    t = torch_slot_run
    r = t["runner"]
    s, res, nl, c = r.run(t["s0"], t["res0"], None, t["c0"], 20)
    assert s.step == 20
    s, res, nl, c = r.run(s, res, nl, c, 20)
    assert s.step == 40
    row = thermo_row(s, res, _TP(t))
    assert row["etotal"] == pytest.approx(t["row1"]["etotal"], rel=1e-5)
    _x_close(s.x, t["s1"].x.numpy(), 11.6, 1e-3)


def _TP(t):
    n = t["s0"].n
    return ThermoParams.create(np.ones(n), 3 * n - 3, tunits.LJ, norm=True,
                               natoms=n, dtype=torch.float32)


def test_slot_runner_matches_runner_on_cells(torch_slot_run):
    """The port's generic Runner on cells (float32, same rebuild schedule)
    against the port's SlotRunner."""
    _, t, Lb, n = _both(np.float32)
    nvep = tnve.NVEParams.create(DT, 1.0, np.ones(n), dtype=torch.float32)
    r = Runner(ff=ForceField(pair=t["pair"]), integ=nve_integrator(nvep),
               neighbor_cfg=t["cfg"], rebuild_every=EVERY)
    s, res, nl, ist = r.setup(t["sys"])
    row0 = thermo_row(s, res, t["tp"])
    s, res, nl, ist = r.run(s, res, nl, ist, NSTEPS)
    row1 = thermo_row(s, res, t["tp"])
    assert s.step == NSTEPS and nl.last_build == 32
    assert not bool(nl.overflow)
    ref = torch_slot_run
    for a, b, relp in ((row0, ref["row0"], 1e-5), (row1, ref["row1"], 1e-4)):
        for k in COLS:
            assert a[k] == pytest.approx(b[k], rel=relp if k == "press"
                                         else 1e-5), k
    _x_close(s.x, ref["s1"].x.numpy(), Lb, 1e-4)


@pytest.mark.parametrize("check", [False, True])
def test_runner_on_cells_matches_jax_float64(check):
    """The generic Runner, NVE on cells, float64: every 4 steps with delay
    8; with check=True only when an atom moved more than skin/2."""
    from lidp_tpu import thermo as jthermo
    from lidp_tpu.forcefield import ForceField as JFF
    from lidp_tpu.integrate import nve as jnve
    from lidp_tpu.integrate.driver import Runner as JRunner
    from lidp_tpu.integrate.driver import nve_integrator as jnve_integ

    j, t, Lb, n = _both(np.float64)
    kw = dict(rebuild_every=4, delay=8, check=check, skin=0.4)
    rj = JRunner(ff=JFF(pair=j["pair"]),
                 integ=jnve_integ(jnve.NVEParams.create(DT, 1.0, np.ones(n))),
                 neighbor_cfg=j["cfg"], **kw)
    rt = Runner(ff=ForceField(pair=t["pair"]),
                integ=nve_integrator(tnve.NVEParams.create(DT, 1.0,
                                                           np.ones(n))),
                neighbor_cfg=t["cfg"], **kw)
    cj = rj.setup(j["sys"])
    ct = rt.setup(t["sys"])
    _rows_close(thermo_row(ct[0], ct[1], t["tp"]),
                jthermo.thermo_row(cj[0], cj[1], j["tp"]), 1e-10, 1e-10)
    for _ in range(2):
        cj = rj.run(*cj, 15)
        ct = rt.run(*ct, 15)
        assert ct[2].last_build == int(cj[2].last_build)
        _rows_close(thermo_row(ct[0], ct[1], t["tp"]),
                    jthermo.thermo_row(cj[0], cj[1], j["tp"]), 1e-10, 1e-10)
    assert ct[2].last_build > 0
    np.testing.assert_allclose(ct[0].x.numpy(), np.asarray(cj[0].x),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(ct[0].image.numpy(),
                                  np.asarray(cj[0].image))
    np.testing.assert_array_equal(ct[2].nlist.atom_of_slot.numpy(),
                                  np.asarray(cj[2].nlist.atom_of_slot))


def test_runner_every_step_ev_and_hooks():
    """every_step_ev tallies energies inside the run; the hooks are called
    once per step, post_force may add a virial."""
    _, t, Lb, n = _both(np.float64)
    nvep = tnve.NVEParams.create(DT, 1.0, np.ones(n))
    calls = dict(pf=0, eos=0, pi=0)

    def post_force(sys, f):
        calls["pf"] += 1
        return f, torch.ones(6, dtype=f.dtype)

    def end_of_step(sys, res):
        calls["eos"] += 1
        assert float(res.evdwl) != 0.0
        return sys

    def post_integrate(sys):
        calls["pi"] += 1
        return sys

    base = Runner(ff=ForceField(pair=t["pair"]), integ=nve_integrator(nvep),
                  neighbor_cfg=t["cfg"], rebuild_every=5)
    hooked = dataclasses.replace(base, every_step_ev=True,
                                 post_force=post_force,
                                 end_of_step=end_of_step,
                                 post_integrate=post_integrate)
    a = base.run(*base.setup(t["sys"]), 6)
    b = hooked.run(*hooked.setup(t["sys"]), 6)
    assert calls == dict(pf=7, eos=6, pi=6)
    assert torch.equal(a[0].x, b[0].x)
    assert float(b[1].evdwl) == pytest.approx(float(a[1].evdwl), rel=1e-12)
    np.testing.assert_allclose(b[1].virial.numpy(), a[1].virial.numpy() + 1)


def test_runner_kahan_variant_runs():
    """The compensated integrator through the Runner: float32 with Kahan
    tracks the float64 trajectory at least as well as plain float32."""
    out = {}
    for name, dtype, comp in (("f64", np.float64, False),
                              ("f32", np.float32, False),
                              ("kahan", np.float32, True)):
        _, t, Lb, n = _both(dtype)
        td = t["sys"].x.dtype
        nvep = tnve.NVEParams.create(DT, 1.0, np.ones(n), dtype=td)
        r = Runner(ff=ForceField(pair=t["pair"]),
                   integ=nve_integrator(nvep, compensated=comp),
                   neighbor_cfg=t["cfg"], rebuild_every=10)
        c = r.setup(t["sys"])
        assert (len(c[3]) == 2) == comp
        out[name] = r.run(*c, 20)[0].x.double()
    err = {k: float((out[k] - out["f64"]).abs().max())
           for k in ("f32", "kahan")}
    assert err["kahan"] <= err["f32"] * 1.5 and err["kahan"] < 1e-3


def test_unported_options_raise():
    _, t, Lb, n = _both(np.float64)
    ff = ForceField(pair=t["pair"])
    integ = nve_integrator(tnve.NVEParams.create(DT, 1.0, np.ones(n)))
    # shrink is ported (tests/test_torch_nonperiodic.py), and so are
    # deform and tmd_hook (tests/test_torch_deform_tmd.py)
    # no neighbor_cfg is the dense route (ported): its setup forces are
    # the cell route's
    _, rd, _, _ = Runner(ff=ff, integ=integ).setup(t["sys"])
    _, rc, _, _ = Runner(ff=ff, integ=integ,
                         neighbor_cfg=t["cfg"]).setup(t["sys"])
    np.testing.assert_allclose(rd.f.numpy(), rc.f.numpy(), rtol=0,
                               atol=1e-10 * float(rc.f.abs().max()))
    with pytest.raises(NotImplementedError, match="neighbor.py"):
        Runner(ff=ff, integ=integ, neighbor_cfg=object()).setup(t["sys"])
    # rigid/nve, its thermostat and its barostat are ported (tests/
    # test_torch_rigid.py, test_torch_thermostats.py, test_torch_npt.py):
    # pstat=True, which raised here, gives the JAX package's fields
    from lidp_tpu.integrate import rigid as jrigid
    from lidp_tpu_torch.integrate import rigid
    from tests.test_torch_rigid import barostat_fields_match

    setup = rigid.setup_bodies(np.zeros((3, 3)) + np.eye(3), np.ones(3),
                               np.ones(3, np.int64), np.ones(3, bool))
    assert rigid_nve_integrator(None, None).params is None
    assert rigid.make_rigid_params(setup, DT, 1.0, device="cpu",
                                   tstat=True, t_start=1.0).tstat
    barostat_fields_match(
        rigid.make_rigid_params(setup, DT, 1.0, device="cpu", pstat=True),
        jrigid.make_rigid_params(jrigid.setup_bodies(
            np.zeros((3, 3)) + np.eye(3), np.ones(3), np.ones(3, np.int64),
            np.ones(3, bool)), DT, 1.0, pstat=True))
    with pytest.raises(NotImplementedError, match="RespaRunner"):
        RespaRunner(ff=ff)


# ------------------------------ lj_melt.build -----------------------------

@pytest.fixture(scope="module")
def melts():
    """scale 0.3: 864 atoms, 3 bins a side.  cap_slack 3.0: the lattice
    planes lie on the bin faces, so the default slack overflows at this
    size."""
    from lidp_tpu.models import lj_melt as jmelt

    out = {}
    for nb, dtype in (("cells", "float64"), ("slots", "float32")):
        out[nb] = (
            jmelt.build(scale=0.3, dtype=getattr(jnp, dtype), neighbor=nb,
                        cap_slack=3.0),
            lj_melt.build(scale=0.3, dtype=getattr(torch, dtype),
                          neighbor=nb, cap_slack=3.0, device="cpu"))
    return out


@pytest.mark.parametrize("nb", ["cells", "slots"])
def test_lj_melt_build_equal(melts, nb):
    mj, mt = melts[nb]
    assert mt.natoms == mj.natoms == 864
    np.testing.assert_array_equal(mt.system.x.numpy(),
                                  np.asarray(mj.system.x))
    np.testing.assert_array_equal(mt.system.v.numpy(),
                                  np.asarray(mj.system.v))
    np.testing.assert_array_equal(mt.system.box.hi.numpy(),
                                  np.asarray(mj.system.box.hi))
    cj, ct = mj.runner.neighbor_cfg, mt.runner.neighbor_cfg
    assert (ct.nbins, ct.cap, ct.cutneigh) == (cj.nbins, cj.cap, cj.cutneigh)
    assert ct.nbins == (3, 3, 3)
    assert mt.runner.rebuild_every == 20
    assert isinstance(mt.runner, SlotRunner if nb == "slots" else Runner)
    assert mt.thermo.dof == mj.thermo.dof == 3 * 864 - 3


@pytest.mark.parametrize("nb", ["cells", "slots"])
def test_lj_melt_step0_row(melts, nb):
    from lidp_tpu import thermo as jthermo

    mj, mt = melts[nb]
    sj, rj, nj, _ = mj.runner.setup(mj.system)
    st, rt, nt, _ = mt.runner.setup(mt.system)
    assert not bool(nj.overflow) and not bool(nt.overflow)
    rel = 1e-10 if nb == "cells" else 1e-5
    rowt = thermo_row(st, rt, mt.thermo)
    _rows_close(rowt, jthermo.thermo_row(sj, rj, mj.thermo), rel, rel)
    assert rowt["temp"] == pytest.approx(1.44, rel=1e-6)
    # the 32,000-atom melt's per-atom energy, to the size effect of 864
    assert rowt["pe"] == pytest.approx(-6.7733681, rel=1e-3)


def test_lj_melt_default_slack_and_modes():
    m = lj_melt.build(scale=0.3, dtype=torch.float32, device="cpu")
    assert isinstance(m.runner, Runner) and m.runner.neighbor_cfg.cap == 48
    for mode in ("list", "none"):
        with pytest.raises(NotImplementedError, match="neighbor.py"):
            lj_melt.build(scale=0.3, neighbor=mode, device="cpu")
    with pytest.raises(ValueError, match="unknown neighbor"):
        lj_melt.build(scale=0.3, neighbor="grid", device="cpu")
    with pytest.raises(ValueError, match=">= 3 bins"):
        lj_melt.build(scale=0.25, device="cpu")


def test_lj_melt_two_bins_raises_in_jax_too():
    from lidp_tpu.models import lj_melt as jmelt

    with pytest.raises(ValueError, match=">= 3 bins"):
        jmelt.build(scale=0.25, neighbor="cells")


def _load_chip_smoke():
    """chip_smoke.py at the repository root, as a module (it imports only
    the standard library until one of its functions is called)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ragged_case_is_ragged():
    """The ragged kernel input of chip_smoke.py and the `cuda` tests."""
    from lidp_tpu_torch.ops.cells import build_cells

    c = _load_chip_smoke().ragged_lj_case("cpu")
    cells = build_cells(c["x"], c["mask"], c["box"], c["cfg"])
    occ = (cells.atom_of_slot < c["n"]).sum(-1)
    assert not bool(cells.overflow)
    assert int(occ.max()) == c["cfg"].cap == 16 and int(occ.min()) == 0
    assert c["cfg"].nbins == (3, 4, 5) and not bool(c["mask"].all())
