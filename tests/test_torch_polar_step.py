"""The port's polarizable MD step (lidp_tpu_torch) against the JAX panel
engine (lidp_tpu.parallel.shard.build_sharded_polar_step, mesh=None) on the
synthetic 375-atom fluid, init plus 3 velocity-Verlet steps, with the
force-field tables carried across by lidp_tpu_torch.convert.

float64: JAX panel="scan" vs the port on the CPU at polar_precision 1e-10 —
evdwl/ecoul/elong rel 1e-10, epol and virial rel 1e-8, f, mu, x, v to
1e-8*max (BASELINE.md's 1e-8 bar), scf_iters within 1 — with exponential
damping and a warm start, and as variants (F64_VARIANTS): a per-type outer
cutoff (cut[1,1] = 7.0 A above cut_coul 6.5, the other pairs 6.0), the
reference's default damping none, a cold start (use_previous off), and a
solve cut at 3 iterations.
float32: JAX panel="pallas" (interpret) vs the port, with the tolerances
of tests/test_pallas_panel.py:29-55.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.models import polar_bench  # noqa: E402

N_SIDE = 5
NSTEPS = 3


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


# f64 parity variants: (cut[1,1] or None, PolarizationSettings overrides)
F64_VARIANTS = {
    "base": (None, {}),
    "cut7": (7.0, {}),
    "damp_none": (None, dict(damping_type=0)),
    "cold": (None, dict(use_previous=False)),
    "iter3": (None, dict(iterations_max=3)),
}


def _jax_run(dtype, panel, precision, cut11=None, **settings):
    """JAX init + NSTEPS steps on the synthetic system, with cut[1,1] =
    cut11 when given and `settings` over the polarization defaults below.
    Returns the port's ForceField converted from the JAX tables, and a list
    of per-evaluation records (init first)."""
    from lidp_tpu import topology, units
    from lidp_tpu.forcefield import ForceField
    from lidp_tpu.ops import polarization as pol
    from lidp_tpu.ops.ewald import EwaldParams, setup_ewald_disp
    from lidp_tpu.ops.pair import make_pair_params
    from lidp_tpu.parallel import shard

    sysd = polar_bench.synthetic_system(N_SIDE)
    u = units.REAL
    n = sysd["x"].shape[0]
    es = setup_ewald_disp(accuracy_rel=polar_bench.EWALD_ACCURACY,
                          qqrd2e=u.qqr2e, q=sysd["q"], natoms=n,
                          cutoff=sysd["cut_coul"], box_lengths=sysd["L"])
    cut = np.array(sysd["cut"], dtype=float)
    if cut11 is not None:
        cut[1, 1] = cut11
    pair = make_pair_params(sysd["eps"], sysd["sig"], cut,
                            cut_coul=sysd["cut_coul"], coul=True,
                            qqrd2e=u.qqr2e, g_ewald=es.g_ewald, dtype=dtype)
    ew = EwaldParams.from_setup(es, u.qqr2e, dtype=dtype)
    kw = dict(iterations_max=50, damping_type=pol.DAMPING_EXPONENTIAL,
              polar_precision=precision, use_previous=True)
    s = pol.PolarizationSettings(**{**kw, **settings})
    ff = ForceField(pair=pair, ewald=ew, polar=s, qqrd2e=u.qqr2e)
    make, bind_box, npad, bind_special = shard.build_sharded_polar_step(
        None, ff, s, n=n, dt=polar_bench.DT, ftm2v=u.ftm2v, dtype=dtype,
        panel=panel)
    bind_box(sysd["L"])
    bind_special(*topology.special_lists(n, sysd["bonds"]))
    step, init = make(None)

    npd = np.float64 if dtype == jnp.float64 else np.float32

    def pad(a, fill=0.0, dt=npd):
        out = np.full((npad,) + np.shape(a)[1:], fill, dt)
        out[:n] = a
        return jnp.asarray(out)

    x, v = pad(sysd["x"]), pad(sysd["v"])
    q, alpha = pad(sysd["q"]), pad(sysd["alpha"])
    typ = pad(sysd["type"], 0, np.int32)
    mol = pad(sysd["mol"], 0, np.int32)
    mass = pad(sysd["mass"], 1.0)
    mask = pad(np.ones(n, bool), False, bool)
    f, mu, en = init(x, q, typ, mol, alpha, pad(np.zeros((n, 3))), mask)
    recs = [dict(f=f, mu=mu, x=x, v=v, **en)]
    for _ in range(NSTEPS):
        x, v, mu, f, en = step(x, v, f, q, typ, mol, alpha, mu, mass, mask)
        recs.append(dict(f=f, mu=mu, x=x, v=v, **en))
    recs = [{k: np.asarray(val) for k, val in r.items()} for r in recs]
    tff = convert.forcefield_from_numpy(
        _fields(pair), _fields(ew), _fields(s), u.qqr2e, device="cpu",
        dtype=torch.float64 if dtype == jnp.float64 else torch.float32)
    return tff, recs, n


def _port_run(tff, dtype):
    bench = polar_bench.build_synthetic(N_SIDE, dtype=dtype, device="cpu",
                                        ff=tff)
    f, en = polar_bench.setup_forces(bench)
    a = bench.arrays
    recs = [dict(f=f, mu=a["mu"], x=a["x"], v=a["v"], **en)]
    for _ in range(NSTEPS):
        f, en = polar_bench.run_step(bench)
        recs.append(dict(f=f, mu=a["mu"], x=a["x"], v=a["v"], **en))
    return [{k: (val.numpy() if torch.is_tensor(val) else np.asarray(val))
             for k, val in r.items()} for r in recs]


@pytest.fixture(scope="module")
def f64_runs():
    """{variant: (JAX records, port records, n)}, each run at first use."""
    runs = {}

    def get(variant):
        if variant not in runs:
            cut11, settings = F64_VARIANTS[variant]
            tff, jrecs, n = _jax_run(jnp.float64, "scan", 1e-10, cut11,
                                     **settings)
            runs[variant] = (jrecs, _port_run(tff, torch.float64), n)
        return runs[variant]
    return get


@pytest.fixture(scope="module")
def f32_runs():
    tff, jrecs, n = _jax_run(jnp.float32, "pallas", 1e-6)
    return jrecs, _port_run(tff, torch.float32), n


@pytest.mark.parametrize("variant,k", [
    pytest.param(v, k, id=str(k) if v == "base" else f"{v}-{k}")
    for v in F64_VARIANTS for k in range(NSTEPS + 1)])
def test_f64_matches_jax_scan(f64_runs, variant, k):
    jrecs, trecs, n = f64_runs(variant)
    j, t = jrecs[k], trecs[k]
    for e in ("evdwl", "ecoul", "elong"):
        assert float(t[e]) == pytest.approx(float(j[e]), rel=1e-10), e
    assert float(t["epol"]) == pytest.approx(float(j["epol"]), rel=1e-8)
    np.testing.assert_allclose(t["virial"], j["virial"], rtol=1e-8,
                               atol=1e-8 * np.abs(j["virial"]).max())
    for a in ("f", "mu", "x", "v"):
        ref = j[a][:n]
        np.testing.assert_allclose(t[a][:n], ref, rtol=0,
                                   atol=1e-8 * np.abs(ref).max(), err_msg=a)
    assert abs(int(t["scf_iters"]) - int(j["scf_iters"])) <= 1


def test_f32_init_matches_jax_pallas(f32_runs):
    jrecs, trecs, n = f32_runs
    j, t = jrecs[0], trecs[0]
    for e in ("evdwl", "ecoul", "elong"):
        assert float(t[e]) == pytest.approx(float(j[e]), rel=5e-6), e
    assert float(t["epol"]) == pytest.approx(float(j["epol"]), rel=1e-4,
                                             abs=2e-2)
    for a in ("f", "mu"):
        ref = j[a][:n]
        np.testing.assert_allclose(t[a][:n], ref, rtol=5e-4,
                                   atol=5e-5 * np.abs(ref).max(), err_msg=a)


@pytest.mark.parametrize("k", range(1, NSTEPS + 1))
def test_f32_steps_track_jax_pallas(f32_runs, k):
    jrecs, trecs, n = f32_runs
    j, t = jrecs[k], trecs[k]
    assert abs(int(t["scf_iters"]) - int(j["scf_iters"])) <= 1
    ref = j["f"][:n]
    np.testing.assert_allclose(t["f"][:n], ref, rtol=1e-3,
                               atol=2e-4 * np.abs(ref).max())


def test_own_forcefield_equals_converted():
    """build_synthetic's own tables are the JAX package's tables."""
    from lidp_tpu import units
    from lidp_tpu.ops.ewald import EwaldParams, setup_ewald_disp
    from lidp_tpu.ops.pair import make_pair_params

    sysd = polar_bench.synthetic_system(N_SIDE)
    u = units.REAL
    es = setup_ewald_disp(accuracy_rel=polar_bench.EWALD_ACCURACY,
                          qqrd2e=u.qqr2e, q=sysd["q"],
                          natoms=sysd["x"].shape[0],
                          cutoff=sysd["cut_coul"], box_lengths=sysd["L"])
    pair = make_pair_params(sysd["eps"], sysd["sig"], sysd["cut"],
                            cut_coul=sysd["cut_coul"], coul=True,
                            qqrd2e=u.qqr2e, g_ewald=es.g_ewald,
                            dtype=jnp.float64)
    ew = EwaldParams.from_setup(es, u.qqr2e, dtype=jnp.float64)
    own = polar_bench.synthetic_forcefield(sysd, torch.float64, "cpu")
    conv = convert.forcefield_from_numpy(_fields(pair), _fields(ew), None,
                                         u.qqr2e, device="cpu",
                                         dtype=torch.float64)
    for name in ("lj3", "lj4", "offset", "cut_ljsq", "cutsq", "special_lj",
                 "special_coul"):
        np.testing.assert_array_equal(getattr(own.pair, name).numpy(),
                                      getattr(conv.pair, name).numpy(), name)
    for name in ("cut_coulsq", "qqrd2e", "g_ewald"):
        assert getattr(own.pair, name) == getattr(conv.pair, name), name
    for name in ("hvecs", "kcoeff", "kvirial"):
        np.testing.assert_array_equal(getattr(own.ewald, name).numpy(),
                                      getattr(conv.ewald, name).numpy(), name)
    for name in ("g_ewald", "qscale", "qsum", "qsqsum"):
        assert getattr(own.ewald, name) == getattr(conv.ewald, name), name


def test_static_trip_cg_matches_loop():
    """cg_static_trips runs the same CG with the update masked once
    converged: the same dipoles and iteration count as the loop."""
    ff = polar_bench.synthetic_forcefield(
        polar_bench.synthetic_system(N_SIDE), torch.float64, "cpu")
    runs = []
    for trips in (0, 30):
        s = dataclasses.replace(ff.polar, cg_static_trips=trips)
        bench = polar_bench.build_synthetic(
            N_SIDE, dtype=torch.float64, device="cpu",
            ff=dataclasses.replace(ff, polar=s))
        f, en = polar_bench.setup_forces(bench)
        runs.append((f, bench.arrays["mu"], en["scf_iters"]))
    (f0, mu0, it0), (f1, mu1, it1) = runs
    assert it0 == it1
    np.testing.assert_allclose(mu1.numpy(), mu0.numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), rtol=0,
                               atol=1e-12 * f0.abs().max().item())


def test_predictor_run_converges_to_same_state():
    """run(predict=2) changes only the CG start: the same trajectory to the
    SCF tolerance, with no more iterations per step."""
    out = []
    for predict in (1, 2):
        bench = polar_bench.build_synthetic(N_SIDE, dtype=torch.float64,
                                            device="cpu")
        polar_bench.setup_forces(bench)
        f, per_step = polar_bench.run(bench, 4, predict=predict)
        out.append((f, [e["scf_iters"] for e in per_step]))
    (f1, it1), (f2, it2) = out
    np.testing.assert_allclose(f2.numpy(), f1.numpy(), rtol=0,
                               atol=1e-4 * f1.abs().max().item())
    assert sum(it2) <= sum(it1)


def test_per_type_cutoff_routes():
    """A per-type outer cutoff (cut[1,1] = 7.0 A): the plain route builds,
    on the CPU also as panel="kernel" (its wrappers run the plain
    versions); a kernel build for a CUDA device raises before touching the
    device, naming panel='scan'."""
    from lidp_tpu_torch.parallel import shard

    ff = polar_bench.synthetic_forcefield(
        polar_bench.synthetic_system(N_SIDE), torch.float32, "cpu")
    cutsq = ff.pair.cutsq.clone()
    cutsq[1, 1] = 49.0
    ff = dataclasses.replace(ff, pair=dataclasses.replace(ff.pair,
                                                          cutsq=cutsq))
    kw = dict(n=375, npad=512, csz=256, dt=0.5, ftm2v=1.0,
              dtype=torch.float32)
    for panel_kind in ("scan", "kernel"):
        step = shard.PolarStep(ff, ff.polar, device="cpu", panel=panel_kind,
                               **kw)
        assert float(step.tabs[4, 1, 1]) == 49.0
    with pytest.raises(ValueError, match="panel='scan'"):
        shard.PolarStep(ff, ff.polar, device="cuda", panel="kernel", **kw)


def test_package_imports_no_jax():
    """lidp_tpu_torch and all its modules import without JAX or lidp_tpu."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import lidp_tpu_torch\n"
        "for m in pkgutil.walk_packages(lidp_tpu_torch.__path__,"
        " 'lidp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'lidp_tpu' or m.startswith('lidp_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'lidp_tpu_torch.parallel.fast_polar' in sys.modules\n"
        "for name in ('rng', 'lattice', 'velocity', 'state', 'thermo',"
        " 'ops.cells', 'ops.cell_kernels', 'integrate.nve',"
        " 'integrate.driver', 'integrate.slot_runner', 'integrate.rigid',"
        " 'integrate.nvt', 'models.lj_melt'):\n"
        "    assert 'lidp_tpu_torch.' + name in sys.modules, name\n"
        "from lidp_tpu_torch.parallel.fast_polar import FastPolarRunner,"
        " maybe_attach\n"
        "from lidp_tpu_torch.models.polar_bench import build_rigid,"
        " run_rigid\n"
        "for name in ('integrate.rigid', 'parallel.fast_polar'):\n"
        "    assert 'lidp_tpu_torch.' + name in sys.modules, name\n"
        "for name in ('io', 'io.script', 'io.data_reader', 'io.data_writer',"
        " 'io.expr', 'io.dump', 'styles', 'styles.fix_integrators', 'sim',"
        " '__main__', 'ops.granular', 'integrate.gran_runner', 'pour',"
        " 'styles.gran_builders', 'styles.fix_output',"
        " 'styles.fix_modifiers', 'api', 'computes'):\n"
        "    assert 'lidp_tpu_torch.' + name in sys.modules, name\n"
        "print(len([m for m in sys.modules if m.startswith('lidp_tpu_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "scripts/profile_torch_polar.py"])
def test_port_scripts_import_no_jax(script):
    """The port's GPU scripts import neither JAX nor the JAX package."""
    import ast

    root = Path(__file__).resolve().parent.parent
    tree = ast.parse((root / script).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib",
                                                   "lidp_tpu")]
    assert not bad, bad
    assert any(m.startswith("lidp_tpu_torch") for m in names)


def test_entry_points_default_to_cuda():
    """Without a GPU the entry points raise unless given device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        polar_bench.build_synthetic(N_SIDE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        polar_bench.build_synthetic(N_SIDE, dtype=torch.float64,
                                    precision=1e-11, host_strips=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.forcefield_from_numpy({}, None, None, 1.0)
    from lidp_tpu_torch.box import Box
    from lidp_tpu_torch.models import lj_melt
    from lidp_tpu_torch.state import make_system

    for neighbor in ("cells", "slots"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lj_melt.build(scale=0.3, dtype=torch.float32, neighbor=neighbor)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_system(np.zeros((4, 3)), box=Box.create(np.zeros(3), np.ones(3)))
    for fn in (convert.pair_from_numpy, convert.system_from_numpy,
               convert.cells_from_numpy, convert.slot_carry_from_numpy,
               convert.rigid_state_from_numpy):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        polar_bench.build_rigid(N_SIDE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        polar_bench.build_rigid(N_SIDE, dtype=torch.float64)
    from lidp_tpu_torch.integrate import rigid
    from lidp_tpu_torch.parallel import fast_polar

    sysd = polar_bench.synthetic_system(2)
    setup = rigid.setup_bodies(sysd["x"], sysd["mass"], sysd["mol"],
                               np.ones(24, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rigid.make_rigid_params(setup, 0.5, 1.0)
    ff32 = polar_bench.synthetic_forcefield(sysd, torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fast_polar.FastPolarRunner(
            None, ff=ff32, pol=ff32.polar, n=24, npad=256, dt=0.5,
            ftm2v=1.0, box_lo=np.zeros(3), box_lengths=sysd["L"])
    from lidp_tpu_torch.parallel import shard

    ff = polar_bench.synthetic_forcefield(
        polar_bench.synthetic_system(N_SIDE), torch.float64, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shard.build_sharded_polar_step(None, ff, ff.polar, n=375, dt=0.5,
                                       ftm2v=1.0)
    # the script front end: the interpreter, the Simulation it builds and
    # the CLI
    import tempfile

    import chip_smoke
    from lidp_tpu_torch.io.script import LammpsScript
    from lidp_tpu_torch.sim import Simulation

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LammpsScript()
    with tempfile.TemporaryDirectory() as d:
        _, in_fluid = chip_smoke.fluid_script_case(d, n_side=2)
        script = LammpsScript(device="cpu")
        script.root = d
        script.execute([line for line in open(in_fluid)
                        if not line.startswith("run")])
        script.device = torch.device("cuda")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Simulation.from_script(script)
        env = dict(os.environ, LIDP_FAST_POLAR="1",
                   PYTHONPATH=str(Path(__file__).resolve().parent.parent))
        res = subprocess.run([sys.executable, "-m", "lidp_tpu_torch", "-in",
                              in_fluid, "-log", "none"], cwd=d, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0 and "device='cpu'" in res.stderr


def _spd_problem(n=40, seed=2):
    """A small dipole system: e0, alpha (some zero), and a symmetric
    interaction matrix T small enough that B = I + sqrt(a) T sqrt(a) is
    SPD."""
    rng = np.random.RandomState(seed)
    m = rng.normal(0, 0.05, (3 * n, 3 * n))
    T = 0.5 * (m + m.T)
    alpha = rng.uniform(0.5, 1.5, n)
    alpha[:4] = 0.0
    return rng.normal(0, 1.0, (n, 3)), alpha, T


@pytest.mark.parametrize("trips", [0, 40])
def test_scf_solve_cg_matches_jax(trips):
    """The port's CG (Python loop / static trips) against the JAX solver on
    the same matrix: same iterations, same dipoles to 1e-12."""
    from lidp_tpu.ops import polarization as jpol
    from lidp_tpu_torch.ops import polarization as tpol

    e0, alpha, T = _spd_problem()
    n = alpha.shape[0]
    kw = dict(iterations_max=50, polar_precision=1e-10,
              cg_static_trips=trips)
    js, ts = jpol.PolarizationSettings(**kw), tpol.PolarizationSettings(**kw)
    Tj, Tt = jnp.asarray(T), torch.as_tensor(T)
    mu_j, it_j, div_j = jpol.scf_solve_cg(
        jnp.asarray(e0), jnp.asarray(alpha),
        lambda m: (Tj @ m.reshape(-1)).reshape(n, 3), js)
    mu_t, it_t, div_t = tpol.scf_solve_cg(
        torch.as_tensor(e0), torch.as_tensor(alpha),
        lambda m: (Tt @ m.reshape(-1)).reshape(n, 3), ts)
    assert it_t == int(it_j) and it_t > 3
    assert bool(div_t) == bool(div_j) is False
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(mu_j)).max())


def test_scf_solve_cg_divergence_fallback():
    """A poisoned matvec (NaN) runs to iterations_max and falls back to
    mu = alpha * E0, as the reference's divergence branch does."""
    from lidp_tpu_torch.ops import polarization as tpol

    e0, alpha, _ = _spd_problem()
    s = tpol.PolarizationSettings(iterations_max=7, polar_precision=1e-10)
    mu, it, div = tpol.scf_solve_cg(
        torch.as_tensor(e0), torch.as_tensor(alpha),
        lambda m: torch.full_like(m, float("nan")), s)
    assert it == 7 and bool(div)
    np.testing.assert_array_equal(mu.numpy(), alpha[:, None] * e0)
