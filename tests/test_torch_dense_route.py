"""The port's dense route (lidp_tpu_torch: topology.special_codes_dense,
ops/pair.dense_pair_forces, ops/ewald.ewald_forces, the dense functions of
ops/polarization and forcefield.compute_forces with nlist=None) against the
JAX package's functions of the same names, float64 on the CPU, both sides
on the same numpy arrays made from a seed and the same force-field tables
(carried across by lidp_tpu_torch.convert).

Bars: 1e-10 of each output's largest entry where both sides run the same
arithmetic (the pair pass, the Ewald sum, the Wolf field, the tensor and
its contraction, the polar forces); BASELINE.md's 1e-8 where a solve
iterates (scf_solve, scf_solve_gauss_seidel, compute_forces).  The case
holds masked atoms, atoms of no molecule (mol 0), unpolarizable atoms and
atoms a box length outside the box.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, as the port's other parity files pin it: the first
# float64 evaluation of a process on several threads once came out wrong
# (ROADMAP queue 3 item 1, not located; tests/test_torch_cpu_threads.py)
torch.set_num_threads(1)

from lidp_tpu import topology as jtopo  # noqa: E402
from lidp_tpu.box import Box as JBox  # noqa: E402
from lidp_tpu.ops import ewald as jewald  # noqa: E402
from lidp_tpu.ops import pair as jpair  # noqa: E402
from lidp_tpu.ops import polarization as jpol  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch import topology as ttopo  # noqa: E402
from lidp_tpu_torch.box import Box as TBox  # noqa: E402
from lidp_tpu_torch.ops import ewald as tewald  # noqa: E402
from lidp_tpu_torch.ops import pair as tpair  # noqa: E402
from lidp_tpu_torch.ops import polarization as tpol  # noqa: E402

QQRD2E = 332.06371
CUT_COUL = 6.5
SAME, SOLVE = 1e-10, 1e-8


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _case(seed=11, nmol=16, L=(15.0, 16.0, 17.0)):
    """nmol bent 3-site molecules and 4 loose atoms of mol 0 (two of them
    unpolarizable) on random sites of a 3 x 3 x 3 lattice: types 1, 2, 2,
    charges -0.8, 0.4, 0.4, bonds O-H, O-H; 3 masked atoms, 4 atoms moved a
    box length out of the box."""
    rng = np.random.RandomState(seed)
    L = np.asarray(L)
    offs = np.array([[0.0, 0.0, 0.0], [0.96, 0.0, 0.0], [-0.24, 0.93, 0.0]])
    g = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    sites = (g[rng.choice(27, nmol + 4, replace=False)] + 0.5) * L / 3
    sites += rng.uniform(-0.5, 0.5, sites.shape)
    x = (sites[:nmol, None] + offs[None]).reshape(-1, 3)
    x = np.concatenate([x, sites[nmol:]])
    n = x.shape[0]
    x += rng.normal(0, 0.05, x.shape)
    q = np.concatenate([np.tile([-0.8, 0.4, 0.4], nmol),
                        rng.normal(0, 0.3, 4)])
    typ = np.concatenate([np.tile([1, 2, 2], nmol), [1, 2, 1, 2]])
    mol = np.concatenate([np.repeat(np.arange(1, nmol + 1), 3),
                          np.zeros(4, int)])
    alpha = np.where(typ == 1, 1.1, 0.4)
    alpha[[n - 3, n - 1]] = 0.0
    mask = np.ones(n, bool)
    mask[rng.choice(3 * nmol, 3, replace=False)] = False
    out = rng.choice(n, 4, replace=False)
    x[out] += L * rng.choice([-1.0, 1.0], (4, 3))
    bonds = np.array([(3 * m + 1, 3 * m + k) for m in range(nmol)
                      for k in (2, 3)])
    mu = rng.normal(0, 0.05, (n, 3)) * (alpha > 0)[:, None]
    return dict(x=x, q=q, type=typ, mol=mol, alpha=alpha, mask=mask, L=L,
                bonds=bonds, mu=mu, n=n)


C = _case()


def _j(a, dtype=jnp.float64):
    return jnp.asarray(np.asarray(a), dtype)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a)).to(dtype)


def _boxes(L):
    return (JBox.create(np.zeros(3), L, dtype=jnp.float64),
            TBox.create(np.zeros(3), L, dtype=torch.float64))


def _close(got, ref, rel, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _pair_tables(g_ewald=0.3, coul=True, special=(0.0, 0.0, 0.0),
                 excl_mol=False):
    """JAX PairParams of the fluid's LJ tables (types 1, 2; per-type
    cutoffs 6.0, 7.0 for 1-1) and its port twin."""
    eps = np.zeros((3, 3))
    sig = np.zeros((3, 3))
    cut = np.zeros((3, 3))
    eps[1:, 1:] = [[0.1, 0.05], [0.05, 0.03]]
    sig[1:, 1:] = [[3.0, 2.7], [2.7, 2.5]]
    cut[1:, 1:] = [[7.0, 6.0], [6.0, 6.0]]
    sp = (1.0,) + tuple(special)
    pj = jpair.make_pair_params(eps, sig, cut, cut_coul=CUT_COUL, coul=coul,
                                qqrd2e=QQRD2E, g_ewald=g_ewald,
                                special_lj=sp, special_coul=sp, shift=True,
                                dtype=jnp.float64)
    pj = dataclasses.replace(pj, excl_mol=excl_mol)
    return pj, convert.pair_from_numpy(_fields(pj), device="cpu",
                                       dtype=torch.float64)


# ----------------------------- special codes ------------------------------

def test_special_codes_dense_matches_jax():
    rng = np.random.RandomState(3)
    n = 40
    chain = [(i, i + 1) for i in range(1, 25)]
    ring = [(26, 27), (27, 28), (28, 29), (29, 26), (28, 30)]
    extra = [tuple(sorted(rng.choice(np.arange(31, n + 1), 2,
                                     replace=False))) for _ in range(6)]
    bonds = np.array(chain + ring + extra)
    got = ttopo.special_codes_dense(n, bonds)
    ref = jtopo.special_codes_dense(n, bonds)
    assert got.dtype == np.int8 and set(np.unique(got)) == {0, 1, 2, 3}
    np.testing.assert_array_equal(got, ref)
    empty = np.zeros((0, 2), int)
    np.testing.assert_array_equal(ttopo.special_codes_dense(5, empty),
                                  jtopo.special_codes_dense(5, empty))


# ------------------------------ pair pass ---------------------------------

PAIR_CASES = {
    # special codes with nonzero factors, so each level scales its pairs
    "special": dict(special=(0.2, 0.5, 0.8), codes=True),
    "special_zero": dict(special=(0.0, 0.0, 0.0), codes=True),
    "excl_mol": dict(excl_mol=True),
    "coul_cut": dict(g_ewald=0.0, codes=True),
    "lj_only": dict(coul=False),
}


@pytest.mark.parametrize("name", list(PAIR_CASES))
def test_dense_pair_forces_matches_jax(name):
    kw = dict(PAIR_CASES[name])
    codes = kw.pop("codes", False)
    pj, pt = _pair_tables(**kw)
    bj, bt = _boxes(C["L"])
    code = jtopo.special_codes_dense(C["n"], C["bonds"]) if codes else None
    outj = jpair.dense_pair_forces(
        _j(C["x"]), _j(C["q"]), _j(C["type"], jnp.int32),
        jnp.asarray(code) if codes else 0, _j(C["mask"], bool), bj, pj,
        mol=_j(C["mol"], jnp.int32))
    outt = tpair.dense_pair_forces(
        _t(C["x"]), _t(C["q"]), _t(C["type"], torch.int32),
        torch.as_tensor(code) if codes else 0, _t(C["mask"], torch.bool),
        bt, pt, mol=_t(C["mol"], torch.int32))
    for k, g, r in zip(("f", "evdwl", "ecoul", "virial"), outt, outj):
        _close(g, r, SAME, k)
    assert np.abs(np.asarray(outj[0])).max() > 0
    if not kw.get("coul", True):
        assert float(outt[2]) == 0.0


# ------------------------------- Ewald sum --------------------------------

def _ewald_params(L, q):
    es = jewald.setup_ewald_disp(accuracy_rel=1e-5, qqrd2e=QQRD2E, q=q,
                                 natoms=len(q), cutoff=CUT_COUL,
                                 box_lengths=L)
    ej = jewald.EwaldParams.from_setup(es, QQRD2E, dtype=jnp.float64)
    f = _fields(ej)
    et = tewald.EwaldParams(
        hvecs=_t(f["hvecs"]), kcoeff=_t(f["kcoeff"]),
        kvirial=_t(f["kvirial"]),
        **{k: float(f[k]) for k in ("g_ewald", "qscale", "qsum", "qsqsum")})
    return ej, et


@pytest.mark.parametrize("blocked", [False, True], ids=["whole", "blocked"])
def test_ewald_forces_matches_jax(blocked):
    """The charges are not neutral, so the background term counts; blocked
    cuts the k axis into blocks of 128 vectors, the last one short, on both
    sides."""
    ej, et = _ewald_params(C["L"], C["q"])
    K, n = et.hvecs.shape[0], C["n"]
    elems = 128 * n if blocked else tewald._EWALD_CHUNK_ELEMS
    if blocked:
        assert K > 2 * 128 and K % 128
    bj, bt = _boxes(C["L"])
    with mock.patch.object(jewald, "_EWALD_CHUNK_ELEMS", elems), \
            mock.patch.object(tewald, "_EWALD_CHUNK_ELEMS", elems):
        outj = jewald.ewald_forces(_j(C["x"]), _j(C["q"]), bj.volume, ej)
        outt = tewald.ewald_forces(_t(C["x"]), _t(C["q"]), bt.volume, et)
    for k, g, r in zip(("f", "elong", "virial"), outt, outj):
        _close(g, r, SAME, k)


# --------------------- field, tensor, induced field -----------------------

def _settings(**kw):
    base = dict(iterations_max=50, damping_type=1, polar_precision=1e-11,
                polar_damp=2.1304)
    base.update(kw)
    return jpol.PolarizationSettings(**base), tpol.PolarizationSettings(
        **base)


def _polar_inputs():
    bj, bt = _boxes(C["L"])
    j = dict(x=_j(C["x"]), q=_j(C["q"]), mol=_j(C["mol"], jnp.int32),
             mask=_j(C["mask"], bool), alpha=_j(C["alpha"]), mu=_j(C["mu"]),
             box=bj)
    t = dict(x=_t(C["x"]), q=_t(C["q"]), mol=_t(C["mol"], torch.int32),
             mask=_t(C["mask"], torch.bool), alpha=_t(C["alpha"]),
             mu=_t(C["mu"]), box=bt)
    return j, t


def test_static_field_wolf_matches_jax():
    j, t = _polar_inputs()
    ref = jpol.static_field_wolf(j["x"], j["q"], j["mol"], j["mask"],
                                 j["box"], CUT_COUL**2, QQRD2E)
    got = tpol.static_field_wolf(t["x"], t["q"], t["mol"], t["mask"],
                                 t["box"], CUT_COUL**2, QQRD2E)
    _close(got, ref, SAME)


@pytest.mark.parametrize("damping", [0, 1], ids=["none", "exponential"])
def test_dipole_field_tensor_and_induced_field_match_jax(damping):
    j, t = _polar_inputs()
    sj, st = _settings(damping_type=damping)
    tj = jpol.dipole_field_tensor(j["x"], j["alpha"], j["mask"], j["box"],
                                  sj)
    tt = tpol.dipole_field_tensor(t["x"], t["alpha"], t["mask"], t["box"],
                                  st)
    n = C["n"]
    assert tt.shape == (n, 3, n, 3)
    _close(tt, tj, SAME, "tensor")
    diag = tt.numpy()[np.arange(n), :, np.arange(n), :]
    assert not diag.any()
    _close(tpol.induced_field(tt, t["mu"]), jpol.induced_field(tj, j["mu"]),
           SAME, "induced field")


# ------------------------------- the solves -------------------------------

def _solve_inputs(damping):
    """Undamped, the O-H pairs at 0.96 A make the polarization catastrophe
    (CG diverges on both sides): there the polarizabilities are a quarter
    of the case's."""
    j, t = _polar_inputs()
    if not damping:
        j["alpha"], t["alpha"] = 0.25 * j["alpha"], 0.25 * t["alpha"]
    sj, st = _settings(damping_type=damping)
    e0j = jpol.static_field_wolf(j["x"], j["q"], j["mol"], j["mask"],
                                 j["box"], CUT_COUL**2, QQRD2E)
    tj = jpol.dipole_field_tensor(j["x"], j["alpha"], j["mask"], j["box"],
                                  sj)
    e0t, tt = _t(e0j), _t(tj)
    return j, t, e0j, tj, e0t, tt


SOLVE_MODES = {"precision": {}, "fixed_iteration": dict(
    fixed_iteration=True, iterations_max=7), "zodid": dict(zodid=True)}


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("damping", [0, 1], ids=["none", "exponential"])
@pytest.mark.parametrize("mode", list(SOLVE_MODES))
def test_scf_solve_matches_jax(mode, damping, warm):
    """E0 and T from the JAX functions on both sides, so the solves are
    held alone."""
    j, t, e0j, tj, e0t, tt = _solve_inputs(damping)
    sj, st = _settings(damping_type=damping, **SOLVE_MODES[mode])
    muj, itj, dvj = jpol.scf_solve(e0j, j["alpha"], tj, sj,
                                   mu_init=j["mu"] if warm else None)
    mut, itt, dvt = tpol.scf_solve(e0t, t["alpha"], tt, st,
                                   mu_init=t["mu"] if warm else None)
    _close(mut, muj, SOLVE, "mu")
    assert not bool(dvj) and not bool(dvt)
    if mode == "precision":
        assert abs(int(itt) - int(itj)) <= 1 and int(itj) > 3
    else:
        assert int(itt) == int(itj)


GS_CASES = {
    "ranked": dict(polar_gs_ranked=True),
    "ranked_fixed": dict(polar_gs_ranked=True, fixed_iteration=True,
                         iterations_max=4),
    "gs": dict(polar_gs=True, polar_gs_ranked=False),
    "gs_fixed": dict(polar_gs=True, polar_gs_ranked=False,
                     fixed_iteration=True, iterations_max=4),
    # two sweeps cannot reach 1e-11: the solve falls back to alpha E0
    "diverged": dict(polar_gs_ranked=True, iterations_max=1),
}


def test_rank_metric_compute_matches_jax():
    j, t = _polar_inputs()
    ref = jpol.rank_metric_compute(j["x"], j["alpha"], j["mol"], j["mask"],
                                   j["box"])
    got = tpol.rank_metric_compute(t["x"], t["alpha"], t["mol"], t["mask"],
                                   t["box"])
    _close(got, ref, SAME)
    assert (np.asarray(ref) > 0).any()


@pytest.mark.parametrize("name", list(GS_CASES))
def test_scf_solve_gauss_seidel_matches_jax(name):
    """polar_gs and polar_gs_ranked sweeps, converged and fixed-iteration,
    in the rank order of rank_metric_compute (ties kept in atom order by
    the stable sort: the unpolarizable and masked atoms rank 0)."""
    j, t, e0j, tj, e0t, tt = _solve_inputs(1)
    sj, st = _settings(**GS_CASES[name])
    rank = jpol.rank_metric_compute(j["x"], j["alpha"], j["mol"], j["mask"],
                                    j["box"])
    muj, itj, dvj = jpol.scf_solve_gauss_seidel(e0j, j["alpha"], tj, sj,
                                                rank_metric=rank)
    mut, itt, dvt = tpol.scf_solve_gauss_seidel(e0t, t["alpha"], tt, st,
                                                rank_metric=_t(rank))
    _close(mut, muj, SOLVE, "mu")
    assert int(itt) == int(itj)
    assert bool(dvt) == bool(dvj) == (name == "diverged")
    if name == "diverged":
        _close(mut, np.asarray(j["alpha"])[:, None] * np.asarray(e0j), 0.0)


# ------------------------------ polar forces ------------------------------

@pytest.mark.parametrize("damping", [0, 1], ids=["none", "exponential"])
@pytest.mark.parametrize("xshift", [False, True], ids=["wrap", "xshift"])
def test_dipole_forces_energy_matches_jax(xshift, damping):
    j, t = _polar_inputs()
    sj, st = _settings(damping_type=damping)
    L = C["L"]
    shift = -np.floor(C["x"] / L) * L if xshift else None
    ref = jpol.dipole_forces_energy(
        j["x"], j["q"], j["mol"], j["alpha"], j["mu"], j["mask"], j["box"],
        CUT_COUL**2, QQRD2E, sj, xshift=None if shift is None else _j(shift))
    got = tpol.dipole_forces_energy(
        t["x"], t["q"], t["mol"], t["alpha"], t["mu"], t["mask"], t["box"],
        CUT_COUL**2, QQRD2E, st, xshift=None if shift is None else _t(shift))
    for k, g, r in zip(("f", "u_polar", "virial"), got, ref):
        _close(g, r, SAME, k)


# --------------------------- the whole evaluation --------------------------

def _graft_forcefield():
    """`__graft_entry__.entry()`'s force field rebuilt in float64 on
    `_tiny_polar_system(8)` (the same calls at the other dtype), after
    checking that the one entry() builds carries these settings and
    tables."""
    import __graft_entry__ as graft
    from lidp_tpu import units
    from lidp_tpu.box import Box
    from lidp_tpu.forcefield import ForceField
    from lidp_tpu.ops.ewald import EwaldParams, setup_ewald_disp
    from lidp_tpu.ops.pair import make_pair_params
    from lidp_tpu.state import make_system

    fn, _ = graft.entry()
    ff32 = next(c.cell_contents for c in fn.__closure__
                if isinstance(c.cell_contents, ForceField))
    u = units.REAL
    x, v, q, typ, mol, alpha, L = graft._tiny_polar_system(8, jnp.float64)
    n = x.shape[0]
    eps = np.zeros((3, 3))
    sig = np.zeros((3, 3))
    cut = np.zeros((3, 3))
    eps[1:, 1:] = [[0.1, 0.05], [0.05, 0.03]]
    sig[1:, 1:] = [[3.0, 2.7], [2.7, 2.5]]
    cut[1:, 1:] = 6.0
    es = setup_ewald_disp(accuracy_rel=1e-4, qqrd2e=u.qqr2e, q=q, natoms=n,
                          cutoff=CUT_COUL, box_lengths=[L, L, L])
    pair = make_pair_params(eps, sig, cut, cut_coul=CUT_COUL, coul=True,
                            qqrd2e=u.qqr2e, g_ewald=es.g_ewald,
                            dtype=jnp.float64)
    ew = EwaldParams.from_setup(es, u.qqr2e, dtype=jnp.float64)
    ff = ForceField(pair=pair, ewald=ew, polar=ff32.polar, qqrd2e=u.qqr2e)
    assert ff32.qqrd2e == ff.qqrd2e
    for k in ("lj1", "lj3", "cutsq"):
        np.testing.assert_allclose(np.asarray(getattr(ff32.pair, k)),
                                   np.asarray(getattr(ff.pair, k)),
                                   rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(ff32.ewald.hvecs, np.float64),
                                  np.asarray(ew.hvecs, np.float32))
    box = Box.create([0.0, 0.0, 0.0], [L, L, L], dtype=jnp.float64)
    sysj = make_system(x, box=box, v=v, q=q, type=typ, mol=mol, alpha=alpha,
                       dtype=jnp.float64)
    return ff, sysj


FF_CASES = {"entry": {}, "reference_gs": dict(reference_gs=True),
            "special": dict(codes=True), "warm": dict(warm=True)}


@pytest.mark.parametrize("name", list(FF_CASES))
def test_compute_forces_matches_jax_on_the_graft_system(name):
    """compute_forces(nlist=None) on _tiny_polar_system(8): entry()'s
    force field (CG at 1e-6); reference_gs: the serial ranked Gauss-Seidel
    solve; special: the molecules' special codes (special_bonds 0.0 0.5
    0.5 on both sides); warm: use_previous from a dipole guess."""
    from lidp_tpu.forcefield import compute_forces as jcompute

    from lidp_tpu_torch.forcefield import compute_forces as tcompute

    kw = FF_CASES[name]
    ff, sysj = _graft_forcefield()
    n = sysj.x.shape[0]
    if kw.get("codes"):
        bonds = np.array([(3 * m + 1, 3 * m + k) for m in range(n // 3)
                          for k in (2, 3)])
        sp = (1.0, 0.0, 0.5, 0.5)
        ff = dataclasses.replace(
            ff, sp_code=jnp.asarray(jtopo.special_codes_dense(n, bonds)),
            pair=dataclasses.replace(ff.pair, special_lj=_j(sp),
                                     special_coul=_j(sp)))
    if kw.get("reference_gs"):
        ff = dataclasses.replace(ff, reference_gs=True)
    if kw.get("warm"):
        ff = dataclasses.replace(ff, polar=dataclasses.replace(
            ff.polar, use_previous=True))
        mu0 = np.random.RandomState(5).normal(0, 0.02, (n, 3))
        sysj = sysj.replace(mu=_j(mu0))
    rj = jcompute(sysj, ff)
    fft = convert.forcefield_from_numpy(
        _fields(ff.pair), _fields(ff.ewald), dataclasses.asdict(ff.polar),
        ff.qqrd2e, device="cpu", dtype=torch.float64,
        sp_code=None if ff.sp_code is None else np.asarray(ff.sp_code),
        reference_gs=ff.reference_gs)
    assert fft.reference_gs == ff.reference_gs
    syst = convert.system_from_numpy(
        dict({k: np.asarray(getattr(sysj, k)) for k in
              ("x", "v", "q", "type", "mol", "alpha", "mu", "image",
               "mask")}, box=dict(lo=np.asarray(sysj.box.lo),
                                  hi=np.asarray(sysj.box.hi))),
        device="cpu")
    rt = tcompute(syst, fft)
    for k in ("f", "mu", "virial"):
        _close(getattr(rt, k), getattr(rj, k), SOLVE, k)
    scale = max(abs(float(getattr(rj, k))) for k in
                ("evdwl", "ecoul", "elong", "epol"))
    for k in ("evdwl", "ecoul", "elong", "epol"):
        assert abs(float(getattr(rt, k)) - float(getattr(rj, k))) \
            <= SOLVE * scale, k
    assert int(rt.scf_iters) == int(rj.scf_iters) > 0
    assert not bool(rt.scf_diverged)
