"""Foundations of the port's LJ slice against the JAX package, on the CPU,
from numpy inputs made from a seed: the random streams, lattice and
velocity creation (bit-exact own copies), the box, the pair table of
lj/cut, the cell configuration and `build_cells` (exactly equal), the NVE
integrator with its Kahan variant, and every column of `thermo_row`
(float64, rel 1e-12).
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# small tensors: one torch thread per test worker beats several workers
# spinning on the same cores
torch.set_num_threads(1)

from lidp_tpu_torch import box as tbox  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch import lattice as tlattice  # noqa: E402
from lidp_tpu_torch import rng as trng  # noqa: E402
from lidp_tpu_torch import thermo as tthermo  # noqa: E402
from lidp_tpu_torch import units as tunits  # noqa: E402
from lidp_tpu_torch import velocity as tvelocity  # noqa: E402
from lidp_tpu_torch.forcefield import pair_only_result  # noqa: E402
from lidp_tpu_torch.integrate import nve as tnve  # noqa: E402
from lidp_tpu_torch.ops import cells as tcells  # noqa: E402
from lidp_tpu_torch.ops import pair as tpair  # noqa: E402
from lidp_tpu_torch.state import Topology, make_system  # noqa: E402


def _fields(obj):
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def jax_system_dict(sys):
    """numpy copy of a JAX System for convert.system_from_numpy."""
    d = {k: v for k, v in _fields(sys).items() if k != "box"}
    d["box"] = dict(lo=np.asarray(sys.box.lo), hi=np.asarray(sys.box.hi),
                    periodic=sys.box.periodic)
    return d


# ------------------------------ random streams ---------------------------

@pytest.mark.parametrize("cls", ["RanPark", "RanMars"])
def test_rng_streams_bit_exact(cls):
    from lidp_tpu import rng as jrng

    a, b = getattr(jrng, cls)(482794), getattr(trng, cls)(482794)
    ua = [a.uniform() for _ in range(50)] + [a.gaussian() for _ in range(51)]
    ub = [b.uniform() for _ in range(50)] + [b.gaussian() for _ in range(51)]
    assert ua == ub


def test_geom_streams_bit_exact():
    from lidp_tpu import rng as jrng

    coords = np.random.RandomState(0).uniform(0, 30, (200, 3))
    np.testing.assert_array_equal(trng._geom_hash_seeds(87287, coords),
                                  jrng._geom_hash_seeds(87287, coords))
    sa = jrng.park_geom_streams(87287, coords)
    sb = trng.park_geom_streams(87287, coords)
    for ga, gb in zip(sa.uniform3() + sa.gaussian3(),
                      sb.uniform3() + sb.gaussian3()):
        np.testing.assert_array_equal(ga, gb)
    r = trng.RanPark(12345)
    r.reset_geom(87287, coords[3])
    r2 = jrng.RanPark(12345)
    r2.reset_geom(87287, coords[3])
    assert r.uniform() == r2.uniform()


def test_lattice_bit_exact():
    from lidp_tpu import lattice as jlattice

    for style, scale in (("fcc", 0.8442), ("bcc", 0.6), ("sc", 1.0)):
        assert tlattice.lattice_spacing(style, scale) == \
            jlattice.lattice_spacing(style, scale)
    a = tlattice.lattice_spacing("fcc", 0.8442)
    xa, ha = jlattice.create_atoms_box("fcc", a, 6, 6, 6)
    xb, hb = tlattice.create_atoms_box("fcc", a, 6, 6, 6)
    assert xb.shape == (864, 3)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ha, hb)
    lo, hi = np.zeros(3), np.array([5.1, 4.2, 6.3])
    np.testing.assert_array_equal(
        jlattice.create_atoms_bounds("sc", 1.0, lo, hi),
        tlattice.create_atoms_bounds("sc", 1.0, lo, hi))


@pytest.mark.parametrize("kw", [
    dict(loop="geom", dist="uniform"),
    dict(loop="geom", dist="gaussian", momentum=True, rotation=True),
    dict(loop="all", dist="uniform", momentum=True),
    dict(loop="all", dist="gaussian", dim=2),
])
def test_velocity_create_bit_exact(kw):
    from lidp_tpu import units as junits
    from lidp_tpu import velocity as jvelocity

    a = tlattice.lattice_spacing("fcc", 0.8442)
    x, _ = tlattice.create_atoms_box("fcc", a, 6, 6, 6)
    if kw["loop"] == "all":
        x = x[:150]
    m = np.ones(x.shape[0])
    va = jvelocity.create(x, m, 1.44, 87287, units=junits.LJ, **kw)
    vb = tvelocity.create(x, m, 1.44, 87287, units=tunits.LJ, **kw)
    np.testing.assert_array_equal(va, vb)


def test_velocity_group_and_ramp_bit_exact():
    from lidp_tpu import units as junits
    from lidp_tpu import velocity as jvelocity

    rs = np.random.RandomState(3)
    x = rs.uniform(0, 8, (120, 3))
    m = rs.uniform(1, 3, 120)
    group = rs.rand(120) < 0.6
    prev = rs.normal(size=(120, 3))
    kw = dict(loop="geom", group=group, v_prev=prev, momentum=True,
              image=rs.randint(-1, 2, (120, 3)), box_lengths=np.full(3, 8.0))
    va = jvelocity.create(x, m, 2.0, 4928459, units=junits.LJ, **kw)
    vb = tvelocity.create(x, m, 2.0, 4928459, units=tunits.LJ, **kw)
    np.testing.assert_array_equal(va, vb)
    args = (x, va, group, 0, 0.0, 1.5, 1, 1.0, 7.0, True)
    np.testing.assert_array_equal(jvelocity.ramp(*args), tvelocity.ramp(*args))
    with pytest.raises(ValueError):
        tvelocity.create(x, m, 2.0, 1, units=tunits.LJ, loop="local")


# --------------------------- box, state, pair ----------------------------

@pytest.mark.parametrize("periodic", [(True, True, True),
                                      (True, False, True)])
def test_box_wrap_unwrap(periodic):
    from lidp_tpu import box as jbox

    rs = np.random.RandomState(5)
    lo, hi = np.array([-1.0, 0.5, 2.0]), np.array([7.0, 9.5, 8.0])
    x = rs.uniform(-12, 20, (64, 3))
    img = rs.randint(-2, 3, (64, 3)).astype(np.int32)
    bj = jbox.Box.create(lo, hi, periodic=periodic)
    bt = tbox.Box.create(lo, hi, periodic=periodic)
    assert bt.lo.dtype == torch.float64
    for name in ("lengths", "img_lengths", "volume"):
        np.testing.assert_array_equal(np.asarray(getattr(bj, name)),
                                      getattr(bt, name).numpy())
    xj, ij = jbox.wrap(jnp.asarray(x), bj, jnp.asarray(img))
    xt, it = tbox.wrap(torch.as_tensor(x), bt, torch.as_tensor(img))
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(
        np.asarray(jbox.unwrap(xj, bj, ij)), tbox.unwrap(xt, bt, it).numpy())
    d = rs.uniform(-9, 9, (10, 3))
    np.testing.assert_array_equal(
        np.asarray(jbox.minimum_image(jnp.asarray(d), bj.img_lengths)),
        tbox.minimum_image(torch.as_tensor(d), bt.img_lengths).numpy())


def test_box_triclinic_raises():
    with pytest.raises(NotImplementedError, match="triclinic"):
        tbox.Box.create(np.zeros(3), np.ones(3), tilt=(0.1, 0.0, 0.0))
    with pytest.raises(NotImplementedError, match="triclinic"):
        tcells.perp_widths(np.ones(3), tilt=(0.0, 0.2, 0.0))
    assert tbox.Box.create(np.zeros(3), np.ones(3),
                           tilt=(0.0, 0.0, 0.0)).triclinic is False


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_make_system_and_convert(dtype):
    from lidp_tpu import box as jbox
    from lidp_tpu.state import make_system as jmake

    rs = np.random.RandomState(7)
    n = 20
    kw = dict(v=rs.normal(size=(n, 3)), q=rs.normal(size=n),
              type=rs.randint(1, 3, n), mol=np.arange(n) // 3,
              alpha=rs.rand(n), image=rs.randint(-1, 2, (n, 3)),
              mask=rs.rand(n) < 0.8)
    x = rs.uniform(0, 5, (n, 3))
    jd = jnp.float32 if dtype == np.float32 else jnp.float64
    td = torch.float32 if dtype == np.float32 else torch.float64
    sj = jmake(x, box=jbox.Box.create(np.zeros(3), np.full(3, 5.0)),
               dtype=jd, **kw)
    st = make_system(x, box=tbox.Box.create(np.zeros(3), np.full(3, 5.0)),
                     dtype=td, device="cpu", **kw)
    sc = convert.system_from_numpy(jax_system_dict(sj), device="cpu")
    assert st.step == 0 and sc.step == 0 and st.n == n and st.dtype == td
    for name, ref in _fields(sj).items():
        if name in ("box", "step"):
            continue
        for s in (st, sc):
            got = getattr(s, name)
            assert str(got.dtype).split(".")[1] == str(ref.dtype), name
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    for s in (st, sc):
        assert s.box.lo.dtype == td
        np.testing.assert_array_equal(s.box.hi.numpy(), np.asarray(sj.box.hi))
    s2 = st.replace(step=5)
    assert s2.step == 5 and s2.x is st.x
    topo = Topology(natoms=n, ntypes=2, mass=np.array([0.0, 1.0, 2.0]))
    assert topo.special_idx is None and topo.natoms == n


@pytest.mark.parametrize("shift", [False, True])
def test_make_pair_params_lj_only(shift):
    from lidp_tpu.ops.pair import make_pair_params as jmake

    rs = np.random.RandomState(11)
    eps = np.zeros((3, 3)); sig = np.zeros((3, 3)); cut = np.zeros((3, 3))
    eps[1:, 1:] = rs.uniform(0.5, 1.5, (2, 2))
    sig[1:, 1:] = rs.uniform(0.9, 1.1, (2, 2))
    cut[1:, 1:] = rs.uniform(2.0, 3.0, (2, 2))
    pj = jmake(eps, sig, cut, coul=False, shift=shift)
    pt = tpair.make_pair_params(eps, sig, cut, coul=False, shift=shift)
    assert pt.coul is False and pt.cut_coulsq == 0.0
    for name in ("lj3", "lj4", "offset", "cut_ljsq", "cutsq", "special_lj",
                 "special_coul"):
        np.testing.assert_allclose(getattr(pt, name).numpy(),
                                   np.asarray(getattr(pj, name)), rtol=1e-15,
                                   atol=0, err_msg=name)
    np.testing.assert_allclose(12.0 * pt.lj3.numpy(), np.asarray(pj.lj1),
                               rtol=1e-15)
    np.testing.assert_allclose(6.0 * pt.lj4.numpy(), np.asarray(pj.lj2),
                               rtol=1e-15)
    np.testing.assert_array_equal(pt.cutsq.numpy(), pt.cut_ljsq.numpy())
    if shift:
        assert float(pt.offset[1, 2]) != 0.0
    pc = convert.pair_from_numpy(_fields(pj), device="cpu",
                                 dtype=torch.float64)
    assert pc.coul is False
    np.testing.assert_array_equal(pc.lj3.numpy(), np.asarray(pj.lj3))
    with pytest.raises(NotImplementedError, match="kind"):
        convert.pair_from_numpy(dict(_fields(pj), kind="nonesuch"),
                                device="cpu")


# ------------------------------ cell grid --------------------------------

@pytest.mark.parametrize("args", [
    ((33.6, 33.6, 33.6), 2.8, 0.8442, 1.5),
    ((10.08, 10.08, 10.08), 2.8, 0.8442, 1.5),
    ((9.0, 12.0, 15.0), 2.9, 0.25, 3.0),
    ((30.0, 30.0, 5.0), 2.8, 0.5, 2.0),
])
def test_cell_config_for_box(args):
    from lidp_tpu.ops.cells import CellConfig as JCfg

    L, cutn, rho, slack = args
    a = JCfg.for_box(L, cutn, density=rho, cap_slack=slack)
    b = tcells.CellConfig.for_box(L, cutn, density=rho, cap_slack=slack)
    assert (a.nbins, a.cap, a.cutneigh) == (b.nbins, b.cap, b.cutneigh)
    assert tcells._HALF_OFFSETS == __import__(
        "lidp_tpu.ops.cells", fromlist=["x"])._HALF_OFFSETS
    assert tcells.half_offsets(b.nbins) == __import__(
        "lidp_tpu.ops.cells", fromlist=["x"]).half_offsets(b.nbins)


def test_cell_config_two_bins_raises():
    with pytest.raises(ValueError, match=">= 3 bins"):
        tcells.CellConfig.for_box((8.0, 8.0, 8.0), 2.8, density=0.8442)


def _cloud(n, L, seed, dtype):
    rs = np.random.RandomState(seed)
    return rs.uniform(-0.3, 1.3, (n, 3)).astype(dtype) * np.asarray(L, dtype)


@pytest.mark.parametrize("case", ["cubic", "uneven", "masked", "overflow",
                                  "open"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_build_cells_equal(case, dtype):
    """atom_of_slot, slot_of_atom and overflow exactly as the JAX package
    builds them: cubic and (3,4,5) grids, atoms outside the box, masked
    atoms, an overflowing cell, a non-periodic dimension."""
    from lidp_tpu import box as jbox
    from lidp_tpu.ops import cells as jcells

    L = (11.6, 11.6, 11.6) if case == "cubic" else (9.0, 12.0, 15.0)
    n = 300
    x = _cloud(n, L, 21, dtype)
    mask = np.ones(n, bool)
    periodic = (True, True, True)
    cap = 24
    if case == "masked":
        mask[np.random.RandomState(1).rand(n) < 0.3] = False
    if case == "overflow":
        x[:40] = np.asarray(L, dtype) * 0.1 + \
            np.random.RandomState(2).uniform(0, 0.5, (40, 3)).astype(dtype)
    if case == "open":
        periodic = (True, True, False)
    nb = tuple(int(v // 2.9) for v in L)
    cfg_j = jcells.CellConfig(nbins=nb, cap=cap, cutneigh=2.9)
    cfg_t = tcells.CellConfig(nbins=nb, cap=cap, cutneigh=2.9)
    bj = jbox.Box.create(np.zeros(3, dtype), np.asarray(L, dtype),
                         periodic=periodic)
    bt = tbox.Box.create(np.zeros(3, dtype), np.asarray(L, dtype),
                                periodic=periodic)
    cj = jcells.build_cells(jnp.asarray(x), jnp.asarray(mask), bj, cfg_j)
    ct = tcells.build_cells(torch.as_tensor(x), torch.as_tensor(mask), bt,
                            cfg_t)
    assert bool(ct.overflow) == bool(cj.overflow) == (case == "overflow")
    assert ct.atom_of_slot.dtype == torch.int32
    assert ct.slot_of_atom.dtype == torch.int32
    np.testing.assert_array_equal(ct.slot_of_atom.numpy(),
                                  np.asarray(cj.slot_of_atom))
    np.testing.assert_array_equal(ct.atom_of_slot.numpy(),
                                  np.asarray(cj.atom_of_slot))
    cc = convert.cells_from_numpy(_fields(cj), device="cpu")
    assert torch.equal(cc.atom_of_slot, ct.atom_of_slot)
    assert torch.equal(cc.slot_of_atom, ct.slot_of_atom)
    # every unmasked atom that found a slot sits in the slot it names
    aos = ct.atom_of_slot.reshape(-1).numpy()
    soa = ct.slot_of_atom.numpy()
    live = aos < n
    assert np.all(soa[aos[live]] == np.nonzero(live)[0])
    assert mask[aos[live]].all()
    if case != "overflow":
        assert live.sum() == mask.sum()


def test_build_cells_thin_bins_flag():
    """A bin thinner than the neighbour cutoff sets the sticky flag."""
    cfg = tcells.CellConfig(nbins=(4, 4, 4), cap=16, cutneigh=2.9)
    bt = tbox.Box.create(np.zeros(3), np.full(3, 11.0))
    x = torch.as_tensor(_cloud(50, (11.0,) * 3, 4, np.float64))
    c = tcells.build_cells(x, torch.ones(50, dtype=torch.bool), bt, cfg)
    assert bool(c.overflow)


# ------------------------------ integrator -------------------------------

def _nve_inputs(dtype, seed=31):
    from lidp_tpu import box as jbox
    from lidp_tpu.state import make_system as jmake

    rs = np.random.RandomState(seed)
    n = 50
    x = rs.uniform(0, 6, (n, 3))
    kw = dict(v=rs.normal(size=(n, 3)), mask=rs.rand(n) < 0.9)
    f = rs.normal(size=(n, 3)) * 30
    mass = rs.uniform(0.5, 3.0, n)
    mass[:3] = 0.0
    jd = jnp.float32 if dtype == np.float32 else jnp.float64
    td = torch.float32 if dtype == np.float32 else torch.float64
    sj = jmake(x, box=jbox.Box.create(np.zeros(3), np.full(3, 6.0)),
               dtype=jd, **kw)
    st = make_system(x, box=tbox.Box.create(np.zeros(3), np.full(3, 6.0)),
                     dtype=td, device="cpu", **kw)
    return sj, st, f.astype(dtype), mass, jd, td


@pytest.mark.parametrize("variant", ["plain", "group", "limit", "noforce"])
def test_nve_matches_jax(variant):
    from lidp_tpu.integrate import nve as jnve

    sj, st, f, mass, jd, td = _nve_inputs(np.float64)
    kw = {}
    if variant == "group":
        kw["gmask"] = np.arange(50) % 3 != 0
    if variant == "limit":
        kw["xlimit"] = 0.004
    if variant == "noforce":
        kw["noforce"] = True
    pj = jnve.NVEParams.create(0.005, 1.0, mass, dtype=jd, **kw)
    pt = tnve.NVEParams.create(0.005, 1.0, mass, dtype=td, **kw)
    fj, ft = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(3):
        sj = jnve.final_integrate(jnve.initial_integrate(sj, fj, pj), fj, pj)
        st = tnve.final_integrate(tnve.initial_integrate(st, ft, pt), ft, pt)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=1e-14)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), rtol=1e-13,
                               atol=1e-15)


def test_nve_kahan_matches_jax():
    """The Kahan variant in float32: same x, v and compensation terms as
    the JAX one after 50 steps, and closer to float64 than plain float32."""
    from lidp_tpu.integrate import nve as jnve

    sj, st, f, mass, jd, td = _nve_inputs(np.float32)
    pj = jnve.NVEParams.create(0.005, 1.0, mass, dtype=jd)
    pt = tnve.NVEParams.create(0.005, 1.0, mass, dtype=td)
    fj, ft = jnp.asarray(f), torch.as_tensor(f)
    sj, cj = jnve.kahan_init_state(sj, fj, pj)
    st, ct = tnve.kahan_init_state(st, ft, pt)
    splain = st
    for _ in range(50):
        sj, cj = jnve.kahan_initial_integrate(sj, fj, pj, cj)
        sj, cj = jnve.kahan_final_integrate(sj, fj, pj, cj)
        st, ct = tnve.kahan_initial_integrate(st, ft, pt, ct)
        st, ct = tnve.kahan_final_integrate(st, ft, pt, ct)
        splain = tnve.final_integrate(
            tnve.initial_integrate(splain, ft, pt), ft, pt)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=1e-6)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ct[0].numpy(), np.asarray(cj[0]), atol=1e-7)
    _, s64, f64, _, _, t64 = _nve_inputs(np.float64)
    p64 = tnve.NVEParams.create(0.005, 1.0, mass, dtype=t64)
    f64 = torch.as_tensor(f64)
    for _ in range(50):
        s64 = tnve.final_integrate(tnve.initial_integrate(s64, f64, p64),
                                   f64, p64)
    err_k = (st.x.double() - s64.x).abs().max()
    err_p = (splain.x.double() - s64.x).abs().max()
    assert err_k <= err_p


# -------------------------------- thermo ---------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(dim=2),
    dict(vcomp=(True, False, True)),
    dict(com_bias=True),
    dict(etail=-12.5, ptail=-30.0),
    dict(norm=False),
])
def test_thermo_row_every_column(kw):
    from lidp_tpu import thermo as jthermo
    from lidp_tpu import units as junits
    from lidp_tpu.forcefield import ForceResult as JRes

    sj, st, f, mass, jd, td = _nve_inputs(np.float64, seed=41)
    sj, st = sj.replace(step=jnp.asarray(17, jnp.int32)), st.replace(step=17)
    rs = np.random.RandomState(43)
    e = rs.normal(size=5)
    vir = rs.normal(size=6)
    extra = rs.normal(size=6)
    n = sj.x.shape[0]
    kw = dict(dict(norm=True), **kw)
    tpj = jthermo.ThermoParams.create(mass, 3 * n - 3, junits.REAL,
                                      natoms=n, **kw)
    tpt = tthermo.ThermoParams.create(mass, 3 * n - 3, tunits.REAL,
                                      natoms=n, **kw)
    rj = JRes(f=jnp.asarray(f), evdwl=e[0], ecoul=e[1], elong=e[2],
              epol=e[3], ebond=e[4], virial=jnp.asarray(vir), mu=sj.mu,
              scf_iters=0, scf_diverged=False)
    rt = dataclasses.replace(
        pair_only_result(st, torch.as_tensor(f), torch.tensor(e[0]),
                         torch.tensor(e[1]), torch.as_tensor(vir)),
        elong=torch.tensor(e[2]), epol=torch.tensor(e[3]),
        ebond=torch.tensor(e[4]))
    for xv in (None, extra):
        rowj = jthermo.thermo_row(
            sj, rj, tpj, None if xv is None else jnp.asarray(xv))
        rowt = tthermo.thermo_row(
            st, rt, tpt, None if xv is None else torch.as_tensor(xv))
        assert set(rowt) == set(rowj)
        assert rowt["step"] == 17 and isinstance(rowt["step"], int)
        for k, v in rowj.items():
            assert isinstance(rowt[k], (int, float)), k
            assert rowt[k] == pytest.approx(float(v), rel=1e-12, abs=1e-300), k
    assert float(tthermo.temperature(st, tpt)) == pytest.approx(
        rowt["temp"], rel=1e-14)
