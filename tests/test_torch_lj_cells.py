"""The port's cell engine against the JAX package on the CPU, from numpy
inputs made from a seed.

  * ops/cells.cell_pair_forces against lidp_tpu.ops.cells.cell_pair_forces
    on the same Cells: float64 to rel 1e-10 (another summation order),
    float32 to 5e-6 of the largest force and rel 1e-5 on the sums (the bar
    of tests/test_slot_runner.py): one type, two types, with coul/long,
    need_ev off, a (3,4,5) grid, a single-bin dimension, an open face;
  * the plain versions of the two LJ cell kernels (ops/cell_kernels.py)
    against the Pallas functions in interpret mode, same bar;
  * the gate of forcefield.compute_forces.
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
from lidp_tpu_torch import forcefield as tff  # noqa: E402
from lidp_tpu_torch.integrate.slot_runner import SlotRunner  # noqa: E402
from lidp_tpu_torch.ops import cell_kernels as tck  # noqa: E402
from lidp_tpu_torch.ops import cells as tcells  # noqa: E402
from lidp_tpu_torch.state import make_system  # noqa: E402

GRIDS = {"cubic": (11.6, 11.6, 11.6), "uneven": (8.8, 11.7, 14.6)}


def _fields(obj):
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _atoms(L, n, seed, dtype):
    """A jittered lattice (no close contacts) filling the box, in [0, L)."""
    rs = np.random.RandomState(seed)
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[rs.permutation(side**3)[:n]]
    h = np.asarray(L) / side
    x = (g + 0.5 + rs.uniform(-0.3, 0.3, (n, 3))) * h
    return x.astype(dtype)


def _tables(ntypes, seed=5):
    rs = np.random.RandomState(seed)
    T = ntypes + 1
    eps = np.zeros((T, T)); sig = np.zeros((T, T)); cut = np.zeros((T, T))
    e = rs.uniform(0.6, 1.4, (ntypes, ntypes))
    s = rs.uniform(0.9, 1.1, (ntypes, ntypes))
    c = rs.uniform(2.2, 2.7, (ntypes, ntypes))
    eps[1:, 1:], sig[1:, 1:], cut[1:, 1:] = (e + e.T) / 2, (s + s.T) / 2, \
        (c + c.T) / 2
    if ntypes == 1:
        eps[1, 1], sig[1, 1], cut[1, 1] = 1.0, 1.0, 2.5
    return eps, sig, cut


def _case(L, dtype, ntypes=1, coul=False, periodic=(True, True, True),
          nbins=None, n=400, masked=False, shift=False, cap=None):
    """The same system, pair table and Cells in both packages; with `cap`
    given, a grid of that cap which the atoms must overflow."""
    from lidp_tpu import box as jbox
    from lidp_tpu.ops import cells as jcells
    from lidp_tpu.ops.pair import make_pair_params as jmake

    jd = jnp.float32 if dtype == np.float32 else jnp.float64
    td = torch.float32 if dtype == np.float32 else torch.float64
    rs = np.random.RandomState(17)
    x = _atoms(L, n, 9, dtype)
    q = (rs.normal(size=n) * 0.4).astype(dtype)
    typ = rs.randint(1, ntypes + 1, n).astype(np.int32)
    mask = np.ones(n, bool)
    if masked:
        mask[rs.rand(n) < 0.15] = False
    eps, sig, cut = _tables(ntypes)
    kw = dict(coul=coul, shift=shift, dtype=jd)
    if coul:
        kw.update(cut_coul=2.6, qqrd2e=332.06371, g_ewald=0.9)
    pj = jmake(eps, sig, cut, **kw)
    pt = convert.pair_from_numpy(_fields(pj), device="cpu", dtype=td)
    nb = nbins or tuple(int(v // 2.9) for v in L)
    overflow = cap is not None
    cap = cap or int(np.ceil(3.0 * n / np.prod(nb) / 8) * 8)
    cfg = jcells.CellConfig(nbins=nb, cap=cap, cutneigh=2.9)
    lo, hi = np.zeros(3, dtype), np.asarray(L, dtype)
    bj = jbox.Box.create(lo, hi, periodic=periodic)
    bt = tbox.Box.create(lo, hi, periodic=periodic)
    cj = jcells.build_cells(jnp.asarray(x), jnp.asarray(mask), bj, cfg)
    assert bool(cj.overflow) == overflow
    ct = convert.cells_from_numpy(_fields(cj), device="cpu")
    jax_in = dict(x=jnp.asarray(x), q=jnp.asarray(q), type=jnp.asarray(typ),
                  mask=jnp.asarray(mask), cells=cj, box=bj, p=pj)
    t = torch.as_tensor
    torch_in = dict(x=t(x), q=t(q), type=t(typ), mask=t(mask), cells=ct,
                    box=bt, p=pt)
    return jax_in, torch_in, cfg


def _close(got, ref, dtype, what):
    """float64: rel 1e-10 of the largest entry.  float32: forces 5e-6 of
    the largest, sums rel 1e-5."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max()
    if dtype == np.float64:
        tol = 1e-10 * scale
    else:
        tol = (5e-6 if what == "f" else 1e-5) * scale
    assert np.abs(got - ref).max() <= tol + 1e-300, \
        (what, np.abs(got - ref).max(), scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,kw", [
    ("one_type", dict()),
    ("one_type_shift_masked", dict(shift=True, masked=True)),
    ("two_types", dict(ntypes=2)),
    ("coul_long", dict(coul=True)),
    ("two_types_coul", dict(ntypes=2, coul=True)),
    ("uneven", dict(L=GRIDS["uneven"])),
    ("single_bin_dim", dict(L=(11.6, 11.6, 5.0), nbins=(4, 4, 1))),
    ("open_face", dict(periodic=(True, True, False), ntypes=2)),
])
def test_cell_pair_forces_matches_jax(name, kw, dtype):
    from lidp_tpu.ops import cells as jcells

    kw = dict(kw)
    L = kw.pop("L", GRIDS["cubic"])
    ji, ti, _ = _case(L, dtype, **kw)
    ref = jcells.cell_pair_forces(ji["x"], ji["q"], ji["type"], ji["mask"],
                                  ji["cells"], ji["box"], ji["p"])
    got = tcells.cell_pair_forces(ti["x"], ti["q"], ti["type"], ti["mask"],
                                  ti["cells"], ti["box"], ti["p"])
    assert float(np.abs(np.asarray(ref[0])).max()) > 0.1
    assert float(ref[1]) != 0.0
    for g, r, what in zip(got, ref, ("f", "evdwl", "ecoul", "virial")):
        assert g.dtype == ti["x"].dtype
        _close(g.numpy(), r, dtype, what)
    if kw.get("masked"):
        assert not got[0][~ti["mask"]].any()
    if kw.get("coul"):
        assert float(got[2]) != 0.0


@pytest.mark.parametrize("coul", [False, True])
def test_cell_pair_forces_quiet(coul):
    """need_ev=False: the same forces, zero energies and virial."""
    _, ti, _ = _case(GRIDS["cubic"], np.float64, ntypes=2, coul=coul)
    args = (ti["x"], ti["q"], ti["type"], ti["mask"], ti["cells"], ti["box"],
            ti["p"])
    f1, ev, ec, vir = tcells.cell_pair_forces(*args, need_ev=False)
    f0 = tcells.cell_pair_forces(*args)[0]
    assert torch.equal(f0, f1)
    assert float(ev) == 0.0 and float(ec) == 0.0 and not vir.any()
    # coul=False overrides a table that has coulomb
    f2 = tcells.cell_pair_forces(*args, coul=False)[0]
    assert torch.equal(f2, f0) != coul


def _slot_inputs(grid, masked=False):
    """Slot-order state of one case in both packages (float32)."""
    from lidp_tpu.forcefield import ForceField as JFF
    from lidp_tpu.integrate.slot_runner import SlotRunner as JSlot

    ji, ti, cfg = _case(GRIDS[grid], np.float32, masked=masked)
    n = ti["x"].shape[0]
    srj = JSlot(ff=JFF(pair=ji["p"]), neighbor_cfg=cfg, dt=0.005, ftm2v=1.0,
                n=n)
    tcfg = tcells.CellConfig(cfg.nbins, cfg.cap, cfg.cutneigh)
    srt = SlotRunner(ff=tff.ForceField(pair=ti["p"]), neighbor_cfg=tcfg,
                     dt=0.005, ftm2v=1.0, n=n)
    sj = srj._slotify(ji["x"], jnp.zeros((n, 3), jnp.float32),
                      jnp.ones(n, jnp.float32),
                      jnp.arange(n, dtype=jnp.int32), ji["mask"], ji["box"])
    st = srt._slotify(ti["x"], torch.zeros((n, 3)), torch.ones(n),
                      torch.arange(n, dtype=torch.int32), ti["mask"],
                      ti["box"])
    return ji, ti, sj, st


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("grid", ["cubic", "uneven"])
def test_slotify_equal(grid, masked):
    """The slot state (sentinels included) is the JAX package's, exactly."""
    _, ti, sj, st = _slot_inputs(grid, masked)
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert st[3].dtype == torch.int32
    n = ti["x"].shape[0]
    assert int((st[3] < n).sum()) == int(ti["mask"].sum())
    base, spacing = tck.sentinel_scalars(ti["box"], ti["p"])
    assert float(spacing) > 2 * 2.5 + max(GRIDS[grid])
    assert float(st[0][..., 0][st[3] == n].min()) >= float(base)


@pytest.mark.parametrize("need_ev", [True, False])
@pytest.mark.parametrize("grid", ["cubic", "uneven"])
def test_slot_lj_forces_plain_matches_pallas(grid, need_ev):
    from lidp_tpu.ops import pallas_pair as PP

    ji, ti, sj, st = _slot_inputs(grid, masked=True)
    fgj, evj, virj = PP.slot_lj_forces(
        [sj[0][..., d] for d in range(3)], ji["box"], ji["p"],
        need_ev=need_ev)
    grids = [st[0][..., d] for d in range(3)]
    fgt, evt, virt = tck.slot_lj_forces_plain(grids, ti["box"], ti["p"],
                                              need_ev=need_ev)
    fj = np.stack([np.asarray(g) for g in fgj], -1)
    ft = torch.stack(fgt, -1).numpy()
    assert np.abs(fj).max() > 0.1
    _close(ft, fj, np.float32, "f")
    n = ti["x"].shape[0]
    assert not ft[(st[3] == n).numpy()].any()       # empty slots: no force
    if need_ev:
        _close(evt.numpy(), evj, np.float32, "evdwl")
        _close(virt.numpy(), virj, np.float32, "virial")
    else:
        assert float(evt) == 0.0 and not virt.any()
    # the wrapper takes the plain version on a CPU tensor, and counts nothing
    before = tck.slot_lj_forces.launches
    fgw, evw, _ = tck.slot_lj_forces(grids, ti["box"], ti["p"],
                                     need_ev=need_ev)
    assert tck.slot_lj_forces.launches == before
    assert torch.equal(torch.stack(fgw, -1), torch.stack(fgt, -1))
    assert torch.equal(evw, evt)


@pytest.mark.parametrize("need_ev", [True, False])
@pytest.mark.parametrize("grid", ["cubic", "uneven"])
def test_cell_pair_forces_lj_plain_matches_pallas(grid, need_ev):
    from lidp_tpu.ops import cells as jcells
    from lidp_tpu.ops import pallas_pair as PP

    ji, ti, _ = _case(GRIDS[grid], np.float32, masked=True)
    ref = PP.cell_pair_forces_pallas(ji["x"], ji["mask"], ji["cells"],
                                     ji["box"], ji["p"], need_ev=need_ev)
    got = tck.cell_pair_forces_lj_plain(ti["x"], ti["mask"], ti["cells"],
                                        ti["box"], ti["p"], need_ev=need_ev)
    assert float(np.abs(np.asarray(ref[0])).max()) > 0.1
    for g, r, what in zip(got, ref, ("f", "evdwl", "ecoul", "virial")):
        assert g.dtype == torch.float32
        if what == "f" or need_ev:
            _close(g.numpy(), r, np.float32, what)
        else:
            assert not g.any()
    assert not got[0][~ti["mask"]].any()
    # ... and both agree with the roll kernel on the same cells
    roll = jcells.cell_pair_forces(ji["x"], ji["q"], ji["type"], ji["mask"],
                                   ji["cells"], ji["box"], ji["p"])
    _close(got[0].numpy(), roll[0], np.float32, "f")
    before = tck.cell_pair_forces_lj.launches
    gw = tck.cell_pair_forces_lj(ti["x"], ti["mask"], ti["cells"], ti["box"],
                                 ti["p"], need_ev=need_ev)
    assert tck.cell_pair_forces_lj.launches == before
    assert torch.equal(gw[0], got[0])


@pytest.mark.parametrize("need_ev", [True, False])
def test_cell_pair_forces_lj_plain_matches_pallas_on_overflow(need_ev):
    """A grid of cap 5 for ~6 atoms a cell: many cells overflow, and the
    atoms that found no slot share their cell's last slot.  The plain
    version gives them that slot's force, as the JAX function does (the
    CUDA kernel is held to the plain version there:
    tests/test_torch_cuda_kernels.py::test_cell_pair_forces_lj_on_an_
    overflowing_grid)."""
    from lidp_tpu.ops import pallas_pair as PP

    ji, ti, _ = _case(GRIDS["cubic"], np.float32, masked=True, cap=5)
    ref = PP.cell_pair_forces_pallas(ji["x"], ji["mask"], ji["cells"],
                                     ji["box"], ji["p"], need_ev=need_ev)
    got = tck.cell_pair_forces_lj_plain(ti["x"], ti["mask"], ti["cells"],
                                        ti["box"], ti["p"], need_ev=need_ev)
    for g, r, what in zip(got, ref, ("f", "evdwl", "ecoul", "virial")):
        if what == "f" or need_ev:
            _close(g.numpy(), r, np.float32, what)
    aos = ti["cells"].atom_of_slot.reshape(-1).long()
    soa = ti["cells"].slot_of_atom.long()
    n = ti["x"].shape[0]
    noslot = ti["mask"] & (aos[soa.clamp(max=aos.numel() - 1)]
                           != torch.arange(n))
    assert int(noslot.sum()) > 10
    f = got[0]
    assert bool((f[noslot] != 0).any())
    # each takes the force of the atom that holds its slot
    holder = aos[soa[noslot]]
    assert torch.equal(f[noslot], f[holder])


def test_kernel_plain_versions_need_three_bins():
    _, ti, _ = _case((11.6, 11.6, 5.0), np.float32, nbins=(4, 4, 1))
    with pytest.raises(ValueError, match=">= 3 bins"):
        tck.cell_pair_forces_lj_plain(ti["x"], ti["mask"], ti["cells"],
                                      ti["box"], ti["p"])


def test_wrapper_registry():
    assert sorted(tck.WRAPPERS) == ["cell_pair_forces_lj", "slot_lj_forces"]
    for w in tck.WRAPPERS.values():
        assert isinstance(w.launches, int)
    _, ti, _ = _case(GRIDS["cubic"], np.float32)
    assert tck.supported(ti["p"], False, False)
    assert not tck.supported(ti["p"], True, False)
    assert not tck.supported(ti["p"], False, True)
    par = tck.lj_par(ti["box"], ti["p"])
    assert par.dtype == torch.float32 and tuple(par.shape) == (tck.NPAR,)
    np.testing.assert_allclose(
        par.numpy(), [4.0, 4.0, 0.0, 6.25, 11.6, 11.6, 11.6, np.inf],
        rtol=1e-6)


@pytest.mark.parametrize("name,kw,want", [
    ("lj_f32", dict(dtype=np.float32), True),
    ("lj_f64", dict(dtype=np.float64), False),
    ("two_types", dict(dtype=np.float32, ntypes=2), False),
    ("coul", dict(dtype=np.float32, coul=True), False),
    ("open_face", dict(dtype=np.float32, periodic=(True, True, False)),
     False),
    ("single_bin", dict(dtype=np.float32, L=(11.6, 11.6, 5.0),
                        nbins=(4, 4, 1)), False),
])
def test_compute_forces_gate(name, kw, want):
    """compute_forces sends single-type float32 LJ on a fully periodic grid
    of >= 3 bins a side to the LJ cell kernel's wrapper, all else to the
    roll kernel; either way the result is the JAX package's."""
    from lidp_tpu.forcefield import ForceField as JFF
    from lidp_tpu.forcefield import compute_forces as jcompute
    from lidp_tpu.state import make_system as jmake

    kw = dict(kw)
    dtype = kw.pop("dtype")
    L = kw.pop("L", GRIDS["cubic"])
    ji, ti, _ = _case(L, dtype, **kw)
    sys_t = make_system(ti["x"], box=ti["box"], q=ti["q"], type=ti["type"],
                        mask=ti["mask"], device="cpu")
    ff = tff.ForceField(pair=ti["p"])
    assert tff.pair_route(sys_t, ff, ti["cells"]) == (
        "cell_pair_forces_lj" if want else "cell_pair_forces")
    for need_ev in (True, False):
        res = tff.compute_forces(sys_t, ff, ti["cells"], need_ev=need_ev)
        sys_j = jmake(ji["x"], box=ji["box"], q=ji["q"], type=ji["type"],
                      mask=ji["mask"])
        ref = jcompute(sys_j, JFF(pair=ji["p"]), ji["cells"],
                       need_ev=need_ev)
        _close(res.f.numpy(), ref.f, dtype, "f")
        if need_ev:
            _close(res.evdwl.numpy(), ref.evdwl, dtype, "evdwl")
            _close(res.virial.numpy(), ref.virial, dtype, "virial")
            assert float(res.pe) == pytest.approx(float(ref.pe), rel=1e-5)
            assert float(res.epair) == pytest.approx(float(res.pe))
            assert float(res.emol) == 0.0
        else:
            assert float(res.evdwl) == 0.0 and not res.virial.any()


def test_atom_order_par_follows_the_box():
    """cell_pair_forces_lj forms its scalars once for a box and a table:
    the same objects give the same tensor, and a new Box (as an
    end_of_step hook that scales the box returns), a new table or an
    in-place change to the box's tensors give the scalars of what they now
    hold."""
    import dataclasses

    _, ti, _ = _case(GRIDS["cubic"], np.float32)
    box, p = ti["box"], ti["p"]
    par = tck._atom_order_par(box, p)
    assert torch.equal(par, tck.lj_par(box, p))
    assert tck._atom_order_par(box, p) is par
    box2 = dataclasses.replace(box, hi=box.hi * 1.01)
    par2 = tck._atom_order_par(box2, p)
    assert torch.equal(par2, tck.lj_par(box2, p))
    assert not torch.equal(par2[4:7], par[4:7])
    box2.hi.mul_(1.01)
    assert torch.equal(tck._atom_order_par(box2, p), tck.lj_par(box2, p))
    _, t2, _ = _case(GRIDS["cubic"], np.float32, shift=True)
    par3 = tck._atom_order_par(box2, t2["p"])
    assert torch.equal(par3, tck.lj_par(box2, t2["p"]))
    assert float(par3[2]) != float(par2[2])        # the shifted offset
    assert torch.equal(tck._atom_order_par(box, p), par)


def test_compute_forces_unported_routes_raise():
    """Neighbour lists raise; excl_mol on a cell grid (which raised here
    until it was ported) gives the JAX package's result; nlist=None is
    the dense route (ported), which gives the cell route's result, with a
    polar term too (the dense polar term after the cell pair term, ported
    in the script's cell route; tests/test_torch_script_cells.py holds it
    to JAX)."""
    tj, ti, _ = _case(GRIDS["cubic"], np.float64)
    sys_t = make_system(ti["x"], box=ti["box"], device="cpu")
    ff = tff.ForceField(pair=ti["p"])
    dense = tff.compute_forces(sys_t, ff, None)
    cells = tff.compute_forces(sys_t, ff, ti["cells"])
    for k in ("f", "evdwl", "virial"):
        _close(getattr(dense, k), getattr(cells, k), np.float64, k)
    with pytest.raises(NotImplementedError, match="neighbor.py"):
        tff.compute_forces(sys_t, ff, object())
    from lidp_tpu_torch.ops.polarization import PolarizationSettings

    ffp = dataclasses.replace(
        ff, polar=PolarizationSettings(),
        pair=dataclasses.replace(ff.pair, cut_coulsq=4.0))
    sys_p = sys_t.replace(alpha=torch.full_like(sys_t.q, 0.5),
                          q=torch.linspace(-0.3, 0.3, sys_t.q.shape[0],
                                           dtype=sys_t.q.dtype))
    dense = tff.compute_forces(sys_p, ffp, None)
    cells = tff.compute_forces(sys_p, ffp, ti["cells"])
    assert float(dense.epol) != 0.0
    for k in ("f", "evdwl", "epol", "mu", "virial"):
        _close(getattr(dense, k), getattr(cells, k), np.float64, k)
    # excl_mol on a cell grid, which raised here, is ported: the JAX
    # package's compute_forces on the same Cells (molecules of 4 atoms)
    from lidp_tpu.forcefield import ForceField as JFF
    from lidp_tpu.forcefield import compute_forces as jforces
    from lidp_tpu.state import make_system as jmake

    mol = np.arange(sys_t.x.shape[0]) // 4 + 1
    sys_m = sys_t.replace(mol=torch.as_tensor(mol, dtype=torch.int32))
    tres = tff.compute_forces(sys_m, dataclasses.replace(
        ff, pair=dataclasses.replace(ff.pair, excl_mol=True)), ti["cells"])
    jres = jforces(jmake(np.asarray(tj["x"]), box=tj["box"], mol=mol,
                         dtype=jnp.float64),
                   JFF(pair=dataclasses.replace(tj["p"], excl_mol=True)),
                   tj["cells"])
    for k in ("f", "evdwl", "virial"):
        _close(getattr(tres, k), getattr(jres, k), np.float64, k)
    assert float(tres.evdwl) != float(cells.evdwl)
