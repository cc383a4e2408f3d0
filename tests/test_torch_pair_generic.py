"""The port's generic pair dispatch (lidp_tpu_torch/ops/pair.py:
generic_vdw, table_terms, the debye, dsf, wolf, gromacs and cut coulomb
kinds, make_generic_pair_params, pair_single and dense_pair_forces;
ops/cells.py cell_pair_forces; convert.pair_from_numpy) against the JAX
package's (lidp_tpu/ops/pair.py _vdw_terms, _table_terms, _pair_terms,
make_generic_pair_params, pair_single, dense_pair_forces; ops/cells.py),
the same seeded numpy tables on both sides, float64 at rel 1e-10 and
float32 at 1e-5 of the largest entry:

  * each van der Waals kind's terms on random distances and type pairs;
  * the table's interpolation, r below the first grid point included;
  * each coulomb kind with the special factors through dense_pair_forces
    (the kind none, as coul/* runs), the dsf/wolf self energy;
  * every kind through dense_pair_forces (with special codes and a
    coulomb kind, pair_modify shift on and off) and cell_pair_forces
    (two types, shift on and off), and pair_single;
  * the special correction of the cell grid (ROADMAP queue 3 item 34):
    on the 375-atom fluid (polar_bench.synthetic_system(5), its bonds'
    special lists), JAX's cell route with special_correction_sparse
    against its dense route with the special codes, for every kind and
    coulomb kind: where JAX's two routes part, the port's correction
    raises; where they agree, the port's cell route equals JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

from lidp_tpu import box as jbox  # noqa: E402
from lidp_tpu.ops import cells as jcells  # noqa: E402
from lidp_tpu.ops import pair as jpair  # noqa: E402
from lidp_tpu_torch import box as tbox  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.ops import cells as tcells  # noqa: E402
from lidp_tpu_torch.ops import pair as tpair  # noqa: E402

T = 2            # atom types
CUT = 2.8
SPECIAL_LJ = (1.0, 0.3, 0.5, 0.7)
SPECIAL_COUL = (1.0, 0.2, 0.4, 0.6)

# each kind's tables t1..t4 (a (lo, hi) range, "lj12"/"lj6" for the LJ
# force tables 12 t3 and 6 t4, None for zeros) and t5 (a range, a list of
# ranges for a stacked table, or None), in the JAX package's meanings
# (lidp_tpu/ops/pair.py _vdw_terms)
LJ = ["lj12", "lj6", (1.0, 2.0), (1.0, 2.0)]
SPECS = {
    "morse": ([(0.5, 1.5), (1.0, 2.0), (1.0, 1.5), "morse"], None),
    "buck": ([(50.0, 150.0), (2.0, 4.0), (0.5, 1.5), None], None),
    "yukawa": ([(0.5, 1.5), (0.5, 1.5), None, None], None),
    "gauss": ([(0.5, 1.5), (0.5, 1.5), None, None], None),
    "soft": ([(0.5, 1.5), None, None, None], None),
    "born": ([(50.0, 150.0), (2.0, 4.0), (0.5, 1.5), (0.8, 1.2)],
             (0.1, 0.5)),
    "lj/expand": (LJ, (0.0, 0.3)),
    "mie": ([(8.0, 12.0), (4.0, 6.0), (1.0, 2.0), (1.0, 2.0)],
            [(10.0, 14.0), (5.0, 7.0)]),
    "lj96": ([(9.0, 18.0), (6.0, 12.0), (1.0, 2.0), (1.0, 2.0)], None),
    "lj/smooth/linear": (LJ, [(-0.1, 0.0), (0.0, 0.1), (2.5, 2.8)]),
    "lj/smooth": (LJ, [(-0.2, 0.0), (-0.5, 0.5), (-0.5, 0.5), (-0.5, 0.5),
                       (-0.5, 0.5), (1.0, 1.3)]),
    "zbl": ([None] * 4, [(0.5, 1.0), (1.0, 2.0), (2.0, 3.0), (6.0, 8.0),
                         (5.0, 10.0), (-2.0, 2.0), (-2.0, 2.0),
                         (-1.0, 1.0), (-1.0, 1.0), (-0.5, 0.5),
                         (1.4, 1.8)]),
    "beck": ([(0.5, 1.5), (0.5, 1.5), (0.8, 1.0), (1.0, 2.0)], (0.1, 0.3)),
    "ufm": ([(1.0, 3.0), (0.5, 1.5), (0.5, 1.5), None], None),
    "lj/cubic": (LJ, [(0.5, 1.5), (0.9, 1.1), (1.1, 1.4)]),
    "lj/gromacs": (LJ, [(-0.5, 0.5), (-0.5, 0.5), (-0.5, 0.5), (-0.5, 0.5),
                        (-0.5, 0.5), (1.6, 2.0)]),
    "none": ([None] * 4, None),
}
KIND_NAMES = sorted(SPECS)
# the coulomb kinds with their g_ewald (kappa, alpha or the Ewald g)
COULS = {"long": 0.9, "cut": 0.0, "debye": 0.7, "dsf": 0.5, "wolf": 0.5,
         "gromacs": 0.0, "msm": 0.0, "charmm": 0.0}


def _sym(rs, lo, hi, shape=()):
    a = rs.uniform(lo, hi, (T + 1, T + 1) + shape)
    a = 0.5 * (a + np.swapaxes(a, 0, 1))
    a[0, :] = a[:, 0] = 0.0
    return a


def _tables(kind, seed=11):
    """(t1, t2, t3, t4, t5) of SPECS[kind], symmetric in the types."""
    rs = np.random.RandomState(seed)
    spec, s5 = SPECS[kind]
    out = [_sym(rs, *s) if isinstance(s, tuple) else np.zeros((T + 1,
                                                               T + 1))
           for s in spec]
    derived = {"lj12": lambda: 12.0 * out[2], "lj6": lambda: 6.0 * out[3],
               "morse": lambda: 2.0 * out[0] * out[1]}
    for k, s in enumerate(spec):
        if isinstance(s, str):
            out[k] = derived[s]()
    if s5 is None:
        t5 = None
    elif isinstance(s5, tuple):
        t5 = _sym(rs, *s5)
    else:
        t5 = np.stack([_sym(rs, *r) for r in s5], axis=-1)
    return (*out, t5)


def _pairs(kind, dtype=np.float64, shift=False, coul=None, cut=CUT):
    """The JAX package's PairParams of `kind` (make_generic_pair_params)
    with the coulomb kind `coul` (None: no coulomb) and the port's from it
    through convert.pair_from_numpy."""
    jd = jnp.float32 if dtype == np.float32 else jnp.float64
    td = torch.float32 if dtype == np.float32 else torch.float64
    cutt = np.full((T + 1, T + 1), cut)
    cutt[0, :] = cutt[:, 0] = 0.0
    kw = dict(cut_lj=cutt, shift=shift, special_lj=SPECIAL_LJ,
              special_coul=SPECIAL_COUL, dtype=jd)
    if coul is not None:
        ck = "long" if coul == "cut" else coul
        kw.update(coul=True, cut_coul=cut + 0.2, qqrd2e=1.3,
                  g_ewald=COULS[coul], coul_kind=ck,
                  cut_coul_inner=cut - 0.6)
    pj = jpair.make_generic_pair_params(kind, *_tables(kind), **kw)
    return pj, convert.pair_from_numpy(_fields(pj), device="cpu", dtype=td)


def _fields(obj):
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _close(got, ref, dtype, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1e-300)
    tol = (1e-10 if dtype == np.float64 else 1e-5) * scale
    err = np.abs(got - ref).max()
    assert err <= tol, (what, err, scale)


# ------------------------------ the terms ---------------------------------

@pytest.mark.parametrize("kind", KIND_NAMES)
def test_vdw_terms_match_jax(kind):
    rs = np.random.RandomState(3)
    n = 500
    rsq = rs.uniform(0.75 ** 2, 3.2 ** 2, n)
    ti, tj = rs.randint(1, T + 1, n), rs.randint(1, T + 1, n)
    for dtype in (np.float64, np.float32):
        tabs = _tables(kind)
        jt = [None if t is None else jnp.asarray(t.astype(dtype))[ti, tj]
              for t in tabs]
        tt = [None if t is None else torch.as_tensor(t.astype(dtype))[ti, tj]
              for t in tabs]
        cut_j = jnp.full(n, CUT, dtype) if kind == "soft" else None
        cut_t = torch.full((n,), CUT, dtype=torch.float64 if dtype
                           == np.float64 else torch.float32) \
            if kind == "soft" else None
        rj = jnp.asarray(rsq.astype(dtype))
        rt = torch.as_tensor(rsq.astype(dtype))
        ref = jpair._vdw_terms(kind, rj, 1.0 / rj, *jt, cut_j)
        got = tpair.generic_vdw(kind, rt, 1.0 / rt, *tt, cut_t)
        for g, r, what in zip(got, ref, ("forcelj", "philj")):
            _close(g.numpy(), r, dtype, f"{kind} {what} {dtype.__name__}")


def test_table_terms_match_jax():
    rs = np.random.RandomState(4)
    nt = 60
    tab_e = _sym(rs, -1.0, 1.0, (nt,))
    tab_f = _sym(rs, -1.0, 1.0, (nt,))
    rlo, dr = 0.8, (CUT - 0.8) / (nt - 1)
    pj = jpair.PairParams(
        **{k: jnp.zeros((T + 1, T + 1)) for k in ("lj1", "lj2", "lj3",
                                                  "lj4", "offset")},
        cut_ljsq=jnp.full((T + 1, T + 1), CUT ** 2),
        cutsq=jnp.full((T + 1, T + 1), CUT ** 2),
        cut_coulsq=jnp.asarray(0.0), special_lj=jnp.asarray(SPECIAL_LJ),
        special_coul=jnp.asarray(SPECIAL_COUL), qqrd2e=jnp.asarray(1.0),
        g_ewald=jnp.asarray(0.0), cut_lj_innersq=jnp.asarray(0.0),
        denom_lj=jnp.asarray(1.0), coul=False, kind="table",
        tab_e=jnp.asarray(tab_e), tab_f=jnp.asarray(tab_f),
        tab_rlo=jnp.asarray(rlo), tab_dr=jnp.asarray(dr))
    pt = convert.pair_from_numpy(_fields(pj), device="cpu",
                                 dtype=torch.float64)
    n = 400
    # below the first grid point too: segment 0, frac clipped to 0
    rsq = rs.uniform(0.5 ** 2, CUT ** 2, n)
    ti, tj = rs.randint(1, T + 1, n), rs.randint(1, T + 1, n)
    ref = jpair._table_terms(pj, jnp.asarray(rsq), None, jnp.asarray(ti),
                             jnp.asarray(tj))
    got = tpair.table_terms(pt, torch.as_tensor(rsq), torch.as_tensor(ti),
                            torch.as_tensor(tj))
    for g, r in zip(got, ref):
        _close(g.numpy(), r, np.float64)
    assert np.any(rsq < 0.8 ** 2)
    ej, fj = jpair.pair_single(jnp.asarray(rsq), jnp.asarray(ti),
                               jnp.asarray(tj), 1.0, 1.0, pj)
    et, ft = tpair.pair_single(torch.as_tensor(rsq), ti, tj, 1.0, 1.0, pt)
    _close(et.numpy(), ej, np.float64)
    _close(ft.numpy(), fj, np.float64)


def test_make_generic_pair_params_matches_jax():
    """The port's builder (shift from the kind's own energy at rc, the
    dsf/wolf shifts, gromacs's coulsw) gives JAX's tables."""
    for kind, coul in (("born", "dsf"), ("lj/gromacs", "gromacs"),
                       ("mie", "wolf"), ("soft", None), ("ufm", "debye")):
        pj, pc = _pairs(kind, shift=True, coul=coul)
        pt = tpair.make_generic_pair_params(
            kind, *_tables(kind), cut_lj=np.asarray(pj.cut_ljsq) ** 0.5,
            shift=True, special_lj=SPECIAL_LJ, special_coul=SPECIAL_COUL,
            **({} if coul is None else dict(
                coul=True, cut_coul=CUT + 0.2, qqrd2e=1.3,
                g_ewald=COULS[coul], coul_kind=coul,
                cut_coul_inner=CUT - 0.6)))
        for name in ("lj1", "lj2", "lj3", "lj4", "lj5", "offset", "cutsq"):
            a, b = getattr(pt, name), getattr(pc, name)
            if a is None:
                assert b is None
                continue
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14,
                                       atol=0, err_msg=f"{kind} {name}")
        # soft's energy is zero at its cutoff
        assert np.any(pt.offset.numpy() != 0.0) == (kind != "soft")
        for name in ("coul_eshift", "coul_fshift", "coulsw"):
            assert getattr(pt, name) == pytest.approx(getattr(pc, name),
                                                      rel=1e-14)


# --------------------------- the dense route ------------------------------

def _system(n=60, L=6.0, seed=5):
    from lidp_tpu_torch import topology

    rs = np.random.RandomState(seed)
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[rs.permutation(side ** 3)[:n]]
    x = (g + 0.5 + rs.uniform(-0.25, 0.25, (n, 3))) * (L / side)
    q = rs.normal(size=n) * 0.5
    typ = rs.randint(1, T + 1, n).astype(np.int32)
    bonds = np.stack([np.arange(1, n, 2), np.arange(2, n + 1, 2)], 1)
    code = topology.special_codes_dense(n, bonds)
    return x, q, typ, code, L


def _dense_pair(kind, coul, shift, dtype):
    x, q, typ, code, L = _system()
    pj, pt = _pairs(kind, dtype, shift=shift, coul=coul)
    bj = jbox.Box.create(np.zeros(3), np.full(3, L))
    bt = tbox.Box.create(np.zeros(3), np.full(3, L))
    mask = np.ones(len(x), bool)
    ref = jpair.dense_pair_forces(
        jnp.asarray(x.astype(dtype)), jnp.asarray(q.astype(dtype)),
        jnp.asarray(typ), jnp.asarray(code), jnp.asarray(mask), bj, pj)
    got = tpair.dense_pair_forces(
        torch.as_tensor(x.astype(dtype)), torch.as_tensor(q.astype(dtype)),
        torch.as_tensor(typ), torch.as_tensor(code), torch.as_tensor(mask),
        bt, pt)
    return got, ref, pj, pt, q


# each kind once with each coulomb kind in turn
DENSE = [(k, list(COULS)[i % len(COULS)]) for i, k in
         enumerate(KIND_NAMES)]


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("kind,coul", DENSE)
def test_dense_pair_forces_match_jax(kind, coul, shift):
    for dtype in (np.float64,) + ((np.float32,) if shift else ()):
        got, ref, _, _, _ = _dense_pair(kind, coul, shift, dtype)
        for g, r, what in zip(got, ref, ("f", "evdwl", "ecoul", "virial")):
            _close(g.numpy(), r, dtype, f"{kind}/{coul} {what}")
    assert abs(float(ref[2])) > 0.0


@pytest.mark.parametrize("coul", list(COULS))
def test_coulomb_kinds_match_jax(coul):
    """The coulomb kinds alone (kind none, the coul/* styles), with the
    special factors, and the dsf/wolf self energy."""
    got, ref, pj, pt, q = _dense_pair("none", coul, False, np.float64)
    for g, r, what in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3]),
                          ("f", "ecoul", "virial")):
        _close(g.numpy(), r, np.float64, f"{coul} {what}")
    assert float(ref[1]) == 0.0 == float(got[1])
    if coul in ("dsf", "wolf"):
        mask = np.ones(len(q), bool)
        ej = jpair.dsf_wolf_self_energy(pj, jnp.asarray(q),
                                        jnp.asarray(mask))
        et = tpair.dsf_wolf_self_energy(pt, torch.as_tensor(q),
                                        torch.as_tensor(mask))
        assert float(et) == pytest.approx(float(ej), rel=1e-13)


@pytest.mark.parametrize("kind", KIND_NAMES)
def test_pair_single_matches_jax(kind):
    rs = np.random.RandomState(8)
    n = 300
    rsq = rs.uniform(0.75 ** 2, 3.3 ** 2, n)
    ti, tj = rs.randint(1, T + 1, n), rs.randint(1, T + 1, n)
    qi, qj = rs.normal(size=n), rs.normal(size=n)
    coul = list(COULS)[KIND_NAMES.index(kind) % len(COULS)]
    pj, pt = _pairs(kind, shift=True, coul=coul)
    for fl, fc in ((1.0, 1.0), (0.5, 0.3)):
        ej, fj = jpair.pair_single(jnp.asarray(rsq), jnp.asarray(ti),
                                   jnp.asarray(tj), jnp.asarray(qi),
                                   jnp.asarray(qj), pj, factor_coul=fc,
                                   factor_lj=fl)
        et, ft = tpair.pair_single(torch.as_tensor(rsq),
                                   torch.as_tensor(ti), torch.as_tensor(tj),
                                   torch.as_tensor(qi), torch.as_tensor(qj),
                                   pt, factor_coul=fc, factor_lj=fl)
        _close(et.numpy(), ej, np.float64, f"{kind} energy")
        _close(ft.numpy(), fj, np.float64, f"{kind} fforce")


# ------------------------------ the cell grid -----------------------------

# the kinds with a stacked lj5 table: the JAX package's cell route stacks
# lj5 with the (T+1,T+1) tables for its one-hot contraction and raises with
# several types (ROADMAP queue 3 item 35), so the port's is held to JAX's
# dense route there
STACKED = ("lj/cubic", "lj/gromacs", "lj/smooth", "lj/smooth/linear", "mie",
           "zbl")


def _cells(kind, coul, shift, dtype):
    """cell_pair_forces of both packages on 160 atoms of two types in a
    9.9 box (a 3^3 grid of cap 24), and JAX's dense_pair_forces on the
    same (with no special pairs)."""
    rs = np.random.RandomState(17)
    L, n = 9.9, 160
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[rs.permutation(side ** 3)[:n]]
    x = ((g + 0.5 + rs.uniform(-0.3, 0.3, (n, 3))) * (L / side)).astype(
        dtype)
    q = (rs.normal(size=n) * 0.4).astype(dtype)
    typ = rs.randint(1, T + 1, n).astype(np.int32)
    mask = np.ones(n, bool)
    pj, pt = _pairs(kind, dtype, shift=shift, coul=coul, cut=2.6)
    cfg = jcells.CellConfig(nbins=(3, 3, 3), cap=24, cutneigh=3.2)
    bj = jbox.Box.create(np.zeros(3, dtype), np.full(3, L, dtype))
    bt = tbox.Box.create(np.zeros(3, dtype), np.full(3, L, dtype))
    jin = (jnp.asarray(x), jnp.asarray(q), jnp.asarray(typ),
           jnp.asarray(mask))
    cj = jcells.build_cells(jin[0], jin[3], bj, cfg)
    assert not bool(cj.overflow)
    ct = convert.cells_from_numpy(_fields(cj), device="cpu")
    got = tcells.cell_pair_forces(torch.as_tensor(x), torch.as_tensor(q),
                                  torch.as_tensor(typ),
                                  torch.as_tensor(mask), ct, bt, pt)
    if kind in STACKED or dtype == np.float32:
        if kind in STACKED:
            with pytest.raises(ValueError, match="same shape"):
                jcells.cell_pair_forces(*jin, cj, bj, pj)
        ref = jpair.dense_pair_forces(jin[0], jin[1], jin[2], 0, jin[3], bj,
                                      pj)
    else:
        ref = jcells.cell_pair_forces(*jin, cj, bj, pj)
    return got, ref


@pytest.mark.parametrize("kind,coul", DENSE)
def test_cell_pair_forces_match_jax(kind, coul):
    got, ref = _cells(kind, coul, kind in ("born", "lj96", "ufm"),
                      np.float64)
    for g, r, what in zip(got, ref, ("f", "evdwl", "ecoul", "virial")):
        _close(g.numpy(), r, np.float64, f"{kind}/{coul} {what}")


@pytest.mark.parametrize("kind", ["born", "zbl"])
def test_cell_pair_forces_float32_match_jax(kind):
    """float32 against JAX's float32 dense route on the same atoms."""
    got, ref = _cells(kind, "dsf", False, np.float32)
    for g, r, what in zip(got, ref, ("f", "evdwl", "ecoul", "virial")):
        _close(g.numpy(), r, np.float32, f"{kind} {what}")


def test_table_on_cells_raises():
    pt = tpair.make_table_pair_params(np.zeros((3, 3, 4)),
                                      np.zeros((3, 3, 4)), 0.5, 0.5,
                                      np.full((3, 3), 2.0))
    x = torch.zeros((1, 3), dtype=torch.float64)
    cells = tcells.Cells(atom_of_slot=torch.ones((3, 3, 3, 8),
                                                 dtype=torch.int32),
                         slot_of_atom=torch.zeros(1, dtype=torch.int32),
                         overflow=torch.tensor(False))
    with pytest.raises(ValueError, match="dense route"):
        tcells.cell_pair_forces(x, x[:, 0], torch.ones(1, dtype=torch.int32),
                                torch.ones(1, dtype=torch.bool), cells,
                                tbox.Box.create(np.zeros(3), np.full(3, 9.0)),
                                pt)
# ----------------- the special correction on the cell grid -----------------

@pytest.fixture(scope="module")
def fluid():
    """The 375-atom fluid (polar_bench.synthetic_system(5): 125 linear
    H-O-H molecules, 20 A box), its special lists and codes, the systems
    of both packages and a 3^3 cell grid (cap 32, cutoff 5 + skin)."""
    from lidp_tpu import topology as jtopo
    from lidp_tpu_torch import topology as ttopo
    from lidp_tpu_torch.models import polar_bench
    from lidp_tpu_torch.state import make_system

    d = polar_bench.synthetic_system(5, seed=0)
    n = d["x"].shape[0]
    x, q = d["x"], d["q"]
    typ = d["type"].astype(np.int32)
    L = float(d["L"][0])
    si, sl = jtopo.special_lists(n, d["bonds"])
    si_t, sl_t = ttopo.special_lists(n, d["bonds"])
    np.testing.assert_array_equal(si, si_t)
    code = jtopo.special_codes_dense(n, d["bonds"])
    bj = jbox.Box.create(np.zeros(3), np.full(3, L))
    mask = np.ones(n, bool)
    cfg = jcells.CellConfig(nbins=(3, 3, 3), cap=32, cutneigh=6.0)
    cj = jcells.build_cells(jnp.asarray(x), jnp.asarray(mask), bj, cfg)
    assert not bool(cj.overflow)
    sys_t = make_system(x, box=tbox.Box.create(np.zeros(3), np.full(3, L)),
                        q=q, type=typ, mask=mask, dtype=torch.float64,
                        device="cpu")
    return dict(
        j=(jnp.asarray(x), jnp.asarray(q), jnp.asarray(typ),
           jnp.asarray(mask)), box=bj, code=jnp.asarray(code),
        si=jnp.asarray(si), sl=jnp.asarray(sl), sys=sys_t,
        cells_t=convert.cells_from_numpy(_fields(cj), device="cpu"),
        si_t=torch.as_tensor(si_t, dtype=torch.long),
        sl_t=torch.as_tensor(sl_t, dtype=torch.long))


# every van der Waals kind alone and every coulomb kind on the kind none
# the CHARMM family (ROADMAP queue 3 item 38): lj/charmmfsw's force
# switch ("lj_fsw") with the long and charmmfsh coulombs, lj with
# coul/charmm/implicit
SPECIAL_CASES = [(k, None) for k in KIND_NAMES] + [
    ("none", c) for c in COULS] + [("lj", "long"), ("lj", "dsf"),
                                   ("lj_fsw", "long"), ("lj_fsw", "charmmfsh"),
                                   ("lj", "charmm/implicit")]
# the cases of that item, where the port's cell route raises naming it
CHARMM_FAMILY = (("lj_fsw", "long"), ("lj_fsw", "charmmfsh"),
                 ("lj", "charmm/implicit"))


def _lj_pairs(coul, fsw=False):
    """lj/cut's table (make_pair_params) in both packages; fsw: the CHARMM
    force switch between 4.0 and the cutoff 5.0 (lj/charmmfsw's); the
    CHARMM coulomb kinds switch or shift between 4.4 and 5.5."""
    rs = np.random.RandomState(12)
    eps, sig = _sym(rs, 0.5, 1.5), _sym(rs, 0.9, 1.1)
    cut = np.full((T + 1, T + 1), 5.0)
    pj = jpair.make_pair_params(
        eps, sig, cut, cut_coul=5.5, coul=True, g_ewald=COULS.get(coul, 0.0),
        coul_kind=coul, special_lj=(1.0, 0.0, 0.0, 0.5),
        special_coul=(1.0, 0.0, 0.0, 0.5), qqrd2e=1.3, charmm=fsw,
        charmm_fsw=fsw, cut_lj_inner=4.0 if fsw else 0.0,
        cut_coul_inner=4.4)
    return pj, convert.pair_from_numpy(_fields(pj), device="cpu",
                                       dtype=torch.float64)


def _special_gap(fluid, pj):
    """JAX's cell route less its dense route on the fluid: on the special
    pairs alone (the other pairs take the same terms in both), the dense
    route's terms at each pair's factors less the full-weight terms of the
    cell pass, less special_correction_sparse; (f, E_vdwl, E_coul, virial)
    of the difference and of the special pairs at full weight (what the
    correction takes away)."""
    from lidp_tpu.box import minimum_image
    from lidp_tpu.ops.bonded import special_correction_sparse as jcorr

    x, q, typ, mask = fluid["j"]
    si, sl, L = fluid["si"], fluid["sl"], fluid["box"].lengths
    n = x.shape[0]
    live = si < n
    jc = jnp.minimum(si, n - 1)
    d = jnp.stack([minimum_image(x[:, k:k + 1] - x[:, k][jc], L[k])
                   for k in range(3)], -1)
    rsq = jnp.where(live, jnp.sum(d * d, -1), 1.0)
    args = (rsq, q[:, None], q[jc], typ[:, None], typ[jc])
    terms = [jpair._pair_terms(*args, code, pj, live)
             for code in (sl, jnp.zeros_like(sl))]
    corr = jcorr(x, q, typ, si, sl, mask, fluid["box"], pj)

    def sums(fp, ev, ec):
        w = 0.5 * fp
        return (jnp.sum(fp[..., None] * d, 1), 0.5 * jnp.sum(ev),
                0.5 * jnp.sum(ec),
                jnp.stack([jnp.sum(w * d[..., a] * d[..., b])
                           for a, b in ((0, 0), (1, 1), (2, 2), (0, 1),
                                        (0, 2), (1, 2))]))

    dense, full = sums(*terms[0]), sums(*terms[1])
    return [a - b - c for a, b, c in zip(dense, full, corr)], full


@pytest.mark.parametrize("kind,coul", SPECIAL_CASES)
def test_cells_special_correction_per_kind(fluid, kind, coul):
    """JAX's cell route (cell_pair_forces at factor 1, which equals its
    dense pass without special codes: test_cell_pair_forces_match_jax and
    the JAX package's own tests; plus special_correction_sparse) against
    its dense route with the special codes, on the fluid's 250 bonds (O-H
    0.7 A, H-H 1.4 A; special_lj and special_coul 0 0 0.5): the measured
    gap (_special_gap, relative to the special pairs' full-weight terms)
    decides.
    Where it parts (above 1e-9 in any of f, E_vdwl, E_coul, virial), the
    port's cell route raises naming ROADMAP queue 3 item 34; where it
    agrees, the port's cell route with its correction (and the dsf/wolf
    self energy) equals JAX's dense route at rel 1e-10."""
    from lidp_tpu_torch.forcefield import ForceField, compute_forces

    if kind in ("lj", "lj_fsw"):
        pj, pt = _lj_pairs(coul, fsw=kind == "lj_fsw")
    else:
        pj, _ = _pairs(kind, coul=coul, cut=5.0)
        pj = dataclasses.replace(
            pj, special_lj=jnp.asarray((1.0, 0.0, 0.0, 0.5)),
            special_coul=jnp.asarray((1.0, 0.0, 0.0, 0.5)))
        pt = convert.pair_from_numpy(_fields(pj), device="cpu",
                                     dtype=torch.float64)
    gaps, own = _special_gap(fluid, pj)
    gap = max([float(np.abs(np.asarray(g)).max())
               / float(np.abs(np.asarray(o)).max())
               for g, o in zip(gaps, own)
               if np.abs(np.asarray(o)).max() > 0], default=0.0)
    ff = ForceField(pair=pt, sp_idx=fluid["si_t"], sp_lvl=fluid["sl_t"])
    family = (kind, coul) in CHARMM_FAMILY
    parts = kind not in ("lj", "none") or coul in ("debye", "gromacs") \
        or family
    assert (gap > 1e-9) == parts, (kind, coul, gap)
    print(f"special gap {kind}/{coul}: {gap:.6e}")
    if parts:
        item = "queue 3 item 38" if family else "queue 3 item 34"
        with pytest.raises(NotImplementedError, match=item):
            compute_forces(fluid["sys"], ff, fluid["cells_t"])
        return
    res = compute_forces(fluid["sys"], ff, fluid["cells_t"])
    x, q, typ, mask = fluid["j"]
    ref = list(jpair.dense_pair_forces(x, q, typ, fluid["code"], mask,
                                       fluid["box"], pj))
    if coul in ("dsf", "wolf"):
        ref[2] = ref[2] + jpair.dsf_wolf_self_energy(pj, q, mask)
    for g, r, what in zip((res.f, res.evdwl, res.ecoul, res.virial), ref,
                          ("f", "evdwl", "ecoul", "virial")):
        _close(g.numpy(), r, np.float64, f"{kind}/{coul} {what}")
