"""The port's CHARMM pair styles (the LJ energy switch of lj/charmm/* and
the switched coulomb of lj/charmm/coul/charmm in lidp_tpu_torch/ops/pair.py
and ops/cells.py) against the JAX package's, float64 on the CPU.

  * make_pair_params with charmm=True (coul long, coul charmm) gives the
    JAX tables (rel 1e-14: sigma**6 rounds differently) and scalars,
    directly and through convert.pair_from_numpy;
  * dense_pair_forces on 3-type charged atoms in a 16 A box with random
    special codes, plus pairs placed at, one ulp inside and one ulp outside
    the inner and outer LJ cutoffs and the inner and outer coulomb cutoffs
    (along x alone, so that no contraction of rsq moves them): f,
    energies and virial at rel 1e-10 of the largest entry;
  * the plain cell pass cell_pair_forces on the same atoms on a 3 x 3 x 3
    grid, both coulomb forms, against the JAX cell_pair_forces on the same
    slot grid at rel 1e-10;
  * pair_single against the JAX pair_single across the switching regions,
    and its force equal to -dE/dr there (central differences), as
    tests/test_charmm.py checks the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from lidp_tpu.box import Box as JBox  # noqa: E402
from lidp_tpu.ops import cells as jcells  # noqa: E402
from lidp_tpu.ops import pair as jpair  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.box import Box  # noqa: E402
from lidp_tpu_torch.ops import cells as tcells  # noqa: E402
from lidp_tpu_torch.ops import pair as tpair  # noqa: E402

L = 16.0
INNER, OUTER = 4.0, 5.5          # the LJ switch
C_INNER, C_OUTER = 5.0, 6.0      # coul/charmm's switch
QQRD2E = 332.06371
SPECIAL = ((1.0, 0.0, 0.0, 0.5), (1.0, 0.0, 0.5, 0.8333))
TOL = 1e-10
KINDS = ("long", "charmm")


def _tables():
    eps = np.zeros((4, 4))
    sig = np.zeros((4, 4))
    e = np.array([0.1, 0.05, 0.2])
    s = np.array([3.0, 2.6, 3.4])
    eps[1:, 1:] = np.sqrt(np.outer(e, e))
    sig[1:, 1:] = 0.5 * (s[:, None] + s[None, :])
    return eps, sig, np.full((4, 4), OUTER)


def _params(kind):
    """(JAX PairParams, the port's from make_pair_params)."""
    eps, sig, cut = _tables()
    kw = dict(cut_coul=C_OUTER if kind == "charmm" else 6.5,
              special_lj=SPECIAL[0], special_coul=SPECIAL[1],
              qqrd2e=QQRD2E, g_ewald=0.0 if kind == "charmm" else 0.31,
              coul=True, cut_lj_inner=INNER, charmm=True, coul_kind=kind,
              cut_coul_inner=C_INNER if kind == "charmm" else 0.0)
    pj = jpair.make_pair_params(eps, sig, cut, dtype=jnp.float64, **kw)
    pt = tpair.make_pair_params(eps, sig, cut, dtype=torch.float64, **kw)
    return pj, pt


@pytest.mark.parametrize("kind", KINDS)
def test_make_pair_params_matches_jax(kind):
    pj, pt = _params(kind)
    fields = {f.name: getattr(pj, f.name) for f in dataclasses.fields(pj)}
    pc = convert.pair_from_numpy(
        {k: (v if v is None or isinstance(v, (str, bool)) else np.array(v))
         for k, v in fields.items()}, device="cpu", dtype=torch.float64)
    for p in (pt, pc):
        for name in ("lj3", "lj4", "offset", "cut_ljsq", "cutsq",
                     "special_lj", "special_coul"):
            # sigma**6 may round differently in XLA and torch: 1e-14
            np.testing.assert_allclose(getattr(p, name).numpy(),
                                       np.asarray(fields[name]), rtol=1e-14,
                                       atol=0, err_msg=name)
        for name in ("cut_coulsq", "qqrd2e", "g_ewald", "cut_lj_innersq",
                     "denom_lj"):
            assert getattr(p, name) == float(fields[name]), name
        assert p.charmm and p.coul_kind == kind
        if kind == "charmm":
            assert p.cut_coul_innersq == float(fields["cut_coul_innersq"])
            assert p.denom_coul == float(fields["denom_coul"])


def _atoms(seed=3, n=90, box=L):
    """n random atoms of 3 types with charges in a cubic box of edge
    `box`, then 12 pairs along x at the switches' edges; random symmetric
    special codes."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.0, box, (n, 3))
    eps_ulp = np.spacing
    edges = []
    for r in (INNER, OUTER, C_INNER, C_OUTER):
        edges += [r, r - eps_ulp(r), r + 4 * eps_ulp(r)]
    y0 = 0.5
    for k, r in enumerate(edges):
        # a pair at distance r along x, far from the other pairs in z
        base = np.array([1.0, y0 + 1.3 * k, 0.25])
        x = np.concatenate([x, [base, base + np.array([r, 0.0, 0.0])]])
    n = x.shape[0]
    typ = rng.randint(1, 4, n)
    q = rng.normal(0.0, 0.4, n)
    sp = rng.randint(0, 4, (n, n)) * (rng.uniform(size=(n, n)) < 0.05)
    sp = np.triu(sp, 1)
    sp = (sp + sp.T).astype(np.int8)
    mask = np.ones(n, bool)
    mask[rng.choice(n - 2 * len(edges), 3, replace=False)] = False
    return x, typ, q, sp, mask


def _close(got, want, msg):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    big = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * big,
                               err_msg=msg)


@pytest.mark.parametrize("kind", KINDS)
def test_dense_pair_forces_match_jax(kind):
    pj, pt = _params(kind)
    x, typ, q, sp, mask = _atoms()
    ref = jax.jit(jpair.dense_pair_forces)(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(typ, jnp.int32),
        jnp.asarray(sp), jnp.asarray(mask),
        JBox.create([0.0] * 3, [L] * 3, dtype=jnp.float64), pj)
    got = tpair.dense_pair_forces(
        torch.as_tensor(x), torch.as_tensor(q), torch.as_tensor(typ),
        torch.as_tensor(sp), torch.as_tensor(mask),
        Box.create([0.0] * 3, [L] * 3, dtype=torch.float64), pt)
    for name, g, r in zip(("f", "evdwl", "ecoul", "virial"), got, ref):
        _close(g, r, f"{kind} {name}")
    # the switches act: beyond the inner cutoff the LJ term is switched,
    # and the pairs at the edges take part
    assert float(got[1]) != 0.0 and float(got[2]) != 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_cell_pair_forces_match_jax(kind):
    """The plain cell pass on a 3 x 3 x 3 grid of 6.6 A bins, every
    cutoff inside one bin (no special codes: the cell grid takes every
    pair at full weight)."""
    pj, pt = _params(kind)
    box = 19.8
    x, typ, q, _, mask = _atoms(seed=5, n=160, box=box)
    cfgj = jcells.CellConfig.for_box(np.full(3, box), 6.5,
                                     density=len(x) / box ** 3,
                                     cap_slack=4.0)
    assert cfgj.nbins == (3, 3, 3)
    bj = JBox.create([0.0] * 3, [box] * 3, dtype=jnp.float64)
    bt = Box.create([0.0] * 3, [box] * 3, dtype=torch.float64)
    cj = jcells.build_cells(jnp.asarray(x), jnp.asarray(mask), bj, cfgj)
    ct = tcells.build_cells(
        torch.as_tensor(x), torch.as_tensor(mask), bt,
        tcells.CellConfig(cfgj.nbins, cfgj.cap, cfgj.cutneigh))
    np.testing.assert_array_equal(ct.atom_of_slot.numpy(),
                                  np.asarray(cj.atom_of_slot))
    ref = jax.jit(jcells.cell_pair_forces)(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(typ, jnp.int32),
        jnp.asarray(mask), cj, bj, pj)
    got = tcells.cell_pair_forces(
        torch.as_tensor(x), torch.as_tensor(q), torch.as_tensor(typ),
        torch.as_tensor(mask), ct, bt, pt)
    for name, g, r in zip(("f", "evdwl", "ecoul", "virial"), got, ref):
        _close(g, r, f"{kind} cells {name}")
    assert float(got[1]) != 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_pair_single_matches_jax_and_is_the_energy_gradient(kind):
    pj, pt = _params(kind)
    r = np.linspace(3.0, 6.3, 67)
    rsq = r * r
    for ti, tj, fl, fc in ((1, 2, 1.0, 1.0), (3, 3, 0.5, 0.8333)):
        ej, fj = jpair.pair_single(jnp.asarray(rsq), ti, tj, 0.4, -0.7, pj,
                                   factor_coul=fc, factor_lj=fl)
        et, ft = tpair.pair_single(torch.as_tensor(rsq), ti, tj, 0.4, -0.7,
                                   pt, factor_coul=fc, factor_lj=fl)
        _close(et, ej, f"{kind} single energy")
        _close(ft, fj, f"{kind} single force")
    # F = -dE/dr in the LJ switching region (coul charmm's force is not
    # its energy's gradient by the reference's own convention: LJ alone)
    pl = dataclasses.replace(pt, coul=False)
    rr = torch.linspace(INNER + 0.05, OUTER - 0.05, 40, dtype=torch.float64)
    h = 1e-6
    e_hi, _ = tpair.pair_single((rr + h) ** 2, 1, 2, 0.0, 0.0, pl)
    e_lo, _ = tpair.pair_single((rr - h) ** 2, 1, 2, 0.0, 0.0, pl)
    _, fforce = tpair.pair_single(rr * rr, 1, 2, 0.0, 0.0, pl)
    np.testing.assert_allclose((fforce * rr).numpy(),
                               (-(e_hi - e_lo) / (2 * h)).numpy(),
                               rtol=1e-6, atol=1e-9)
