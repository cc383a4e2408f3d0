"""The whole-panel dipole kernel's algorithm on the CPU (csrc/dipole_panel.cuh
runs only on the GPU; tests/test_torch_cuda_kernels.py holds it there).

  * a plain-torch emulation of dipole_whole_kernel: per block's tile pair
    (the closed form of panel_common.cuh tile_pair) each unordered pair
    once, in the kernel's expressions (M as h 1 - e d d^T, the damping's
    t1 term folded), each side gated by the OTHER atom's mask, the row
    and column sums in the kernel's slots, the slot-order sum, u_dd and
    the virial over both sides of each pair at half weight; it equals
    dipole_panel_plain (the row form) in float64 to rtol 1e-12, atol
    1e-12*max|ref| (scalars 1e-12 of the largest scalar output), with
    padding, alpha = 0 atoms and masked atoms that carry a charge, for
    both damping types and three tile sizes; and JAX's Pallas
    dipole_panel (interpret mode on the CPU) in float32 to
    tests/test_torch_panel_kernels.py's bars (per-row rtol 1e-4, atol
    1e-5*max|ref|; u_ef rel 5e-6, u_dd rel 1e-4, virial rtol 5e-6 and
    atol 5e-6 of the largest diagonal entry);
  * the kernel's exact skips, emulated vote by vote (a warp's 32 lanes x
    DG rows against one column each step): the votes in which no pair
    takes a block give it exactly zero, so the emulation with the skips
    equals the one without by torch.equal, and on the spatially ordered
    case most votes skip the charge-dipole block;
  * the absent damping skip: in float32 t1 = exp(-pd*r) is exactly 0 only
    beyond pd*r ~ 104 (the fluid's 60 A box reaches pd*r 110 at its
    corners only), and where l1 and l3 round to 1 (eind's EIND_SKIP_U)
    the t1 term of pre1 still changes pre1 when its other terms cancel,
    so no damping skip carries over;
  * the least arithmetic that chip_smoke.py's bound counts: the pairs it
    charges for are those on which the plain row form puts a force;
  * pairs at exactly cut_coulsq and one ulp inside it (chip_smoke.py
    dipole_cutoff_case): the plain version, whole and strip form, decides
    them by rsq rounded term by term, as the CUDA kernels do since they
    form rsq with rsq_rn, and agrees with JAX where contraction cannot
    move a pair; what JAX decides on the case itself is recorded.
"""

import math

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from lidp_tpu.ops import pallas_panel  # noqa: E402
from lidp_tpu_torch.ops import panel  # noqa: E402

PD = 2.1304
QQRD2E = 332.06371
CUT_COULSQ = 6.5**2
DG = 2              # csrc/dipole_panel.cuh: rows per warp vote
# atoms per tile of the kernel, by dtype (csrc/dipole_panel.cuh DipoleTile);
# the emulation holds at any tile of whole vote groups
TILE = {torch.float32: 128, torch.float64: 64}


def tile_pairs(npad, tile):
    """(I, k) of each block of the whole-panel kernels (panel_common.cuh
    tile_pair), in block order: tile I against J = I + k mod nT."""
    nT = -(-npad // tile)
    nK = nT * ((nT - 1) // 2 + 1)
    return [(b % nT, b // nT) if b < nK else (b - nK, nT // 2)
            for b in range(nT * (nT + 1) // 2)]


def _votes(tile):
    """(tile, tile) int: the vote of each pair (row, column) of one tile
    pair within its CTA: warp w = column // 32, step t = (column - lane) mod
    32 with lane = row % 32, group (row // 32) // DG."""
    row = torch.arange(tile)[:, None]
    col = torch.arange(tile)[None, :]
    lane = row % 32
    step = (col % 32 - lane) % 32
    group = (row // 32) // DG
    ngroups = -(-(tile // 32) // DG)
    return ((col // 32) * 32 + step) * ngroups + group


def emulate_whole(x, q, mol, a, mu, m, L, pd, cut_coulsq, qqrd2e,
                  damping_type=panel.DAMP_EXP, tile=None, skip=True):
    """dipole_whole_kernel in plain torch: (f, u_ef, u_dd, vir6).  With
    `skip` the pairs of a vote in which no pair takes a block on either
    side contribute an exact zero for that block without their gates
    being read (as the kernel's warp skips it); also returns the counts
    (votes, charge-dipole skips, dipole-dipole skips) as a 5th element."""
    n = x.shape[0]
    tile = tile or TILE[x.dtype]
    nT = -(-n // tile)

    def pad(t):
        out = t.new_zeros((nT * tile,) + t.shape[1:])
        out[:n] = t
        return out

    x, q, mol, a, mu, m = (pad(t) for t in (x, q, mol, a, mu, m))
    Linv = 1.0 / L
    sq = math.sqrt(qqrd2e)
    f_shift = -1.0 / cut_coulsq
    p3h = 0.5 * pd**3
    p4h = p3h * pd
    part = x.new_full((nT, nT + 1, tile, 3), math.nan)
    acc = x.new_zeros(8)
    loc = torch.arange(tile)
    votes = _votes(tile)
    nv = int(votes.max()) + 1
    counts = [0, 0, 0]
    for I, k in tile_pairs(n, tile):
        J = (I + k) % nT
        ri, cj = I * tile + loc, J * tile + loc
        d = x[ri][:, None, :] - x[cj][None, :, :]
        d = d - L * torch.round(d * Linv)
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        rsq = dx * dx + dy * dy + dz * dz
        ok = (loc[:, None] < loc[None, :]) if k == 0 else \
            torch.ones((tile, tile), dtype=torch.bool)
        mI, mJ = (m[ri] != 0)[:, None], (m[cj] != 0)[None, :]
        molI, molJ = mol[ri][:, None], mol[cj][None, :]
        cd = ok & (rsq < cut_coulsq) & ((molI != molJ) | (molI == 0))
        dd = ok & (a[ri] != 0)[:, None] & (a[cj] != 0)[None, :]
        cdi, cdj, ddi, ddj = cd & mJ, cd & mI, dd & mJ, dd & mI
        if skip:
            take_cd = torch.zeros(nv, dtype=torch.bool).index_put_(
                (votes[cdi | cdj],), torch.tensor(True))
            take_dd = torch.zeros(nv, dtype=torch.bool).index_put_(
                (votes[ddi | ddj],), torch.tensor(True))
            counts[0] += nv
            counts[1] += int((~take_cd).sum())
            counts[2] += int((~take_dd).sum())
            run_cd, run_dd = take_cd[votes], take_dd[votes]
        rinv = torch.rsqrt(rsq)
        r2inv = rinv * rinv
        r3inv = r2inv * rinv
        mi_, mj_ = mu[ri][:, None, :], mu[cj][None, :, :]
        qi, qj = q[ri][:, None], q[cj][None, :]
        pidotr = (mi_ * d).sum(-1)
        pjdotr = (mj_ * d).sum(-1)
        # charge-dipole: sqrt_q r^-3 [h (q_j mu_i - q_i mu_j) - e B d]
        wf = r2inv + f_shift
        hh = rsq * wf
        e = 3.0 * r2inv + f_shift
        gq = wf * rinv * sq
        A = qj[..., None] * mi_ - qi[..., None] * mj_
        eB = e * (qj * pidotr - qi * pjdotr)
        Fcd = (sq * r3inv)[..., None] * (hh[..., None] * A - eB[..., None] * d)
        uef = (torch.where(cdj, gq * qi * pjdotr, 0.0)
               - torch.where(cdi, gq * qj * pidotr, 0.0))
        # dipole-dipole, the t1 term of pre1 folded
        r5inv = r3inv * r2inv
        pdotp = (mi_ * mj_).sum(-1)
        pp = pidotr * pjdotr
        if damping_type == panel.DAMP_EXP:
            rr = rsq * rinv
            u = pd * rr
            t1 = torch.exp(-u)
            t2 = 1.0 + u + 0.5 * pd * pd * rsq
            t3 = t2 + (pd**3 / 6.0) * rsq * rr
            v1 = r3inv * (1.0 - t1 * t2) * pdotp
            v3 = r5inv * (1.0 - t1 * t3)
            pre1 = t1 * (p4h * pp * r3inv - p3h * pdotp * r2inv)
        else:
            v1, v3, pre1 = r3inv * pdotp, r5inv, torch.zeros_like(rsq)
        b3 = 3.0 * v3
        v3 = v3 * pp
        pre1 = pre1 + 3.0 * r2inv * (v1 - 5.0 * v3)
        udd = v1 - 3.0 * v3
        Fdd = (pre1[..., None] * d + (b3 * pjdotr)[..., None] * mi_
               + (b3 * pidotr)[..., None] * mj_)

        def gate(g, v):
            return torch.where(g[..., None] if v.dim() == 3 else g, v, 0.0)

        # side i's force, side j's negated, u_ef and u_dd terms
        cd_terms = [gate(cdi, Fcd), gate(cdj, Fcd), uef]
        dd_terms = [gate(ddi, Fdd), gate(ddj, Fdd),
                    gate(ddi, udd) + gate(ddj, udd)]
        if skip:   # a skipped vote's block gives zeros, gates unread
            cd_terms = [gate(run_cd, v) for v in cd_terms]
            dd_terms = [gate(run_dd, v) for v in dd_terms]
        fi = cd_terms[0] + dd_terms[0]
        gj = cd_terms[1] + dd_terms[1]
        pu = [cd_terms[2], dd_terms[2]]
        D = fi + gj
        part[I, k] = fi.sum(1)
        part[J, nT - k if k else nT] = -gj.sum(0)
        acc += torch.stack([
            pu[0].sum(), pu[1].sum(), (dx * D[..., 0]).sum(),
            (dy * D[..., 1]).sum(), (dz * D[..., 2]).sum(),
            (dx * D[..., 1]).sum(), (dx * D[..., 2]).sum(),
            (dy * D[..., 2]).sum()])
    assert not torch.isnan(part).any()           # every slot written
    f = torch.zeros_like(part[:, 0])
    for s in range(nT + 1):
        f += part[:, s]
    acc = torch.cat([acc[:1], 0.5 * acc[1:]])
    out = (f.reshape(-1, 3)[:n], acc[0], acc[1], acc[2:8])
    return (*out, counts) if skip else out


def _case(seed=7, n=300, npad=512, L=(20.0, 22.0, 24.0), n_masked=30):
    """Jittered-lattice atoms in spatial order, 3-atom molecules (ids from
    1, and 12 atoms in no molecule, mol 0), 20 alpha = 0 atoms, n_masked
    live atoms masked out with alpha and mu zeroed but their charge kept,
    and the rows past n padding (all zero, masked)."""
    rng = np.random.RandomState(seed)
    L = np.asarray(L)
    side = math.ceil(n ** (1 / 3))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    x = np.zeros((npad, 3))
    x[:n] = (g + 0.5) * (L / side) + rng.uniform(-0.4, 0.4, (n, 3))
    mask = np.zeros(npad)
    mask[:n] = 1.0
    mask[rng.choice(n, n_masked, replace=False)] = 0.0
    alpha = np.zeros(npad)
    alpha[:n] = rng.uniform(0.5, 2.0, n)
    alpha[rng.choice(n, 20, replace=False)] = 0.0
    alpha *= mask
    mu = np.zeros((npad, 3))
    mu[:n] = rng.normal(0, 1e-2, (n, 3))
    mu[alpha == 0.0] = 0.0
    q = np.zeros(npad)
    q[:n] = rng.normal(0, 0.5, n)
    mol = np.zeros(npad)
    mol[:n] = np.arange(n) // 3 + 1
    mol[rng.choice(n, 12, replace=False)] = 0.0
    return x, q, mol, alpha, mu, mask, L


def _torch(case, dtype):
    return tuple(torch.as_tensor(np.asarray(v), dtype=dtype) for v in case)


def _close(got, ref, rtol, atol, srel):
    """Per-row forces rtol, atol of max|ref|; the scalars (u_ef, u_dd, the
    virial rows: all energies) srel of the largest of them: u_dd is a
    small difference of large terms, whose sum moves by ~1e-14 with the
    alignment of the arrays that torch's vectorized sum meets."""
    f, *sc = got
    rf, *rsc = ref
    f, rf = np.asarray(f, np.float64), np.asarray(rf, np.float64)
    np.testing.assert_allclose(f, rf, rtol=rtol, atol=atol * np.abs(rf).max())
    scale = max(np.abs(np.asarray(r, np.float64)).max() for r in rsc)
    for g, r in zip(sc, rsc):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(r, np.float64), rtol=0,
                                   atol=srel * scale)


@pytest.mark.parametrize("tile", [128, 64, 32])
@pytest.mark.parametrize("damping", [panel.DAMP_EXP, panel.DAMP_NONE],
                         ids=["exp", "none"])
def test_emulation_matches_plain_f64(damping, tile):
    """512 rows: 4, 8 and 16 tiles, the last ones all padding."""
    args = _torch(_case(), torch.float64)
    kw = dict(damping_type=damping)
    got = emulate_whole(*args, PD, CUT_COULSQ, QQRD2E, tile=tile, **kw)
    ref = panel.dipole_panel_plain(*args, PD, CUT_COULSQ, QQRD2E, **kw)
    _close(got[:4], ref, 1e-12, 1e-12, 1e-12)


def test_masked_atom_receives_and_gives_none():
    """A masked atom with a charge (alpha, mu zero) next to an unmasked
    one: it receives charge-dipole force and the unmasked atom none, in
    the row form and the emulation alike."""
    x = torch.tensor([[1.0, 1.0, 1.0], [3.0, 1.5, 1.2]], dtype=torch.float64)
    q = torch.tensor([0.7, -0.4], dtype=torch.float64)
    mol = torch.tensor([1.0, 2.0], dtype=torch.float64)
    a = torch.tensor([0.0, 1.1], dtype=torch.float64)
    mu = torch.tensor([[0.0, 0.0, 0.0], [0.02, -0.01, 0.03]],
                      dtype=torch.float64)
    m = torch.tensor([0.0, 1.0], dtype=torch.float64)
    L = torch.full((3,), 20.0, dtype=torch.float64)
    ref = panel.dipole_panel_plain(x, q, mol, a, mu, m, L, PD, CUT_COULSQ,
                                   QQRD2E)
    got = emulate_whole(x, q, mol, a, mu, m, L, PD, CUT_COULSQ, QQRD2E,
                        tile=32)
    assert bool(ref[0][0].abs().max() > 0)
    assert bool((ref[0][1] == 0).all())
    _close(got[:4], ref, 1e-12, 1e-12, 1e-12)


@pytest.mark.parametrize("damping", [panel.DAMP_EXP, panel.DAMP_NONE],
                         ids=["exp", "none"])
def test_emulation_matches_jax_f32(damping):
    case = _case()
    args = _torch(case, torch.float32)
    got = emulate_whole(*args, PD, CUT_COULSQ, QQRD2E, damping_type=damping)
    ja = [jnp.asarray(np.asarray(v, np.float32)) for v in case]
    rf, ru_ef, ru_dd, rvir = pallas_panel.dipole_panel(
        *ja, PD, CUT_COULSQ, QQRD2E, damping_type=damping)
    f, u_ef, u_dd, vir = (np.asarray(v, np.float64) for v in got[:4])
    rf = np.asarray(rf, np.float64)
    np.testing.assert_allclose(f, rf, rtol=1e-4, atol=1e-5 * np.abs(rf).max())
    assert float(u_ef) == pytest.approx(float(ru_ef), rel=5e-6)
    assert float(u_dd) == pytest.approx(float(ru_dd), rel=1e-4)
    rvir = np.asarray(rvir, np.float64)
    np.testing.assert_allclose(vir, rvir, rtol=5e-6,
                               atol=5e-6 * np.abs(rvir[:3]).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("damping", [panel.DAMP_EXP, panel.DAMP_NONE],
                         ids=["exp", "none"])
def test_skip_is_exact(dtype, damping):
    """The votes that skip a block drop only exact zeros: the emulation
    with the skips equals the one without, by torch.equal.  The case is
    in spatial order, so most charge-dipole votes skip; the padding tiles
    skip the dipole-dipole block too."""
    args = _torch(_case(n=600, npad=1024, L=(26.0, 28.0, 30.0)), dtype)
    kw = dict(damping_type=damping, tile=TILE[dtype])
    *on, (votes, cd_skips, dd_skips) = emulate_whole(
        *args, PD, CUT_COULSQ, QQRD2E, **kw)
    off = emulate_whole(*args, PD, CUT_COULSQ, QQRD2E, skip=False, **kw)
    for a_, b_ in zip(on, off):
        assert torch.equal(a_, b_)
    assert cd_skips > votes // 2
    assert 0 < dd_skips < votes


def test_no_damping_skip_carries_over():
    """In float32 exp(-u) is exactly 0 only from u ~ 104 on, which only
    the corners of the 60 A fluid's box reach (pd*r up to 2.1304 * 52 =
    110.7).  At eind's skip threshold (EIND_SKIP_U, where l1 and l3 round
    to exactly 1) the t1 term of pre1 still changes pre1 where its other
    terms cancel (mu_i.mu_j = 5 (mu_i.d)(mu_j.d) / r^2): there a skip of
    the exponential would not give the same bits."""
    u = np.arange(100.0, 106.0, 0.01, dtype=np.float32)
    zero = np.exp(-u) == 0
    first = u[zero].min()
    assert 103.0 < first < 104.5 and zero[u >= first].all()
    assert first < PD * 30.0 * math.sqrt(3)
    f32 = np.float32
    r = f32(panel.EIND_SKIP_U[torch.float32] / PD)
    rinv = f32(1) / r
    r2inv = rinv * rinv
    r3inv = r2inv * rinv
    r5inv = r3inv * r2inv
    t1 = np.exp(-f32(PD) * r)
    c = f32(math.sqrt(0.2))         # cos^2 = 1/5: mu along x, d at c
    pidotr = pjdotr = r * c
    pdotp = f32(1)
    pp = pidotr * pjdotr
    v1, v3 = r3inv * pdotp, r5inv * pp               # l1 = l3 = 1
    base = f32(3) * r2inv * (v1 - f32(5) * v3)
    term = t1 * (f32(0.5 * PD**4) * pp * r3inv
                 - f32(0.5 * PD**3) * pdotp * r2inv)
    assert base + term != base


def test_bound_counts_the_pairs_that_act():
    """chip_smoke.dipole_bound_ms counts arithmetic only where the function
    needs it.  Held against dipole_panel_plain one column at a time (the
    force on every row from column j), on a case with padding and masked
    atoms that keep their charge: its active pairs are exactly the
    unordered pairs with a force on either atom, its charge-dipole pairs
    exactly those with one when alpha is zeroed (the dipole-dipole block
    off), and its geometry pairs exactly those with one when cut_coul
    takes in the whole box; no pair of a padding atom counts."""
    import chip_smoke

    n_live = 90
    c = chip_smoke.to_f64(chip_smoke.make_case(n_live, 128, 14.0, seed=3,
                                               n_masked=9, dev="cpu"))
    _, _, cnt = chip_smoke.dipole_bound_ms("dipole_panel_df", c, CUT_COULSQ,
                                           PD, panel.DAMP_EXP)

    def acting(alpha, cut_coulsq):
        ops = [c["x"], c["q"], c["mol"], alpha, c["mu"], c["mask"]]
        f = torch.stack([panel.dipole_panel_plain(
            *ops, c["L"], PD, cut_coulsq, QQRD2E,
            cols=tuple(t[j:j + 1] for t in ops), row0=-j)[0]
            for j in range(ops[0].shape[0])], 1)       # on row i from j
        nz = (f != 0).any(-1)
        return int(torch.triu(nz | nz.T, 1).sum())

    assert cnt["active_pairs"] == acting(c["alpha"], CUT_COULSQ)
    assert cnt["cd_pairs"] == acting(torch.zeros_like(c["alpha"]),
                                     CUT_COULSQ)
    assert cnt["geometry_pairs"] == acting(c["alpha"], 1e6)
    assert cnt["active_pairs"] < cnt["geometry_pairs"] \
        < n_live * (n_live - 1) // 2
    assert 0 < cnt["both_pairs"] < cnt["cd_pairs"]


# ----------------------- pairs at the coulomb cutoff ------------------------

def _cutoff_case(dtype, polar, movable):
    """chip_smoke.dipole_cutoff_case (pairs at exactly cut_coulsq and one
    ulp inside it, in four molecules, with dipoles), or with movable=False
    the same layout with partners whose contracted rsq rounds to the same
    value (how XLA forms rsq on the CPU cannot move them)."""
    import chip_smoke

    c = chip_smoke.dipole_cutoff_case(dtype, "cpu", polar)
    if movable:
        return c
    npt = np.float32 if dtype == torch.float32 else np.float64
    x = c["x"].numpy().copy()
    C = npt(chip_smoke.CUTOFF_SQ)
    for k, target in enumerate((C, np.nextafter(C, npt(0)))):
        x[2 * k + 1] = chip_smoke._cutoff_partner(
            npt, x[2 * k], target, lambda f, t=target: f == t, seed=10 + k)
    return dict(c, x=torch.as_tensor(x))


# rows with a force with one polar atom (no dipole-dipole pair): by rsq
# rounded term by term (the plain version, the CUDA kernels) and by a
# contracted rsq on the movable case (XLA on the CPU)
_ROUNDED = np.array([False, False, True, True, False, False])
_CONTRACTED = np.array([True, True, False, False, False, False])


def _cutoff_args(c, conv):
    return tuple(conv(c[k]) for k in ("x", "q", "mol", "alpha", "mu",
                                      "mask", "L")) + (PD, CUT_COULSQ,
                                                       QQRD2E)


@pytest.mark.parametrize("polar", ["one", "both"])
def test_cutoff_pairs_decided_as_pallas(polar):
    """float32: the plain version, whole and strip form (cols = all atoms,
    row0 = 0), against JAX's Pallas dipole_panel (interpret mode) on pairs
    at exactly cut_coulsq and one ulp inside it.  Where contraction cannot
    move them, both put the charge-dipole force on rows 2 and 3 only (one
    polar atom) and agree at the float32 bars; on chip_smoke's
    dipole_cutoff_case the plain version decides by rsq rounded term by
    term, as the CUDA kernels do, and the Pallas kernel as the contracted
    form (rows 0 and 1): XLA on the CPU contracts rsq."""
    for movable, jax_rows in ((False, _ROUNDED), (True, _CONTRACTED)):
        c = _cutoff_case(torch.float32, polar, movable)
        args = _cutoff_args(c, lambda a: torch.as_tensor(
            np.asarray(a), dtype=torch.float32))
        jargs = _cutoff_args(c, lambda a: jnp.asarray(np.asarray(a,
                                                                 np.float32)))
        whole = panel.dipole_panel_plain(*args)
        strip = panel.dipole_panel_plain(*args, cols=args[:6], row0=0)
        ref = pallas_panel.dipole_panel(*jargs)
        ref_strip = pallas_panel.dipole_panel(*jargs, cols=jargs[:6], row0=0)
        for a, b in zip(whole, strip):
            assert torch.equal(a, b)
        got_rows = (whole[0] != 0).any(1).numpy()
        jrows = (np.asarray(ref[0]) != 0).any(1)
        np.testing.assert_array_equal(
            (np.asarray(ref_strip[0]) != 0).any(1), jrows)
        if polar == "one":
            np.testing.assert_array_equal(got_rows, _ROUNDED)
            np.testing.assert_array_equal(jrows, jax_rows)
        if not movable:
            f, rf = whole[0].double().numpy(), np.asarray(ref[0], np.float64)
            np.testing.assert_allclose(f, rf, rtol=1e-4,
                                       atol=1e-5 * np.abs(rf).max())
            assert float(whole[2]) == pytest.approx(float(ref[2]), rel=1e-4,
                                                    abs=1e-12)
        else:
            # the contracted decision moves the force by more than the bar
            rf = np.asarray(ref[0], np.float64)
            assert np.abs(whole[0].double().numpy() - rf).max() \
                > 1e-3 * np.abs(rf).max()


def _jax_scan_dipole(c):
    """The JAX scan path's dipole phase (build_sharded_polar_step(
    panel="scan").host_phases(strips=2), float64) on case c: (fpol of its
    six rows, epol = u_self + u_ef + u_dd)."""
    from lidp_tpu.forcefield import ForceField
    from lidp_tpu.ops import polarization as jpol
    from lidp_tpu.ops.pair import make_pair_params
    from lidp_tpu.parallel import shard

    eps, sig, cut = np.zeros((3, 3)), np.zeros((3, 3)), np.zeros((3, 3))
    eps[1:, 1:] = [[0.1, 0.05], [0.05, 0.03]]
    sig[1:, 1:] = [[3.0, 2.7], [2.7, 2.5]]
    cut[1:, 1:] = 6.0
    pair = make_pair_params(eps, sig, cut, cut_coul=6.5, coul=True,
                            qqrd2e=QQRD2E, g_ewald=0.29, dtype=jnp.float64)
    s = jpol.PolarizationSettings(damping_type=jpol.DAMPING_EXPONENTIAL,
                                  polar_damp=PD)
    ff = ForceField(pair=pair, ewald=None, polar=s, qqrd2e=QQRD2E)
    make, bind_box, npad, _ = shard.build_sharded_polar_step(
        None, ff, s, n=4, dt=1.0, ftm2v=1.0, dtype=jnp.float64,
        panel="scan")
    bind_box(np.full(3, 60.0))
    ph = make.host_phases(strips=2)

    def padded(k, dt=np.float64):
        a = np.asarray(c[k])
        out = np.zeros((npad,) + a.shape[1:], dt)
        out[:6] = a
        return jnp.asarray(out)

    fpol, epol, _ = ph["dipole"](0, padded("x"), padded("q"),
                                 padded("mol", np.int32), padded("alpha"),
                                 padded("mu"), padded("mask", bool))
    return np.asarray(fpol)[:6], float(epol)


@pytest.mark.parametrize("polar", ["one", "both"])
def test_cutoff_pairs_decided_as_jax_f64(polar):
    """float64: the plain version (dipole_panel_df's, whole and strip form)
    against the JAX scan path's dipole phase, on the pairs that
    contraction cannot move and on dipole_cutoff_case itself: the same
    rows take a force (rows 2 and 3 with one polar atom), the forces agree
    to 1e-12 of their largest and u_self + u_ef + u_dd to 1e-12.  Unlike
    the float32 Pallas kernel (and the scan path's pair phase in float64),
    XLA's float64 dipole phase on the CPU decides dipole_cutoff_case's
    pairs by rsq rounded term by term."""
    for movable in (False, True):
        c = _cutoff_case(torch.float64, polar, movable)
        args = _cutoff_args(c, lambda a: torch.as_tensor(
            np.asarray(a), dtype=torch.float64))
        whole = panel.dipole_panel_df_plain(*args)
        strip = panel.dipole_panel_df_plain(*args, cols=args[:6], row0=0)
        for a, b in zip(whole, strip):
            assert torch.equal(a, b)
        fj, epj = _jax_scan_dipole(c)
        if polar == "one":
            np.testing.assert_array_equal((whole[0] != 0).any(1).numpy(),
                                          _ROUNDED)
            np.testing.assert_array_equal((fj != 0).any(1), _ROUNDED)
        np.testing.assert_allclose(whole[0].numpy(), fj, rtol=0,
                                   atol=1e-12 * np.abs(fj).max())
        a, mu = c["alpha"].numpy(), c["mu"].numpy()
        u_self = 0.5 * float(np.sum(np.where(
            a != 0, (mu * mu).sum(1) / np.where(a != 0, a, 1.0), 0.0)))
        assert u_self + float(whole[1]) + float(whole[2]) \
            == pytest.approx(epj, rel=1e-12)
