"""The whole-panel pair kernel's algorithm on the CPU (csrc/pair_panel.cuh
runs only on the GPU; tests/test_torch_cuda_kernels.py holds it there),
in its four forms: coulomb and the Wolf field, coulomb, LJ only, and the
field alone (FORCE false: wolf_panel's whole panel, held against
wolf_panel_plain and JAX's Pallas wolf_panel).

  * a plain-torch emulation of pair_whole_kernel: per block's tile pair
    (the closed form of panel_common.cuh tile_pair) each unordered pair
    once, in the kernel's expressions (one LJ and coulomb force F for
    +F d on i and -F d on j, one Wolf factor w for w q_j d on i and
    -w q_i d on j), each side gated on its own (side i by mask_j and i
    being an atom, side j by mask_i), the special exclusion from each
    side's own list, the row and column sums in the kernel's slots (force
    and field), the slot-order sum, evdwl, ecoul and the virial over both
    sides of each pair at half weight; it equals the plain row form
    (pair_wolf_panel_plain, pair_panel_plain with and without coulomb) in
    float64 to rtol 1e-12, atol 1e-12*max|ref| (scalars 1e-12 of the
    largest scalar output), with padding at the origin, masked atoms that
    keep their charge, mol 0 atoms, two types, coordinates outside the box
    and special lists of which some name a partner that does not name
    them back, at three tile sizes; and JAX's Pallas pair_wolf_panel,
    pair_panel and pair_panel_df (interpret mode on the CPU) in float32 to
    tests/test_torch_panel_kernels.py's bars (per-row rtol 1e-4, atol
    1e-5*max|ref|; evdwl and ecoul rel 5e-6; virial rtol 5e-6 and atol
    5e-6 of the largest diagonal entry);
  * the kernel's exact skips, emulated vote by vote (a warp's 32 lanes x
    PG rows against one column each step) and tile pair by tile pair (the
    coordinate boxes of tile_box_kernel and the test of far_tiles, as
    chip_smoke.far_tile_pairs counts them; a dropped tile pair writes no
    slot and the slot sum leaves it out, by slot_block, the schedule's
    inverse): the votes and tile pairs skipped
    give exactly zero, so the emulation with the skips equals the one
    without by torch.equal, and on the spatially ordered case most votes
    skip and tile pairs are dropped;
  * a padding atom near the origin receives its nonzero Wolf field row,
    and a masked atom receives LJ and coulomb force and gives none (and
    so in the field alone);
  * a pair at exactly rsq == cut_coulsq is inside the field's inclusive
    cutoff for the plain row form, the tile-pair test and the warp vote
    alike;
  * the strip form (cols=, row0) at the outer cutoff: pairs at exactly
    rsq == cutsq and one ulp inside it are decided by the plain version as
    by JAX's Pallas pair_wolf_panel and pair_panel (interpret mode,
    float32) and the JAX scan path's strip phases (float64): the same rows
    take a force and the field, exactly zero elsewhere, at
    tests/test_torch_panel_kernels.py's bars (1e-12 in float64).  On
    chip_smoke.cutoff_pairs_case, whose pairs a rsq contracted into fused
    multiply-adds puts on the other side (held here with exact
    arithmetic), the plain version decides by rsq rounded term by term,
    as the CUDA kernels do (tests/test_torch_cuda_kernels.py holds the
    strip and whole kernels to it), and JAX on the CPU by the contracted
    form: XLA contracts rsq in both dtypes;
  * the wrapper refuses type tables that are not symmetric;
  * the least arithmetic that chip_smoke.py's bound counts: the pairs it
    charges for are those on which the plain row form puts a term.
"""

import math

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin
# on the cores the other workers use (this file and nine like it took
# over 4x as long under -n 6 without the pin; the CPU-thread fault it
# once guarded is repaired, ROADMAP queue 3 item 1)
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu.ops import pallas_panel  # noqa: E402
from lidp_tpu_torch.ops import panel  # noqa: E402
from lidp_tpu_torch.ops.pair import EWALD_F, erfc_as  # noqa: E402

QQRD2E = 332.06371
G_EWALD = 0.29
CUT_COULSQ = 6.5**2
# atoms per tile and rows per warp vote of the kernel, by dtype
# (csrc/pair_panel.cuh PairTile); the emulation holds at any tile of whole
# vote groups
TILE = {torch.float32: 128, torch.float64: 64}
PG = {torch.float32: 2, torch.float64: 1}
# form -> (coul, wolf, force): the field alone ("wolf") has no LJ or
# coulomb block (csrc/pair_panel.cuh FORCE false, the field's tile and
# vote rows as float32's)
FORMS = {"coul_wolf": (True, True, True), "coul": (True, False, True),
         "lj": (False, False, True), "wolf": (False, True, False)}


def tile_pairs(npad, tile):
    """(I, k) of each block of the whole-panel kernels (panel_common.cuh
    tile_pair), in block order: tile I against J = I + k mod nT."""
    nT = -(-npad // tile)
    nK = nT * ((nT - 1) // 2 + 1)
    return [(b % nT, b // nT) if b < nK else (b - nK, nT // 2)
            for b in range(nT * (nT + 1) // 2)]


def slot_block(t, slot, nT):
    """panel_common.cuh slot_block: the block whose CTA writes slot `slot`
    of tile t."""
    if slot == nT:
        return t
    row = 2 * slot < nT or (2 * slot == nT and t < nT // 2)
    k = slot if row else nT - slot
    i = t if row else (t - k) % nT
    K = (nT - 1) // 2 + 1
    return k * nT + i if k < K else nT * K + i


def _votes(tile, pg):
    """(tile, tile) int: the vote of each pair (row, column) of one tile
    pair within its CTA: warp w = column // 32, step t = (column - lane) mod
    32 with lane = row % 32, group (row // 32) // pg."""
    row = torch.arange(tile)[:, None]
    col = torch.arange(tile)[None, :]
    lane = row % 32
    step = (col % 32 - lane) % 32
    group = (row // 32) // pg
    ngroups = -(-(tile // 32) // pg)
    return ((col // 32) * 32 + step) * ngroups + group


def emulate_whole(x, q, typef, mol, maskf, tabs, L, cut_coulsq, qqrd2e,
                  g_ewald, sp=None, *, coul=True, wolf=True, tile=None,
                  skip=True, cull=True, force=True):
    """pair_whole_kernel in plain torch: ((f, evdwl, ecoul, vir6, e0 or
    None), counts), or with force=False (the field alone: typef, tabs,
    qqrd2e, g_ewald and sp unread, the outer radius cut_coulsq inclusive,
    r^-2 = rinv * rinv) (e0, counts).  With `skip` the pairs of a vote in
    which no pair lies inside the outer radius on an open side contribute
    an exact zero without their terms being read, and with `cull` the tile
    pairs far_tiles drops write no slot, which the slot sum leaves out;
    counts = [votes, votes skipped, tile pairs dropped, tile pairs]."""
    n = x.shape[0]
    tile = tile or TILE[x.dtype]
    pg = PG[x.dtype] if tile % (32 * PG[x.dtype]) == 0 else 1
    nT = -(-n // tile)
    N = nT * tile

    def pad(t, fill=0):
        out = t.new_full((N,) + t.shape[1:], fill)
        out[:n] = t
        return out

    atom = torch.arange(N) < n
    xp, qp, mp = pad(x), pad(q), pad(maskf)
    tp = pad(typef).long() if force else None
    molp = pad(mol) if wolf else torch.zeros_like(qp)
    spp = pad(sp.long(), -1) if sp is not None and force else None
    Linv = 1.0 / L
    cutsq_u = float(tabs[4].max()) if force else 0.0
    f_shift = -1.0 / cut_coulsq
    rc = math.sqrt(max(cutsq_u, cut_coulsq if wolf else 0.0))
    far = chip_smoke.far_tile_pairs(x, maskf, L, tile, rc)
    nc = 3 * force + 3 * wolf
    part = x.new_full((nT, nT + 1, tile, nc), math.nan)
    acc = x.new_zeros(8)
    loc = torch.arange(tile)
    votes = _votes(tile, pg)
    nv = int(votes.max()) + 1
    pairs = tile_pairs(n, tile)
    counts = [0, 0, 0, len(pairs)]
    kept = [True] * len(pairs)
    for b, (I, k) in enumerate(pairs):
        J = (I + k) % nT
        cslot = nT - k if k else nT
        if cull and bool(far[I, J]):
            kept[b] = False
            counts[2] += 1
            continue
        ri, cj = I * tile + loc, J * tile + loc
        d = xp[ri][:, None, :] - xp[cj][None, :, :]
        d = d - L * torch.round(d * Linv)
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        rsq = dx * dx + dy * dy + dz * dz
        ok = (loc[:, None] < loc[None, :]) if k == 0 else \
            torch.ones((tile, tile), dtype=torch.bool)
        mI, mJ = (mp[ri] != 0)[:, None], (mp[cj] != 0)[None, :]
        oi = ok & mJ & atom[ri][:, None]
        oj = ok & mI & atom[cj][None, :]
        near = rsq < cutsq_u
        if wolf:
            near = near | (rsq <= cut_coulsq)
        if skip:
            take = torch.zeros(nv, dtype=torch.bool).index_put_(
                (votes[(oi | oj) & near],), torch.tensor(True))
            counts[0] += nv
            counts[1] += int((~take).sum())
            run = take[votes]
        rinv = torch.rsqrt(rsq)
        qI, qJ = qp[ri][:, None], qp[cj][None, :]
        rows, cols, sc = [], [], []
        if force:
            rows, cols, sc = _force_terms(
                d, rsq, rinv, oi, oj, tp[ri][:, None], tp[cj][None, :],
                tabs, cutsq_u, spp, ri, cj, qI, qJ, coul, cut_coulsq,
                qqrd2e, g_ewald)
        r2inv = 1.0 / rsq if force else rinv * rinv
        if wolf:
            molI, molJ = molp[ri][:, None], molp[cj][None, :]
            wl = (rsq <= cut_coulsq) & ((molI != molJ) | (molI == 0))
            wv = (r2inv + f_shift) * rinv
            efi = torch.where(wl & oi, wv, 0.0) * qJ
            efj = torch.where(wl & oj, wv, 0.0) * qI
            rows.append(efi[..., None] * d)
            cols.append(efj[..., None] * d)
        rows, cols = torch.cat(rows, -1), torch.cat(cols, -1)
        if skip:   # a skipped vote gives zeros, its terms unread
            rows = torch.where(run[..., None], rows, 0.0)
            cols = torch.where(run[..., None], cols, 0.0)
            sc = [torch.where(run, v, 0.0) for v in sc]
        part[I, k] = rows.sum(1)
        part[J, cslot] = -cols.sum(0)
        if force:
            acc += torch.stack([v.sum() for v in sc])
    out = torch.zeros_like(part[:, 0])
    for s in range(nT + 1):          # in slot order, the dropped left out
        for t in range(nT):
            if kept[slot_block(t, s, nT)]:
                out[t] += part[t, s]
    assert not torch.isnan(out).any()          # every kept slot written
    out = out.reshape(-1, nc)[:n]
    if not force:
        return out, counts
    acc = 0.5 * acc
    return ((out[:, :3], acc[0], acc[1], acc[2:8],
             out[:, 3:] if wolf else None), counts)


def _force_terms(d, rsq, rinv, oi, oj, ti, tj, tabs, cutsq_u, spp, ri, cj,
                 qI, qJ, coul, cut_coulsq, qqrd2e, g_ewald):
    """The LJ and coulomb blocks of one tile pair: ([row force], [column
    force], [the 8 scalars' terms])."""
    lj3, lj4, off = tabs[0][ti, tj], tabs[1][ti, tj], tabs[2][ti, tj]
    inr = rsq < cutsq_u
    lj = inr & (rsq < tabs[3][ti, tj])
    lji, ljj = lj & oi, lj & oj
    if spp is not None:   # each side's own list
        lji = lji & ~(spp[ri][:, None, :] == cj[None, :, None]).any(-1)
        ljj = ljj & ~(spp[cj][None, :, :] == ri[:, None, None]).any(-1)
    r2inv = 1.0 / rsq
    r6inv = r2inv * r2inv * r2inv
    forcelj = r6inv * (12.0 * lj3 * r6inv - 6.0 * lj4)
    evdwl = r6inv * (lj3 * r6inv - lj4) - off
    fpi = torch.where(lji, forcelj, 0.0)
    fpj = torch.where(ljj, forcelj, 0.0)
    ci = cjj = torch.zeros_like(oi)
    ecs = torch.zeros_like(rsq)
    if coul:
        cm = inr & (rsq < cut_coulsq)
        ci, cjj = cm & oi, cm & oj
        rr = rsq * rinv
        grij = g_ewald * rr
        expm2 = torch.exp(-grij * grij)
        erfc = erfc_as(grij, expm2)
        prefactor = qqrd2e * qI * qJ * rinv
        fc = prefactor * (erfc + EWALD_F * grij * expm2)
        ec = prefactor * erfc
        fpi = torch.where(ci, fc, 0.0) + fpi
        fpj = torch.where(cjj, fc, 0.0) + fpj
        ecs = torch.where(ci, ec, 0.0) + torch.where(cjj, ec, 0.0)
    # selected after the product: r2inv is not finite at rsq = 0
    fpi = torch.where(ci | lji, fpi * r2inv, 0.0)
    fpj = torch.where(cjj | ljj, fpj * r2inv, 0.0)
    evs = torch.where(lji, evdwl, 0.0) + torch.where(ljj, evdwl, 0.0)
    rows, cols = fpi[..., None] * d, fpj[..., None] * d
    D = rows + cols
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    sc = [evs, ecs, dx * D[..., 0], dy * D[..., 1], dz * D[..., 2],
          dx * D[..., 1], dx * D[..., 2], dy * D[..., 2]]
    return [rows], [cols], sc


def _tabs():
    """(5, 3, 3) [lj3 lj4 offset cut_ljsq cutsq] of the synthetic fluid's
    LJ tables (types 1, 2; row and column 0 unused), with an energy shift,
    uniform outer cutoff; symmetric."""
    eps = np.zeros((3, 3))
    sig = np.zeros((3, 3))
    cut = np.zeros((3, 3))
    eps[1:, 1:] = [[0.1, 0.05], [0.05, 0.03]]
    sig[1:, 1:] = [[3.0, 2.7], [2.7, 2.5]]
    cut[1:, 1:] = 6.0
    s6 = sig**6
    lj3, lj4 = 4 * eps * s6 * s6, 4 * eps * s6
    off = np.zeros((3, 3))
    off[1:, 1:] = lj3[1:, 1:] / 6.0**12 - lj4[1:, 1:] / 6.0**6
    return np.stack([lj3, lj4, off, cut**2, np.maximum(cut, 6.5)**2])


def _case(seed=7, n=300, npad=512, L=(20.0, 22.0, 24.0), n_masked=30):
    """Jittered-lattice atoms in spatial order (consecutive atoms along z),
    types 1 and 2, 3-atom molecules (ids from 1, and 12 atoms in no
    molecule, mol 0), n_masked live atoms masked out with their charge
    kept, 10 atoms moved by a box length out of the box, the rows past n
    padding at the origin (masked, type 0, no charge), and special lists
    (4 slots, unused ones n): each atom's molecule partners, and for 20
    atoms the next atom in order, which does not list it back."""
    rng = np.random.RandomState(seed)
    L = np.asarray(L)
    side = math.ceil(n ** (1 / 3))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    x = np.zeros((npad, 3))
    x[:n] = (g + 0.5) * (L / side) + rng.uniform(-0.4, 0.4, (n, 3))
    out = rng.choice(n, 10, replace=False)
    x[out] += L * rng.choice([-1.0, 1.0], (10, 3))
    mask = np.zeros(npad)
    mask[:n] = 1.0
    mask[rng.choice(n, n_masked, replace=False)] = 0.0
    q = np.zeros(npad)
    q[:n] = rng.normal(0, 0.5, n)
    typ = np.zeros(npad)
    typ[:n] = rng.randint(1, 3, n)
    mol = np.zeros(npad)
    mol[:n] = np.arange(n) // 3 + 1
    mol[rng.choice(n, 12, replace=False)] = 0.0
    i = np.arange(npad)
    base, k = 3 * (i // 3), i % 3
    sp = np.full((npad, 4), n, np.int32)
    sp[:, 0], sp[:, 1] = base + (k + 1) % 3, base + (k + 2) % 3
    one = rng.choice(n - 1, 20, replace=False)
    sp[one, 2] = one + 1
    sp[(sp >= n) | (i[:, None] >= n)] = n
    return dict(x=x, q=q, type=typ, mol=mol, mask=mask, tabs=_tabs(), L=L,
                sp=sp, n=n)


def _args(c, dtype, form, conv=None):
    """The plain row form's arguments of `form` on case c, in torch tensors
    of `dtype` (or through `conv`)."""
    t = conv or (lambda a: torch.as_tensor(np.asarray(a), dtype=dtype))
    if form == "wolf":
        return (t(c["x"]), t(c["q"]), t(c["mol"]), t(c["mask"]), t(c["L"]),
                CUT_COULSQ)
    head = (t(c["x"]), t(c["q"]), t(c["type"]))
    tail = (t(c["mask"]), t(c["tabs"]), t(c["L"]), CUT_COULSQ, QQRD2E,
            G_EWALD)
    return head + ((t(c["mol"]),) if FORMS[form][1] else ()) + tail


def _plain(args, sp, form):
    coul, wolf, force = FORMS[form]
    if not force:
        return panel.wolf_panel_plain(*args)
    if wolf:
        return panel.pair_wolf_panel_plain(*args, sp=sp)
    return panel.pair_panel_plain(*args, sp=sp, coul=coul)


def _emulate(args, sp, form, **kw):
    coul, wolf, force = FORMS[form]
    if not force:
        x, q, mol, m, L, cut = args
        return emulate_whole(x, q, None, mol, m, None, L, cut, None, None,
                             wolf=True, force=False, **kw)
    if wolf:
        return emulate_whole(*args, sp=sp, coul=coul, wolf=True, **kw)
    x, q, typ, *rest = args
    return emulate_whole(x, q, typ, None, *rest, sp=sp, coul=coul,
                         wolf=False, **kw)


def _outputs(v):
    """A form's outputs as a tuple (the field alone returns one tensor)."""
    return v if isinstance(v, tuple) else (v,)


def _close(got, ref, rtol, atol, srel):
    """Per-row outputs rtol, atol of max|ref|; the scalars (evdwl, ecoul,
    the virial: all energies) srel of the largest of them.  The field
    alone has per-row outputs only."""
    if not isinstance(ref, tuple):
        g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        np.testing.assert_allclose(g, r, rtol=rtol,
                                   atol=atol * np.abs(r).max())
        return
    f, ev, ec, vir, *e0 = got
    rf, rev, rec, rvir, *re0 = ref
    for g, r in [(f, rf)] + list(zip(e0, re0)):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        np.testing.assert_allclose(g, r, rtol=rtol,
                                   atol=atol * np.abs(r).max())
    scale = max(float(np.abs(np.asarray(v, np.float64)).max())
                for v in (rev, rec, rvir))
    for g, r in ((ev, rev), (ec, rec), (vir, rvir)):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(r, np.float64), rtol=0,
                                   atol=srel * scale)


@pytest.mark.parametrize("nT", [1, 2, 3, 4, 7, 8, 96, 97])
def test_slot_block_inverts_the_schedule(nT):
    """Each slot of each tile is written by one block, and slot_block
    names it: row sums of (I, k) to slot k of I, column sums to slot
    nT - k of J (nT for the diagonal)."""
    writer = {}
    for b, (I, k) in enumerate(tile_pairs(nT, 1)):
        J = (I + k) % nT
        for key in ((I, k), (J, nT - k if k else nT)):
            assert key not in writer
            writer[key] = b
    assert len(writer) == nT * (nT + 1)
    for (t, s), b in writer.items():
        assert slot_block(t, s, nT) == b


@pytest.mark.parametrize("tile", [128, 64, 32])
@pytest.mark.parametrize("form", list(FORMS))
def test_emulation_matches_plain_f64(form, tile):
    """512 rows: 4, 8 and 16 tiles, the last ones all padding."""
    _, wolf, force = FORMS[form]
    c = _case()
    args = _args(c, torch.float64, form)
    sp = torch.as_tensor(c["sp"])
    got, _ = _emulate(args, sp, form, tile=tile)
    ref = _plain(args, sp, form)
    if force and not wolf:
        got = got[:4]
    _close(got, ref, 1e-12, 1e-12, 1e-12)


def test_padding_atom_near_the_origin_receives_the_field():
    """The padding rows sit at the origin; live atoms lie within 6.5 A of
    it, so both the row form and the emulation give those rows a nonzero
    field (and no force: they have no charge and type 0)."""
    c = _case()
    args = _args(c, torch.float64, "coul_wolf")
    sp = torch.as_tensor(c["sp"])
    n = c["n"]
    got, _ = _emulate(args, sp, "coul_wolf", tile=64)
    ref = _plain(args, sp, "coul_wolf")
    assert bool((ref[4][n:].abs().sum(1) > 0).all())
    assert not ref[0][n:].any()
    _close(got, ref, 1e-12, 1e-12, 1e-12)


def test_masked_atom_receives_and_gives_none():
    """A masked atom with a charge next to an unmasked one: it receives LJ
    and coulomb force and field, the unmasked atom none, in the row form
    and the emulation alike."""
    f64 = torch.float64
    x = torch.tensor([[1.0, 1.0, 1.0], [4.0, 1.5, 1.2]], dtype=f64)
    q = torch.tensor([0.7, -0.4], dtype=f64)
    typ = torch.tensor([1.0, 2.0], dtype=f64)
    mol = torch.tensor([1.0, 2.0], dtype=f64)
    m = torch.tensor([0.0, 1.0], dtype=f64)
    tabs = torch.as_tensor(_tabs(), dtype=f64)
    L = torch.full((3,), 20.0, dtype=f64)
    args = (x, q, typ, mol, m, tabs, L, CUT_COULSQ, QQRD2E, G_EWALD)
    ref = panel.pair_wolf_panel_plain(*args)
    got, _ = emulate_whole(*args, tile=32)
    assert bool(ref[0][0].abs().max() > 0) and bool(ref[4][0].abs().max() > 0)
    assert bool((ref[0][1] == 0).all()) and bool((ref[4][1] == 0).all())
    _close(got, ref, 1e-12, 1e-12, 1e-12)


def test_field_alone_padding_receives_and_masked_gives_none():
    """The field alone (wolf_panel's whole panel): the padding rows at the
    origin receive their nonzero field from the live atoms within 6.5 A,
    and a masked atom with a charge receives the field of an unmasked one
    and gives it none, in the row form and the emulation alike."""
    c = _case()
    args = _args(c, torch.float64, "wolf")
    got, _ = _emulate(args, None, "wolf", tile=64)
    ref = _plain(args, None, "wolf")
    assert bool((ref[c["n"]:].abs().sum(1) > 0).all())
    _close(got, ref, 1e-12, 1e-12, 1e-12)
    f64 = torch.float64
    pair = (torch.tensor([[1.0, 1.0, 1.0], [4.0, 1.5, 1.2]], dtype=f64),
            torch.tensor([0.7, -0.4], dtype=f64),
            torch.tensor([1.0, 2.0], dtype=f64),
            torch.tensor([0.0, 1.0], dtype=f64),
            torch.full((3,), 20.0, dtype=f64), CUT_COULSQ)
    ref = panel.wolf_panel_plain(*pair)
    got, _ = _emulate(pair, None, "wolf", tile=32)
    assert bool(ref[0].abs().max() > 0) and bool((ref[1] == 0).all())
    _close(got, ref, 1e-12, 1e-12, 1e-12)


def _cutoff_case(dtype):
    """Two live atoms exactly 6.5 A apart along x (rsq == 42.25, exact in
    either dtype), atom 0 in tile 0 and atom 32 in tile 1 of 32; the other
    atoms masked, on the same line, no nearer than 7 A to the other tile's
    live atom: tile 0's box ends at x = 1, tile 1's starts at 7.5."""
    x = np.ones((64, 3))
    x[0, 0], x[32, 0] = 1.0, 7.5
    x[1:32, 0] = np.linspace(-4.0, 0.5, 31)
    x[33:, 0] = np.linspace(8.0, 12.5, 31)
    mask = np.zeros(64)
    mask[[0, 32]] = 1.0
    q = np.random.RandomState(11).normal(0, 0.5, 64)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa
    return dict(x=t(x), q=t(q), mol=t(np.arange(1.0, 65.0)), mask=t(mask),
                L=t(np.full(3, 40.0)), type=t(np.ones(64)),
                sp=torch.zeros((64, 1), dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_at_the_cutoff_is_included(dtype):
    """The field's cutoff is inclusive (rsq <= cut_coulsq): a pair at
    exactly rsq == cut_coulsq counts as a field pair in the row form's
    arithmetic (wolf_bound_ms forms rsq as the plain version does), its
    tile pair, whose boxes' gap is exactly the cutoff, is kept, and the
    one warp vote that holds it runs; with the cutoff one ulp lower the
    same tile pair is kept but that vote skips and the pair is no field
    pair.  The emulation equals the row form at both."""
    c = _cutoff_case(dtype)
    args = (c["x"], c["q"], c["mol"], c["mask"], c["L"])
    below = float(np.nextafter(np.asarray(CUT_COULSQ, dtype=str(dtype)[6:]),
                               0))
    assert below < CUT_COULSQ
    at_cut = {}
    for cut in (CUT_COULSQ, below):
        got, counts = _emulate((*args, cut), None, "wolf", tile=32)
        _close(got, panel.wolf_panel_plain(*args, cut), 1e-12, 1e-12, 1e-12)
        _, _, cnt = chip_smoke.wolf_bound_ms("wolf_panel", c, cut, tile=32)
        at_cut[cut] = counts, cnt
    (votes, skipped, dropped, npairs), cnt = at_cut[CUT_COULSQ]
    (votes_b, skipped_b, dropped_b, _), cnt_b = at_cut[below]
    assert (dropped, dropped_b, npairs) == (0, 0, 3)
    assert votes == votes_b and skipped_b == skipped + 1
    assert cnt["wolf_pairs"] == cnt_b["wolf_pairs"] + 1
    assert cnt["kept_tile_pairs"] == cnt_b["kept_tile_pairs"] == 3


def test_special_list_is_each_sides_own():
    """Atom 0 lists atom 1 and atom 1 does not list atom 0: LJ acts on 1
    from 0 and not on 0 from 1, in the row form and the emulation."""
    f64 = torch.float64
    x = torch.tensor([[1.0, 1.0, 1.0], [4.2, 1.5, 1.2]], dtype=f64)
    q = torch.zeros(2, dtype=f64)
    typ = torch.tensor([1.0, 1.0], dtype=f64)
    m = torch.ones(2, dtype=f64)
    tabs = torch.as_tensor(_tabs(), dtype=f64)
    L = torch.full((3,), 20.0, dtype=f64)
    sp = torch.tensor([[1], [2]], dtype=torch.int32)
    args = (x, q, typ, m, tabs, L, CUT_COULSQ, QQRD2E, G_EWALD)
    ref = panel.pair_panel_plain(*args, sp=sp)
    got, _ = emulate_whole(x, q, typ, None, *args[3:], sp=sp, wolf=False,
                           tile=32)
    assert bool((ref[0][0] == 0).all()) and bool(ref[0][1].abs().max() > 0)
    _close(got[:4], ref, 1e-12, 1e-12, 1e-12)


def _close_f32(got, ref):
    """tests/test_torch_panel_kernels.py's bars (the field alone: its
    per-row bars)."""
    if not isinstance(ref, tuple):
        g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())
        return
    f, ev, ec, vir, *e0 = got
    rf, rev, rec, rvir, *re0 = ref
    for g, r in [(f, rf)] + list(zip(e0, re0)):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())
    assert float(ev) == pytest.approx(float(rev), rel=5e-6)
    assert float(ec) == pytest.approx(float(rec), rel=5e-6, abs=1e-30)
    rvir = np.asarray(rvir, np.float64)
    np.testing.assert_allclose(np.asarray(vir, np.float64), rvir, rtol=5e-6,
                               atol=5e-6 * np.abs(rvir[:3]).max())


@pytest.mark.parametrize("form", list(FORMS))
def test_emulation_matches_jax_f32(form):
    coul, wolf, force = FORMS[form]
    c = _case()
    sp = torch.as_tensor(c["sp"])
    got, _ = _emulate(_args(c, torch.float32, form), sp, form)
    aj = _args(c, None, form,
               conv=lambda a: jnp.asarray(np.asarray(a, np.float32)))
    spj = jnp.asarray(c["sp"])
    if not force:
        ref = pallas_panel.wolf_panel(*aj)
    elif wolf:
        ref = pallas_panel.pair_wolf_panel(*aj, sp=spj)
    else:
        ref = pallas_panel.pair_panel(*aj, sp=spj, coul=coul)
        got = got[:4]
    _close_f32(got, ref)


@pytest.mark.parametrize("wolf", [True, False], ids=["field", "no_field"])
def test_emulation_matches_jax_df_f32(wolf):
    """JAX's pair_panel_df runs its double-f32 kernel in interpret mode at
    float32 grade on the CPU (tests/test_df_panels.py): the float32
    emulation of the kernel the port builds for it, at the same bars."""
    c = _case()
    sp = torch.as_tensor(c["sp"])
    form = "coul_wolf" if wolf else "coul"
    got, _ = _emulate(_args(c, torch.float32, form), sp, form)
    d = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa
    ref = pallas_panel.pair_panel_df(
        d(c["x"]), d(c["q"]), d(c["type"]), d(c["mask"]), d(c["tabs"]),
        d(c["L"]), CUT_COULSQ, QQRD2E, G_EWALD, sp=jnp.asarray(c["sp"]),
        mol=d(c["mol"]) if wolf else None)
    _close_f32(got if wolf else got[:4], ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", list(FORMS))
def test_skips_are_exact(form, dtype):
    """The votes and tile pairs that skip drop only exact zeros: the
    emulation with the skips equals the one without, by torch.equal.  The
    case is in spatial order, so most votes skip and the tile-pair test
    drops tile pairs (and all of those between padding tiles)."""
    c = _case(n=700, npad=1024, L=(26.0, 28.0, 30.0))
    args = _args(c, dtype, form)
    sp = torch.as_tensor(c["sp"])
    tile = TILE[dtype]
    on, (votes, skipped, dropped, npairs) = _emulate(args, sp, form,
                                                     tile=tile)
    off, counts = _emulate(args, sp, form, tile=tile, skip=False,
                           cull=False)
    for a_, b_ in zip(_outputs(on), _outputs(off)):
        if a_ is not None:
            assert torch.equal(a_, b_)
    assert counts[2] == 0
    assert skipped > votes // 2
    assert 0 < dropped < npairs
    # the padding tiles hold no unmasked atom: all their pairs drop
    pad = [(I, k) for I, k in tile_pairs(1024, tile)
           if I * tile >= 700 and ((I + k) % (1024 // tile)) * tile >= 700]
    assert pad and dropped >= len(pad)


def test_asymmetric_tables_are_refused():
    """The whole-panel kernel uses one F for both atoms of a pair, so the
    wrapper takes only symmetric type tables (checked once per table)."""
    tabs = torch.as_tensor(_tabs(), dtype=torch.float32)
    panel._symmetric_tables("pair_panel", tabs)
    bad = tabs.clone()
    bad[0, 1, 2] *= 1.5
    with pytest.raises(ValueError, match="symmetric"):
        panel._symmetric_tables("pair_panel", bad)
    bad[0, 2, 1] *= 1.5                    # symmetric again: its version
    panel._symmetric_tables("pair_panel", bad)   # moved, so checked anew


def test_bound_counts_the_pairs_that_act():
    """chip_smoke.pair_bound_ms and wolf_bound_ms count arithmetic only
    where the function needs it.  Held against the plain row forms one
    column at a time (the terms on every row from column j), on a case
    with padding, masked atoms that keep their charge and special lists:
    the LJ, coulomb and Wolf pairs it counts are exactly the unordered
    pairs with such a term on either atom, and the geometry pairs those
    with an unmasked atom on one side."""
    c = chip_smoke.to_f64(chip_smoke.make_case(90, 128, 14.0, seed=3,
                                               n_masked=9, dev="cpu"))
    from lidp_tpu_torch.models import polar_bench

    ff = polar_bench.synthetic_forcefield(polar_bench.synthetic_system(2),
                                          torch.float64, "cpu")
    p = ff.pair
    tabs = chip_smoke.tabs_for(p, torch.float64)
    _, _, cnt = chip_smoke.pair_bound_ms("pair_panel_df", c, tabs,
                                         p.cut_coulsq, wolf=True, tile=64)
    _, _, wcnt = chip_smoke.wolf_bound_ms("wolf_panel", c, p.cut_coulsq,
                                          tile=64)
    npad = c["x"].shape[0]
    base = (c["x"], c["q"], c["type"])

    def acting(which):
        terms = []
        for j in range(npad):
            cols = tuple(t[j:j + 1] for t in (*base, c["mol"], c["mask"]))
            if which == "wolf":
                e0 = panel.wolf_panel_plain(
                    c["x"], c["q"], c["mol"], c["mask"], c["L"],
                    p.cut_coulsq, cols=(cols[0], cols[1], cols[3],
                                        cols[4]), row0=-j)
                terms.append(e0)
                continue
            tb = tabs.clone()
            if which == "coul":
                tb[:2] = 0.0
            sc = (p.cut_coulsq, p.qqrd2e, p.g_ewald)
            # column j is column 0 of its strip: the lists shift with it
            f = panel.pair_panel_plain(
                *base, c["mask"], tb, c["L"], *sc, sp=c["sp"] - j,
                cols=(cols[0], cols[1], cols[2], cols[4]), row0=-j,
                coul=which == "coul")[0]
            terms.append(f)
        nz = (torch.stack(terms, 1) != 0).any(-1)      # on row i from j
        return int(torch.triu(nz | nz.T, 1).sum())

    assert cnt["lj_pairs"] == acting("lj")
    assert cnt["coul_pairs"] == acting("coul")
    assert wcnt["wolf_pairs"] == acting("wolf") == cnt["wolf_pairs"]
    live = c["mask"] != 0
    either = (live[:, None] | live[None, :]).triu(1)
    assert cnt["geometry_pairs"] == int(either.sum())
    assert cnt["lj_pairs"] < cnt["coul_pairs"] < cnt["geometry_pairs"]
    # wolf_panel's geometry is counted in the tile pairs its test keeps at
    # its radius, 6.5 A, here the pair kernel's outer radius too; every
    # pair that takes the field lies in one of them
    for k in ("geometry_pairs", "kept_pairs", "tile_pairs",
              "kept_tile_pairs"):
        assert wcnt[k] == cnt[k]
    tid = torch.arange(npad) // 64
    keep = ~chip_smoke.far_tile_pairs(c["x"], c["mask"], c["L"], 64, 6.5)
    wl = panel.wolf_panel_plain
    e0 = [wl(c["x"], c["q"], c["mol"], c["mask"], c["L"], p.cut_coulsq,
             cols=(c["x"][j:j + 1], c["q"][j:j + 1], c["mol"][j:j + 1],
                   c["mask"][j:j + 1]), row0=-j) for j in range(npad)]
    acts = (torch.stack(e0, 1) != 0).any(-1)
    assert bool(keep[tid[:, None], tid[None, :]][acts].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cutoff_pairs_case_crosses_when_fused(dtype):
    """The case's pairs: rsq rounded term by term is the cutoff (pair 0)
    or one ulp below it (pair 1), and both contracted forms lie on the
    other side of the cutoff."""
    c = chip_smoke.cutoff_pairs_case(dtype, "cpu")
    npt = np.float32 if dtype == torch.float32 else np.float64
    x = c["x"].numpy()
    C = npt(chip_smoke.CUTOFF_SQ)
    for k, (want, side) in enumerate(((C, lambda f: f < C),
                                      (np.nextafter(C, npt(0)),
                                       lambda f: f >= C))):
        d = x[2 * k] - x[2 * k + 1]
        assert (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] == want
        assert all(side(f) for f in chip_smoke.fused_rsq(d, npt)), k


def _cutoff_args(c, form, conv):
    tabs = _tabs()
    head = (conv(c["x"]), conv(c["q"]), conv(c["type"]))
    tail = (conv(c["mask"]), conv(tabs), conv(c["L"]), CUT_COULSQ, QQRD2E,
            G_EWALD)
    if form == "coul_wolf":
        args = head + (conv(c["mol"]),) + tail
        return args, args[:5]
    args = head + tail
    return args, args[:4]


def _acting_rows(out):
    """Rows with a nonzero force, and (with the field) a nonzero field."""
    rows = [(np.asarray(out[0]) != 0).any(1)]
    if len(out) == 5:
        rows.append((np.asarray(out[4]) != 0).any(1))
    return rows


def _same_rounding_case(dtype):
    """Pairs at exactly CUTOFF_SQ and one ulp inside it, laid out as in
    cutoff_pairs_case, whose contracted forms round to the same rsq: how
    XLA forms rsq on the CPU cannot move them."""
    npt = np.float32 if dtype == torch.float32 else np.float64
    c = chip_smoke.cutoff_pairs_case(dtype, "cpu")
    x = c["x"].numpy().copy()
    C = npt(chip_smoke.CUTOFF_SQ)
    for k, target in enumerate((C, np.nextafter(C, npt(0)))):
        x[2 * k + 1] = chip_smoke._cutoff_partner(
            npt, x[2 * k], target, lambda f, t=target: f == t, seed=10 + k)
    return dict(c, x=torch.as_tensor(x))


# rows with a force on each case: by rsq rounded term by term (the plain
# version, the CUDA kernels) and by a contracted rsq (XLA on the CPU)
_ROUNDED = np.array([False, False, True, True, False, False])
_CONTRACTED = np.array([True, True, False, False, False, False])


def _cases(dtype):
    return ((_same_rounding_case(dtype), _ROUNDED),
            (chip_smoke.cutoff_pairs_case(dtype, "cpu"), _CONTRACTED))


@pytest.mark.parametrize("form", ["coul_wolf", "coul"])
def test_strip_form_decides_cutoff_pairs_as_pallas(form):
    """The strip form (cols = all atoms, row0 = 0) of the plain version and
    of JAX's Pallas kernel (interpret mode, float32) on pairs at exactly the
    outer cutoff and one ulp inside it: rows 2 and 3 take a coulomb force
    and the field, the others exactly none, at the float32 bars.  On
    cutoff_pairs_case, whose pairs the contracted forms put on the other
    side, the plain version decides by rsq rounded term by term, as the
    CUDA kernels do, and the Pallas kernel as the contracted form: XLA on
    the CPU contracts rsq into fused multiply-adds."""
    for case, jax_rows in _cases(torch.float32):
        args, cols = _cutoff_args(case, form, lambda a: torch.as_tensor(
            np.asarray(a), dtype=torch.float32))
        jargs, jcols = _cutoff_args(case, form, lambda a: jnp.asarray(
            np.asarray(a, np.float32)))
        if form == "coul_wolf":
            got = panel.pair_wolf_panel_plain(*args, cols=cols, row0=0)
            ref = pallas_panel.pair_wolf_panel(*jargs, cols=jcols, row0=0)
        else:
            got = panel.pair_panel_plain(*args, cols=cols, row0=0)
            ref = pallas_panel.pair_panel(*jargs, cols=jcols, row0=0)
        for a in _acting_rows(got):
            np.testing.assert_array_equal(a, _ROUNDED)
        for a in _acting_rows(ref):
            np.testing.assert_array_equal(a, jax_rows)
        if jax_rows is _ROUNDED:
            _close_f32(got, ref)


def _jax_scan_strip(c):
    """The JAX scan path's strip phases (build_sharded_polar_step(
    panel="scan").host_phases(strips=2): pair_real and wolf, float64) on
    case c: (f, ecoul, e0 unscaled) of its six rows."""
    from lidp_tpu.forcefield import ForceField
    from lidp_tpu.ops import polarization as jpol
    from lidp_tpu.ops.pair import make_pair_params
    from lidp_tpu.parallel import shard

    eps, sig, cut = np.zeros((3, 3)), np.zeros((3, 3)), np.zeros((3, 3))
    eps[1:, 1:] = [[0.1, 0.05], [0.05, 0.03]]
    sig[1:, 1:] = [[3.0, 2.7], [2.7, 2.5]]
    cut[1:, 1:] = 6.0
    pair = make_pair_params(eps, sig, cut, cut_coul=6.5, coul=True,
                            qqrd2e=QQRD2E, g_ewald=G_EWALD,
                            dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(pair.cutsq), _tabs()[4])
    s = jpol.PolarizationSettings()
    ff = ForceField(pair=pair, ewald=None, polar=s, qqrd2e=QQRD2E)
    make, bind_box, npad, _ = shard.build_sharded_polar_step(
        None, ff, s, n=4, dt=1.0, ftm2v=1.0, dtype=jnp.float64,
        panel="scan")
    bind_box(np.full(3, 60.0))
    ph = make.host_phases(strips=2)

    def padded(a, dt=np.float64):
        a = np.asarray(a)
        out = np.zeros((npad,) + a.shape[1:], dt)
        out[:6] = a
        return jnp.asarray(out)

    x, q, m = padded(c["x"]), padded(c["q"]), padded(c["mask"], bool)
    f, _, ec, _, _ = ph["pair_real"](0, x, q, padded(c["type"], np.int32), m)
    e0 = ph["wolf"](0, x, q, padded(c["mol"], np.int32), m)
    return (np.asarray(f)[:6], float(ec),
            np.asarray(e0)[:6] / np.sqrt(QQRD2E))


def test_strip_form_decides_cutoff_pairs_as_jax_f64():
    """float64: the plain strip form (cols, row0) against the JAX scan
    path's strip phases on the same two cases: the same rows take a force
    and the field, and the values agree to 1e-12 of their largest, on the
    pairs at exactly the cutoff and one ulp inside it that the contracted
    forms leave in place; on cutoff_pairs_case XLA decides as the
    contracted form, as in float32."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa
    for case, jax_rows in _cases(torch.float64):
        args = (case["x"], case["q"], case["type"], case["mol"],
                case["mask"], t(_tabs()), case["L"], CUT_COULSQ, QQRD2E,
                G_EWALD)
        f, _, ec, _, e0 = panel.pair_wolf_panel_plain(*args, cols=args[:5],
                                                      row0=0)
        fj, ecj, e0j = _jax_scan_strip(case)
        for a in (f, e0):
            np.testing.assert_array_equal((a.numpy() != 0).any(1),
                                          _ROUNDED)
        for a in (fj, e0j):
            np.testing.assert_array_equal((a != 0).any(1), jax_rows)
        if jax_rows is _ROUNDED:
            for a, b in ((f, fj), (e0, e0j)):
                np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                           atol=1e-12 * np.abs(b).max())
            assert float(ec) == pytest.approx(ecj, rel=1e-12)


def test_strip_form_decides_cutoff_pairs_f64():
    """The float64 plain strip form, with the field (pair_panel_df's plain
    version), decides the float64 case's pairs alike, with the bits of the
    whole form."""
    c = chip_smoke.cutoff_pairs_case(torch.float64, "cpu")
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa
    args = (c["x"], c["q"], c["type"], c["mask"], t(_tabs()), c["L"],
            CUT_COULSQ, QQRD2E, G_EWALD)
    got = panel.pair_panel_df_plain(*args, mol=c["mol"],
                                    cols=(*args[:4], c["mol"]), row0=0)
    whole = panel.pair_panel_df_plain(*args, mol=c["mol"])
    for a in _acting_rows(got):
        np.testing.assert_array_equal(a, _ROUNDED)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)
