"""The LJ cell kernel's algorithm on the CPU (csrc/lj_cell.cuh runs only on
the GPU; tests/test_torch_cuda_kernels.py holds it there).

A plain-torch emulation of the kernel's decomposition, with the kernel's
own constants (its two tiles' TX, TY, ZC, and LJ_R, LJ_LANES, read from the
header):

  * the CTAs: TX x TY columns of ZC z-cells each, in the wide tile the
    launcher takes for caps that fit it and in the narrow one that a larger
    cap takes; each stages the (TX + 2) x (TY + 2) columns around them,
    ZC + 2 cells each: per
    32 slots of a cell a ballot of the live ones, each placed at the
    popcount of the live lanes below it plus the column's count so far, so
    a column's live slots lie compacted in slot order and the 3
    consecutive cells that a row meets in it are one range;
  * the row groups: the live rows of each own cell in groups of LJ_R, a
    team of LJ_LANES lanes per group, the 9 columns' candidates strided
    over the lanes, each lane summing in order, the lanes combined by the
    shuffle tree;
  * the +-L placement: added to the candidate for the 13 offsets of the
    Newton half stencil, subtracted from the row for the others, uniform
    over a run's 3 cells unless the row's cell is at a z face;

held against slot_lj_forces_plain and cell_pair_forces_lj_plain (forces
5e-6 of max |f|, evdwl and virial rel 1e-5: float32 sums in another order,
the bar of tests/test_torch_lj_cells.py) and against JAX's Pallas functions
in interpret mode at the same bar; and each pair's two evaluations are
exactly opposite.  Energy and virial are summed in float64 here (the
kernel sums per thread in float32, then per CTA, then over CTAs in
double).  Cases: a cubic (4,4,4) and the ragged (3,4,5) grid of
chip_smoke.py with masked atoms (an empty cell, a full one), a grid whose
every slot holds an atom, and the ragged grid with each cell's slots in a
random order.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from lidp_tpu_torch.box import Box  # noqa: E402
from lidp_tpu_torch.ops import cell_kernels as tck  # noqa: E402
from lidp_tpu_torch.ops.cells import CellConfig, build_cells  # noqa: E402
from lidp_tpu_torch.ops.pair import make_pair_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CASES = ["cubic", "ragged", "full", "scattered"]


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """chip_smoke.py at the repository root, as a module (it imports only
    the standard library until one of its functions is called)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _consts():
    text = (ROOT / "lidp_tpu_torch/csrc/lj_cell.cuh").read_text()
    consts = {k: int(re.search(rf"constexpr int {k} = (\d+);",
                               text).group(1))
              for k in ("ZC", "LJ_R", "LJ_LANES", "LJ_THREADS", "NRUN",
                        "CENTER_RUN")}
    consts["wide"] = tuple(int(v) for v in re.search(
        r"constexpr int LJ_TX = (\d+), LJ_TY = (\d+);", text).groups()) \
        + (consts["ZC"],)
    assert "using LJWide = LJTile<LJ_TX, LJ_TY, ZC>;" in text
    consts["narrow"] = tuple(int(v) for v in re.search(
        r"using LJNarrow = LJTile<(\d+), (\d+), (\d+)>;", text).groups())
    return consts


def _cubic_case():
    """400 atoms on a jittered lattice in a cube of 11.6, 15% masked, on a
    (4,4,4) grid of cap 24."""
    rs = np.random.RandomState(9)
    L = np.full(3, 11.6)
    g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[rs.permutation(512)[:400]]
    x = (g + 0.5 + rs.uniform(-0.3, 0.3, (400, 3))) * (L / 8)
    one = np.zeros((2, 2))
    one[1, 1] = 1.0
    f32 = torch.float32
    return dict(
        x=torch.as_tensor(x, dtype=f32),
        mask=torch.as_tensor(rs.rand(400) > 0.15),
        box=Box.create(np.zeros(3), L, dtype=f32, device="cpu"),
        pair=make_pair_params(one, one, 2.5 * one, coul=False, dtype=f32,
                              device="cpu"),
        cfg=CellConfig(nbins=(4, 4, 4), cap=24, cutneigh=2.9), n=400)


@functools.lru_cache(maxsize=None)
def _case(name):
    """The case's torch inputs, its Cells (slots scattered for
    `scattered`), slot state and live slots."""
    cs = _chip_smoke()
    if name == "cubic":
        c = _cubic_case()
    elif name == "full":
        c = cs.full_lj_case("cpu")
    else:
        c = cs.ragged_lj_case("cpu")
    cells = build_cells(c["x"], c["mask"], c["box"], c["cfg"])
    assert not bool(cells.overflow)
    if name == "scattered":
        cells = cs.scatter_slots(cells)
    xs = cs.slot_state(c["x"], cells, c["box"], c["pair"])
    live = (cells.atom_of_slot < c["x"].shape[0]).numpy()
    return dict(c, cells=cells, xs=xs, live=live)


def _jax_inputs(c):
    """The case's box, pair table and Cells in the JAX package."""
    from lidp_tpu import box as jbox
    from lidp_tpu.ops import cells as jcells
    from lidp_tpu.ops.pair import make_pair_params as jmake

    one = np.zeros((2, 2))
    one[1, 1] = 1.0
    L = c["box"].lengths.numpy().astype(np.float32)
    bj = jbox.Box.create(np.zeros(3, np.float32), L)
    pj = jmake(one, one, 2.5 * one, coul=False, dtype=jnp.float32)
    cj = jcells.Cells(
        atom_of_slot=jnp.asarray(c["cells"].atom_of_slot.numpy()),
        slot_of_atom=jnp.asarray(c["cells"].slot_of_atom.numpy()),
        overflow=jnp.asarray(False))
    return bj, pj, cj


def stage(live, cx, cy, z0, nz):
    """The staging of grid column (cx, cy) for a CTA of z-cells z0 ..
    z0 + nz - 1: the (cx, cy, cz, s) of its live slots, z0 - 1 .. z0 + nz
    (wrapped), in staged order, and each staged cell's offset (nz + 3
    entries, the last the column's count), as the warp's ballot and
    popcount place them."""
    nbz, cap = live.shape[2:]
    slots, offs, cnt = [], [], 0
    for zz in range(nz + 2):
        offs.append(cnt)
        cz = (z0 - 1 + zz) % nbz
        for s0 in range(0, cap, 32):
            bits = live[cx, cy, cz, s0:s0 + 32].astype(np.int64)
            below = np.cumsum(bits) - bits          # popc(ballot & lanemask)
            for lane in np.flatnonzero(bits):
                assert cnt + below[lane] == len(slots)
                slots.append((cx, cy, cz, s0 + lane))
            cnt += int(bits.sum())
    offs.append(cnt)
    return np.array(slots, dtype=np.int64).reshape(-1, 4), offs


def tiles(live, tile="wide"):
    """The CTAs of a launch with `tile` ("wide" or "narrow"): (x0, y0, z0,
    ntx, nty, nz)."""
    TX, TY, ZC = _consts()[tile]
    nbx, nby, nbz = live.shape[:3]
    return [(x0, y0, z0, min(TX, nbx - x0), min(TY, nby - y0),
             min(ZC, nbz - z0))
            for x0 in range(0, nbx, TX) for y0 in range(0, nby, TY)
            for z0 in range(0, nbz, ZC)]


def _shift(c, nb, L):
    """wrap_shift of csrc/lj_cell.cuh."""
    return L if c >= nb else (-L if c < 0 else 0.0)


def emulate(xs, live, L, pair, need_ev, record=None, tile="wide"):
    """The kernel with `tile` on the slot state xs (nbx,nby,nbz,cap,3)
    float32 with live slots `live`: (forces (nbx,nby,nbz,cap,3), zero on
    empty slots, evdwl, virial6 at half weight).  With `record` a dict,
    each pair that passes the cutoff test is recorded as {(row slot,
    candidate slot): (dx, dy, dz)} as the kernel forms them."""
    k_ = _consts()
    TX, TY = k_[tile][:2]
    R, LANES = k_["LJ_R"], k_["LJ_LANES"]
    C, NRUN = k_["CENTER_RUN"], k_["NRUN"]
    f32 = torch.float32
    nbx, nby, nbz, cap = live.shape
    lj3, lj4, off, cutsq = (t[1, 1].to(f32) for t in
                            (pair.lj3, pair.lj4, pair.offset, pair.cut_ljsq))
    lj1, lj2 = torch.tensor(12.0, dtype=f32) * lj3, \
        torch.tensor(6.0, dtype=f32) * lj4
    Lf = [float(v) for v in L.to(f32)]
    f = torch.zeros_like(xs)
    ev = torch.zeros(7, dtype=torch.float64)
    for x0, y0, z0, ntx, nty, nz in tiles(live, tile):
        cols = {(sx, sy): stage(live, (x0 - 1 + sx) % nbx,
                                (y0 - 1 + sy) % nby, z0, nz)
                for sx in range(ntx + 2) for sy in range(nty + 2)}
        cand = {key: xs[s[:, 0], s[:, 1], s[:, 2], s[:, 3]]
                for key, (s, _) in cols.items()}
        # the own cells in the kernel's order, each cut into row groups
        for oc in range(TX * TY):
            sx, sy = oc // TY + 1, oc % TY + 1
            if sx > ntx or sy > nty:
                continue
            ix, iy = x0 + sx - 1, y0 + sy - 1
            own_slots, own_off = cols[(sx, sy)]
            for k in range(nz):
                zedge = z0 + k in (0, nbz - 1)
                for g0 in range(own_off[k + 1], own_off[k + 2], R):
                    rows = np.arange(g0, min(g0 + R, own_off[k + 2]))
                    xi = cand[(sx, sy)][rows]
                    lanes, parts = [], []
                    for run in range(NRUN):
                        ox, oy = run // 3 - 1, run % 3 - 1
                        key = (sx + ox, sy + oy)
                        shx = _shift(ix + ox, nbx, Lf[0])
                        shy = _shift(iy + oy, nby, Lf[1])
                        offs = cols[key][1]
                        if not zedge:
                            half = ox > 0 or (ox == 0 and oy > 0)
                            segs = [(offs[k], offs[k + 3], half,
                                     (shx, shy, 0.0), run == C)]
                        else:
                            segs = []
                            for zo in range(3):
                                zz = k + zo
                                half = ox > 0 or (ox == 0 and (
                                    oy > 0 or (oy == 0 and zo >= 1)))
                                segs.append((
                                    offs[zz], offs[zz + 1], half,
                                    (shx, shy,
                                     _shift(z0 - 1 + zz, nbz, Lf[2])),
                                    run == C and zo == 1))
                        for j0, j1, half, sh, self_ in segs:
                            if j1 == j0:
                                continue
                            sh = torch.tensor(sh, dtype=f32)
                            q = cand[key][j0:j1]
                            if half:
                                q, xr = q + sh, xi
                            else:
                                xr = xi - sh
                            d = xr[:, None, :] - q[None, :, :]
                            rsq = (d[..., 0] * d[..., 0]
                                   + d[..., 1] * d[..., 1]) \
                                + d[..., 2] * d[..., 2]
                            ok = rsq < cutsq
                            if self_:
                                ok &= torch.as_tensor(
                                    np.arange(j0, j1)[None, :]
                                    != rows[:, None])
                            r2inv = 1.0 / torch.where(ok, rsq, 1.0)
                            r6inv = r2inv * r2inv * r2inv
                            fpair = torch.where(
                                ok, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
                            p = fpair[..., None] * d
                            lanes.append(np.arange(j1 - j0) % LANES)
                            parts.append(p)
                            if need_ev:
                                e = torch.where(
                                    ok, r6inv * (lj3 * r6inv - lj4) - off,
                                    0.0)
                                pd, dd = p.double(), d.double()
                                ev += torch.stack([
                                    e.double().sum(),
                                    *[(pd[..., a] * dd[..., b]).sum()
                                      for a, b in ((0, 0), (1, 1), (2, 2),
                                                   (0, 1), (0, 2), (1, 2))]])
                            if record is not None:
                                cs_ = cols[key][0][j0:j1]
                                for r, j in zip(*np.nonzero(ok.numpy())):
                                    record[(tuple(own_slots[rows[r]]),
                                            tuple(cs_[j]))] = \
                                        d[r, j].numpy().copy()
                    # each lane sums its candidates in order, from 0
                    lane = np.concatenate(lanes)
                    p_all = torch.cat(parts, dim=1)
                    v = torch.zeros((LANES, len(rows), 3), dtype=f32)
                    for ln in range(LANES):
                        sel = torch.as_tensor(np.flatnonzero(lane == ln))
                        if len(sel):
                            v[ln] = torch.cumsum(p_all[:, sel], dim=1,
                                                 dtype=f32)[:, -1]
                    # team_sum: shfl_down by LANES/2, ..., 1 to lane 0
                    w = LANES // 2
                    while w:
                        v = v[:w] + v[w:2 * w]
                        w //= 2
                    s = own_slots[rows]
                    f[s[:, 0], s[:, 1], s[:, 2], s[:, 3]] = v[0]
    return f, (0.5 * ev[0]).to(f32), (0.5 * ev[1:]).to(f32)


@functools.lru_cache(maxsize=None)
def _emulated(name, need_ev, tile="wide"):
    c = _case(name)
    return emulate(c["xs"], c["live"], c["box"].lengths, c["pair"], need_ev,
                   tile=tile)


def _close(got, ref, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max()
    tol = (5e-6 if what == "f" else 1e-5) * scale
    assert np.abs(got - ref).max() <= tol, (what, np.abs(got - ref).max(),
                                            scale)


@pytest.mark.parametrize("tile", ["wide", "narrow"])
@pytest.mark.parametrize("name", CASES)
def test_staging_compacts_in_slot_order(name, tile):
    """Every CTA stages, per column, exactly the live slots of its cells,
    in slot order; the offsets bound each cell; the own cells of the CTAs
    cover every slot of the grid once."""
    c = _case(name)
    live = c["live"]
    nbx, nby, nbz, cap = live.shape
    owned = np.zeros(live.shape[:3], int)
    for x0, y0, z0, ntx, nty, nz in tiles(live, tile):
        owned[x0:x0 + ntx, y0:y0 + nty, z0:z0 + nz] += 1
        for cx, cy in [((x0 - 1) % nbx, (y0 - 1) % nby),
                       (x0, y0), ((x0 + ntx) % nbx, (y0 + nty) % nby)]:
            slots, offs = stage(live, cx, cy, z0, nz)
            assert offs[-1] == len(slots)
            for zz in range(nz + 2):
                seg = slots[offs[zz]:offs[zz + 1]]
                cz = (z0 - 1 + zz) % nbz
                assert (seg[:, :3] == (cx, cy, cz)).all()
                np.testing.assert_array_equal(
                    seg[:, 3], np.flatnonzero(live[cx, cy, cz]))
    assert (owned == 1).all()
    if name == "full":
        assert live.all()
    if name == "scattered":
        # some cell's live slots are not a prefix of it
        n_live = live.sum(-1)
        prefix = np.arange(cap) < n_live[..., None]
        assert (live != prefix).any()


@pytest.mark.parametrize("tile", ["wide", "narrow"])
@pytest.mark.parametrize("need_ev", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_emulation_matches_plain(name, need_ev, tile):
    c = _case(name)
    f, evdwl, vir = _emulated(name, need_ev, tile)
    grids = [c["xs"][..., d] for d in range(3)]
    fg, ev_ref, vir_ref = tck.slot_lj_forces_plain(grids, c["box"],
                                                   c["pair"], need_ev=need_ev)
    ref = torch.stack(fg, -1)
    assert float(ref.abs().max()) > 1.0
    _close(f, ref, "f")
    assert not f[torch.as_tensor(~c["live"])].any()   # empty slots: zero
    if need_ev:
        _close(evdwl, ev_ref, "evdwl")
        _close(vir, vir_ref, "virial")
    # atom order: the same rows, stored to f[atom] for unmasked atoms
    aos = c["cells"].atom_of_slot.reshape(-1).long()
    n = c["x"].shape[0]
    fa = torch.zeros((n + 1, 3))
    fa[torch.clamp(aos, max=n)] = f.reshape(-1, 3)
    fa = torch.where(c["mask"][:, None], fa[:n], 0.0)
    ga = tck.cell_pair_forces_lj_plain(c["x"], c["mask"], c["cells"],
                                       c["box"], c["pair"], need_ev=need_ev)
    _close(fa, ga[0], "f")
    if need_ev:
        _close(evdwl, ga[1], "evdwl")
        _close(vir, ga[3], "virial")


@pytest.mark.parametrize("need_ev", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_emulation_matches_pallas(name, need_ev):
    from lidp_tpu.ops import pallas_pair as PP

    c = _case(name)
    bj, pj, cj = _jax_inputs(c)
    f, evdwl, vir = _emulated(name, need_ev)
    xs = c["xs"].numpy()
    fgj, evj, virj = PP.slot_lj_forces(
        [jnp.asarray(xs[..., d]) for d in range(3)], bj, pj, need_ev=need_ev)
    _close(f, np.stack([np.asarray(g) for g in fgj], -1), "f")
    if need_ev:
        _close(evdwl, evj, "evdwl")
        _close(vir, virj, "virial")
    ref = PP.cell_pair_forces_pallas(jnp.asarray(c["x"].numpy()),
                                     jnp.asarray(c["mask"].numpy()), cj, bj,
                                     pj, need_ev=need_ev)
    aos = c["cells"].atom_of_slot.reshape(-1).long()
    n = c["x"].shape[0]
    fa = torch.zeros((n + 1, 3))
    fa[torch.clamp(aos, max=n)] = f.reshape(-1, 3)
    fa = torch.where(c["mask"][:, None], fa[:n], 0.0)
    _close(fa, ref[0], "f")


@pytest.mark.parametrize("name", ["ragged", "full"])
def test_pair_evaluations_exactly_opposite(name):
    """With the shift on the neighbour for the half stencil and on the row
    for the opposite offsets, each pair inside the cutoff is seen from both
    sides with exactly opposite separations, across the periodic faces
    too (3 bins in x: both x neighbours of a cell wrap)."""
    c = _case(name)
    rec = {}
    emulate(c["xs"], c["live"], c["box"].lengths, c["pair"], False,
            record=rec)
    assert len(rec) > 0 and len(rec) % 2 == 0
    L = c["box"].lengths.numpy()
    wrapped = 0
    for (i, j), d in rec.items():
        np.testing.assert_array_equal(rec[(j, i)], -d)
        xi = c["xs"][i].numpy()
        xj = c["xs"][j].numpy()
        wrapped += bool((np.abs(xi - xj) > L / 2).any())
    assert wrapped > 0


def test_header_tiles():
    """The emulation reads the kernel's constants.  Their shared memory
    per slot (a float4 per staged slot, an int per slot of an own column)
    leaves the narrow tile every cap up to 358, the largest the kernel
    took before it had a narrow tile, within the H100's 227 KiB a block,
    with 2 KiB to spare for the kernel's static arrays; no float atomics."""
    k = _consts()
    assert k["LJ_R"] >= 1 and 32 % k["LJ_LANES"] == 0
    text = (ROOT / "lidp_tpu_torch/csrc/lj_cell.cuh").read_text()
    assert ("return (sizeof(float4) * NSC + sizeof(int) * TX * TY) * "
            "(ZC + 2) * cap;") in text
    per_slot = {}
    for tile in ("wide", "narrow"):
        tx, ty, zc = k[tile]
        per_slot[tile] = (16 * (tx + 2) * (ty + 2) + 4 * tx * ty) * (zc + 2)
    assert k["wide"] == (2, 2, 4)
    assert per_slot["narrow"] < per_slot["wide"]
    assert per_slot["narrow"] * 358 <= 227 * 1024 - 2048
    assert "atomicAdd" not in text
