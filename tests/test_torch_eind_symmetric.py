"""The whole-panel eind kernel's algorithm on the CPU (csrc/eind_panel.cuh
runs only on the GPU; tests/test_torch_cuda_kernels.py holds it there).

  * the kernel's tile pair of each block (tile_pair, the closed form that
    eind_whole_kernel computes from blockIdx.x) covers every unordered pair
    of tiles, and of atoms, exactly once, and the slots the kernel writes
    give each tile nT + 1 partials, each written once;
  * a plain-torch emulation of the kernel (each unordered pair once, both
    sides, the partial buffer, the slot-order sum) equals eind_panel_plain
    in float64 to rtol 1e-12, and JAX's Pallas eind_panel (interpret mode
    on the CPU) in float32 to tests/test_torch_panel_kernels.py's bar,
    per-row rtol 1e-4, atol 1e-5*max|ref| (float32 sums in another order);
  * the exact damping skip (ops/panel.EIND_SKIP_U): at and beyond the
    threshold, l1 = 1 - t1*t2 and l2 = 1 - t1*t3 round to exactly 1 in the
    kernel's operation order, both separately rounded and contracted to an
    FMA, with exp taken 4 ulps high; and a u below the threshold gives
    l != 1, so the margin is what the constant's comment states.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from __graft_entry__ import _tiny_polar_system  # noqa: E402
from lidp_tpu.ops import pallas_panel  # noqa: E402
from lidp_tpu_torch.ops import panel  # noqa: E402

PD = 2.1304


def tile_pair(b, nT):
    """(I, k) of block b of csrc/eind_panel.cuh eind_whole_kernel: tile I
    against J = I + k mod nT; k = 0 .. (nT - 1) // 2 for every I, then
    k = nT / 2 for I < nT / 2 when nT is even."""
    nK = nT * ((nT - 1) // 2 + 1)
    return (b % nT, b // nT) if b < nK else (b - nK, nT // 2)


def tile_pairs(npad, tile=panel.EIND_TILE):
    """The tile pairs of the launch's nT (nT + 1) / 2 blocks, in block
    order."""
    nT = -(-npad // tile)
    return [tile_pair(b, nT) for b in range(nT * (nT + 1) // 2)]


def _slots(pairs, nT):
    """(tile, slot) of the row side and of the column side of each tile
    pair, as the kernel writes them."""
    rows = [(int(i), int(k)) for i, k in pairs]
    cols = [((int(i) + int(k)) % nT, nT - int(k) if k else nT)
            for i, k in pairs]
    return rows, cols


@pytest.mark.parametrize("npad", [1000, 12288, 1100, 129, 100])
def test_schedule_covers_tile_pairs_once(npad):
    """npad 1000 and 12,288: even tile counts (8, 96); 1100: odd (9); 129:
    two tiles; 100: one."""
    nT = -(-npad // panel.EIND_TILE)
    pairs = tile_pairs(npad)
    assert all(0 <= i < nT and 0 <= k <= nT // 2 for i, k in pairs)
    seen = {}
    for i, k in pairs:
        key = frozenset((int(i), (int(i) + int(k)) % nT))
        seen[key] = seen.get(key, 0) + 1
    assert len(seen) == nT * (nT + 1) // 2
    assert set(seen.values()) == {1}
    rows, cols = _slots(pairs, nT)
    written = rows + cols
    assert len(set(written)) == len(written) == nT * (nT + 1)
    assert set(written) == {(t, s) for t in range(nT) for s in range(nT + 1)}


@pytest.mark.parametrize("npad,tile", [(45, 8), (37, 8), (16, 8), (5, 8)])
def test_schedule_covers_atom_pairs_once(npad, tile):
    """Atom by atom, small tiles: every unordered pair i != j once (the
    diagonal tile takes i < j); padded atoms past npad take no part."""
    nT = -(-npad // tile)
    count = np.zeros((nT * tile, nT * tile), int)
    for i, k in tile_pairs(npad, tile):
        j = (i + k) % nT
        r = np.arange(i * tile, (i + 1) * tile)[:, None]
        c = np.arange(j * tile, (j + 1) * tile)[None, :]
        take = (r < c) if k == 0 else np.ones((tile, tile), bool)
        np.add.at(count, (np.broadcast_to(r, take.shape)[take],
                          np.broadcast_to(c, take.shape)[take]), 1)
    sym = (count + count.T)[:npad, :npad]
    assert (np.diag(sym) == 0).all()
    assert (sym[~np.eye(npad, dtype=bool)] == 1).all()


def emulate_whole(x, alpha_eff, mu, L, pd, damping_type=panel.DAMP_EXP,
                  tile=panel.EIND_TILE):
    """The whole-panel kernel in plain torch: per block's tile pair (I, k)
    each pair once, c1 and c2 applied to both sides, the row side to slot
    k of I and the column side to slot nT - k (nT on the diagonal) of
    J = I + k mod nT; then each atom's slots summed in slot order and
    negated.  Masks as the kernel: alpha_i != 0, alpha_j != 0, and i < j
    on the diagonal tile."""
    n = x.shape[0]
    nT = -(-n // tile)

    def pad(t):
        out = t.new_zeros((nT * tile,) + t.shape[1:])
        out[:n] = t
        return out

    x, a, mu = pad(x), pad(alpha_eff), pad(mu)
    Linv = 1.0 / L
    part = x.new_full((nT, nT + 1, tile, 3), math.nan)
    loc = torch.arange(tile)
    for I, k in tile_pairs(n, tile):
        J = (I + k) % nT
        ri, cj = I * tile + loc, J * tile + loc
        d = x[ri][:, None, :] - x[cj][None, :, :]
        d = d - L * torch.round(d * Linv)
        pm = (a[ri] != 0)[:, None] & (a[cj] != 0)[None, :]
        if k == 0:
            pm &= loc[:, None] < loc[None, :]
        rsq = torch.where(pm, (d * d).sum(-1), 1.0)
        rinv = torch.rsqrt(rsq)
        r = rsq * rinv
        r2inv = rinv * rinv
        r3inv = r2inv * rinv
        r5inv = r3inv * r2inv
        l1, l2 = panel._damping(r, rsq, pd, damping_type)
        c1 = torch.where(pm, -3.0 * (l2 * r5inv), 0.0)[..., None]
        c2 = torch.where(pm, l1 * r3inv, 0.0)[..., None]
        mj, mi = mu[cj][None, :, :], mu[ri][:, None, :]
        row = c1 * (mj * d).sum(-1, keepdim=True) * d + c2 * mj
        col = c1 * (mi * d).sum(-1, keepdim=True) * d + c2 * mi
        part[I, k] = row.sum(1)
        part[J, nT - k if k else nT] = col.sum(0)
    assert not torch.isnan(part).any()           # every slot written
    out = torch.zeros_like(part[:, 0])
    for s in range(nT + 1):
        out += part[:, s]
    return -out.reshape(-1, 3)[:n]


def _random_case():
    """tests/test_torch_panel_kernels.py's random eind case (its _case with
    seed 3, uniform positions): 300 atoms in 512 rows, 20 alpha=0 atoms."""
    rng = np.random.RandomState(3)
    n, npad, L = 300, 512, np.array([20.0, 22.0, 24.0])
    x = np.zeros((npad, 3))
    x[:n] = rng.uniform(0, 1, (n, 3)) * L
    alpha = np.zeros(npad)
    alpha[:n] = rng.uniform(0.5, 2.0, n)
    alpha[:20] = 0.0
    mu = np.zeros((npad, 3))
    mu[:n] = rng.normal(0, 1e-2, (n, 3))
    mu[alpha == 0.0] = 0.0
    return x, alpha, mu, L


def _tiny_case(npad=256):
    """__graft_entry__._tiny_polar_system (24 atoms, L = 14) padded to npad
    rows, with dipoles from RandomState(1)."""
    x0, _, _, _, _, alpha0, L = _tiny_polar_system()
    n = x0.shape[0]
    x = np.zeros((npad, 3))
    x[:n] = x0
    alpha = np.zeros(npad)
    alpha[:n] = alpha0
    mu = np.zeros((npad, 3))
    mu[:n] = np.random.RandomState(1).normal(0, 0.05, (n, 3))
    return x, alpha, mu, np.full(3, L)


CASES = {"random": _random_case, "tiny": _tiny_case}


def _torch(case, dtype):
    return tuple(torch.as_tensor(np.asarray(a), dtype=dtype) for a in case)


@pytest.mark.parametrize("tile", [panel.EIND_TILE, 64, 24])
@pytest.mark.parametrize("name", list(CASES))
def test_emulation_matches_plain_f64(name, tile):
    """512 rows: 4, 8 and 22 tiles (the last one part padding); 256 rows:
    2, 4 and 11."""
    x, a, mu, L = _torch(CASES[name](), torch.float64)
    got = emulate_whole(x, a, mu, L, PD, tile=tile)
    ref = panel.eind_panel_plain(x, a, mu, L, PD)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12 * ref.abs().max().item())


def test_emulation_without_damping_matches_plain_f64():
    x, a, mu, L = _torch(_random_case(), torch.float64)
    got = emulate_whole(x, a, mu, L, PD, damping_type=panel.DAMP_NONE,
                        tile=64)
    ref = panel.eind_panel_plain(x, a, mu, L, PD,
                                 damping_type=panel.DAMP_NONE)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12 * ref.abs().max().item())


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_matches_jax_f32(name):
    case = CASES[name]()
    x, a, mu, L = _torch(case, torch.float32)
    got = emulate_whole(x, a, mu, L, PD).numpy()
    xj, aj, muj, Lj = (jnp.asarray(np.asarray(v, np.float32)) for v in case)
    ref = np.asarray(pallas_panel.eind_panel(xj, aj, muj, Lj, PD),
                     np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


# ------------------------- the damping skip -----------------------------

# (numpy dtype, ulps exp may be off, exponent of half an ulp below 1)
SKIP = {torch.float32: (np.float32, 4, -25), torch.float64: (np.float64, 4,
                                                               -54)}


def _stays_one(dt, t1, t2, rsq, r, fma):
    """Do l1 = 1 - t1*t2 and l2 = 1 - t1*(t2 + pd^3/6 rsq r) round to
    exactly 1?  1 - p rounds to 1 iff p <= 2^e (half an ulp below 1, the
    tie going to the even 1): p is the exact product for the FMA form,
    the rounded one otherwise.  Returns a bool per element."""
    npt, _, e = SKIP[dt]
    pd3_6 = npt(PD) * npt(PD) * npt(PD) / npt(6)
    if fma:   # t3 = fma(pd3_6*rsq, r, t2), exact product, one rounding
        t3 = np.array([npt(Fraction(float(a)) * Fraction(float(b))
                           + Fraction(float(c)))
                       for a, b, c in zip(pd3_6 * rsq, r, t2)], npt)
    else:
        t3 = t2 + pd3_6 * rsq * r
    half = Fraction(2) ** e
    out = []
    for a, b2, b3 in zip(t1, t2, t3):
        for b in (b2, b3):
            if fma:
                p = Fraction(float(a)) * Fraction(float(b))
            else:
                p = Fraction(float(npt(a) * npt(b)))
            if p > half:
                out.append(False)
                break
        else:
            out.append(True)
    return np.array(out)


def _kernel_terms(dt, u_grid):
    """r, rsq, u = pd*r, t1 (exp taken the allowed ulps high) and t2 in
    the dtype, as the kernel forms them from r = u/pd; t2 both separately
    rounded and as fma(pd2h, rsq, 1 + u)."""
    npt, ulps, _ = SKIP[dt]
    pd = npt(PD)
    r = (np.asarray(u_grid) / PD).astype(npt)
    rsq = r * r
    u = pd * r
    t1 = np.exp(-u)
    for _ in range(ulps):
        t1 = np.nextafter(t1, npt(1))
    pd2h = npt(0.5) * pd * pd
    t2_sep = (npt(1) + u) + pd2h * rsq
    t2_fma = np.array([npt(Fraction(float(a)) * Fraction(float(b))
                           + Fraction(float(c)))
                       for a, b, c in zip(pd2h * np.ones_like(rsq), rsq,
                                          npt(1) + u)], npt)
    return r, rsq, u, t1, t2_sep, t2_fma


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_skip_threshold_rounds_to_one(dt):
    thr = panel.EIND_SKIP_U[dt]
    grid = np.concatenate([thr + np.linspace(0, 4, 4001),
                           np.geomspace(thr + 4, 1e3, 500)])
    r, rsq, u, t1, t2_sep, t2_fma = _kernel_terms(dt, grid)
    beyond = u > SKIP[dt][0](thr)           # the kernel's test
    assert beyond.sum() >= len(grid) - 2
    for t2, fma in ((t2_sep, False), (t2_fma, True)):
        ok = _stays_one(dt, t1[beyond], t2[beyond], rsq[beyond], r[beyond],
                        fma)
        assert ok.all(), u[beyond][~ok][:5]


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_skip_threshold_margin(dt):
    """Below the threshold l differs from 1 somewhere: the last such u on
    a grid of step 0.01 lies within 2 of it (25.36 in float32, 47.27 in
    float64, with exp exact)."""
    thr = panel.EIND_SKIP_U[dt]
    grid = np.arange(thr - 3.0, thr, 0.01)
    r, rsq, u, t1, t2, _ = _kernel_terms(dt, grid)
    t1 = np.exp(-u)                          # exp exact, no ulps added
    ok = _stays_one(dt, t1, t2, rsq, r, False)
    assert not ok.all()
    last = grid[~ok].max()
    assert thr - 2.0 < last < thr, last
