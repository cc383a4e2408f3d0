// Single-type LJ forces on the cell-slot grid: the device code shared by
// slot_lj_forces.cu (state in slot order, empty slots hold sentinels) and
// cell_pair_forces_lj.cu (state in atom order, gathered through
// atom_of_slot; the forces come out in slot order and atom_gather_kernel
// takes each atom's through slot_of_atom).  The two differ only in how a
// slot is loaded (and whether it holds an atom), so the kernel is a
// template on that addressing.
//
// Design, replacing the TPU kernels' sequential grid and neighbour-side
// partial grids (lidp_tpu/ops/pallas_pair.py _lj_kernel_v3, _lj_kernel):
//
//  * Full 27-cell stencil.  A CTA computes only the forces on the atoms of
//    its own cells: every pair is evaluated from both sides, so there is no
//    neighbour-side partial to scatter, one output grid, no atomics, and
//    repeated launches are bit-identical.  Energy and virial are summed at
//    half weight.
//  * A CTA owns a tile of TX x TY columns of ZC consecutive z-cells (fewer
//    at the grid's faces).  It stages the (TX + 2) x (TY + 2) columns
//    around them, ZC + 2 cells each, halo included, once in shared memory:
//    each own cell's 27 neighbours are 3 consecutive cells in each of 9 of
//    them.  The wide tile, 2 x 2 columns of 4 z-cells, stages 6 cells per
//    own cell where one column stages 13.5, and gives the CTA ~90 row
//    groups at the melt's density, so that passes of 32 teams leave few
//    idle.  Its shared memory holds caps up to 141; a larger cap takes the
//    narrow tile, one cell with its 27 neighbours, up to a cap of 522.
//  * Live slots only.  A warp stages one column at a time: per 32 slots of
//    a cell a ballot of which hold an atom, and each live one goes to its
//    rank among the column's live slots, in slot order (x, y, z packed in a
//    float4).  So the 3 consecutive z-cells that a row meets stay one
//    contiguous range, and the pair loop reads no empty slot and needs no
//    sentinel.  The live slots need not be a prefix of their cell.  Each
//    staged cell's offset in its column is kept in shared memory, and for
//    the own columns each compacted row's slot, for the store.  Shared
//    memory stays sized for full cells.
//  * Rows blocked in registers.  The live rows of each own cell are cut
//    into groups of R; a team of LANES threads takes a group, holds its R
//    rows in registers and strides the cell's live candidates (9 columns
//    x 3 z-cells), each candidate read from shared memory once for R rows.
//    A warp's teams take consecutive groups in the same pass and walk the
//    9 columns together, so they stay converged.  A row's sums over the
//    team are combined by shuffles in a fixed order and written once.
//    Empty own slots get no row (their zero force is written while
//    staging); a group's padding rows repeat its first row with their
//    pairs masked off.
//  * The periodic image is a shift of +-L by cell index (not a minimum
//    image: with 3 bins in a dimension the +1 and -1 neighbours are
//    different cells and both can wrap).  For the 13 offsets of the Newton
//    half stencil it is added to the neighbour, for the 13 opposite ones
//    subtracted from the row: a pair across the periodic face then rounds
//    the same float32 sum x_j + L from both sides, its two evaluations are
//    exactly opposite (Newton's third law holds to the last bit) and equal
//    to the one a half stencil makes.  The shift is uniform over a run's 3
//    cells unless the row's cell is at a z face, where the 3 cells are
//    taken one by one.
//  * The reciprocal is rcp.approx.ftz (one MUFU op; rsq is a normal number
//    well above the subnormal range for every pair that counts).  rsq
//    itself is formed unfused (lj_pair says why).
//  * Per-CTA energy/virial partials go to a (gridDim.x, 8) buffer that
//    reduce_partials sums in a fixed order in double (panel_common.cuh).
//
// Bound on the H100: FP32 issue.  The pair loop issues 21 instructions per
// row and live candidate (the cutoff test, the force selected away where
// it fails, the masks) for every ordered pair, where the function's least
// arithmetic (chip_smoke.py cell_bound_ms) tests each unordered pair once
// and computes the force only inside the cutoff, a tenth of the pairs.
//
// Needs >= 3 bins in every dimension (a cell must not appear twice in its
// own neighbourhood).
#pragma once

#include "panel_common.cuh"

namespace lidp {

constexpr int ZC = 4;                           // the wide tile's own
constexpr int LJ_TX = 2, LJ_TY = 2;             // z-cells and columns
constexpr int LJ_R = 4;                         // rows per thread
constexpr int LJ_LANES = 8;                     // threads per row group
constexpr int LJ_THREADS = 256;                 // threads per CTA
// CTAs per SM at least, for the kernel without energy and virial in slot
// order (80 registers); the others need more registers than that to run
// without spilling and take 2
constexpr int LJ_MINB = 3;
constexpr int LJ_TEAMS = LJ_THREADS / LJ_LANES;
constexpr int LJ_WARPS = LJ_THREADS / 32;
constexpr int NRUN = 9;                         // (ox, oy) columns
constexpr int CENTER_RUN = 4;                   // ox = oy = 0

// A CTA's own cells: TX x TY columns of ZC z-cells.
template <int TX_, int TY_, int ZC_>
struct LJTile {
  static constexpr int TX = TX_, TY = TY_, ZC = ZC_;
  static constexpr int SCY = TY + 2;            // staged columns along y
  static constexpr int NSC = (TX + 2) * SCY;    // staged columns
  static constexpr int NOWN = TX * TY * ZC;     // own cells per CTA

  // dynamic shared memory: a float4 per staged slot, an int per slot of an
  // own column
  static size_t smem(int cap) {
    return (sizeof(float4) * NSC + sizeof(int) * TX * TY) * (ZC + 2) * cap;
  }
  static int blocks(int nbx, int nby, int nbz) {
    return ((nbx + TX - 1) / TX) * ((nby + TY - 1) / TY) *
           ((nbz + ZC - 1) / ZC);
  }
};
using LJWide = LJTile<LJ_TX, LJ_TY, ZC>;
using LJNarrow = LJTile<1, 1, 1>;

// par (8 floats on the device): lj3 lj4 offset cutsq Lx Ly Lz sent_floor
constexpr int NPAR = 8;

// Slot order: three grids of nslots floats, element stride `stride`, empty
// slots holding the caller's sentinels (x >= par[7]); forces for every slot
// to out[3 * slot + d], zero on an empty one.
struct SlotOrder {
  static constexpr bool kSlots = true;
  const float* gx;
  const float* gy;
  const float* gz;
  int stride;
  float* out;

  __device__ __forceinline__ bool load(long slot, float floor_x, float& x,
                                       float& y, float& z) const {
    x = gx[slot * stride];
    y = gy[slot * stride];
    z = gz[slot * stride];
    return x < floor_x;
  }
  __device__ __forceinline__ void store(long slot, float fx, float fy,
                                        float fz) const {
    out[3 * slot] = fx;
    out[3 * slot + 1] = fy;
    out[3 * slot + 2] = fz;
  }
  __device__ __forceinline__ void clear(long slot) const {
    store(slot, 0.f, 0.f, 0.f);
  }
};

// Atom order: x (n,3), atom_of_slot (nslots) with n for an empty slot,
// par[7] unused; forces for every slot to out[3 * slot + d], zero on an
// empty one, as in slot order: atom_gather_kernel then gives each atom the
// force of its slot.
struct AtomOrder {
  static constexpr bool kSlots = false;
  const float* x;
  const int* aos;
  int n;
  float* out;

  __device__ __forceinline__ bool load(long slot, float, float& px,
                                       float& py, float& pz) const {
    const int a = aos[slot];
    if (a >= n) return false;
    px = x[3 * a];
    py = x[3 * a + 1];
    pz = x[3 * a + 2];
    return true;
  }
  __device__ __forceinline__ void store(long slot, float fx, float fy,
                                        float fz) const {
    out[3 * slot] = fx;
    out[3 * slot + 1] = fy;
    out[3 * slot + 2] = fz;
  }
  __device__ __forceinline__ void clear(long slot) const {
    store(slot, 0.f, 0.f, 0.f);
  }
};

// f (n,3): each atom's force is that of the slot slot_of_atom names,
// clamped to the grid, and zero where mask is 0 -- the gather of the JAX
// function (pallas_pair.py cell_pair_forces_pallas) and of the plain
// version.  An atom that found no slot in an overflowing grid shares its
// cell's last slot there, and so takes that slot's force.  One thread per
// component.
__global__ void atom_gather_kernel(const float* __restrict__ fs,
                                   const int* __restrict__ soa,
                                   const unsigned char* __restrict__ mask,
                                   int n, long nslots, float* __restrict__ f) {
  const long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= 3L * n) return;
  const int a = static_cast<int>(e / 3), d = static_cast<int>(e % 3);
  const long s = soa[a] < nslots ? soa[a] : nslots - 1;
  f[e] = mask[a] ? fs[3 * s + d] : 0.f;
}

// cell index c of a neighbour, possibly one step outside [0, nb): the cell
// it wraps to, and the box length its atoms are carried across
__device__ __forceinline__ int wrap_cell(int c, int nb) {
  return c >= nb ? c - nb : (c < 0 ? c + nb : c);
}
__device__ __forceinline__ float wrap_shift(int c, int nb, float L) {
  return c >= nb ? L : (c < 0 ? -L : 0.f);
}

struct LJCoeffs {
  float lj1, lj2, lj3, lj4, off, cutsq;   // lj1 = 12 lj3, lj2 = 6 lj4
};

__device__ __forceinline__ float lj_rcp(float v) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}

// one candidate pair at separation (dx, dy, dz): its force on the row and,
// with EV, its energy and virial terms; `use` masks off a padding row and
// the row itself.  rsq is formed with every product and sum rounded on its
// own, not contracted into fused multiply-adds: the lj/cut force does not
// vanish at the cutoff (0.039 at 2.5 sigma), so a pair within one rounding
// of it must fall on the same side here as in the plain version, which
// rounds each step.  Among 2e9 candidate pairs a few do lie that close.
// Where the pair fails the test its terms are selected away, so the
// reciprocal of any rsq (0 for the row itself) is harmless.
template <bool EV>
__device__ __forceinline__ void lj_pair(float dx, float dy, float dz,
                                        bool use, const LJCoeffs& c,
                                        float& fx, float& fy, float& fz,
                                        float (&ev)[NACC]) {
  const float rsq = __fadd_rn(
      __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  const bool ok = (rsq < c.cutsq) && use;
  const float r2inv = lj_rcp(rsq);
  const float r6inv = r2inv * r2inv * r2inv;
  const float fpair = ok ? r6inv * (c.lj1 * r6inv - c.lj2) * r2inv : 0.f;
  const float px = fpair * dx, py = fpair * dy, pz = fpair * dz;
  fx += px;
  fy += py;
  fz += pz;
  if (EV) {
    ev[0] += ok ? r6inv * (c.lj3 * r6inv - c.lj4) - c.off : 0.f;
    ev[1] += px * dx;
    ev[2] += py * dy;
    ev[3] += pz * dz;
    ev[4] += px * dy;
    ev[5] += px * dz;
    ev[6] += py * dz;
  }
}

// R rows against the staged candidates [j0, j1), strided by the team's
// lanes.  SHIFT adds (ax, ay, az) to every candidate (the rows come with
// their own shift already subtracted); SELF masks the pair of row r with
// its own staged entry, row0 + r.
template <bool EV, bool SELF, bool SHIFT>
__device__ __forceinline__ void lj_rows(
    const float4* __restrict__ cand, int j0, int j1, int lane,
    const float (&xr)[LJ_R], const float (&yr)[LJ_R],
    const float (&zr)[LJ_R], const bool (&rv)[LJ_R],
    int row0, float ax, float ay, float az,
    const LJCoeffs& c, float (&fx)[LJ_R], float (&fy)[LJ_R],
    float (&fz)[LJ_R], float (&ev)[NACC]) {
  for (int j = j0 + lane; j < j1; j += LJ_LANES) {
    float4 q = cand[j];
    if (SHIFT) {
      q.x += ax;
      q.y += ay;
      q.z += az;
    }
#pragma unroll
    for (int r = 0; r < LJ_R; ++r)
      lj_pair<EV>(xr[r] - q.x, yr[r] - q.y, zr[r] - q.z,
                  rv[r] && (!SELF || j != row0 + r), c, fx[r], fy[r], fz[r],
                  ev);
  }
}

// sum over the LJ_LANES threads of one team; its lane 0 holds the total
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int off = LJ_LANES / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(FULL, v, off, LJ_LANES);
  return v;
}

// One run of a row group: the rows' own cell k of the CTA (staged cell
// k + 1), its 3 neighbour cells k .. k + 2 in `run`.
template <bool EV>
__device__ __forceinline__ void lj_run(
    const float4* __restrict__ cand, const int* off, int run, int k,
    bool zedge, int lane, int ix, int iy, int z0, int nbx, int nby, int nbz,
    float Lx, float Ly, float Lz, const float (&xi)[LJ_R],
    const float (&yi)[LJ_R], const float (&zi)[LJ_R],
    const bool (&rv)[LJ_R], int row0, const LJCoeffs& c,
    float (&fx)[LJ_R], float (&fy)[LJ_R], float (&fz)[LJ_R],
    float (&ev)[NACC]) {
  const int ox = run / 3 - 1, oy = run % 3 - 1;
  const float shx = wrap_shift(ix + ox, nbx, Lx);
  const float shy = wrap_shift(iy + oy, nby, Ly);
  if (!zedge) {
    // one range over the run's 3 cells; the shift (if any) is the run's,
    // and only ox and oy decide the half stencil
    const int j0 = off[k], j1 = off[k + 3];
    if (run == CENTER_RUN) {
      lj_rows<EV, true, false>(cand, j0, j1, lane, xi, yi, zi, rv, row0, 0.f,
                               0.f, 0.f, c, fx, fy, fz, ev);
    } else if (shx == 0.f && shy == 0.f) {
      lj_rows<EV, false, false>(cand, j0, j1, lane, xi, yi, zi, rv, row0,
                                0.f, 0.f, 0.f, c, fx, fy, fz, ev);
    } else {
      const bool half = ox > 0 || (ox == 0 && oy > 0);
      float xr[LJ_R], yr[LJ_R];
#pragma unroll
      for (int r = 0; r < LJ_R; ++r) {
        xr[r] = half ? xi[r] : xi[r] - shx;
        yr[r] = half ? yi[r] : yi[r] - shy;
      }
      lj_rows<EV, false, true>(cand, j0, j1, lane, xr, yr, zi, rv, row0,
                               half ? shx : 0.f, half ? shy : 0.f, 0.f, c, fx,
                               fy, fz, ev);
    }
    return;
  }
  for (int zo = 0; zo < 3; ++zo) {
    const int zz = k + zo;                    // staged cell; oz = zo - 1
    const float shz = wrap_shift(z0 - 1 + zz, nbz, Lz);
    // The shift goes to the neighbour (x_j + L) for the 13 offsets of the
    // Newton half stencil and to the row itself for the 13 opposite ones,
    // so that both evaluations of a pair round the same sum and give
    // exactly opposite forces, the ones a half stencil would tally once.
    const bool half = ox > 0 || (ox == 0 && (oy > 0 || (oy == 0 && zo >= 1)));
    float xr[LJ_R], yr[LJ_R], zr[LJ_R];
#pragma unroll
    for (int r = 0; r < LJ_R; ++r) {
      xr[r] = half ? xi[r] : xi[r] - shx;
      yr[r] = half ? yi[r] : yi[r] - shy;
      zr[r] = half ? zi[r] : zi[r] - shz;
    }
    const float ax = half ? shx : 0.f, ay = half ? shy : 0.f;
    const float az = half ? shz : 0.f;
    if (run == CENTER_RUN && zo == 1)
      lj_rows<EV, true, true>(cand, off[zz], off[zz + 1], lane, xr, yr, zr,
                              rv, row0, ax, ay, az, c, fx, fy, fz, ev);
    else
      lj_rows<EV, false, true>(cand, off[zz], off[zz + 1], lane, xr, yr, zr,
                               rv, row0, ax, ay, az, c, fx, fy, fz, ev);
  }
}

template <bool EV, typename Addr, typename Tile>
__global__ void __launch_bounds__(LJ_THREADS,
                                  EV || !Addr::kSlots ? 2 : LJ_MINB)
lj_cell_kernel(Addr io, int nbx, int nby, int nbz, int cap,
               const float* __restrict__ par, float* __restrict__ partials) {
  constexpr int TX = Tile::TX, TY = Tile::TY, ZC = Tile::ZC;
  constexpr int SCY = Tile::SCY, NSC = Tile::NSC, NOWN = Tile::NOWN;
  extern __shared__ float4 spos[];            // NSC columns of runlen slots
  __shared__ int soff[NSC][ZC + 3];           // live offset of staged cell
  __shared__ int sgrp[NOWN + 1];              // row groups before own cell
  const int runlen = (ZC + 2) * cap;          // staged slots per column
  int* sslot = reinterpret_cast<int*>(spos + NSC * runlen);

  const int nzc = (nbz + ZC - 1) / ZC, nty_t = (nby + TY - 1) / TY;
  const int zchunk = blockIdx.x % nzc;
  const int tile = blockIdx.x / nzc;
  const int x0 = tile / nty_t * TX, y0 = tile % nty_t * TY;
  const int ntx = min(TX, nbx - x0), nty = min(TY, nby - y0);
  const int z0 = zchunk * ZC;
  const int nz = min(ZC, nbz - z0);           // own cells of each column
  const float floor_x = par[7];

  // stage each column's live slots, compacted in slot order (column
  // (sx, sy) of the (ntx + 2) x (nty + 2) staged ones holds the grid's
  // column (x0 - 1 + sx, y0 - 1 + sy), wrapped); the periodic shifts are
  // added in the pair loop, where it is known which atom of a pair takes
  // them
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int sc = warp; sc < (ntx + 2) * (nty + 2); sc += LJ_WARPS) {
    const int sx = sc / (nty + 2), sy = sc - sx * (nty + 2);
    const int col = sx * SCY + sy;
    const int cx = wrap_cell(x0 - 1 + sx, nbx);
    const int cy = wrap_cell(y0 - 1 + sy, nby);
    const int oc = sx >= 1 && sx <= ntx && sy >= 1 && sy <= nty
                       ? (sx - 1) * TY + sy - 1 : -1;  // own column
    float4* dst = spos + col * runlen;
    int cnt = 0;
    for (int zz = 0; zz < nz + 2; ++zz) {
      if (wl == 0) soff[col][zz] = cnt;
      const int cz = wrap_cell(z0 - 1 + zz, nbz);
      const long cbase = (static_cast<long>(cx * nby + cy) * nbz + cz) * cap;
      const bool own = oc >= 0 && zz >= 1 && zz <= nz;
      for (int s0 = 0; s0 < cap; s0 += 32) {
        const int s = s0 + wl;
        float x = 0.f, y = 0.f, z = 0.f;
        const bool live = s < cap && io.load(cbase + s, floor_x, x, y, z);
        const unsigned b = __ballot_sync(FULL, live);
        if (live) {
          const int pos = cnt + __popc(b & ((1u << wl) - 1u));
          dst[pos] = make_float4(x, y, z, 0.f);
          if (oc >= 0) sslot[oc * runlen + pos] = (zz - 1) * cap + s;
        } else if (own && s < cap) {
          io.clear(cbase + s);                // an empty own slot
        }
        cnt += __popc(b);
      }
    }
    if (wl == 0) soff[col][nz + 2] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // row groups of LJ_R live rows, per own cell q = oc * ZC + k
    int g = 0;
    for (int q = 0; q < NOWN; ++q) {
      sgrp[q] = g;
      const int oc = q / ZC, k = q - oc * ZC;
      const int sx = oc / TY + 1, sy = oc % TY + 1;
      if (sx <= ntx && sy <= nty && k < nz) {
        const int* off = soff[sx * SCY + sy];
        g += (off[k + 2] - off[k + 1] + LJ_R - 1) / LJ_R;
      }
    }
    sgrp[NOWN] = g;
  }
  __syncthreads();

  const LJCoeffs c{12.f * par[0], 6.f * par[1], par[0], par[1], par[2],
                   par[3]};
  const float Lx = par[4], Ly = par[5], Lz = par[6];
  const int team = threadIdx.x / LJ_LANES, lane = threadIdx.x % LJ_LANES;
  const int ngroups = sgrp[NOWN];
  float ev[NACC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  // every thread takes the same number of passes, so the team shuffles
  // below run with the whole warp; a warp's teams take consecutive groups,
  // mostly of one own cell, and walk its runs together
  for (int g0 = 0; g0 < ngroups; g0 += LJ_TEAMS) {
    const int grp = g0 + team;
    const bool active = grp < ngroups;
    int q = 0;                                // the group's own cell
    while (q + 1 < NOWN && sgrp[q + 1] <= grp) ++q;
    const int oc = q / ZC, k = q - oc * ZC;
    const int sx = oc / TY + 1, sy = oc % TY + 1;
    const int ocol = sx * SCY + sy;
    const int row0 = soff[ocol][k + 1] + (grp - sgrp[q]) * LJ_R;
    const int rend = soff[ocol][k + 2];
    float xi[LJ_R], yi[LJ_R], zi[LJ_R], fx[LJ_R], fy[LJ_R], fz[LJ_R];
    bool rv[LJ_R];
#pragma unroll
    for (int r = 0; r < LJ_R; ++r) {
      rv[r] = active && row0 + r < rend;
      const float4 p =
          spos[ocol * runlen + (active ? (rv[r] ? row0 + r : row0) : 0)];
      xi[r] = p.x;
      yi[r] = p.y;
      zi[r] = p.z;
      fx[r] = fy[r] = fz[r] = 0.f;
    }
    const int ix = x0 + sx - 1, iy = y0 + sy - 1;
    if (active) {
      // does the rows' cell see a wrapped cell below or above it?
      const bool zedge = z0 + k == 0 || z0 + k == nbz - 1;
      for (int run = 0; run < NRUN; ++run) {
        const int col = (sx + run / 3 - 1) * SCY + sy + run % 3 - 1;
        lj_run<EV>(spos + col * runlen, soff[col], run, k, zedge, lane, ix,
                   iy, z0, nbx, nby, nbz, Lx, Ly, Lz, xi, yi, zi, rv, row0, c,
                   fx, fy, fz, ev);
      }
    }
    const long slot0 = (static_cast<long>(ix * nby + iy) * nbz + z0) * cap;
#pragma unroll
    for (int r = 0; r < LJ_R; ++r) {
      const float sxf = team_sum(fx[r]);
      const float syf = team_sum(fy[r]);
      const float szf = team_sum(fz[r]);
      if (rv[r] && lane == 0)
        io.store(slot0 + sslot[oc * runlen + row0 + r], sxf, syf, szf);
    }
  }
  if (EV) block_partials<float, LJ_THREADS>(ev, partials);
}

// The largest dynamic shared memory the kernel's CTA may take on the
// current device: the opt-in limit less its static arrays, the smaller over
// need_ev on and off, so that both take the same tile.  Queried once.
template <typename Addr, typename Tile>
size_t lj_smem_limit() {
  static const size_t limit = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes a0{}, a1{};
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncGetAttributes(&a0, lj_cell_kernel<false, Addr, Tile>) !=
            cudaSuccess ||
        cudaFuncGetAttributes(&a1, lj_cell_kernel<true, Addr, Tile>) !=
            cudaSuccess)
      return size_t(0);
    const size_t st = a0.sharedSizeBytes > a1.sharedSizeBytes
                          ? a0.sharedSizeBytes : a1.sharedSizeBytes;
    return static_cast<size_t>(optin) > st ? optin - st : size_t(0);
  }();
  return limit;
}

// The tile a grid of this cap takes: 1 wide, 2 narrow, 0 when it fits
// neither's shared memory.
template <typename Addr>
int lj_cell_tile(int cap) {
  if (LJWide::smem(cap) <= lj_smem_limit<Addr, LJWide>()) return 1;
  if (LJNarrow::smem(cap) <= lj_smem_limit<Addr, LJNarrow>()) return 2;
  return 0;
}

// The tile of a launch on this grid (lj_cell_tile) and its CTAs, which
// are the partials' rows with need_ev; both 0 when the cap fits no tile,
// and then the launch fails with cudaErrorInvalidValue.  Returns a CUDA
// error code.
template <typename Addr>
int lj_cell_dims(int nbx, int nby, int nbz, int cap, int* tile,
                 int* nblocks) {
  *tile = *nblocks = 0;
  if (nbx < 3 || nby < 3 || nbz < 3 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  *tile = lj_cell_tile<Addr>(cap);
  if (*tile == 1) *nblocks = LJWide::blocks(nbx, nby, nbz);
  if (*tile == 2) *nblocks = LJNarrow::blocks(nbx, nby, nbz);
  return static_cast<int>(cudaGetLastError());
}

template <typename Addr, typename Tile>
int launch_lj_tile(const Addr& io, int nbx, int nby, int nbz, int cap,
                   const float* par, int need_ev, float* partials,
                   float* acc, cudaStream_t st) {
  const int nblocks = Tile::blocks(nbx, nby, nbz);
  const size_t smem = Tile::smem(cap);
  auto kern = need_ev ? lj_cell_kernel<true, Addr, Tile>
                      : lj_cell_kernel<false, Addr, Tile>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<nblocks, LJ_THREADS, smem, st>>>(io, nbx, nby, nbz, cap, par,
                                          partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !need_ev) return static_cast<int>(e);
  reduce_partials<float><<<1, REDUCE_THREADS, 0, st>>>(partials, nblocks,
                                                       0.5f, 0.5f, acc);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream` with the tile of lj_cell_tile; with need_ev the
// second stage leaves evdwl in acc[0], the virial (xx yy zz xy xz yz) in
// acc[1..6] and 0 in acc[7], all at half weight of the two-sided sums, and
// partials has lj_cell_dims' rows.  Without it acc is not written.
template <typename Addr>
int launch_lj_cell(const Addr& io, int nbx, int nby, int nbz, int cap,
                   const float* par, int need_ev, float* partials,
                   float* acc, void* stream) {
  int tile = 0, nblocks = 0;
  const int e = lj_cell_dims<Addr>(nbx, nby, nbz, cap, &tile, &nblocks);
  if (e != 0) return e;
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 1)
    return launch_lj_tile<Addr, LJWide>(io, nbx, nby, nbz, cap, par,
                                        need_ev, partials, acc, st);
  return launch_lj_tile<Addr, LJNarrow>(io, nbx, nby, nbz, cap, par, need_ev,
                                        partials, acc, st);
}

}  // namespace lidp
