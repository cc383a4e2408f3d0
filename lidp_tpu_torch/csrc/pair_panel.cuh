// The pair panel: dense LJ (+ coul/long) pair forces with half-weight
// evdwl/ecoul tallies and the 6-term virial, optionally fused with the
// unscaled Wolf static field E0 from the same geometry.  One kernel
// template serves pair_wolf_panel.cu (float, COUL, WOLF), pair_panel.cu
// (float, COUL or LJ only, no field), pair_panel_df.cu (double, COUL,
// with or without the field) and, with FORCE false, the whole panel of
// wolf_panel.cu (float, the field alone: no LJ or coulomb block, no type
// tables, no scalar partials and no reduce of them).
//
// The function, row by row as the TPU kernel states it (i != j, mask_j):
//   LJ for rsq < min(cutsq_u, cut_ljsq[ti,tj]) unless j is one of i's
//   special neighbours (excluded in-pass, _excl_mask pallas_panel.py:112);
//   COUL: prefactor*(erfc + EWALD_F g r e^{-g^2 r^2}) / r^2 for
//   rsq < min(cutsq_u, cut_coulsq), erfc by the reference's A&S polynomial
//   (also in the double kernel, never the library erfc);
//   WOLF: E0 += q_j (1/r^2 - 1/rc^2)/r d for rsq <= cut_coulsq between
//   different molecules (or mol_i == 0).  The caller scales E0 by
//   sqrt(qqrd2e).
// The TPU gathers per-row type tables outside the kernel and forms
// per-pair values with a one-hot MXU matmul; here the (T1 x T1) tables sit
// in shared memory and are indexed by (t_i, t_j).  The outer cutoff is the
// single cutsq_u = max(tabs[4]).  rsq is formed unfused (rsq_rn), so that
// kernel and plain version put every pair on the same side of a cutoff.
//
// Two kernels:
//  * pair_whole_kernel, the whole square panel (cols is None): each
//    unordered pair once, applied to both atoms, on the tile-pair schedule,
//    slots and slot-order sum of panel_common.cuh.  With d = mi(x_i - x_j)
//    (and mi(x_j - x_i) = -d exactly, see eind_panel.cuh), the LJ and
//    coulomb pair forces are F d and -F d with one F (the type tables are
//    symmetric: ops/panel.py checks them before it launches this kernel),
//    and the Wolf field w q_j d on i and -w q_i d on j with one w.  The
//    gates are not symmetric and stay so: side i takes a term where its
//    test passes and mask_j (and i is an atom, not the tile's padding),
//    side j where mask_i, so a masked atom (padding at the origin
//    included) still receives LJ, coulomb and the field from unmasked
//    atoms and gives none, as in the row form.  The special exclusion is
//    each side's own: side i drops LJ where j is in i's list, side j where
//    i is in j's (read from global memory, only for the pairs inside an LJ
//    cutoff).  The molecule test is symmetric.  evdwl and ecoul take e once
//    for each side whose gate is open, the virial d (x) (F_i - F_j), and
//    reduce_partials keeps the row form's half weights.  Every term is
//    selected after its product: two padding atoms at the origin have
//    rsq = 0.
//    The WT warps share the BT rows of tile I (RW per lane, in registers)
//    and each takes 32 columns of tile J, packed as (x, y, z, q) 16-byte
//    vectors, the molecule id and a flag word (type, mask, atom or
//    padding); lane l meets column (l + t) & 31 at step t and the column's
//    sums (force, field) travel with it, as in eind_whole_kernel.
//  * pair_strip_kernel, a row strip against all columns (cols=, row0=):
//    the one-sided row form, 8 lanes per row, the columns staged per CTA
//    in shared memory, the row's special list in registers.  At the whole
//    shape it is the yardstick of the whole-panel kernel.
//
// Exact skips in the whole kernel.  Every block acts only inside the
// outer radius (rsq < cutsq_u, or rsq <= cut_coulsq for the field), ~0.5%
// of the fluid's pairs, and outside it every term enters through a select
// as an exact zero, so skipping it gives the same bits (chip_smoke.py
// holds this with each skip off):
//  * a warp votes once per step on each group of PG rows (32 x PG pairs):
//    where no pair of the group is inside the outer radius on an open
//    side, the warp does only the geometry and the vote;
//  * a tile pair is dropped whole where neither tile holds an unmasked
//    atom, or where the gap between the two tiles' coordinate boxes, by
//    minimum image, exceeds the outer radius on some axis (a margin of
//    1e-3 of the radius, the box edge and the boxes' centres covers the
//    rounding of the pairs' own minimum images).  tile_box_kernel forms
//    the boxes (one CTA per tile), tile_cull_kernel a flag for each tile
//    pair and tile_list_kernel the list of the kept ones each call;
//    pair_whole_kernel's CTAs, one wave of them, take the list's items in
//    turn, so a dropped tile pair costs no CTA; it writes no slot and no
//    partials row, and the slot sum and reduce_kept_partials leave both
//    out by its flag.  Every kept tile
//    pair writes its own partials row, so the scalars are summed in the
//    same groups and order with the test or without it.
// `stats`, when not null, gains the count of votes, of the votes that
// skipped, and of the tile pairs dropped (integer atomics, for measurement
// only).
//
// No float atomics anywhere: the row sums of the WT warps are added in
// warp order, each atom's slots in slot order, and the tile pairs' scalar
// partials by reduce_kept_partials (the strip kernel's CTAs' by
// reduce_partials) in a fixed order, so results repeat bit for bit and do
// not depend on block order.
#pragma once

#include "panel_common.cuh"

namespace lidp {

constexpr int MAX_T1 = 16;   // type-table edge (types 0..15)

// atoms per tile of the whole-panel kernel (and threads per CTA: 32
// columns per warp, BT / 32 warps, BT / 32 rows per lane; the launchers
// export it as lidp_<name>_whole_tile), the CTAs per SM its register
// budget must allow, and the rows per warp vote, by dtype, and for the
// field alone (FORCE false) on its own
template <typename T>
struct PairTile;
template <>
struct PairTile<float> {
  static constexpr int BT = 128, MIN_CTAS = 4, PG = 2;
};
template <>
struct PairTile<double> {
  static constexpr int BT = 64, MIN_CTAS = 8, PG = 1;
};
template <typename T, bool FORCE>
struct WholeTile : PairTile<T> {};
// the field alone: 6 CTAs per SM hold its registers without a spill (on
// an H100, scripts/profile_torch_polar.py --path pair: 8 spilled 28 bytes
// and took 1.09x as long; tiles of 64 took 0.95x, with twice the partial
// buffer)
template <>
struct WholeTile<float, false> {
  static constexpr int BT = 128, MIN_CTAS = 6, PG = 2;
};

// the flag word: type in the low byte, the atom's mask, and whether the
// index is an atom at all (the last tile's rows past n are not)
constexpr int PF_TYPE = 0xff, PF_MASK = 0x100, PF_ATOM = 0x200;

template <typename T>
struct PCol {
  T x, y, z, q, mol;
  int fl;
};

// (the type is read only with FORCE: the field alone takes no types)
template <typename T, bool WOLF, bool FORCE>
__device__ __forceinline__ PCol<T> load_pcol(
    const T* __restrict__ x, const T* __restrict__ q,
    const T* __restrict__ typ, const T* __restrict__ mol,
    const T* __restrict__ m, int j, int n) {
  if (j >= n) return PCol<T>{};  // no atom: every gate closed
  return PCol<T>{x[3 * j], x[3 * j + 1], x[3 * j + 2], q[j],
                 WOLF ? mol[j] : T(0),
                 (FORCE ? to_int(typ[j]) : 0) |
                     (m[j] != T(0) ? PF_MASK : 0) | PF_ATOM};
}

// (x, y, z, q) as one float4 or two double2
template <typename T>
struct PVec;
template <>
struct PVec<float> {
  using type = float4;
  static constexpr int n = 1;
};
template <>
struct PVec<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ void put_pcol(float4 (*s)[32], float* smol,
                                         int* sfl, int c,
                                         const PCol<float>& v) {
  s[0][c] = make_float4(v.x, v.y, v.z, v.q);
  smol[c] = v.mol;
  sfl[c] = v.fl;
}
__device__ __forceinline__ void put_pcol(double2 (*s)[32], double* smol,
                                         int* sfl, int c,
                                         const PCol<double>& v) {
  s[0][c] = make_double2(v.x, v.y);
  s[1][c] = make_double2(v.z, v.q);
  smol[c] = v.mol;
  sfl[c] = v.fl;
}
__device__ __forceinline__ PCol<float> get_pcol(float4 (*s)[32],
                                                const float* smol,
                                                const int* sfl, int c) {
  const float4 p = s[0][c];
  return PCol<float>{p.x, p.y, p.z, p.w, smol[c], sfl[c]};
}
__device__ __forceinline__ PCol<double> get_pcol(double2 (*s)[32],
                                                 const double* smol,
                                                 const int* sfl, int c) {
  const double2 p = s[0][c], r = s[1][c];
  return PCol<double>{p.x, p.y, r.x, r.y, smol[c], sfl[c]};
}

// is `other` in owner's special list?
__device__ __forceinline__ bool listed(const int* __restrict__ sp, int S,
                                       int owner, int other) {
  if (S == 0) return false;
  const int* p = sp + static_cast<size_t>(owner) * S;
  bool hit = false;
  for (int s = 0; s < S; ++s) hit = hit || (__ldg(p + s) == other);
  return hit;
}

// The coordinate box of each tile's atoms (the rows past n are none):
// boxes (nT, 8) = lo x y z, hi x y z, 1 where the tile holds an unmasked
// atom (else 0), 0.  One CTA of BT threads per tile.
template <typename T, int BT>
__global__ void __launch_bounds__(BT)
tile_box_kernel(const T* __restrict__ x, const T* __restrict__ m, int n,
                T* __restrict__ boxes) {
  __shared__ T red[BT / 32][7];
  const int i = blockIdx.x * BT + threadIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool atom = i < n;
  T v[7];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[a] = atom ? x[3 * i + a] : T(1e30);
    v[3 + a] = atom ? x[3 * i + a] : T(-1e30);
  }
  v[6] = __any_sync(FULL, atom && m[i] != T(0)) ? T(1) : T(0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = min_(v[a], __shfl_xor_sync(FULL, v[a], off));
      v[3 + a] = max_(v[3 + a], __shfl_xor_sync(FULL, v[3 + a], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 7; ++a) red[w][a] = v[a];
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    const int a = threadIdx.x;
    T s = a < 7 ? red[0][a] : T(0);
    for (int u = 1; u < BT / 32 && a < 7; ++u)
      s = a < 3 ? min_(s, red[u][a]) : max_(s, red[u][a]);
    boxes[blockIdx.x * 8 + a] = s;
  }
}

// Can no pair of tiles with boxes bI, bJ take a term?  Neither tile holds
// an unmasked atom, or on some axis the gap between the boxes by minimum
// image exceeds the outer radius rc by the margin.
template <typename T>
__device__ __forceinline__ bool far_tiles(const T* __restrict__ bI,
                                          const T* __restrict__ bJ,
                                          const T (&L)[3], const T (&Li)[3],
                                          T rc) {
  if (bI[6] == T(0) && bJ[6] == T(0)) return true;
  bool far = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T cI = T(0.5) * (bI[a] + bI[3 + a]);
    const T cJ = T(0.5) * (bJ[a] + bJ[3 + a]);
    const T h = T(0.5) * ((bI[3 + a] - bI[a]) + (bJ[3 + a] - bJ[a]));
    const T gap = abs_(mi(cI - cJ, L[a], Li[a])) - h;
    const T margin = T(1e-3) * (rc + L[a] + abs_(cI) + abs_(cJ));
    far = far || gap > rc + margin;
  }
  return far;
}

// The outer cutoff max(tabs[4]) of the (5, t1, t1) tables, in every lane
// of the calling warp.
template <typename T>
__device__ __forceinline__ T outer_cutsq(const T* __restrict__ tabs, int t1) {
  const int nt2 = t1 * t1;
  T c = T(0);
  for (int e = threadIdx.x & 31; e < nt2; e += 32)
    c = max_(c, tabs[4 * nt2 + e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    c = max_(c, __shfl_xor_sync(FULL, c, off));
  return c;
}

constexpr int CULL_THREADS = 256;

// The tile-pair test, one thread per block b of the schedule: kept[b] = 1
// where its tile pair is kept (boxes null: every one), else 0.  The outer
// radius is sqrt(max(max(tabs[4]), field_cutsq)) (tabs null with t1 = 0:
// the field's alone).  A tile pair is dropped only where the gap exceeds
// the radius by the margin, so one that holds a pair at exactly the
// field's inclusive cutoff is kept.  stats[2], when stats is not null,
// gains the count of tile pairs dropped.
template <typename T>
__global__ void __launch_bounds__(CULL_THREADS)
tile_cull_kernel(const T* __restrict__ boxes, const T* __restrict__ tabs,
                 int t1, const T* __restrict__ Lp, T field_cutsq, int nT,
                 unsigned char* __restrict__ kept,
                 unsigned long long* stats) {
  const T rc = sqrt_(max_(outer_cutsq(tabs, t1), field_cutsq));
  const int b = blockIdx.x * CULL_THREADS + threadIdx.x;
  const int npairs = tile_pair_count(nT);
  bool drop = false;
  if (b < npairs) {
    if (boxes != nullptr) {
      const T L[3] = {Lp[0], Lp[1], Lp[2]};
      const T Li[3] = {T(1) / L[0], T(1) / L[1], T(1) / L[2]};
      const TilePair tp = tile_pair(b, nT);
      drop = far_tiles(boxes + 8 * tp.I, boxes + 8 * tp.J, L, Li, rc);
    }
    kept[b] = !drop;
  }
  if (stats != nullptr) {
    const unsigned bal = __ballot_sync(FULL, drop);
    if ((threadIdx.x & 31) == 0 && bal)
      atomicAdd(&stats[2], (unsigned long long)__popc(bal));
  }
}

constexpr int LIST_THREADS = 1024;

// list = [count, 0 (the work counter of pair_whole_kernel), the blocks b
// with kept[b], in increasing order].  One CTA: thread t takes the run of
// ceil(npairs / LIST_THREADS) blocks from t times that, counts its kept
// ones, and writes them at the exclusive sum of the counts before it.
__global__ void __launch_bounds__(LIST_THREADS)
tile_list_kernel(const unsigned char* __restrict__ kept, int npairs,
                 int* __restrict__ list) {
  __shared__ int wsum[LIST_THREADS / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int per = (npairs + LIST_THREADS - 1) / LIST_THREADS;
  const int b0 = threadIdx.x * per;
  const int b1 = b0 + per < npairs ? b0 + per : npairs;
  int cnt = 0;
#pragma unroll 4
  for (int b = b0; b < b1; ++b) cnt += kept[b];
  // exclusive scan of cnt over the CTA: within the warp, then the warps'
  // totals
  int inc = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += v;
  }
  if (lane == 31) wsum[w] = inc;
  __syncthreads();
  int pos = inc - cnt;
  for (int v = 0; v < w; ++v) pos += wsum[v];
  for (int b = b0; b < b1; ++b)
    if (kept[b]) list[2 + pos++] = b;
  if (threadIdx.x == LIST_THREADS - 1) {
    list[0] = pos;
    list[1] = 0;
  }
}

// The tile pairs of list (tile_list_kernel), each CTA taking the next item
// of it by an atomic counter until none is left: a dropped tile pair costs
// no CTA, and the dense tile pairs near the diagonal, first in the list,
// are spread over the first CTAs to start.  The outputs do not depend on
// which CTA takes an item.  x, q, typ (types in T), mol (WOLF only), m
// (mask) of the n atoms (n <= nT * BT; the rows past n are no atoms); sp
// (n, S) int32 special lists or null with S = 0; tabs (5, t1, t1); part
// (nT, nT + 1, 3 or 6, BT) and partials (nT (nT + 1) / 2, NACC) scratch: a
// kept tile pair of block b writes its two slots and partials row b, a
// dropped one nothing (the slot sum and reduce_kept_partials leave them
// out).  With FORCE false (WOLF true, COUL false) the kernel is the field
// alone: typ, sp and tabs are not read, the outer radius is cut_coulsq
// (inclusive), r^-2 is rinv * rinv as in the row form, the slots hold
// the field (part (nT, nT + 1, 3, BT)) and nothing is written to
// partials.
template <typename T, bool COUL, bool WOLF, bool FORCE = true>
__global__ void __launch_bounds__(WholeTile<T, FORCE>::BT,
                                  WholeTile<T, FORCE>::MIN_CTAS)
pair_whole_kernel(const T* __restrict__ x, const T* __restrict__ q,
                  const T* __restrict__ typ, const T* __restrict__ mol,
                  const T* __restrict__ m, const int* __restrict__ sp,
                  int S, int n, const T* __restrict__ tabs, int t1,
                  const T* __restrict__ Lp, T cut_coulsq, T qqrd2e,
                  T g_ewald, int skip, int* __restrict__ list, int nT,
                  T* __restrict__ part, T* __restrict__ partials,
                  unsigned long long* stats) {
  // A&S erfc constants (pair_lj_cut_coul_long_polarization.cpp:43-49)
  const T EWALD_F = T(1.12837917), EWALD_P = T(0.3275911);
  const T A1 = T(0.254829592), A2 = T(-0.284496736), A3 = T(1.421413741);
  const T A4 = T(-1.453152027), A5 = T(1.061405429);
  constexpr int BT = WholeTile<T, FORCE>::BT, WT = BT / 32, RW = BT / 32;
  constexpr int PG = WholeTile<T, FORCE>::PG;
  // the slots' components: force (FORCE), then the field (WOLF)
  constexpr int NC = (FORCE ? 3 : 0) + (WOLF ? 3 : 0), FO = FORCE ? 3 : 0;
  static_assert(BT % 32 == 0 && RW % PG == 0, "a tile of whole vote groups");
  static_assert(FORCE || (WOLF && !COUL), "the field alone is WOLF only");
  using V = typename PVec<T>::type;
  __shared__ V scol[WT][PVec<T>::n][32];
  __shared__ T smol[WT][32];
  __shared__ int sfl[WT][32];
  __shared__ T srow[WT][NC][BT];
  __shared__ T tab[FORCE ? 4 : 1][FORCE ? MAX_T1 * MAX_T1 : 1];
  __shared__ int sitem;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = 32 * w;  // this warp's columns within tile J
  const int nt2 = t1 * t1;
  const T cutsq_u = FORCE ? outer_cutsq(tabs, t1) : T(0);
  const T L[3] = {Lp[0], Lp[1], Lp[2]};
  const T Li[3] = {T(1) / L[0], T(1) / L[1], T(1) / L[2]};
  const T f_shift = T(-1) / cut_coulsq;
  if constexpr (FORCE)
    for (int e = threadIdx.x; e < 4 * nt2; e += BT)
      tab[e / nt2][e % nt2] = tabs[e];
  unsigned nvote = 0, nskip = 0;
  const int count = list[0];
  for (;;) {
    // every thread has read the last item (it did so before the syncs of
    // the last item's body)
    if (threadIdx.x == 0) sitem = atomicAdd(&list[1], 1);
    __syncthreads();
    const int item = sitem;
    if (item >= count) break;
    {
      const int b = list[2 + item];
      const TilePair tp = tile_pair(b, nT);
      const int I = tp.I, J = tp.J, k = tp.k;
      put_pcol(scol[w], smol[w], sfl[w], lane,
               load_pcol<T, WOLF, FORCE>(x, q, typ, mol, m,
                                         J * BT + c0 + lane, n));
      T xi[RW], yi[RW], zi[RW], qi[RW], moli[RW];
      int fli[RW];
      T fx[RW], fy[RW], fz[RW], ex[RW], ey[RW], ez[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const PCol<T> ci = load_pcol<T, WOLF, FORCE>(
            x, q, typ, mol, m, I * BT + lane + 32 * r, n);
        xi[r] = ci.x, yi[r] = ci.y, zi[r] = ci.z, qi[r] = ci.q;
        moli[r] = ci.mol, fli[r] = ci.fl;
        fx[r] = fy[r] = fz[r] = ex[r] = ey[r] = ez[r] = T(0);
      }
      // the tables (first item), this item's columns, and the row sums of
      // the last one read
      __syncthreads();

      const bool diag = k == 0;
      T acc[NACC] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
      // the sums of column c0 + (lane + t) & 31: force, and field
      T cx = T(0), cy = T(0), cz = T(0), gx = T(0), gy = T(0), gz = T(0);
      for (int t = 0; t < 32; ++t) {
        const int c = (lane + t) & 31;
        const PCol<T> cj = get_pcol(scol[w], smol[w], sfl[w], c);
        const bool mj = cj.fl & PF_MASK, aj = cj.fl & PF_ATOM;
        const int tj = cj.fl & PF_TYPE, gj = J * BT + c0 + c;
#pragma unroll
        for (int g = 0; g < RW; g += PG) {
          T dx[PG], dy[PG], dz[PG], rsq[PG];
          bool oi[PG], oj[PG];
          bool any = false;
#pragma unroll
          for (int h = 0; h < PG; ++h) {
            const int r = g + h;
            dx[h] = mi(xi[r] - cj.x, L[0], Li[0]);
            dy[h] = mi(yi[r] - cj.y, L[1], Li[1]);
            dz[h] = mi(zi[r] - cj.z, L[2], Li[2]);
            rsq[h] = rsq_rn(dx[h], dy[h], dz[h]);
            const bool ok = !diag || lane + 32 * r < c0 + c;
            oi[h] = ok && mj && (fli[r] & PF_ATOM);
            oj[h] = ok && (fli[r] & PF_MASK) && aj;
            const bool near =
                rsq[h] < cutsq_u || (WOLF && rsq[h] <= cut_coulsq);
            any = any || ((oi[h] || oj[h]) && near);
          }
          if (skip) {
            any = __any_sync(FULL, any);
            ++nvote;
            nskip += !any;
          } else {
            any = true;
          }
          if (!any) continue;
#pragma unroll
          for (int h = 0; h < PG; ++h) {
            const int r = g + h;
            T rinv = T(0);
            if (COUL || WOLF) rinv = rsqrt_(rsq[h]);
            // r^-2: the division where LJ needs it, else as the field's
            // row form forms it
            const T r2inv = FORCE ? T(1) / rsq[h] : rinv * rinv;
            if constexpr (FORCE) {
              const int ij = (fli[r] & PF_TYPE) * t1 + tj;
              const bool inr = rsq[h] < cutsq_u;
              const bool lj = inr && rsq[h] < tab[3][ij];
              bool lji = lj && oi[h], ljj = lj && oj[h];
              const int gi = I * BT + lane + 32 * r;
              if (lji) lji = !listed(sp, S, gi, gj);
              if (ljj) ljj = !listed(sp, S, gj, gi);
              const T r6inv = r2inv * r2inv * r2inv;
              const T lj3 = tab[0][ij], lj4 = tab[1][ij];
              const T forcelj = r6inv * (T(12) * lj3 * r6inv - T(6) * lj4);
              const T evdwl = r6inv * (lj3 * r6inv - lj4) - tab[2][ij];
              T fpi = lji ? forcelj : T(0), fpj = ljj ? forcelj : T(0);
              bool ci = false, cjj = false;
              if (COUL) {
                const bool coul = inr && rsq[h] < cut_coulsq;
                ci = coul && oi[h], cjj = coul && oj[h];
                const T rr = rsq[h] * rinv;
                const T grij = g_ewald * rr;
                const T expm2 = exp_(-grij * grij);
                const T tt = T(1) / (T(1) + EWALD_P * grij);
                const T erfc =
                    tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) *
                    expm2;
                const T prefactor = qqrd2e * qi[r] * cj.q * rinv;
                const T forcecoul =
                    prefactor * (erfc + EWALD_F * grij * expm2);
                const T ecoul = prefactor * erfc;
                fpi = (ci ? forcecoul : T(0)) + fpi;
                fpj = (cjj ? forcecoul : T(0)) + fpj;
                acc[1] += (ci ? ecoul : T(0)) + (cjj ? ecoul : T(0));
              }
              // selected after the product: r2inv is not finite at rsq = 0
              fpi = (ci || lji) ? fpi * r2inv : T(0);
              fpj = (cjj || ljj) ? fpj * r2inv : T(0);
              acc[0] += (lji ? evdwl : T(0)) + (ljj ? evdwl : T(0));
              const T pxi = fpi * dx[h], pyi = fpi * dy[h], pzi = fpi * dz[h];
              const T pxj = fpj * dx[h], pyj = fpj * dy[h], pzj = fpj * dz[h];
              fx[r] += pxi, fy[r] += pyi, fz[r] += pzi;
              cx -= pxj, cy -= pyj, cz -= pzj;
              const T Dx = pxi + pxj, Dy = pyi + pyj, Dz = pzi + pzj;
              acc[2] += dx[h] * Dx;
              acc[3] += dy[h] * Dy;
              acc[4] += dz[h] * Dz;
              acc[5] += dx[h] * Dy;
              acc[6] += dx[h] * Dz;
              acc[7] += dy[h] * Dz;
            }
            if (WOLF) {
              const bool wolf = rsq[h] <= cut_coulsq &&
                                (moli[r] != cj.mol || moli[r] == T(0));
              const T wv = (r2inv + f_shift) * rinv;
              const T efi = (wolf && oi[h] ? wv : T(0)) * cj.q;
              const T efj = (wolf && oj[h] ? wv : T(0)) * qi[r];
              ex[r] += efi * dx[h], ey[r] += efi * dy[h];
              ez[r] += efi * dz[h];
              gx -= efj * dx[h], gy -= efj * dy[h], gz -= efj * dz[h];
            }
          }
        }
        // column c's sums go to the lane that meets it at step t + 1
        const int src = (lane + 1) & 31;
        if (FORCE) {
          cx = __shfl_sync(FULL, cx, src);
          cy = __shfl_sync(FULL, cy, src);
          cz = __shfl_sync(FULL, cz, src);
        }
        if (WOLF) {
          gx = __shfl_sync(FULL, gx, src);
          gy = __shfl_sync(FULL, gy, src);
          gz = __shfl_sync(FULL, gz, src);
        }
      }

      T* pc = slot_ptr<BT, T, NC>(part, J, col_slot(k, nT), nT) + c0 + lane;
      if (FORCE) {
        pc[0] = cx;
        pc[BT] = cy;
        pc[2 * BT] = cz;
      }
      if (WOLF) {
        pc[FO * BT] = gx;
        pc[(FO + 1) * BT] = gy;
        pc[(FO + 2) * BT] = gz;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (FORCE) {
          srow[w][0][lane + 32 * r] = fx[r];
          srow[w][1][lane + 32 * r] = fy[r];
          srow[w][2][lane + 32 * r] = fz[r];
        }
        if (WOLF) {
          srow[w][FO][lane + 32 * r] = ex[r];
          srow[w][FO + 1][lane + 32 * r] = ey[r];
          srow[w][FO + 2][lane + 32 * r] = ez[r];
        }
      }
      __syncthreads();
      T* pr = slot_ptr<BT, T, NC>(part, I, k, nT);
      for (int e = threadIdx.x; e < NC * BT; e += BT) {
        const int comp = e / BT, row = e % BT;
        T s = srow[0][comp][row];
#pragma unroll
        for (int v = 1; v < WT; ++v) s += srow[v][comp][row];
        pr[e] = s;
      }
      if constexpr (FORCE)
        block_partials_row<T, BT>(acc, partials + (size_t)b * NACC);
    }
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(&stats[0], (unsigned long long)nvote);
    atomicAdd(&stats[1], (unsigned long long)nskip);
  }
}

// acc[k] = scale_k * the sum of partials[b, k] over the blocks b with
// kept[b], in double, scale_0 = s0, scale_k = s1 for k > 0; the order of
// reduce_partials with KRED_GROUPS groups (a dropped block adds nothing,
// as its zero would: the same bits).  One CTA.
constexpr int KRED_GROUPS = 128;

template <typename T>
__global__ void __launch_bounds__(NACC * KRED_GROUPS)
reduce_kept_partials(const T* __restrict__ partials,
                     const unsigned char* __restrict__ kept, int nblocks,
                     T s0, T s1, T* __restrict__ acc) {
  __shared__ double part[KRED_GROUPS][NACC];
  const int k = threadIdx.x % NACC, g = threadIdx.x / NACC;
  double s = 0.0;
#pragma unroll 4
  for (int b = g; b < nblocks; b += KRED_GROUPS)
    if (kept[b]) s += partials[(size_t)b * NACC + k];
  part[g][k] = s;
  __syncthreads();
  if (threadIdx.x < NACC) {
    double t = 0.0;
    for (int h = 0; h < KRED_GROUPS; ++h) t += part[h][k];
    acc[k] = static_cast<T>((k == 0 ? s0 : s1) * t);
  }
}

// CTAs of pair_whole_kernel resident on the device at once: its grid
// (one wave; each CTA takes items of the list until none is left).
// Queried once.
template <typename T, bool COUL, bool WOLF, bool FORCE>
int pair_whole_ctas() {
  static const int ctas = [] {
    int dev = 0, sms = 0, per = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, pair_whole_kernel<T, COUL, WOLF, FORCE>,
            WholeTile<T, FORCE>::BT, 0) !=
            cudaSuccess)
      return 0;
    return sms * per;
  }();
  return ctas;
}

// The whole panel of n atoms: x (n,3), q, typ, mol (WOLF only), m, sp
// (n, S), tabs (5, t1, t1), L (3,) on the device; boxes (nT, 8), part
// (nT, nT + 1, 3 or 6, BT), partials (nT (nT + 1) / 2, 8), kept (nT (nT
// + 1) / 2 bytes) and list (nT (nT + 1) / 2 + 2 ints) scratch with nT =
// ceil(n / BT); f, e0 (WOLF only)
// (n,3); acc (8,) = [evdwl ecoul vxx vyy vzz vxy vxz vyz], each
// half-weight.  skip = 0 turns the warp skip off, cull = 0 the tile-pair
// test (no box pass, every tile pair kept).  With FORCE false only x, q,
// mol, m, L, cut_coulsq, the tile-pair scratch, part (nT, nT + 1, 3, BT)
// and e0 are read or written (typ, sp, tabs, partials, f and acc may be
// null, t1 0).
template <typename T, bool COUL, bool WOLF, bool FORCE = true>
int launch_pair_whole(const T* x, const T* q, const T* typ, const T* mol,
                      const T* m, const int* sp, int S, int n, const T* tabs,
                      int t1, const T* L, T cut_coulsq, T qqrd2e, T g_ewald,
                      int skip, int cull, int nT, T* boxes, T* part,
                      T* partials, unsigned char* kept, int* list, T* f,
                      T* e0, T* acc, unsigned long long* stats,
                      void* stream) {
  constexpr int BT = WholeTile<T, FORCE>::BT;
  constexpr int NC = (FORCE ? 3 : 0) + (WOLF ? 3 : 0);
  if (nT != (n + BT - 1) / BT || (FORCE && (t1 < 1 || t1 > MAX_T1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = pair_whole_ctas<T, COUL, WOLF, FORCE>();
  if (ctas < 1) {  // the occupancy query failed: launch nothing, say so
    const int err = static_cast<int>(cudaGetLastError());
    return err ? err : static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cull) {
    tile_box_kernel<T, BT><<<nT, BT, 0, s>>>(x, m, n, boxes);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  const int npairs = tile_pair_count(nT);
  tile_cull_kernel<T><<<(npairs + CULL_THREADS - 1) / CULL_THREADS,
                         CULL_THREADS, 0, s>>>(
      cull ? boxes : nullptr, tabs, t1, L, WOLF ? cut_coulsq : T(0), nT,
      kept, stats);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  tile_list_kernel<<<1, LIST_THREADS, 0, s>>>(kept, npairs, list);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  pair_whole_kernel<T, COUL, WOLF, FORCE>
      <<<npairs < ctas ? npairs : ctas, BT, 0, s>>>(
          x, q, typ, mol, m, sp, S, n, tabs, t1, L, cut_coulsq, qqrd2e,
          g_ewald, skip, list, nT, part, partials, stats);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // the first three components to f, the field's to e0 (the field alone:
  // its three to e0)
  slot_sum_kernel<T, BT, false, NC>
      <<<dim3(nT, NC), BT, (nT + 1) * sizeof(int), s>>>(
          part, n, nT, FORCE ? f : e0, FORCE ? e0 : nullptr, kept);
  err = static_cast<int>(cudaGetLastError());
  if (err || !FORCE) return err;
  reduce_kept_partials<T><<<1, NACC * KRED_GROUPS, 0, s>>>(
      partials, kept, npairs, T(0.5), T(0.5), acc);
  return static_cast<int>(cudaGetLastError());
}

// The strip form (the row form of the TPU kernel): LANES threads per row,
// ROWS rows per CTA, the CTA loops over all columns in TILE-wide tiles
// staged in shared memory; the row's special list (MAXS slots) in
// registers.
template <typename T, int MAXS, bool COUL, bool WOLF>
__global__ void __launch_bounds__(THREADS)
pair_strip_kernel(const T* __restrict__ xr, const T* __restrict__ qr,
                  const T* __restrict__ tr, const T* __restrict__ molr,
                  const int* __restrict__ sp, int S, int nrows, int row0,
                  const T* __restrict__ xc, const T* __restrict__ qc,
                  const T* __restrict__ tc, const T* __restrict__ molc,
                  const T* __restrict__ mc, int npad,
                  const T* __restrict__ tabs, int t1,
                  const T* __restrict__ Lp, T cut_coulsq, T qqrd2e,
                  T g_ewald, T* __restrict__ f, T* __restrict__ e0,
                  T* __restrict__ partials) {
  // A&S erfc constants (pair_lj_cut_coul_long_polarization.cpp:43-49)
  const T EWALD_F = T(1.12837917), EWALD_P = T(0.3275911);
  const T A1 = T(0.254829592), A2 = T(-0.284496736), A3 = T(1.421413741);
  const T A4 = T(-1.453152027), A5 = T(1.061405429);
  __shared__ T sx[TILE], sy[TILE], sz[TILE], sq[TILE], smol[TILE];
  __shared__ T smask[TILE];
  __shared__ int st[TILE];
  __shared__ T tab[5][MAX_T1 * MAX_T1];
  const int nt2 = t1 * t1;
  for (int k = threadIdx.x; k < 5 * nt2; k += THREADS)
    tab[k / nt2][k % nt2] = tabs[k];

  const int lane = threadIdx.x % LANES;
  const int i = blockIdx.x * ROWS + threadIdx.x / LANES;
  const bool valid = i < nrows;
  const int ic = valid ? i : nrows - 1;
  const T Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const T Lix = T(1) / Lx, Liy = T(1) / Ly, Liz = T(1) / Lz;
  const T xi = xr[3 * ic], yi = xr[3 * ic + 1], zi = xr[3 * ic + 2];
  const T qi = qr[ic];
  T moli = T(0);
  if (WOLF) moli = molr[ic];
  const int ti = to_int(tr[ic]);
  const int gi = row0 + i;
  int spi[MAXS > 0 ? MAXS : 1];
#pragma unroll
  for (int s = 0; s < MAXS; ++s) spi[s] = s < S ? sp[ic * S + s] : -1;
  const T f_shift = T(-1) / cut_coulsq;
  const T qq_i = qqrd2e * qi;

  __syncthreads();
  T cutsq_u = T(0);
  for (int k = 0; k < nt2; ++k) cutsq_u = max_(cutsq_u, tab[4][k]);
  const T* lj3r = &tab[0][ti * t1];
  const T* lj4r = &tab[1][ti * t1];
  const T* offr = &tab[2][ti * t1];
  const T* cljr = &tab[3][ti * t1];

  T fx = T(0), fy = T(0), fz = T(0), ex = T(0), ey = T(0), ez = T(0);
  T acc[NACC] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};

  for (int j0 = 0; j0 < npad; j0 += TILE) {
    const int nt = min(TILE, npad - j0);
    __syncthreads();
    if (threadIdx.x < nt) {
      const int j = j0 + threadIdx.x;
      sx[threadIdx.x] = xc[3 * j];
      sy[threadIdx.x] = xc[3 * j + 1];
      sz[threadIdx.x] = xc[3 * j + 2];
      sq[threadIdx.x] = qc[j];
      if (WOLF) smol[threadIdx.x] = molc[j];
      smask[threadIdx.x] = mc[j];
      st[threadIdx.x] = to_int(tc[j]);
    }
    __syncthreads();
    for (int t = lane; t < nt; t += LANES) {
      const int gj = j0 + t;
      const T dx = mi(xi - sx[t], Lx, Lix);
      const T dy = mi(yi - sy[t], Ly, Liy);
      const T dz = mi(zi - sz[t], Lz, Liz);
      const bool pm = (gi != gj) && (smask[t] != T(0));
      const T rsq = pm ? dx * dx + dy * dy + dz * dz : T(1);
      const bool in_range = pm && (rsq < cutsq_u);
      const int tj = st[t];
      bool lj_mask = in_range && (rsq < cljr[tj]);
#pragma unroll
      for (int s = 0; s < MAXS; ++s) lj_mask = lj_mask && (spi[s] != gj);
      const T r2inv = T(1) / rsq;
      const T r6inv = r2inv * r2inv * r2inv;
      const T lj3 = lj3r[tj], lj4 = lj4r[tj];
      const T forcelj =
          lj_mask ? r6inv * (T(12) * lj3 * r6inv - T(6) * lj4) : T(0);
      const T evdwl = lj_mask ? r6inv * (lj3 * r6inv - lj4) - offr[tj] : T(0);
      T rinv = T(0), forcecoul = T(0), ecoul = T(0);
      if (COUL || WOLF) rinv = rsqrt_(rsq);
      if (COUL) {
        const bool coul_mask = in_range && (rsq < cut_coulsq);
        const T r = rsq * rinv;
        const T grij = g_ewald * r;
        const T expm2 = exp_(-grij * grij);
        const T tt = T(1) / (T(1) + EWALD_P * grij);
        const T erfc =
            tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) * expm2;
        const T prefactor = qq_i * sq[t] * rinv;
        forcecoul =
            coul_mask ? prefactor * (erfc + EWALD_F * grij * expm2) : T(0);
        ecoul = coul_mask ? prefactor * erfc : T(0);
      }
      const T fpair = (forcecoul + forcelj) * r2inv;
      const T px = fpair * dx, py = fpair * dy, pz = fpair * dz;
      fx += px;
      fy += py;
      fz += pz;
      acc[0] += evdwl;
      acc[1] += ecoul;
      acc[2] += px * dx;
      acc[3] += py * dy;
      acc[4] += pz * dz;
      acc[5] += px * dy;
      acc[6] += px * dz;
      acc[7] += py * dz;
      if (WOLF) {
        const T molj = smol[t];
        const bool winc = pm && (rsq <= cut_coulsq) &&
                          ((moli != molj) || (moli == T(0)));
        const T efq = (winc ? (r2inv + f_shift) * rinv : T(0)) * sq[t];
        ex += efq * dx;
        ey += efq * dy;
        ez += efq * dz;
      }
    }
  }
  fx = row_sum(fx);
  fy = row_sum(fy);
  fz = row_sum(fz);
  if (WOLF) {
    ex = row_sum(ex);
    ey = row_sum(ey);
    ez = row_sum(ez);
  }
  if (valid && lane == 0) {
    f[3 * i] = fx;
    f[3 * i + 1] = fy;
    f[3 * i + 2] = fz;
    if (WOLF) {
      e0[3 * i] = ex;
      e0[3 * i + 1] = ey;
      e0[3 * i + 2] = ez;
    }
  }
  if (!valid) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = T(0);
  }
  block_partials(acc, partials);
}

// Rows: xr (nrows,3), qr, tr (types in T), molr (nrows, WOLF only); sp
// (nrows,S) int32 special-neighbour indices or null with S = 0.  Columns:
// xc (npad,3), qc, tc, molc (WOLF only), mc (npad).  tabs (5,t1,t1) =
// [lj3 lj4 offset cut_ljsq cutsq].  Outputs f, e0 (WOLF only) (nrows,3);
// partials (nblocks,8) scratch; acc (8,) = [evdwl ecoul vxx vyy vzz vxy vxz
// vyz], each half-weight.
template <typename T, bool COUL, bool WOLF>
int launch_pair_strip(const T* xr, const T* qr, const T* tr, const T* molr,
                      const int* sp, int S, int nrows, int row0,
                      const T* xc, const T* qc, const T* tc, const T* molc,
                      const T* mc, int npad, const T* tabs, int t1,
                      const T* L, T cut_coulsq, T qqrd2e, T g_ewald, T* f,
                      T* e0, T* partials, T* acc, void* stream) {
  const int nb = nblocks_for(nrows);
  const dim3 grid(nb), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LIDP_PAIR(MAXS)                                                    \
  pair_strip_kernel<T, MAXS, COUL, WOLF><<<grid, block, 0, s>>>(           \
      xr, qr, tr, molr, sp, S, nrows, row0, xc, qc, tc, molc, mc, npad,    \
      tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, e0, partials)
  if (S == 0)
    LIDP_PAIR(0);
  else if (S <= 8)
    LIDP_PAIR(8);
  else
    LIDP_PAIR(16);
#undef LIDP_PAIR
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_partials<T><<<1, REDUCE_THREADS, 0, s>>>(partials, nb, T(0.5),
                                                  T(0.5), acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lidp
