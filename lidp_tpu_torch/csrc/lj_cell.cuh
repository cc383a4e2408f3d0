// Single-type LJ forces on the cell-slot grid: the device code shared by
// slot_lj_forces.cu (state in slot order, empty slots hold sentinels) and
// cell_pair_forces_lj.cu (state in atom order, gathered through
// atom_of_slot and scattered straight to f[atom]).  The two differ only in
// how a slot's coordinates are loaded and where its force is stored, so the
// kernel is a template on that addressing.
//
// Design, replacing the TPU kernels' sequential grid and neighbour-side
// partial grids (lidp_tpu/ops/pallas_pair.py _lj_kernel_v3, _lj_kernel):
//
//  * Full 27-cell stencil.  A CTA computes only the forces on the slots of
//    its own cells: every pair is evaluated from both sides, so there is no
//    neighbour-side partial to scatter, one output grid, no atomics, and
//    repeated launches are bit-identical.  Energy and virial are summed at
//    half weight.  This doubles the pair arithmetic of the Newton half
//    stencil; the kernel is bound by FP32 arithmetic (25 flops per candidate
//    pair against 24 bytes per slot), and the half stencil with per-offset
//    partial grids is the alternative a later tuning pass can measure.
//  * A CTA owns up to ZC consecutive z-cells of one (ix, iy) column.  Its 27
//    neighbour cells per own cell are 9 contiguous z-runs of the grid
//    (ZC + 2 cells each, halo included), staged once in shared memory as
//    x/y/z arrays.
//  * The periodic image is a shift of +-L by cell index (not a minimum
//    image: with 3 bins in a dimension the +1 and -1 neighbours are
//    different cells and both can wrap), added in the pair loop.  For the 13
//    offsets of the Newton half stencil it is added to the neighbour, for the
//    13 opposite ones subtracted from the row: a pair across the periodic
//    face then rounds the same float32 sum x_j + L from both sides, its two
//    evaluations are exactly opposite (Newton's third law holds to the last
//    bit) and equal to the one a half stencil makes.
//  * LANES adjacent threads share a row (one slot) and stride the 27*cap
//    candidates; the row's sums stay in registers, are combined by shuffles
//    and written once.  cap need not be a multiple of 32.
//  * Empty slots carry far-apart sentinel coordinates, so no validity mask
//    is read in the pair loop: every pair with a sentinel fails
//    rsq < cutsq.  Rows that are sentinels themselves (x >= sent_floor) are
//    skipped and get zero force.
//  * Per-CTA energy/virial partials go to a (gridDim.x, 8) buffer that
//    reduce_partials sums in block order in double (panel_common.cuh).
//
// Needs >= 3 bins in every dimension (a cell must not appear twice in its
// own neighbourhood).
#pragma once

#include "panel_common.cuh"

namespace lidp {

constexpr int ZC = 4;                           // own z-cells per CTA
constexpr int NRUN = 9;                         // (ox, oy) columns
constexpr int CENTER_RUN = 4;                   // ox = oy = 0
constexpr int PASS_ROWS = THREADS / LANES;      // rows per pass: 32
constexpr float ATOM_SENTINEL = 1.0e15f;        // kernel-made sentinels

// par (8 floats on the device): lj3 lj4 offset cutsq Lx Ly Lz sent_floor
constexpr int NPAR = 8;

// Slot order: three grids of nslots floats, element stride `stride`, empty
// slots holding the caller's sentinels (x >= par[7]); forces for every slot
// to out[3 * slot + d].
struct SlotOrder {
  const float* gx;
  const float* gy;
  const float* gz;
  int stride;
  float* out;

  __device__ __forceinline__ void load(long slot, int, float& x, float& y,
                                       float& z) const {
    x = gx[slot * stride];
    y = gy[slot * stride];
    z = gz[slot * stride];
  }
  __device__ __forceinline__ float sent_floor(const float* par) const {
    return par[7];
  }
  __device__ __forceinline__ void store(long slot, float fx, float fy,
                                        float fz) const {
    out[3 * slot] = fx;
    out[3 * slot + 1] = fy;
    out[3 * slot + 2] = fz;
  }
};

// Atom order: x (n,3), atom_of_slot (nslots) with n for an empty slot, mask
// (n) bytes; forces of live, unmasked atoms to out[3 * atom + d] (each live
// slot is one atom, so no two threads write one address).  Empty slots get
// sentinels made from their staging index.
struct AtomOrder {
  const float* x;
  const int* aos;
  const unsigned char* mask;
  int n;
  float* out;

  __device__ __forceinline__ void load(long slot, int sidx, float& px,
                                       float& py, float& pz) const {
    const int a = aos[slot];
    if (a < n) {
      px = x[3 * a];
      py = x[3 * a + 1];
      pz = x[3 * a + 2];
    } else {
      px = ATOM_SENTINEL * static_cast<float>(1 + sidx);
      py = 0.f;
      pz = 0.f;
    }
  }
  __device__ __forceinline__ float sent_floor(const float*) const {
    return ATOM_SENTINEL;
  }
  __device__ __forceinline__ void store(long slot, float fx, float fy,
                                        float fz) const {
    const int a = aos[slot];
    if (a < n && mask[a]) {
      out[3 * a] = fx;
      out[3 * a + 1] = fy;
      out[3 * a + 2] = fz;
    }
  }
};

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

// one candidate pair at separation (dx, dy, dz): its force on the row and,
// with EV, its energy and virial terms.  rsq is formed with every product
// and sum rounded on its own, not contracted into fused multiply-adds: the
// lj/cut force does not vanish at the cutoff (0.039 at 2.5 sigma), so a pair
// within one rounding of it must fall on the same side here as in the plain
// version, which rounds each step.  Among 2e9 candidate pairs a few do lie
// that close.
template <bool EV>
__device__ __forceinline__ void lj_pair(float dx, float dy, float dz,
                                        bool not_self, const LJCoeffs& c,
                                        float& fx, float& fy, float& fz,
                                        float (&ev)[NACC]) {
  const float rsq0 = __fadd_rn(
      __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  const bool ok = (rsq0 < c.cutsq) && not_self;
  const float rsq = ok ? rsq0 : 1.f;
  const float r2inv = 1.f / rsq;
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

template <bool EV, typename Addr>
__global__ void __launch_bounds__(THREADS)
lj_cell_kernel(Addr io, int nbx, int nby, int nbz, int cap,
               const float* __restrict__ par, float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int runlen = (ZC + 2) * cap;       // staged slots per z-run
  const int nstage = NRUN * runlen;
  float* sx = smem;
  float* sy = smem + nstage;
  float* sz = smem + 2 * nstage;

  const int nzc = (nbz + ZC - 1) / ZC;
  const int zchunk = blockIdx.x % nzc;
  const int col = blockIdx.x / nzc;
  const int iy = col % nby, ix = col / nby;
  const int z0 = zchunk * ZC;
  const int nz = min(ZC, nbz - z0);        // own cells of this CTA

  const LJCoeffs c{12.f * par[0], 6.f * par[1], par[0], par[1], par[2],
                   par[3]};
  const float Lx = par[4], Ly = par[5], Lz = par[6];
  const float floor_x = io.sent_floor(par);

  // stage the 9 z-runs as they are stored; the periodic shifts are added
  // in the pair loop, where it is known which atom of the pair takes them
  for (int t = threadIdx.x; t < nstage; t += THREADS) {
    const int run = t / runlen;
    const int rem = t - run * runlen;
    const int zz = rem / cap;
    if (zz > nz + 1) continue;             // past this CTA's halo: never read
    const int s = rem - zz * cap;
    const int cx = wrap_cell(ix + run / 3 - 1, nbx);
    const int cy = wrap_cell(iy + run % 3 - 1, nby);
    const int cz = wrap_cell(z0 - 1 + zz, nbz);
    const long slot = (static_cast<long>(cx * nby + cy) * nbz + cz) * cap + s;
    io.load(slot, t, sx[t], sy[t], sz[t]);
  }
  __syncthreads();

  const int lane = threadIdx.x % LANES;
  const int rsub = threadIdx.x / LANES;
  const int nrows = nz * cap;
  const long slot0 = (static_cast<long>(ix * nby + iy) * nbz + z0) * cap;
  float ev[NACC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int r0 = 0; r0 < nrows; r0 += PASS_ROWS) {
    const int r = r0 + rsub;
    const bool in_range = r < nrows;
    const int zc = in_range ? r / cap : 0;
    const int own = CENTER_RUN * runlen + cap + (in_range ? r : 0);
    const float xi = sx[own], yi = sy[own], zi = sz[own];
    float fx = 0.f, fy = 0.f, fz = 0.f;
    if (in_range && xi < floor_x) {
      // does this row's cell see a wrapped cell below or above it?
      const bool zedge = z0 + zc == 0 || z0 + zc == nbz - 1;
      for (int run = 0; run < NRUN; ++run) {
        const int ox = run / 3 - 1, oy = run % 3 - 1;
        const float shx = wrap_shift(ix + ox, nbx, Lx);
        const float shy = wrap_shift(iy + oy, nby, Ly);
        if (shx == 0.f && shy == 0.f && !zedge) {
          // no periodic face between the row and this run: its 3*cap
          // candidates are contiguous and taken as they are
          const int base = run * runlen + zc * cap;
          for (int j = lane; j < 3 * cap; j += LANES) {
            const int idx = base + j;
            lj_pair<EV>(xi - sx[idx], yi - sy[idx], zi - sz[idx], idx != own,
                        c, fx, fy, fz, ev);
          }
          continue;
        }
        for (int zo = 0; zo < 3; ++zo) {
          const int zz = zc + zo;          // staged cell; offset oz = zo - 1
          const float shz = wrap_shift(z0 - 1 + zz, nbz, Lz);
          // The shift goes to the neighbour (x_j + L) for the 13 offsets of
          // the Newton half stencil and to the row itself for the 13
          // opposite ones, so that both evaluations of a pair round the
          // same sum and give exactly opposite forces, the ones a half
          // stencil would tally once.
          const bool half = ox > 0 || (ox == 0 && (oy > 0 ||
                                                   (oy == 0 && zo >= 1)));
          const float xr = half ? xi : xi - shx, ax = half ? shx : 0.f;
          const float yr = half ? yi : yi - shy, ay = half ? shy : 0.f;
          const float zr = half ? zi : zi - shz, az = half ? shz : 0.f;
          const int base = run * runlen + zz * cap;
          for (int j = lane; j < cap; j += LANES) {
            const int idx = base + j;
            lj_pair<EV>(xr - (sx[idx] + ax), yr - (sy[idx] + ay),
                        zr - (sz[idx] + az), idx != own, c, fx, fy, fz, ev);
          }
        }
      }
    }
    fx = row_sum(fx);
    fy = row_sum(fy);
    fz = row_sum(fz);
    if (in_range && lane == 0) io.store(slot0 + r, fx, fy, fz);
  }
  if (EV) block_partials(ev, partials);
}

inline size_t lj_cell_smem(int cap) {
  return sizeof(float) * 3 * NRUN * (ZC + 2) * cap;
}

// Launch on `stream`; with need_ev the second stage leaves evdwl in acc[0],
// the virial (xx yy zz xy xz yz) in acc[1..6] and 0 in acc[7], all at half
// weight of the two-sided sums.  Without it acc is not written.
template <typename Addr>
int launch_lj_cell(const Addr& io, int nbx, int nby, int nbz, int cap,
                   const float* par, int need_ev, float* partials,
                   float* acc, void* stream) {
  if (nbx < 3 || nby < 3 || nbz < 3 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = nbx * nby * ((nbz + ZC - 1) / ZC);
  const size_t smem = lj_cell_smem(cap);
  auto kern = need_ev ? lj_cell_kernel<true, Addr>
                      : lj_cell_kernel<false, Addr>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<nblocks, THREADS, smem, st>>>(io, nbx, nby, nbz, cap, par, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !need_ev) return static_cast<int>(e);
  reduce_partials<float><<<1, 32, 0, st>>>(partials, nblocks, 0.5f, 0.5f, acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lidp
