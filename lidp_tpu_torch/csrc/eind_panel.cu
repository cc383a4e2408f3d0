// eind_panel: E_ind = -T.mu with Thole exponential damping.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:194 eind_panel
// (_eind_kernel :144).  Per pair (i != j, alpha_i != 0, alpha_j != 0):
//   E_i -= -3 l2 r^-5 (mu_j . d) d + l1 r^-3 mu_j,   d = mi(x_i - x_j).
// The rows' dipoles are never read (the contraction consumes column
// dipoles only), so the row operand is x and alpha_eff alone.
//
// Bound on the H100: FP32 CUDA-core arithmetic.  The Pallas CostEstimate
// counts 45 flops per pair (plus one exp and one rsqrt on the SFU); at the
// slice's 12,288 x 12,288 panel that is 6.8 GFLOP, 0.10 ms at the 67 TFLOP/s
// FP32 peak, against 0.3 MB of operands.  The design keeps every per-pair
// value in registers, reads each column from L2 once per CTA through a
// shared-memory tile, and gives each row 8 lanes so ~24 warps per SM are
// resident to hide the SFU and FMA latencies.  Masks are selects, not
// branches, exactly as the TPU kernel applies them.
#include "panel_common.cuh"

namespace lidp {

template <int DAMP>
__global__ void __launch_bounds__(THREADS)
eind_kernel(const float* __restrict__ xr, const float* __restrict__ ar,
            int nrows, int row0, const float* __restrict__ xc,
            const float* __restrict__ ac, const float* __restrict__ muc,
            int npad, const float* __restrict__ Lp, float pd,
            float* __restrict__ out) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sa[TILE];
  __shared__ float smx[TILE], smy[TILE], smz[TILE];
  const int lane = threadIdx.x % LANES;
  const int i = blockIdx.x * ROWS + threadIdx.x / LANES;
  const int ic = i < nrows ? i : nrows - 1;
  const float Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const float Lix = 1.f / Lx, Liy = 1.f / Ly, Liz = 1.f / Lz;
  const float xi = xr[3 * ic], yi = xr[3 * ic + 1], zi = xr[3 * ic + 2];
  const float ai = ar[ic];
  const int gi = row0 + i;
  const float pd2h = 0.5f * pd * pd, pd3_6 = pd * pd * pd / 6.f;
  float ex = 0.f, ey = 0.f, ez = 0.f;

  for (int j0 = 0; j0 < npad; j0 += TILE) {
    const int nt = min(TILE, npad - j0);
    __syncthreads();
    if (threadIdx.x < nt) {
      const int j = j0 + threadIdx.x;
      sx[threadIdx.x] = xc[3 * j];
      sy[threadIdx.x] = xc[3 * j + 1];
      sz[threadIdx.x] = xc[3 * j + 2];
      sa[threadIdx.x] = ac[j];
      smx[threadIdx.x] = muc[3 * j];
      smy[threadIdx.x] = muc[3 * j + 1];
      smz[threadIdx.x] = muc[3 * j + 2];
    }
    __syncthreads();
    for (int t = lane; t < nt; t += LANES) {
      const float dx = mi(xi - sx[t], Lx, Lix);
      const float dy = mi(yi - sy[t], Ly, Liy);
      const float dz = mi(zi - sz[t], Lz, Liz);
      const bool pm = (gi != j0 + t) && (sa[t] != 0.f) && (ai != 0.f);
      const float rsq = pm ? dx * dx + dy * dy + dz * dz : 1.f;
      const float rinv = rsqrtf(rsq);
      const float r = rsq * rinv;
      const float r2inv = rinv * rinv;
      const float r3inv = r2inv * rinv;
      const float r5inv = r3inv * r2inv;
      float l1 = 1.f, l2 = 1.f;
      if (DAMP == 1) {
        const float t1 = expf(-pd * r);
        const float t2 = 1.f + pd * r + pd2h * rsq;
        l1 = 1.f - t1 * t2;
        l2 = 1.f - t1 * (t2 + pd3_6 * rsq * r);
      }
      const float mjx = smx[t], mjy = smy[t], mjz = smz[t];
      const float mdotd = mjx * dx + mjy * dy + mjz * dz;
      const float a1 = pm ? -3.f * (l2 * r5inv) * mdotd : 0.f;
      const float a2 = pm ? l1 * r3inv : 0.f;
      ex += a1 * dx + a2 * mjx;
      ey += a1 * dy + a2 * mjy;
      ez += a1 * dz + a2 * mjz;
    }
  }
  ex = row_sum(ex);
  ey = row_sum(ey);
  ez = row_sum(ez);
  if (i < nrows && lane == 0) {
    out[3 * i] = -ex;
    out[3 * i + 1] = -ey;
    out[3 * i + 2] = -ez;
  }
}

}  // namespace lidp

// xr (nrows,3), ar (nrows): the row strip; xc (npad,3), ac (npad),
// muc (npad,3): the columns; L (3,) on the device; out (nrows,3).
extern "C" int lidp_eind_panel(const float* xr, const float* ar, int nrows,
                               int row0, const float* xc, const float* ac,
                               const float* muc, int npad, const float* L,
                               float pd, int damping_type, float* out,
                               void* stream) {
  const dim3 grid(lidp::nblocks_for(nrows)), block(lidp::THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (damping_type == 1)
    lidp::eind_kernel<1><<<grid, block, 0, s>>>(xr, ar, nrows, row0, xc, ac,
                                                muc, npad, L, pd, out);
  else
    lidp::eind_kernel<0><<<grid, block, 0, s>>>(xr, ar, nrows, row0, xc, ac,
                                                muc, npad, L, pd, out);
  return static_cast<int>(cudaGetLastError());
}
