// slot_lj_forces: single-type LJ forces purely in cell-slot space, float32
// (the kernel is in lj_cell.cuh).  In: three (nbx,nby,nbz,cap) coordinate
// grids whose empty slots hold the sentinels base + spacing*k in x and 0 in
// y and z.  Out: the force on every slot (zero on empty ones), and with
// need_ev the LJ energy and the 6-term virial.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_pair.py:314 slot_lj_forces
// (_lj_kernel_v3 :150).
//
// Bound on the H100: FP32 CUDA-core arithmetic.  By the TPU kernel's own
// count, nbx*nby*nbz*cap*cap*14*25 flops (the Newton half stencil): 0.745
// GFLOP on the (11,11,11,40) grid of the 32,000-atom melt, 0.011 ms at the
// 67 TFLOP/s FP32 peak, against 1.3 MB of grids (24 bytes per slot).  This
// kernel evaluates the full stencil, twice that arithmetic, to write each
// force once without a scatter.
#include "lj_cell.cuh"

// gx, gy, gz: the slot grids, element stride `stride` (1 for separate
// grids, 3 for the columns of one (...,cap,3) array).  par: NPAR floats on
// the device, par[7] = the sentinel base.  fout: (nslots,3).  partials:
// (nblocks,8), acc: (8), both read and written only when need_ev.
extern "C" int lidp_slot_lj_forces(const float* gx, const float* gy,
                                   const float* gz, int stride, int nbx,
                                   int nby, int nbz, int cap,
                                   const float* par, int need_ev, float* fout,
                                   float* partials, float* acc,
                                   void* stream) {
  const lidp::SlotOrder io{gx, gy, gz, stride, fout};
  return lidp::launch_lj_cell(io, nbx, nby, nbz, cap, par, need_ev, partials,
                              acc, stream);
}
