// slot_lj_forces: single-type LJ forces purely in cell-slot space, float32
// (the kernel is in lj_cell.cuh).  In: three (nbx,nby,nbz,cap) coordinate
// grids whose empty slots hold the sentinels base + spacing*k in x and 0 in
// y and z.  Out: the force on every slot (zero on empty ones), and with
// need_ev the LJ energy and the 6-term virial.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_pair.py:314 slot_lj_forces
// (_lj_kernel_v3 :150).
//
// Bound on the H100: FP32 arithmetic.  The function's least work, counted
// on the state at hand by chip_smoke.py cell_bound_ms: each unordered pair
// of live slots in the Newton half stencil tested against the cutoff (8
// flops), each pair inside it given its force on both atoms (16 flops; 17
// more for energy and virial), over 67 TFLOP/s, against 24 bytes per slot
// (3 grids in, 3 out) over 3.35 TB/s.  (The TPU kernel's count,
// nbx*nby*nbz*cap*cap*14*25 flops, counts every slot pair, padding
// included.)  The kernel evaluates each pair from both sides, so it does
// the cutoff test twice, to write each force once without a scatter.
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

// The tile a launch on this grid takes (1 wide, 2 narrow, 0 none: the cap
// does not fit shared memory) and its CTAs, the rows of `partials`.
extern "C" int lidp_slot_lj_forces_dims(int nbx, int nby, int nbz,
                                        int cap, int* tile, int* nblocks) {
  return lidp::lj_cell_dims<lidp::SlotOrder>(nbx, nby, nbz, cap, tile,
                                             nblocks);
}
