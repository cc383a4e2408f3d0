// cell_pair_forces_lj: the same single-type LJ cell stencil from atom order,
// float32 (the kernel is in lj_cell.cuh).  The kernel gathers coordinates
// through atom_of_slot while staging, and scatters each live slot's force
// straight to f[atom]; the caller zeroes f first, so masked atoms (which
// hold no slot) stay zero.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_pair.py:433
// cell_pair_forces_pallas (_lj_kernel :62) together with the XLA code
// around it: the slotify gather, the 13 pre-rolled neighbour grids, the 13
// roll-backs of the neighbour-side partials and the gather to atom order.
//
// Bound on the H100: FP32 CUDA-core arithmetic, C*cap*14*cap*25 flops by
// the TPU kernel's count without its lane and cell padding: 0.745 GFLOP on
// the 32,000-atom melt's (11,11,11,40) grid, 0.011 ms at the 67 TFLOP/s
// FP32 peak, against about 1 MB of coordinates, indices and forces.
#include "lj_cell.cuh"

// x: (n,3).  aos: atom_of_slot (nbx*nby*nbz*cap) int32, n for an empty slot.
// mask: (n) bytes.  par: NPAR floats on the device (par[7] unused).  f:
// (n,3), zeroed by the caller.  partials (nblocks,8), acc (8): need_ev only.
extern "C" int lidp_cell_pair_forces_lj(const float* x, const int* aos,
                                        const unsigned char* mask, int n,
                                        int nbx, int nby, int nbz, int cap,
                                        const float* par, int need_ev,
                                        float* f, float* partials, float* acc,
                                        void* stream) {
  const lidp::AtomOrder io{x, aos, mask, n, f};
  return lidp::launch_lj_cell(io, nbx, nby, nbz, cap, par, need_ev, partials,
                              acc, stream);
}
