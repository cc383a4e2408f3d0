// cell_pair_forces_lj: the same single-type LJ cell stencil from atom order,
// float32 (the kernel is in lj_cell.cuh).  The kernel gathers coordinates
// through atom_of_slot while staging and writes the forces in slot order;
// atom_gather_kernel then gives each atom the force of the slot its
// slot_of_atom names (clamped to the grid), zero where it is masked, as the
// JAX function and the plain version do.  So an atom that found no slot
// in an overflowing grid takes the force of the slot it shares.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_pair.py:433
// cell_pair_forces_pallas (_lj_kernel :62) together with the XLA code
// around it: the slotify gather, the 13 pre-rolled neighbour grids, the 13
// roll-backs of the neighbour-side partials and the gather to atom order.
//
// Bound on the H100: FP32 arithmetic.  The function's least work, counted
// on the state at hand by chip_smoke.py cell_bound_ms: each unordered pair
// of live slots in the Newton half stencil tested against the cutoff (8
// flops), each pair inside it given its force on both atoms (16 flops; 17
// more for energy and virial), over 67 TFLOP/s, against x, mask and
// atom_of_slot read and f written once over 3.35 TB/s.  (The TPU kernel's
// count, cells*cap*14*cap*25 flops, counts every slot pair, padding
// included.)  The kernel evaluates each pair from both sides, so it does
// the cutoff test twice.
#include "lj_cell.cuh"

// x: (n,3).  aos: atom_of_slot (nbx*nby*nbz*cap) int32, n for an empty
// slot.  soa: slot_of_atom (n) int32.  mask: (n) bytes.  par: NPAR floats
// on the device (par[7] unused).  fs: (nbx*nby*nbz*cap, 3) scratch for the
// slot-order forces.  f: (n,3).  partials (nblocks,8), acc (8): need_ev
// only.
extern "C" int lidp_cell_pair_forces_lj(const float* x, const int* aos,
                                        const int* soa,
                                        const unsigned char* mask, int n,
                                        int nbx, int nby, int nbz, int cap,
                                        const float* par, int need_ev,
                                        float* fs, float* f, float* partials,
                                        float* acc, void* stream) {
  const lidp::AtomOrder io{x, aos, n, fs};
  const int err = lidp::launch_lj_cell(io, nbx, nby, nbz, cap, par, need_ev,
                                       partials, acc, stream);
  if (err) return err;
  const long nslots = static_cast<long>(nbx) * nby * nbz * cap;
  const int threads = 256;
  const int blocks = static_cast<int>((3L * n + threads - 1) / threads);
  lidp::atom_gather_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      fs, soa, mask, n, nslots, f);
  return static_cast<int>(cudaGetLastError());
}

// The tile a launch on this grid takes (1 wide, 2 narrow, 0 none: the cap
// does not fit shared memory) and its CTAs, the rows of `partials`.
extern "C" int lidp_cell_pair_forces_lj_dims(int nbx, int nby, int nbz,
                                             int cap, int* tile,
                                             int* nblocks) {
  return lidp::lj_cell_dims<lidp::AtomOrder>(nbx, nby, nbz, cap, tile,
                                             nblocks);
}
