// The degrid lab (scripts/torch_kernel_lab.py --degrid, --degrid-rungs):
// every design of K6 / K9 (pg_degrid.cu) by name, and their skeletons.
//
// Design 0 is the earlier design, a thread a visibility,
// which K6 / K9 still launch at k != 7 where their window design cannot
// put three blocks on an SM; the lab and the card tests hold the others
// against it, bit for bit (each sums the same products in the same
// order).
//
// Skeletons (mode, every design at k = 7; the thread design at every
// k): 1 the factors only (summed into the output so that they are not
// dead), 2 the grid loads only (for the window its staging and its reads
// of shared memory; summed), 3 the sums of the kernel (with the taps
// design's exchange between lanes) on register data in place of loads
// and factors. The output of a skeleton is not a degrid.
#include "pg_degrid.cuh"

// The degrid lab: design 0 the thread, 1 the taps, 2 the window, 3 the
// one K6 / K9 launch (pg_degrid.cuh); mode 0 the kernel, 1-3 its
// skeletons. K9 where gmap is given (woff the block's first plane, the
// result added to out), else K6; operands and output as
// pfbt_pg_degrid's / pfbt_pg_degrid_gs's.
extern "C" int pfbt_pg_degrid_lab(const float* gr, const float* gi,
                                  const float* pos, const int* tid,
                                  const int* gmap, float* out, int NE, int C,
                                  int nw, int Thx, int Thy, int txs, int tys,
                                  int nty, int Nx, int Ny, int k, int woff,
                                  double beta, int design, int mode,
                                  void* stream) {
  const pfbt::DegridArgs a{gr,  gi,  pos, tid, gmap, out, NE, C,  nw,
                           Thx, Thy, txs, tys, nty,  Nx,  Ny, k,
                           static_cast<float>(beta),
                           static_cast<float>(woff)};
  return static_cast<int>(pfbt::pg_degrid_launch(
      a, design, mode, static_cast<cudaStream_t>(stream)));
}
