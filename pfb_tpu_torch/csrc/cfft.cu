// K3: batched unnormalised c2c DFT along the middle axis of a plane
// stack, with the w-stacking gridder's roll/crop absorbed.
//
// Replaces pfb_tpu/ops/pallas_cfft.py:fftx_c2c (Pallas kernel
// _kx_kernel): (P, Nin, L) float32 re/im -> (P, Nout, L), forward e^-,
// inverse e^+, no 1/N. in_rolled reads the N/2 image rows at
// (i - N/4) mod N (no pad, no roll pass); out_rolled emits only rows
// (r - N/4) mod N, r < N/2 (no roll, no crop pass).
//
// What bounds it on the H100: one complex line of N = 8192 is 64 KB, so
// a block holds one to a few lines, and the x pass reads along the
// strided axis. Each line stays in shared memory for every pass of a
// mixed-radix Stockham FFT (one HBM read and one write per pass of the
// 2-D transform); a block takes a strip of adjacent columns so its loads
// and stores are coalesced across the strip, and the strip's width
// shrinks as N grows (line_launch). The y pass of a 2-D transform runs
// on contiguous rows (L = 1), so no transpose pass is needed. What
// bounds it: shared-memory traffic (every pass reads and writes the
// whole line) and the narrow strips of the strided pass. The
// strided pass at 2048 <= N <= 16384 runs cfft_cols.cu, the rows at N =
// 256 R2 (R2 = 8-64, 5-smooth) run cfft_rows.cu and both passes above
// 16384 run cfft_four.cu's four-step (ops/cfft.py's routes); this kernel
// takes every other length up to kMaxN.
#include "fft_lines.cuh"

namespace pfbt {

// The plan's twiddle table, one thread per entry: pass i holds
// (R_i - 1) Ns_i entries, N - 1 in all.
__global__ void twiddle_kernel(float2* __restrict__ T, LinePlan p) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  int Ns = 1, off = 0;
  unsigned long long c = p.codes;
  for (int i = 0; i < p.npass; ++i, c >>= 3) {
    const int R = radix_of((unsigned)(c & 7ull));
    if (e < off + (R - 1) * Ns) {
      const int q = (e - off) / Ns + 1, k = (e - off) % Ns;
      double sn, cs;
      sincospi(-2.0 * q * k / ((double)Ns * R), &sn, &cs);
      T[e] = make_float2((float)cs, (float)sn);
      return;
    }
    off += (R - 1) * Ns;
    Ns *= R;
  }
}

}  // namespace pfbt

extern "C" int pfbt_cfft(const float* xr, const float* xi, float* yr,
                         float* yi, int B, int L, int N, int Nin, int Nout,
                         int in_rolled, int out_rolled, int inverse,
                         const void* T, void* stream) {
  pfbt::LinePlan p;
  if (!pfbt::make_plan(N, T, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = pfbt::launch_lines(
      xr, xi, yr, yi, B, L, Nin, Nin, Nout, Nout,
      in_rolled ? pfbt::kInRolled : pfbt::kInNatural,
      out_rolled ? pfbt::kOutRolled : pfbt::kOutNatural, inverse, 1.0f, p,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

// K3 with lab launch parameters (scripts/torch_g2i_lab.py, the counterpart
// of scripts/wl_g2i_lab.py's lane-block sweep and k_stage1): S lines per
// block (0: line_launch's choice; S * N <= 2 kLineElems) and the plan cut
// to its first npass radix passes (0: all; a cut plan's output is not a
// DFT, it times the passes). With S = npass = 0 this is pfbt_cfft.
extern "C" int pfbt_cfft_lab(const float* xr, const float* xi, float* yr,
                             float* yi, int B, int L, int N, int Nin,
                             int Nout, int in_rolled, int out_rolled,
                             int inverse, int S, int npass, const void* T,
                             void* stream) {
  pfbt::LinePlan p;
  if (!pfbt::make_plan(N, T, &p) || npass < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (npass > 0 && npass < p.npass) p.npass = npass;
  cudaError_t e = pfbt::launch_lines(
      xr, xi, yr, yi, B, L, Nin, Nin, Nout, Nout,
      in_rolled ? pfbt::kInRolled : pfbt::kInNatural,
      out_rolled ? pfbt::kOutRolled : pfbt::kOutNatural, inverse, 1.0f, p,
      static_cast<cudaStream_t>(stream), S);
  return static_cast<int>(e);
}

// The twiddle table of a length-N plan (N - 1 float2 entries) into T;
// both kernels take it as their T/TX/TY operand.
extern "C" int pfbt_twiddles(int N, void* T, void* stream) {
  pfbt::LinePlan p;
  if (!pfbt::make_plan(N, nullptr, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = N - 1, threads = 256;
  pfbt::twiddle_kernel<<<(n + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(T), p);
  return static_cast<int>(cudaGetLastError());
}
