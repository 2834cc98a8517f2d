// Rotate, subtract and gadget-decompose one CMux step's accumulator.
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _rot_diff_decompose_kernel
// behind rot_diff_decompose_pallas (the first of the two kernels of each
// CMux step in the `split` step mode).
//
//   in : acc  (k+1, B, N) int32, bara (B,) int32
//   out: (rows, B, N) int8, rows = (k+1)*l, row u*l + jl holds
//        ((v_u >> (32 - (jl+1)*bg_bit)) & (Bg-1)) - Bg/2,
//        v = X^bara * acc - acc + offset      (all mod 2^32)
//
// Bound on the H100: memory.  Each output coefficient reads two int32
// words of the accumulator and writes l bytes; at B=1024, N=1024, k=1,
// l=2 a step reads 8 MB and writes 4 MB, and does a handful of integer
// operations per byte moved.
//
// Design: the TPU kernel builds X^bara as eleven conditional static
// rolls (a barrel shifter), because per-lane gathers are slow there.
// Here coefficient j of X^a * c is read directly: c_i with
// i = (j - a) mod 2N when i < N, else -c_{i-N}.  Consecutive threads
// take consecutive j, so both reads and every digit row's writes are
// coalesced.  One block covers up to 256 coefficients of one (u, b)
// polynomial; the grid is (B, N / threads, k+1), so any B launches
// whole blocks and no ragged edge or batch padding exists.  All
// wrapping arithmetic is uint32_t (signed overflow is undefined in C++).

#include "cmux_common.cuh"

using namespace ieache;

namespace {

__global__ void rot_diff_decompose_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    int8_t* __restrict__ out, int batch, int n, int bg_bit, int l,
    uint32_t offset) {
  const int b = blockIdx.x;
  const int u = blockIdx.z;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const uint32_t v = rot_diff<false>(acc + ((int64_t)u * batch + b) * n,
                                     (uint32_t)bara[b], j, n, offset);
  for (int jl = 0; jl < l; ++jl) {
    out[((int64_t)(u * l + jl) * batch + b) * n + j] =
        gadget_digit(v, jl, bg_bit);
  }
}

}  // namespace

extern "C" int ieache_rot_diff_decompose(
    const void* acc, const void* bara, void* out, int kp1, int batch, int n,
    int bg_bit, int l, uint32_t offset, void* stream) {
  const int threads = n < 256 ? n : 256;
  const dim3 grid(batch, n / threads, kp1);
  rot_diff_decompose_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)bara, (int8_t*)out, batch, n,
      bg_bit, l, offset);
  return (int)cudaGetLastError();
}

extern "C" const char* ieache_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
