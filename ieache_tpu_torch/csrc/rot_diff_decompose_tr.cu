// Rotate, subtract and gadget-decompose one CMux step's accumulator in the
// transposed (k+1, N, B) layout, batch innermost (step mode `tr`).
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _rot_diff_decompose_tr_kernel
// behind rot_diff_decompose_pallas_tr (the first of the two kernels of each
// CMux step in the `tr` step mode).
//
//   in : acc  (k+1, N, B) int32, bara (B,) int32 in [0, 2N)
//   out: (rows, N, B) int8, rows = (k+1)*l, row u*l + jl holds
//        ((v_u >> (32 - (jl+1)*bg_bit)) & (Bg-1)) - Bg/2,
//        v = X^bara * acc - acc + offset      (all mod 2^32)
//
// Bound on the H100: memory, and here the L2's sector rate.  A step reads
// the accumulator twice and writes l bytes per coefficient, as
// rot_diff_decompose.cu does (8 MB in, 4 MB out at B=1024, N=1024, k=1,
// l=2).  But in this layout the rotated read acc[u, (j - a_b) mod N, b]
// lands on a different row of the accumulator for every lane of a warp,
// since each batch lane b has its own amount a_b: a gather, in which each
// lane's 4-byte word costs one 32-byte sector.  That is 64 MB of sector
// traffic per step at B=1024 where the coalesced reads take 8 MB.
//
// Design: the simple, correct form.  One thread per (u, j, b), b fastest,
// so the read of acc[u, j, b] and every digit row's int8 store are
// coalesced, and the rotated read is the gather through L2 described
// above.  The TPU kernel instead rolls the sublane (N) axis with a barrel
// shifter, because the TPU has no per-lane gather.  A shared-memory tile of
// a few batch columns x N rows, read coalesced and rotated inside shared
// memory, is the known better form, and is later work.  All wrapping
// arithmetic is uint32_t.  Any B; N a power of two (as TFHEParams requires)
// and a multiple of 8.

#include "cmux_common.cuh"

using namespace ieache;

namespace {

constexpr int kLanes = 32;  // batch lanes per block
constexpr int kRows = 8;    // coefficients per block

__global__ void __launch_bounds__(kLanes* kRows) rot_diff_decompose_tr_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    int8_t* __restrict__ out, int batch, int n, int bg_bit, int l,
    uint32_t offset) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  const int j = blockIdx.y * kRows + threadIdx.y;
  const int u = blockIdx.z;
  if (b >= batch) return;
  const uint32_t a = (uint32_t)bara[b];
  // column b of polynomial u: coefficient i at c[i * batch]
  const uint32_t* c = acc + (int64_t)u * n * batch + b;
  const uint32_t i = ((uint32_t)j - a) & (uint32_t)(2 * n - 1);
  const uint32_t rotated = i < (uint32_t)n
                               ? c[(int64_t)i * batch]
                               : 0u - c[(int64_t)(i - n) * batch];
  const uint32_t v = (rotated - c[(int64_t)j * batch]) + offset;
  for (int jl = 0; jl < l; ++jl) {
    out[((int64_t)(u * l + jl) * n + j) * batch + b] =
        gadget_digit(v, jl, bg_bit);
  }
}

}  // namespace

extern "C" int ieache_rot_diff_decompose_tr(
    const void* acc, const void* bara, void* out, int kp1, int batch, int n,
    int bg_bit, int l, uint32_t offset, void* stream) {
  const dim3 block(kLanes, kRows);
  const dim3 grid((batch + kLanes - 1) / kLanes, n / kRows, kp1);
  rot_diff_decompose_tr_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)bara, (int8_t*)out, batch, n,
      bg_bit, l, offset);
  return (int)cudaGetLastError();
}
