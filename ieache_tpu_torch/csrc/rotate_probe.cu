// The rotation probe's two kernels: one negacyclic rotation X^a * acc with
// per-batch amounts, in each accumulator layout, with no diff and no
// decomposition (ieache_tpu_torch/tools/transposed_probe.py times them).
//
// Replaces: tools/transposed_probe.py, the two inline Pallas kernels of
// main(): the lane kernel (lane_kernel, a barrel shifter rolling the lane
// axis of (k+1, B, N)) and the sublane kernel (sublane_kernel, the same
// rolls on the sublane axis of (k+1, N, B)).
//
//   in : acc (k+1, B, N) int32 [lane] or (k+1, N, B) int32 [sublane],
//        bara (B,) int32 in [0, 2N)
//   out: X^bara * acc in the same layout (mod 2^32)
//
// Bound on the H100: memory.  A rotation reads and writes the accumulator
// once (8 MB each way at B=2048, N=1024, k=1).  The question the probe
// asks is what the transposed layout costs: in (k+1, B, N) a warp's 32
// lanes read 32 consecutive coefficients of one polynomial (coalesced); in
// (k+1, N, B) they read one coefficient row of 32 batch lanes, each lane at
// its own rotated row: a gather, one 32-byte sector per 4-byte word.
//
// Design: one thread per output coefficient, the innermost axis fastest,
// so the store is coalesced in both layouts; coefficient j of X^a * c is
// c_i with i = (j - a) mod 2N when i < N, else -c_{i-N}, read directly
// (the TPU's barrel shifter exists because it has no per-lane gather).
// Any B; N a power of two, at least 8.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLaneThreads = 256;  // lane kernel: coefficients per block
constexpr int kLanes = 32;         // sublane kernel: batch lanes per block
constexpr int kRows = 8;           // sublane kernel: coefficients per block

__device__ __forceinline__ uint32_t rotated(const uint32_t* c, int64_t stride,
                                            uint32_t a, int j, int n) {
  const uint32_t i = ((uint32_t)j - a) & (uint32_t)(2 * n - 1);
  return i < (uint32_t)n ? c[(int64_t)i * stride]
                         : 0u - c[(int64_t)(i - n) * stride];
}

__global__ void rotate_lane_kernel(const uint32_t* __restrict__ acc,
                                   const int32_t* __restrict__ bara,
                                   uint32_t* __restrict__ out, int batch,
                                   int n) {
  const int b = blockIdx.x, u = blockIdx.z;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t row = ((int64_t)u * batch + b) * n;
  out[row + j] = rotated(acc + row, 1, (uint32_t)bara[b], j, n);
}

__global__ void __launch_bounds__(kLanes* kRows) rotate_sublane_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    uint32_t* __restrict__ out, int batch, int n) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  const int j = blockIdx.y * kRows + threadIdx.y;
  const int u = blockIdx.z;
  if (b >= batch) return;
  const int64_t col = (int64_t)u * n * batch + b;
  out[col + (int64_t)j * batch] =
      rotated(acc + col, batch, (uint32_t)bara[b], j, n);
}

}  // namespace

extern "C" int ieache_rotate_lane(const void* acc, const void* bara,
                                  void* out, int kp1, int batch, int n,
                                  void* stream) {
  const int threads = n < kLaneThreads ? n : kLaneThreads;
  const dim3 grid(batch, n / threads, kp1);
  rotate_lane_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)bara, (uint32_t*)out, batch, n);
  return (int)cudaGetLastError();
}

extern "C" int ieache_rotate_sublane(const void* acc, const void* bara,
                                     void* out, int kp1, int batch, int n,
                                     void* stream) {
  const dim3 block(kLanes, kRows);
  const dim3 grid((batch + kLanes - 1) / kLanes, n / kRows, kp1);
  rotate_sublane_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)bara, (uint32_t*)out, batch, n);
  return (int)cudaGetLastError();
}
