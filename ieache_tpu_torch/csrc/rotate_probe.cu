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
// Design.  Lane kernel: one thread per output coefficient, the innermost
// axis fastest, so the load and the store are coalesced; coefficient j of
// X^a * c is c_i with i = (j - a) mod 2N when i < N, else -c_{i-N}, read
// directly (the TPU's barrel shifter exists because it has no per-lane
// gather).  Sublane kernel: the slab of rot_slab.cuh, as the tr step's
// rotation has it: a block copies all N rows of 16 lanes of a polynomial
// into shared memory by cp.async, then each thread reads its rotated word
// from there and stores it, a warp two 64-byte pieces of a row.  The
// caller's `splits` (ops/kernels.py:rot_tr_route) shares a slab between
// blocks below one slab an SM, or takes the gather (one thread per output
// word, the store coalesced) at small batches and where a slab does not fit
// a block's shared memory (N >= 4096).  Any B; N a power of two, at least
// 8.

#include "rot_slab.cuh"

using namespace ieache;

namespace {

constexpr int kLaneThreads = 256;  // lane kernel: coefficients per block

__global__ void rotate_lane_kernel(const uint32_t* __restrict__ acc,
                                   const int32_t* __restrict__ bara,
                                   uint32_t* __restrict__ out, int batch,
                                   int n) {
  const int b = blockIdx.x, u = blockIdx.z;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t row = ((int64_t)u * batch + b) * n;
  out[row + j] = column_rotated(acc + row, 1, (uint32_t)bara[b], j, n);
}

// Slab blockIdx.x / splits of polynomial blockIdx.y, rows
// N / splits * (blockIdx.x % splits) onwards.
__global__ void __launch_bounds__(kSlabThreads) rotate_sublane_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    uint32_t* __restrict__ out, int batch, int n, int splits, int vec) {
  extern __shared__ __align__(16) uint32_t slab[];  // (N, kSlabLanes)
  const int tid = threadIdx.x, u = blockIdx.y;
  const int s = blockIdx.x % splits, b0 = (blockIdx.x / splits) * kSlabLanes;
  load_slab(acc, slab, u, b0, batch, n, vec);

  const int bl = tid & (kSlabLanes - 1), b = b0 + bl;
  if (b >= batch) return;  // no barrier follows
  const uint32_t a = (uint32_t)bara[b];
  const int rows = n / splits, j_end = (s + 1) * rows;
  uint32_t* dst = out + (int64_t)u * n * batch + b;
  for (int j = s * rows + tid / kSlabLanes; j < j_end;
       j += kSlabThreads / kSlabLanes)
    dst[(int64_t)j * batch] = slab_rotated(slab, a, j, n, bl);
}

// The gather: thread (b, j) of block (x, y, u) computes coefficient j of
// lane b of polynomial u from device memory.
__global__ void __launch_bounds__(kGatherLanes* kGatherRows)
    rotate_sublane_gather(const uint32_t* __restrict__ acc,
                          const int32_t* __restrict__ bara,
                          uint32_t* __restrict__ out, int batch, int n) {
  const int b = blockIdx.x * kGatherLanes + threadIdx.x;
  const int j = blockIdx.y * kGatherRows + threadIdx.y;
  const int u = blockIdx.z;
  if (b >= batch) return;
  const int64_t col = (int64_t)u * n * batch + b;
  out[col + (int64_t)j * batch] =
      column_rotated(acc + col, batch, (uint32_t)bara[b], j, n);
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

// `splits`: blocks a slab, or 0 for the gather (rot_slab.cuh).
extern "C" int ieache_rotate_sublane(const void* acc, const void* bara,
                                     void* out, int kp1, int batch, int n,
                                     int splits, void* stream) {
  if (!slab_splits_ok(n, splits)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (splits == 0) {
    rotate_sublane_gather<<<gather_grid(kp1, batch, n), gather_block(), 0,
                            st>>>((const uint32_t*)acc, (const int32_t*)bara,
                                  (uint32_t*)out, batch, n);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = allow_smem(rotate_sublane_kernel, slab_bytes(n));
  if (err != cudaSuccess) return (int)err;
  rotate_sublane_kernel<<<slab_grid(kp1, batch, splits), kSlabThreads,
                          slab_bytes(n), st>>>(
      (const uint32_t*)acc, (const int32_t*)bara, (uint32_t*)out, batch, n,
      splits, slab_vec(acc, batch));
  return (int)cudaGetLastError();
}
