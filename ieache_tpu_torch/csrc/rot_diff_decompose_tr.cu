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
// Bound on the H100: memory.  A step reads the accumulator once and writes
// l bytes per coefficient (8 MB in, 4 MB out at B=1024, N=1024, k=1, l=2):
// 0.0038 ms at 3.35 TB/s.
//
// Design: the slab of rot_slab.cuh.  A block holds all N rows of 16 lanes
// of one polynomial in shared memory and computes, for each coefficient
// (j, b) of its rows, both operands from there: no word is read from
// device memory twice.  Each thread stores its coefficient's l digit
// bytes, one a digit row, so a warp writes two 16-byte pieces of each
// digit row.  The caller's `splits` (ops/kernels.py:rot_tr_route) shares a
// slab between blocks when the slabs are fewer than the SMs (B <= 1024 at
// k = 1), or takes the gather from 16 blocks a slab (B <= 128 at k = 1):
// each of a slab's 16 blocks would move 64 bytes a row, where the gather
// moves 16 sectors of 32 bytes for the rotated words and 64 bytes for the
// plain ones, and it needs no load before the first coefficient.  Blocks
// that share a slab in a cluster, each loading a part and reading the
// others' rotated rows through distributed shared memory, were slower on
// the H100 at every batch (PERF.md §6).
//
// All wrapping arithmetic is uint32_t.  Any B; N a power of two of at
// least 64 whose slab fits a block's shared memory (the launch returns an
// error otherwise).

#include "rot_slab.cuh"

using namespace ieache;

namespace {

// Slab blockIdx.x / splits of polynomial blockIdx.y, rows
// N / splits * (blockIdx.x % splits) onwards.
__global__ void __launch_bounds__(kSlabThreads) rot_diff_decompose_tr_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    int8_t* __restrict__ out, int batch, int n, int bg_bit, int l,
    uint32_t offset, int splits, int vec) {
  extern __shared__ __align__(16) uint32_t slab[];  // (N, kSlabLanes)
  const int tid = threadIdx.x, u = blockIdx.y;
  const int s = blockIdx.x % splits, b0 = (blockIdx.x / splits) * kSlabLanes;
  load_slab(acc, slab, u, b0, batch, n, vec);

  const int bl = tid & (kSlabLanes - 1), b = b0 + bl;
  if (b >= batch) return;  // no barrier follows
  const uint32_t a = (uint32_t)bara[b];
  const int rows = n / splits, j_end = (s + 1) * rows;
  int8_t* dst = out + (int64_t)u * l * n * batch + b;
  for (int j = s * rows + tid / kSlabLanes; j < j_end;
       j += kSlabThreads / kSlabLanes) {
    const uint32_t v =
        (slab_rotated(slab, a, j, n, bl) - slab[j * kSlabLanes + bl]) +
        offset;
    for (int jl = 0; jl < l; ++jl)
      dst[((int64_t)jl * n + j) * batch] = gadget_digit(v, jl, bg_bit);
  }
}

// The gather: thread (b, j) of block (x, y, u) computes coefficient j of
// lane b of polynomial u from device memory.
__global__ void __launch_bounds__(kGatherLanes* kGatherRows)
    rot_diff_decompose_tr_gather(const uint32_t* __restrict__ acc,
                                 const int32_t* __restrict__ bara,
                                 int8_t* __restrict__ out, int batch, int n,
                                 int bg_bit, int l, uint32_t offset) {
  const int b = blockIdx.x * kGatherLanes + threadIdx.x;
  const int j = blockIdx.y * kGatherRows + threadIdx.y;
  const int u = blockIdx.z;
  if (b >= batch) return;
  // column b of polynomial u: coefficient i at c[i * batch]
  const uint32_t* c = acc + (int64_t)u * n * batch + b;
  const uint32_t v = (column_rotated(c, batch, (uint32_t)bara[b], j, n) -
                      c[(int64_t)j * batch]) +
                     offset;
  for (int jl = 0; jl < l; ++jl)
    out[((int64_t)(u * l + jl) * n + j) * batch + b] =
        gadget_digit(v, jl, bg_bit);
}

}  // namespace

// `splits`: blocks a slab, or 0 for the gather (rot_slab.cuh).
extern "C" int ieache_rot_diff_decompose_tr(
    const void* acc, const void* bara, void* out, int kp1, int batch, int n,
    int bg_bit, int l, uint32_t offset, int splits, void* stream) {
  if (n < 64 || !slab_splits_ok(n, splits)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (splits == 0) {
    rot_diff_decompose_tr_gather<<<gather_grid(kp1, batch, n), gather_block(),
                                   0, st>>>(
        (const uint32_t*)acc, (const int32_t*)bara, (int8_t*)out, batch, n,
        bg_bit, l, offset);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = allow_smem(rot_diff_decompose_tr_kernel,
                                     slab_bytes(n));
  if (err != cudaSuccess) return (int)err;
  rot_diff_decompose_tr_kernel<<<slab_grid(kp1, batch, splits), kSlabThreads,
                                 slab_bytes(n), st>>>(
      (const uint32_t*)acc, (const int32_t*)bara, (int8_t*)out, batch, n,
      bg_bit, l, offset, splits, slab_vec(acc, batch));
  return (int)cudaGetLastError();
}
