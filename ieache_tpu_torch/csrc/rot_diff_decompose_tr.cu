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
// Design.  In this layout the rotated read acc[u, (j - a_b) mod N, b] lands
// on another row of the accumulator for every batch lane b, since each
// lane has its own amount a_b: read from device memory, that is a gather,
// one 32-byte sector per 4-byte word.  So a block first copies all N rows
// of 16 lanes of one polynomial, acc[u, :, b0 .. b0 + 15], into shared
// memory (the slab: 64 KB at N = 1024) by cp.async, 16 bytes a copy, all
// of a thread's copies in flight at once, coalesced, and
// then reads both operands of every coefficient from there: no word is
// read from device memory twice.  A warp takes 2 rows x 16 lanes: lane b
// reads slab word 16 i_b + b, so its bank's low four bits are b and the
// 16 lanes never meet, and its two rows' reads lie 16 banks apart; the
// reads are free of bank conflicts whatever the amounts (ops/kernels.py:
// rot_tr_slab_banks, pinned over random amounts in the CPU tests).  Each
// thread computes one (j, b) and stores its l digit bytes, one a digit
// row, so a warp writes two 16-byte pieces of each digit row.  When the
// slabs are fewer than the SMs (B <= 1024 at k = 1), the launch gives each
// slab to a power of two of blocks (rot_splits), each loading all of it
// and computing a run of its rows.
//
// A small batch gathers instead.  Each of a slab's `splits` blocks moves
// 64 bytes a row, where the gather moves 16 sectors of 32 bytes for the
// rotated words and 64 bytes for the plain ones: from kGatherSplits = 16
// blocks a slab (B <= 128 at k = 1) the gather moves fewer bytes, and it
// needs no load before the first coefficient.  One thread per (u, j, b),
// b fastest, so the plain read and every digit row's store are coalesced.
// Blocks that share a slab in a cluster, each loading a part and reading
// the others' rotated rows through distributed shared memory, were slower
// on the H100 at every batch (PERF.md §6).
//
// All wrapping arithmetic is uint32_t.  Any B; N a power of two of at
// least 64 whose slab fits a block's shared memory (the launch returns an
// error otherwise).

#include "cmux_common.cuh"

using namespace ieache;

namespace {

constexpr int kW = 16;          // batch lanes of a slab
constexpr int kThreads = 256;   // kThreads / kW rows at a time
constexpr int kGatherSplits = 16;
constexpr int kLanes = 32;      // batch lanes of a gather block
constexpr int kRows = 8;        // coefficients of a gather block

// Blocks that share a slab: 1 when the slabs reach the SMs, else the
// smallest power of two that does, at most N / 16.  ops/kernels.py:
// rot_tr_splits is its twin.
inline int rot_splits(int blocks, int n, int sms) {
  int splits = 1;
  while (blocks * splits < sms && splits < n / 16) splits *= 2;
  return splits;
}

// Slab blockIdx.x / splits of polynomial blockIdx.y, rows
// N / splits * (blockIdx.x % splits) onwards.  `vec`: batch % 4 == 0 and
// acc 16-byte aligned, so four lanes are one 16-byte load.
__global__ void __launch_bounds__(kThreads) rot_diff_decompose_tr_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    int8_t* __restrict__ out, int batch, int n, int bg_bit, int l,
    uint32_t offset, int splits, int vec) {
  extern __shared__ __align__(16) uint32_t slab[];  // (N, kW)
  const int tid = threadIdx.x, u = blockIdx.y;
  const int s = blockIdx.x % splits, b0 = (blockIdx.x / splits) * kW;
  const uint32_t* src = acc + (int64_t)u * n * batch + b0;
  const uint32_t slab_s = (uint32_t)__cvta_generic_to_shared(slab);
  for (int x = tid; x < n * (kW / 4); x += kThreads) {
    const int r = x / (kW / 4), b = 4 * (x % (kW / 4));
    const uint32_t* row = src + (int64_t)r * batch + b;
    if (vec) {
      // all of a thread's copies in flight at once; past the batch, zeros
      const bool valid = b0 + b < batch;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                       slab_s + (uint32_t)(r * kW + b) * 4u),
                   "l"(valid ? row : acc), "r"(valid ? 16 : 0)
                   : "memory");
    } else {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (b0 + b < batch) w.x = row[0];
      if (b0 + b + 1 < batch) w.y = row[1];
      if (b0 + b + 2 < batch) w.z = row[2];
      if (b0 + b + 3 < batch) w.w = row[3];
      *reinterpret_cast<uint4*>(slab + r * kW + b) = w;
    }
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  const int bl = tid & (kW - 1), b = b0 + bl;
  if (b >= batch) return;  // no barrier follows
  const uint32_t a = (uint32_t)bara[b];
  const uint32_t mask2n = (uint32_t)(2 * n - 1);
  const int rows = n / splits, j_end = (s + 1) * rows;
  int8_t* dst = out + (int64_t)u * l * n * batch + b;
  for (int j = s * rows + tid / kW; j < j_end; j += kThreads / kW) {
    const uint32_t i = ((uint32_t)j - a) & mask2n;
    const uint32_t rotated =
        i < (uint32_t)n ? slab[i * kW + bl] : 0u - slab[(i - n) * kW + bl];
    const uint32_t v = (rotated - slab[j * kW + bl]) + offset;
    for (int jl = 0; jl < l; ++jl)
      dst[((int64_t)jl * n + j) * batch] = gadget_digit(v, jl, bg_bit);
  }
}

// The gather: thread (b, j) of block (x, y, u) computes coefficient j of
// lane b of polynomial u from device memory.
__global__ void __launch_bounds__(kLanes* kRows) rot_diff_decompose_tr_gather(
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
  for (int jl = 0; jl < l; ++jl)
    out[((int64_t)(u * l + jl) * n + j) * batch + b] =
        gadget_digit(v, jl, bg_bit);
}

}  // namespace

extern "C" int ieache_rot_diff_decompose_tr(
    const void* acc, const void* bara, void* out, int kp1, int batch, int n,
    int bg_bit, int l, uint32_t offset, void* stream) {
  if (n < 64 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int nslabs = (batch + kW - 1) / kW;
  const int splits = rot_splits(nslabs * kp1, n, sms);
  if (splits >= kGatherSplits) {
    rot_diff_decompose_tr_gather<<<
        dim3((batch + kLanes - 1) / kLanes, n / kRows, kp1),
        dim3(kLanes, kRows), 0, (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const int32_t*)bara, (int8_t*)out, batch, n,
        bg_bit, l, offset);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)n * kW * sizeof(uint32_t);
  err = allow_smem(rot_diff_decompose_tr_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = batch % 4 == 0 && ((uintptr_t)acc & 15) == 0;
  rot_diff_decompose_tr_kernel<<<dim3(nslabs * splits, kp1), kThreads, smem,
                                 (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)bara, (int8_t*)out, batch, n,
      bg_bit, l, offset, splits, vec);
  return (int)cudaGetLastError();
}
