// One whole CMux step as one kernel, the digits kept in shared memory.
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _cmux_step_kernel behind
// cmux_step_pallas (the `fused2` step mode).
//
//   in : acc (k+1, B, N) int32, bara (B,) int32 in [0, 2N),
//        bk (rows, k+1, N) int32 one TRGSW step
//   out: acc + sum_p digits_p(X^bara * acc - acc) (*) bk[p, o],
//        negacyclic, exact mod 2^32; equal to rot_diff_decompose.cu
//        followed by external_product.cu with the accumulator fused
//
// Bound on the H100: operations, as external_product.cu: 34.4 G int8
// multiply-adds a step at B=1024, N=1024, k=1, l=2 on the tensor cores,
// 0.035 ms at their peak; the bytes (8 MB of accumulator in and out, 16 KB
// of key) take 0.003 ms.  What fusing saves over the split pair is the
// digit tensor's round trip through device memory (4 MB written and read
// a step at B=1024), one launch a step, and the host's second wrapper call.
//
// Design (the kernel is in cmux_step_parts.cuh): the external product's
// tensor-core tile (mma_tile.cuh, mma.sync m16n8k32 s8 x s8 -> s32) with
// its digits read by ldmatrix straight from a (rows, 16, N + 16) int8 tile
// that the block decomposed into its own shared memory, once, before the
// products: 66.6 KB at N=1024 and 4 rows beside the 21 KB of byte planes,
// two blocks an SM.  Nothing hides a block's decomposition (the two blocks
// of an SM start together and stay in step), so the design makes it small:
// * a block computes a run of the N/T x (k+1) tiles of its 16 batch rows
//   from one decomposition, the longest run that still fills the card
//   (fused::tiles_per_item: 2 of the 8 tiles at B=1024, N=1024, k=1, 4 at
//   B=2048);
// * the blocks that share batch rows are launched as thread-block clusters
//   of two: each decomposes 8 of the 16 rows and copies the other 8 from
//   its peer's shared memory (distributed shared memory; ldmatrix reads
//   only the block's own);
// * a thread decomposes four coefficients at a time, a whole batch row in
//   flight at once so that L1 serves one of the row's two reads, and at
//   Bg = 2^8 a digit row's four bytes come from three byte permutes.
// On an H100 (700 W) at B=1024, N=1024, k=1, l=2: 0.103 ms a step, of
// which the products are 0.084 (the same step with the decomposition
// taken out) against 0.093 for external_product.cu, which streams its
// digits from L2; every block decomposing all 16 rows: 0.115; clusters of
// four (one decomposition for 16 rows and all their tiles): 0.144, so
// clusters stay at two.  A batch with fewer tiles than SMs (B <= 256 at
// N=1024) splits each tile's sum over (p, chunk) parts as
// external_product.cu does; a part decomposes only the digit row and
// columns it sums over, so at B=8 (128 parts of one chunk) nothing is
// decomposed twice but for the l digits of a coefficient.  The output must
// not alias the accumulator.  The launch refuses what the tile refuses
// (cudaErrorInvalidValue): an N that is not a power of two of at least 64,
// rows * N >= 2^17, and a digit tile that does not fit the block's shared
// memory.

#include "cmux_step_parts.cuh"

using namespace ieache;

extern "C" int ieache_cmux_step(const void* acc, const void* bara,
                                const void* bk, void* out, int rows, int kp1,
                                int batch, int n, int bg_bit, int l,
                                uint32_t offset, void* stream) {
  if (!mma::shape_ok(rows, n)) return (int)cudaErrorInvalidValue;
  int sms = 0, smem_optin = 0;
  const cudaError_t err = fused::device_limits(&sms, &smem_optin);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n >= 256)
    return fused::launch_step_parts<8>(acc, bara, bk, out, rows, kp1, batch, n,
                                bg_bit, l, offset, sms, smem_optin, s);
  if (n == 128)
    return fused::launch_step_parts<4>(acc, bara, bk, out, rows, kp1, batch, n,
                                bg_bit, l, offset, sms, smem_optin, s);
  return fused::launch_step_parts<2>(acc, bara, bk, out, rows, kp1, batch, n,
                                     bg_bit, l, offset, sms, smem_optin, s);
}
