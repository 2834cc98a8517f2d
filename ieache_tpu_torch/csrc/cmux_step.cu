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
// Bound on the H100: as external_product.cu, the CUDA cores' integer
// multiply-add rate (8.6 G multiply-adds per step at B=1024, N=1024,
// k=1, l=2).  What fusing saves is the digit tensor's round trip through
// device memory (4 MB written and read per step at B=1024) and one
// launch per step.
//
// Design: the external product's kernel with its digit staging replaced.
// A block computes one 16 x 256 output tile of one component o, grid
// (B/16, N/256, k+1), and, for each digit row p = u*l + jl and chunk of
// 256 digit columns, computes the chunk's digits from the accumulator
// straight into the shared-memory buffer the product reads
// (ieache::RotatedDigits): the digits never touch device memory.  The
// rotation is redone per digit row and per block, l * (k+1) * N/256 =
// 16 times at N=1024, l=2: about 10 instructions and two L1/L2 reads
// per digit against 8 * 256 multiply-adds per digit per thread tile,
// and it keeps the external product's 512 blocks at B=1024 and its
// shared memory (24.6 KB), so five blocks share an SM and one block's
// loads overlap the others' multiply-adds.  The alternatives were
// slower or smaller: decomposing a block's 16 batch rows into 64 KB of
// shared memory first costs a serial prologue of about 60 us per block
// (an int8 store may alias the next load, so the loads wait on the
// stores) and allows only two blocks per SM; a block that owned all
// (o, j) tiles of its rows would leave only 64 blocks for 132 SMs.

#include "cmux_common.cuh"

using namespace ieache;

namespace {

__global__ void __launch_bounds__(kTileThreads) cmux_step_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    const uint32_t* __restrict__ bk, uint32_t* __restrict__ out, int rows,
    int kp1, int batch, int n, int bg_bit, int l, uint32_t offset) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const Tile t = make_tile(blockIdx.x, blockIdx.y, blockIdx.z, n, tx);
  uint32_t sum[RB][RJ];
  zero_sum(sum);
  product_accumulate(
      smem, bk, kp1, n, t, 0, rows * (n / chunk_cols(n)), tid, ty,
      RotatedDigits{acc, bara, batch, n, t.b0, l, bg_bit, tid, offset},
      BlockSync{}, sum);
  store_tile<false>(sum, t, ty, acc, out, batch, n);
}

}  // namespace

extern "C" int ieache_cmux_step(const void* acc, const void* bara,
                                const void* bk, void* out, int rows, int kp1,
                                int batch, int n, int bg_bit, int l,
                                uint32_t offset, void* stream) {
  const size_t smem = (size_t)product_smem_words(n) * sizeof(uint32_t);
  const cudaError_t err = allow_smem(cmux_step_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + TB - 1) / TB, (n + TJ - 1) / TJ, kp1);
  cmux_step_kernel<<<grid, kTileThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)bara, (const uint32_t*)bk,
      (uint32_t*)out, rows, kp1, batch, n, bg_bit, l, offset);
  return (int)cudaGetLastError();
}
