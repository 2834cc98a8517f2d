// External product of one CMux step, accumulator fused.
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _ext_product_kernel behind
// external_product_pallas_t(..., acc_t=...) (the second of the two
// kernels of each CMux step in the `split` step mode).
//
//   in : d (rows, B, N) int8 digits, bk (rows, k+1, N) int32 one TRGSW
//        step, acc (k+1, B, N) int32 or null
//   out: out[o, b, :] = acc[o, b, :] + sum_p d[p, b, :] (*) bk[p, o, :]
//        negacyclic, exact mod 2^32
//
// Form: a direct int32 negacyclic convolution (cmux_common.cuh),
// multiplied and accumulated in uint32_t, which wraps mod 2^32 and is
// therefore exact by construction with no bound on the sum.  The TPU
// kernel instead multiplies int8 digits by the four int8 limbs of the
// Toeplitz matrix on the matrix unit (four times the multiply-adds, each
// dot exact because rows * N * 2^14 < 2^31); that form on Hopper's int8
// tensor cores (mma.sync / wgmma s8 x s8 -> s32) is later work.
//
// Bound on the H100: CUDA-core integer multiply-add throughput.  At
// B=1024, N=1024, k=1, l=2 (4 rows) a step is (k+1)*B*N*rows*N = 8.6 G
// multiply-adds; IMAD issues at 64 per clock per SM, which puts the
// floor near 0.6 ms per step.  Bytes are small beside that: 16 KB of key
// and 4 MB of digits in, 8 MB of accumulator in and out.
//
// Design: a block computes one 16 (batch) x 256 (coefficient) output
// tile of one component o (ieache::product_accumulate).  It stages e of
// each row p in shared memory (2N words) and the tile's digits in chunks
// of up to 256 columns, widened to int32.  Each thread owns a 4 x 8
// register tile: per four digit columns it reads one 16-byte word of
// digits per batch row (a warp-wide broadcast) and four new words of e,
// and issues 128 multiply-adds.  The e values a thread needs form a
// window that slides by one word per digit column, kept in 12 registers.
// The batch edge is masked (any B); N must be a multiple of 8.

#include "cmux_common.cuh"

using namespace ieache;

namespace {

__global__ void __launch_bounds__(kTileThreads) external_product_kernel(
    const int8_t* __restrict__ d, const uint32_t* __restrict__ bk,
    const uint32_t* __restrict__ acc, uint32_t* __restrict__ out, int rows,
    int kp1, int batch, int n) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const Tile t = make_tile(blockIdx.x, blockIdx.y, blockIdx.z, n, tx);
  uint32_t sum[RB][RJ];
  zero_sum(sum);
  product_accumulate(smem, bk, kp1, n, t, 0, rows * (n / chunk_cols(n)),
                     tid, ty, GlobalDigits<false>{d, batch, n, t.b0, tid},
                     BlockSync{}, sum);
  store_tile<false>(sum, t, ty, acc, out, batch, n);
}

}  // namespace

extern "C" int ieache_external_product(const void* d, const void* bk,
                                       const void* acc, void* out, int rows,
                                       int kp1, int batch, int n,
                                       void* stream) {
  const size_t smem = (size_t)product_smem_words(n) * sizeof(uint32_t);
  const cudaError_t err = allow_smem(external_product_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + TB - 1) / TB, (n + TJ - 1) / TJ, kp1);
  external_product_kernel<<<grid, kTileThreads, smem,
                            (cudaStream_t)stream>>>(
      (const int8_t*)d, (const uint32_t*)bk, (const uint32_t*)acc,
      (uint32_t*)out, rows, kp1, batch, n);
  return (int)cudaGetLastError();
}
