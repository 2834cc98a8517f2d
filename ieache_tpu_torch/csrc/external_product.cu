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
// Form: the TPU kernel's, on this card's int8 tensor cores
// (ieache::mma::product_accumulate_mma in mma_tile.cuh): the int8 digits
// times the four balanced int8 limbs of the Toeplitz matrix of each key
// polynomial, mma.sync m16n8k32 s8 x s8 -> s32, the four sums recombined
// as sum_v S_v << 8v in uint32_t.  The Toeplitz limb fragments are built
// in shared memory from the 4 KB key polynomial; no (N x N) operand
// exists in device memory.  Each limb's sum is exact in s32 while
// rows * N < 2^17, and the launch refuses larger shapes
// (cudaErrorInvalidValue), as it refuses an N that is not a power of two
// of at least 64.
//
// Bound on the H100: operations.  At B=1024, N=1024, k=1, l=2 (4 rows) a
// step is 4 limbs * rows * (k+1) * B * N * N = 34.4 G int8 multiply-adds,
// 0.035 ms at the tensor cores' peak; its bytes (16 KB of key, 4 MB of
// digits, 8 MB of accumulator in and out) take 0.006 ms.  What holds a
// hand-written mma.sync kernel below that peak is feeding the tensor
// cores from shared memory: mma_tile.cuh's note says what the tile does
// about it (one ldmatrix of digits for the four limbs, Toeplitz fragments
// reused along diagonals).
//
// Design: a block computes one 16 (batch) x T (coefficient) tile of one
// component o, T = min(N, 256), over all (p, chunk) pairs, adds the
// accumulator and stores.  At B=1024 that is 512 blocks, two resident an
// SM.  A small batch has too few tiles to fill the card (8 at B <= 16),
// so the launch then splits each tile's sum over its (p, chunk) pairs
// into the smallest number of parts that gives a part per SM
// (mma::split_for), first copies the accumulator into the output (or
// clears it), and each part adds its share with atomicAdd on unsigned
// int, which wraps: exact in any order.

#include "mma_tile.cuh"

using namespace ieache;

namespace {

// Part q of `split` of tile (blockIdx.x / split, blockIdx.y, blockIdx.z).
template <int NI>
__global__ void __launch_bounds__(mma::kThreads, 2) external_product_kernel(
    const int8_t* __restrict__ d, const uint32_t* __restrict__ bk,
    const uint32_t* acc, uint32_t* out, int rows, int kp1, int batch, int n,
    int split) {
  extern __shared__ __align__(16) uint8_t smem[];
  using S = mma::Shape<NI>;
  const int tid = threadIdx.x;
  const int q = blockIdx.x % split, b0 = (blockIdx.x / split) * mma::BM;
  const int jb = blockIdx.y * S::T, o = blockIdx.z;
  const int nchunks = rows * (n / S::T);
  int32_t sum[4][NI][4];
  mma::zero_acc<NI>(sum);
  mma::product_accumulate_mma<NI>(
      smem, mma::GlobalDigits<NI>{d, batch, n, b0}, bk, kp1, n, o, jb,
      q * nchunks / split, (q + 1) * nchunks / split, tid, BlockSync{}, sum);
  if (split > 1) {
    mma::atomic_add_tile_mma<NI>(sum, o, b0, jb, tid, out, batch, n);
  } else {
    mma::store_tile_mma<NI, false>(sum, o, b0, jb, tid, acc, out, batch, n);
  }
}

// The launch for N's tile, NI = min(N, 256) / 32.
template <int NI>
int launch(const void* d, const void* bk, const void* acc, void* out,
           int rows, int kp1, int batch, int n, int sms, cudaStream_t s) {
  using S = mma::Shape<NI>;
  const int nbt = (batch + mma::BM - 1) / mma::BM, njt = n / S::T;
  const int split = mma::split_for(nbt * njt * kp1, rows * (n / S::T), sms);
  cudaError_t err = cudaSuccess;
  if (split > 1) {
    const size_t bytes = (size_t)kp1 * batch * n * sizeof(uint32_t);
    err = acc != nullptr
              ? cudaMemcpyAsync(out, acc, bytes, cudaMemcpyDeviceToDevice, s)
              : cudaMemsetAsync(out, 0, bytes, s);
    if (err != cudaSuccess) return (int)err;
  }
  err = allow_smem(external_product_kernel<NI>, S::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  external_product_kernel<NI>
      <<<dim3(nbt * split, njt, kp1), mma::kThreads, S::kSmemBytes, s>>>(
          (const int8_t*)d, (const uint32_t*)bk, (const uint32_t*)acc,
          (uint32_t*)out, rows, kp1, batch, n, split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ieache_external_product(const void* d, const void* bk,
                                       const void* acc, void* out, int rows,
                                       int kp1, int batch, int n,
                                       void* stream) {
  if (!mma::shape_ok(rows, n)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n >= 256)
    return launch<8>(d, bk, acc, out, rows, kp1, batch, n, sms, s);
  if (n == 128)
    return launch<4>(d, bk, acc, out, rows, kp1, batch, n, sms, s);
  return launch<2>(d, bk, acc, out, rows, kp1, batch, n, sms, s);
}
