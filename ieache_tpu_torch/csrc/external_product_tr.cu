// External product of one CMux step in the transposed (k+1, N, B) layout,
// batch innermost, accumulator fused (step mode `tr`).
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _ext_product_tr_kernel and
// its host-side operand builder _bk_rev_tiles, behind
// external_product_pallas_tr (the second of the two kernels of each CMux
// step in the `tr` step mode).
//
//   in : d (rows, N, B) int8 digits, bk (rows, k+1, N) int32 one TRGSW
//        step, acc (k+1, N, B) int32 or null
//   out: out[o, :, b] = acc[o, :, b] + sum_p d[p, :, b] (*) bk[p, o, :]
//        negacyclic, exact mod 2^32
//
// Form: the direct int32 negacyclic convolution of external_product.cu,
//   out[o, j, b] += sum_m e[N + j - m] * d[p, m, b],  e = concat(-g, g),
// multiplied and accumulated in uint32_t (wrapping, exact with no bound on
// the sum).  The TPU kernel builds the transposed Toeplitz matrix with
// doubling rolls of a reversed, pre-tiled copy of the key and multiplies
// its four int8 limbs on the matrix unit; none of that is carried over.
//
// Bound on the H100: CUDA-core integer multiply-add throughput, as for
// external_product.cu: (k+1) * B * N * rows * N = 8.6 G multiply-adds per
// step at B=1024, N=1024, k=1, l=2, the same count as the split layout.
//
// Design: the product tile of cmux_common.cuh, unchanged (a block computes
// a 16 (batch) x 256 (coefficient) output tile of one component o; each
// thread a 4 x 8 register tile), with two layout-specific ends:
// * staging: in this layout digit column m's 16 batch values of the tile
//   are contiguous, so a thread loads one column's 16 bytes (a single
//   16-byte load when B % 16 == 0) and writes them, widened to int32, down
//   that column of the (16, mc) shared chunk; consecutive threads take
//   consecutive columns, so the shared stores are free of bank conflicts;
// * store: a thread's four batch rows are consecutive in b, so each of its
//   eight coefficients is one 16-byte store of the register tile's column
//   (B % 4 == 0), or four scalar stores.
// The batch edge is masked (any B); N must be a multiple of 8.

#include "cmux_common.cuh"

using namespace ieache;

namespace {

// Stages digit columns m0c .. m0c+mc-1 of row p, batch rows b0 .. b0+TB-1,
// from a (rows, N, batch) int8 tensor.  `vec` says batch % TB == 0, so
// every column's TB bytes are there and 16-byte aligned.
struct TransposedDigits {
  const int8_t* d;
  int batch, n, b0, tid;
  bool vec;
  __device__ __forceinline__ void operator()(int p, int m0c, int mc,
                                             uint32_t* ds) const {
    const int8_t* dp = d + (int64_t)p * n * batch + b0;
    for (int ml = tid; ml < mc; ml += kTileThreads) {
      const int8_t* src = dp + (int64_t)(m0c + ml) * batch;
      if (vec) {
        const int4 w = *reinterpret_cast<const int4*>(src);
        const uint32_t words[4] = {(uint32_t)w.x, (uint32_t)w.y,
                                   (uint32_t)w.z, (uint32_t)w.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            ds[(4 * q + s) * mc + ml] =
                (uint32_t)(int32_t)(int8_t)(words[q] >> (8 * s));
      } else {
#pragma unroll
        for (int bl = 0; bl < TB; ++bl)
          ds[bl * mc + ml] =
              b0 + bl < batch ? (uint32_t)(int32_t)src[bl] : 0u;
      }
    }
  }
};

// out[o, j0 + r, b .. b+RB-1] = acc[...] (when acc is not null) + the
// register tile's column r, for the thread's RB consecutive batch rows
// b = b0 + ty * RB.
__device__ __forceinline__ void store_tile_tr(const uint32_t (&sum)[RB][RJ],
                                              const Tile& t, int ty,
                                              const uint32_t* acc,
                                              uint32_t* out, int batch,
                                              int n) {
  const int b = t.b0 + ty * RB;
  if (!t.active || b >= batch) return;
  const bool vec = batch % RB == 0;
#pragma unroll
  for (int r = 0; r < RJ; ++r) {
    const int64_t base = ((int64_t)t.o * n + t.j0 + r) * batch + b;
    if (vec) {
      uint4 v = make_uint4(sum[0][r], sum[1][r], sum[2][r], sum[3][r]);
      if (acc != nullptr) {
        const uint4 a = *reinterpret_cast<const uint4*>(acc + base);
        v.x += a.x; v.y += a.y; v.z += a.z; v.w += a.w;
      }
      *reinterpret_cast<uint4*>(out + base) = v;
    } else {
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        if (b + rb >= batch) break;
        out[base + rb] =
            sum[rb][r] + (acc != nullptr ? acc[base + rb] : 0u);
      }
    }
  }
}

__global__ void __launch_bounds__(kTileThreads) external_product_tr_kernel(
    const int8_t* __restrict__ d, const uint32_t* __restrict__ bk,
    const uint32_t* __restrict__ acc, uint32_t* __restrict__ out, int rows,
    int kp1, int batch, int n) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const Tile t = make_tile(blockIdx.x, blockIdx.y, blockIdx.z, n, tx);
  uint32_t sum[RB][RJ];
  zero_sum(sum);
  product_accumulate(
      smem, bk, kp1, n, t, 0, rows * (n / chunk_cols(n)), tid, ty,
      TransposedDigits{d, batch, n, t.b0, tid, batch % TB == 0}, BlockSync{},
      sum);
  store_tile_tr(sum, t, ty, acc, out, batch, n);
}

}  // namespace

extern "C" int ieache_external_product_tr(const void* d, const void* bk,
                                          const void* acc, void* out,
                                          int rows, int kp1, int batch, int n,
                                          void* stream) {
  const size_t smem = (size_t)product_smem_words(n) * sizeof(uint32_t);
  const cudaError_t err = allow_smem(external_product_tr_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + TB - 1) / TB, (n + TJ - 1) / TJ, kp1);
  external_product_tr_kernel<<<grid, kTileThreads, smem,
                               (cudaStream_t)stream>>>(
      (const int8_t*)d, (const uint32_t*)bk, (const uint32_t*)acc,
      (uint32_t*)out, rows, kp1, batch, n);
  return (int)cudaGetLastError();
}
