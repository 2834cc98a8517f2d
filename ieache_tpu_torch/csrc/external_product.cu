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
// Form: a direct int32 negacyclic convolution,
//   (d (*) g)[j] = sum_m d[m] * e[N + j - m],  e = concat(-g, g),
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
// Design: a block computes a 16 (batch) x 256 (coefficient) output tile
// of one component o.  It stages e of each row p in shared memory
// (2N words) and the tile's digits in chunks of up to 256 columns,
// widened to int32.  Each thread owns a 4 x 8 register tile: per four
// digit columns it reads one 16-byte word of digits per batch row (a
// warp-wide broadcast) and four new words of e, and issues 128
// multiply-adds.  The e values a thread needs form a window that slides
// by one word per digit column, kept in 12 registers.  The batch edge
// is masked (any B); N must be a multiple of 8.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RB = 4;              // batch rows per thread
constexpr int RJ = 8;              // output coefficients per thread
constexpr int TX = 32;             // threads along the coefficients
constexpr int TY = 4;              // threads along the batch
constexpr int TB = TY * RB;        // batch rows per block
constexpr int TJ = TX * RJ;        // coefficients per block
constexpr int MC_MAX = 256;        // digit columns staged per chunk
constexpr int PAD = 4;             // words before e: the last window
                                   // advance reads down to e[-4]

__global__ void __launch_bounds__(TX * TY) external_product_kernel(
    const int8_t* __restrict__ d, const uint32_t* __restrict__ bk,
    const uint32_t* __restrict__ acc, uint32_t* __restrict__ out, int rows,
    int kp1, int batch, int n, int mc) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* es = smem + PAD;           // e = concat(-g, g), 2N words
  uint32_t* ds = smem + PAD + 2 * n;   // digits tile (TB, mc) as int32

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int b0 = blockIdx.x * TB;
  const int o = blockIdx.z;
  const int j_first = blockIdx.y * TJ + tx * RJ;
  const bool active = j_first < n;     // false only when N < 256
  const int j0 = active ? j_first : 0;

  if (tid < PAD) smem[tid] = 0u;

  uint32_t sum[RB][RJ];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int r = 0; r < RJ; ++r) sum[rb][r] = 0u;

  uint32_t win[12];   // win[q] = e[N + j0 - m0 - 4 + q] at column group m0
  for (int p = 0; p < rows; ++p) {
    __syncthreads();  // the previous row's readers of es and ds are done
    const uint32_t* g = bk + ((int64_t)p * kp1 + o) * n;
    for (int s = tid; s < n; s += TX * TY) {
      const uint32_t gs = g[s];
      es[s] = 0u - gs;
      es[n + s] = gs;
    }
    const int8_t* dp = d + (int64_t)p * batch * n;
    const int quads = mc / 4;
    for (int m0c = 0; m0c < n; m0c += mc) {
      __syncthreads();  // es is written; the previous chunk is consumed
      for (int q = tid; q < TB * quads; q += TX * TY) {
        const int bl = q / quads, mq = q - bl * quads;
        int4 v = make_int4(0, 0, 0, 0);
        if (b0 + bl < batch) {
          const char4 c = *reinterpret_cast<const char4*>(
              dp + (int64_t)(b0 + bl) * n + m0c + 4 * mq);
          v = make_int4(c.x, c.y, c.z, c.w);
        }
        *reinterpret_cast<int4*>(ds + bl * mc + 4 * mq) = v;
      }
      __syncthreads();
      if (m0c == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const uint4 w =
              *reinterpret_cast<const uint4*>(es + n + j0 - 4 + 4 * k);
          win[4 * k] = w.x;
          win[4 * k + 1] = w.y;
          win[4 * k + 2] = w.z;
          win[4 * k + 3] = w.w;
        }
      }
#pragma unroll 2
      for (int ml = 0; ml < mc; ml += 4) {
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const uint4 dv =
              *reinterpret_cast<const uint4*>(ds + (ty * RB + rb) * mc + ml);
          const uint32_t dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int r = 0; r < RJ; ++r)
              sum[rb][r] += dd[s] * win[r - s + 4];
        }
        // slide the window to the next four columns
        const int m0 = m0c + ml;
#pragma unroll
        for (int q = 11; q >= 4; --q) win[q] = win[q - 4];
        const uint4 w = *reinterpret_cast<const uint4*>(es + n + j0 - m0 - 8);
        win[0] = w.x;
        win[1] = w.y;
        win[2] = w.z;
        win[3] = w.w;
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    const int b = b0 + ty * RB + rb;
    if (b >= batch) continue;
    const int64_t base = ((int64_t)o * batch + b) * n + j0;
    uint4 lo = make_uint4(sum[rb][0], sum[rb][1], sum[rb][2], sum[rb][3]);
    uint4 hi = make_uint4(sum[rb][4], sum[rb][5], sum[rb][6], sum[rb][7]);
    if (acc != nullptr) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(acc + base);
      const uint4 a1 = *reinterpret_cast<const uint4*>(acc + base + 4);
      lo.x += a0.x; lo.y += a0.y; lo.z += a0.z; lo.w += a0.w;
      hi.x += a1.x; hi.y += a1.y; hi.z += a1.z; hi.w += a1.w;
    }
    *reinterpret_cast<uint4*>(out + base) = lo;
    *reinterpret_cast<uint4*>(out + base + 4) = hi;
  }
}

}  // namespace

extern "C" int ieache_external_product(const void* d, const void* bk,
                                       const void* acc, void* out, int rows,
                                       int kp1, int batch, int n,
                                       void* stream) {
  const int mc = n < MC_MAX ? n : MC_MAX;
  const size_t smem = (size_t)(PAD + 2 * n + TB * mc) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        external_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((batch + TB - 1) / TB, (n + TJ - 1) / TJ, kp1);
  const dim3 block(TX, TY);
  external_product_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int8_t*)d, (const uint32_t*)bk, (const uint32_t*)acc,
      (uint32_t*)out, rows, kp1, batch, n, mc);
  return (int)cudaGetLastError();
}
