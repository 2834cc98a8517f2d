// The LWE-to-LWE keyswitch of a bootstrap wave in one kernel.
//
// Replaces: no TPU kernel.  The JAX package leaves the keyswitch to XLA
// (ieache_tpu/ops/keyswitch.py); the port ran it as plain ops
// (ops/keyswitch.py:keyswitch_plain): the digits in about 26 elementwise
// ops, four torch._int_mm products, one per int8 limb of the key, then
// shifts, adds and the finish, about 45 launches a wave.  This kernel is
// the same function in one launch, after a zeroing of the output:
//
//   in : lwe (B, kN+1) int32   the sample-extracted ciphertexts
//        ks  (4, K, M) int8    the key's balanced int8 limbs, K = kN*t
//                               rows, M >= n+1 columns (padding past n)
//   out: (B, n+1) int32, out[b, m] = [m == n] lwe[b, kN]
//                                     - sum_k D[b, k] KS[k, m]  (mod 2^32)
//   D[b, i*t + j] = ((lwe[b, i] + offset) >> (32 - (j+1) basebit)
//                    & (2^basebit - 1)) - 2^(basebit - 1)
//   KS = sum_v ks[v] << 8v
//
// Bound on the H100, at lambda=110 (K = 8192, M = 504): at one lane the
// key's 16.5 MB, 4.9 us at 3.35 TB/s; at 1024 lanes the int8 products,
// 4 x 2 x 1024 x 8192 x 504 = 33.8 GOP, 17.1 us at 1,979 TOP/s.  The
// four cuBLAS products it replaces took 0.92-1.17 ms at every batch: a
// grid of a few blocks, each walking all 8,192 rows of K, the other SMs
// idle.  The design, for mma.sync.m16n8k32 (s8 x s8 -> s32, wrapping: no
// .satfinite; csrc/mma_tile.cuh's fragments):
//
// * Split-K over the card.  The K rows are cut in units of 64; a block
//   owns one K-slice of units, one tile of 16, 32 or 64 lanes, and all M
//   columns, so that a unit of one limb is one contiguous run of 64 M
//   bytes: one bulk copy (cp.async.bulk) into a stage of a ring of four,
//   completed on the stage's mbarrier.  At one lane the launch
//   (ops/kernels.py:keyswitch_launch, the one place the policy lives)
//   cuts 128 slices, one block an SM with its whole 129 KB of the key in
//   flight at once; at 1024 lanes 16 tiles x 8 slices.  The parts meet
//   by wrapping atomic adds (red.global.add.u32) into the zeroed output:
//   addition mod 2^32 does not depend on their order, so the result is
//   exact on every run.
// * Digits made in the kernel.  Before its MMAs the block decomposes its
//   lanes' mask words for its slice into shared memory, in the A
//   fragments' order (a thread's four registers of a k-step one 16-byte
//   load), while the first four units are in flight.
// * The key as the B operand.  A B register wants four consecutive k of
//   one column; the key lies row by row.  A thread of a warp's strip of
//   32 columns loads one word (4 columns) of each of four rows and
//   transposes the 4 x 4 bytes with 8 byte permutes: four registers, one
//   for each of the strip's four 8-column tiles, tile c's fragment column
//   g being the strip's column 4 g + c.  Rows 4 q + i of a stage are
//   126 words apart at M = 504, so a warp's 32 loads fall on 32 banks.
// * The four limbs summed in registers, by Horner's rule: the ring runs
//   limb 3's units first, then 2, 1, 0, and at each new limb the block
//   shifts its accumulators left by 8; the MMAs' sums wrap mod 2^32.  One
//   set of accumulators (16 a 16-lane tile a thread), no fold.
// * The finish in the epilogue.  Each warp puts its accumulators through
//   shared memory (columns back in order), and adds minus the sum, lane l
//   of the warp column 32 w + l of a row: a warp's atomics fall on one
//   128-byte line.  Slice 0's blocks add the body at column n; columns
//   past n are never written.
//
// A key's rows past the slice meet zero digits, so whatever a stage held
// there adds nothing; the last strip's loads past M read the next row's
// bytes into columns that are never written (each stage keeps 32 bytes of
// slack).  All torus arithmetic is uint32_t.

#include <atomic>
#include <climits>

#include "wgmma_tile.cuh"

using namespace ieache;

namespace {

constexpr int kUnitRows = 64;   // key rows a stage: the K split's unit
constexpr int kStages = 4;      // stages of the ring
constexpr int kStagePad = 32;   // bytes past a stage that a strip reads
constexpr int kMaxStrips = 16;  // warps, one 32-column strip each
constexpr int kEpiPitch = 36;   // words a row of a warp's epilogue tile
constexpr int kBarBytes = 128;  // the stages' mbarriers, then alignment
constexpr int kSmemLimit = 232448;

__host__ __device__ inline int stage_bytes(int m) {
  return kUnitRows * m + kStagePad;
}

// ops/kernels.py:keyswitch_smem_bytes
inline size_t smem_bytes(int m, int lanes, int units) {
  const size_t ring = (size_t)kStages * stage_bytes(m);
  const size_t digits = (size_t)units * kUnitRows * lanes;
  const size_t epi = (size_t)((m + 31) / 32) * 16 * kEpiPitch * 4;
  return kBarBytes + (ring + digits > epi ? ring + digits : epi);
}

// `bytes` from global `src` into shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The 4 x 4 byte transpose: byte i of t[c] = byte c of w[i].
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&t)[4]) {
  const uint32_t x = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t y = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t z = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t u = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(x, z, 0x5410);
  t[1] = __byte_perm(x, z, 0x7632);
  t[2] = __byte_perm(y, u, 0x5410);
  t[3] = __byte_perm(y, u, 0x7632);
}

// One block: K-slice blockIdx.x of `split`, lanes b0 .. b0 + 16 MT - 1
// (b0 = 16 MT blockIdx.y), every column; one warp a 32-column strip.
template <int MT>
__global__ void __launch_bounds__(kMaxStrips * 32, 1)
    keyswitch_kernel(const uint32_t* __restrict__ lwe,
                     const int8_t* __restrict__ ks, uint32_t* out, int batch,
                     int kn, int t, int basebit, uint32_t offset, int krows,
                     int m, int n, int split) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem);
  uint8_t* ring = smem + kBarBytes;
  const uint32_t sring = bars + kBarBytes;
  const int sbytes = stage_bytes(m);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int units = (krows + kUnitRows - 1) / kUnitRows;
  const int s = blockIdx.x;
  const int u0 = s * units / split, u1 = (s + 1) * units / split;
  const int nu = u1 - u0, nchunks = 4 * nu;
  const int k0 = u0 * kUnitRows;
  const int rows = min(u1 * kUnitRows, krows) - k0;
  const int b0 = blockIdx.y * 16 * MT;
  uint32_t* digits = reinterpret_cast<uint32_t*>(ring + kStages * sbytes);

  // chunk c: limb 3 - c / nu, unit u0 + c % nu, into stage c % kStages
  auto fetch = [&](int c) {
    const int v = 3 - c / nu, u = u0 + c % nu;
    const int ur = min(kUnitRows, krows - u * kUnitRows);
    const uint32_t bar = bars + 8 * (c % kStages);
    wg::mbar_expect(bar, ur * m);
    bulk_load(sring + (c % kStages) * sbytes,
              ks + ((size_t)v * krows + (size_t)u * kUnitRows) * m, ur * m,
              bar);
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) wg::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < min(kStages, nchunks); ++c) fetch(c);

  // the slice's digits in the A fragments' order: word
  // ((kk MT + mt) 32 + lane) 4 + r, register r of thread `lane` for
  // k-step kk and lanes b0 + 16 mt ..; zero past the batch and the slice
  const int words = 2 * nu * MT * 128;
  const uint32_t mask = (1u << basebit) - 1, half = 1u << (basebit - 1);
  for (int w = tid; w < words; w += blockDim.x) {
    const int r = w & 3, ln = (w >> 2) & 31, rest = w >> 7;
    const int mt = rest % MT, kk = rest / MT;
    const int b = b0 + 16 * mt + (ln >> 2) + 8 * (r & 1);
    const int k = 32 * kk + 4 * (ln & 3) + 16 * (r >> 1);
    uint32_t word = 0;
    if (b < batch) {
      const uint32_t* row = lwe + (size_t)b * (kn + 1);
      int wi = (k0 + k) / t, j = (k0 + k) - wi * t;
      for (int i = 0; i < 4 && k + i < rows; ++i) {
        const uint32_t v = row[wi] + offset;
        const uint32_t d = ((v >> (32 - (j + 1) * basebit)) & mask) - half;
        word |= (d & 0xFF) << (8 * i);
        if (++j == t) {
          j = 0;
          ++wi;
        }
      }
    }
    digits[w] = word;
  }
  __syncthreads();

  int32_t acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][c][r] = 0;

  for (int c = 0; c < nchunks; ++c) {
    if (c > 0 && c % nu == 0) {  // a new limb: Horner's shift
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[mt][cc][r] = (int32_t)((uint32_t)acc[mt][cc][r] << 8);
    }
    wg::mbar_wait(bars + 8 * (c % kStages), (c / kStages) & 1);
    const uint8_t* st = ring + (c % kStages) * sbytes + 32 * warp + 4 * g;
    const uint4* a4 =
        reinterpret_cast<const uint4*>(digits) + 2 * (c % nu) * MT * 32 + lane;
#pragma unroll
    for (int ksb = 0; ksb < 2; ++ksb) {
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = *reinterpret_cast<const uint32_t*>(
              st + (32 * ksb + 16 * h + 4 * q + i) * m);
        transpose4(w, b[h]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 f = a4[(ksb * MT + mt) * 32];
        const uint32_t a[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          mma::mma_s8(acc[mt][cc], a, b[0][cc], b[1][cc]);
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && c + kStages < nchunks) fetch(c + kStages);
  }

  // the epilogue, a 16-lane tile at a time, through the warp's
  // 16 x kEpiPitch words of the (now idle) ring
  uint32_t* epi = reinterpret_cast<uint32_t*>(ring) + warp * 16 * kEpiPitch;
  const int col = 32 * warp + lane;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<uint4*>(epi + (g + 8 * (r >> 1)) * kEpiPitch + 8 * q +
                                4 * (r & 1)) =
          make_uint4(acc[mt][0][r], acc[mt][1][r], acc[mt][2][r],
                     acc[mt][3][r]);
    __syncwarp();
    for (int row = 0; row < 16; ++row) {
      const int b = b0 + 16 * mt + row;
      if (b >= batch) break;
      if (col <= n) {
        uint32_t v = 0u - epi[row * kEpiPitch + lane];
        if (col == n && s == 0) v += lwe[(size_t)b * (kn + 1) + kn];
        atomicAdd(out + (size_t)b * (n + 1) + col, v);
      }
    }
    __syncwarp();
  }
}

// Devices whose shared-memory limit a kernel has had raised.
constexpr int kMaxDevices = 64;

template <int MT>
int launch(const void* lwe, const void* ks, void* out, int batch, int kn,
           int t, int basebit, uint32_t offset, int krows, int m, int n,
           int split, size_t smem, cudaStream_t stream) {
  static std::atomic<bool> smem_allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !smem_allowed[dev].load()) {
    err = allow_smem(keyswitch_kernel<MT>, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_allowed[dev].store(true);
  }
  const dim3 grid(split, (batch + 16 * MT - 1) / (16 * MT));
  keyswitch_kernel<MT><<<grid, 32 * ((m + 31) / 32), smem, stream>>>(
      (const uint32_t*)lwe, (const int8_t*)ks, (uint32_t*)out, batch, kn, t,
      basebit, offset, krows, m, n, split);
  return (int)cudaGetLastError();
}

}  // namespace

// `lanes`: a block's tile, 16, 32 or 64; `split`: K-slices, 1 .. the key's
// units of 64 rows.  ks 16-byte aligned; kN * t even; basebit 1..8 with
// basebit * t <= 32; M a multiple of 8 in [n+1, 512].
extern "C" int ieache_keyswitch(const void* lwe, const void* ks, void* out,
                                int batch, int kn, int t, int basebit,
                                uint32_t offset, int m, int n, int lanes,
                                int split, void* stream) {
  const int64_t krows64 = (int64_t)kn * t;
  if (batch < 0 || kn < 1 || t < 1 || basebit < 1 || basebit > 8 ||
      basebit * t > 32 || krows64 % 2 || krows64 > INT_MAX / 8 || n < 0 ||
      m % 8 || m < n + 1 || m > 32 * kMaxStrips ||
      ((uintptr_t)ks & 15) != 0 || (lanes != 16 && lanes != 32 && lanes != 64))
    return (int)cudaErrorInvalidValue;
  const int krows = (int)krows64;
  const int units = (krows + kUnitRows - 1) / kUnitRows;
  if (split < 1 || split > units || (batch + lanes - 1) / lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(m, lanes, (units + split - 1) / split);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)batch * (n + 1) * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (lanes == 16)
    return launch<1>(lwe, ks, out, batch, kn, t, basebit, offset, krows, m, n,
                     split, smem, s);
  if (lanes == 32)
    return launch<2>(lwe, ks, out, batch, kn, t, basebit, offset, krows, m, n,
                     split, smem, s);
  return launch<4>(lwe, ks, out, batch, kn, t, basebit, offset, krows, m, n,
                   split, smem, s);
}
