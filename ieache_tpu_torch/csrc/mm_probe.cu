// The matmul-rate probe's two kernels: a bare tensor-core product repeated
// g times into one accumulator, (s8, s8) -> s32 and (bf16, bf16) -> f32
// (ieache_tpu_torch/tools/mosaic_mm_probe.py times them).
//
// Replaces: tools/mosaic_mm_probe.py:38-62, the inline Pallas kernel of
// main() (kern: with A (m, k) and B (k, n) resident in VMEM, a grid of g
// steps, each doing o += dot_general(A, B) into a resident (m, n)
// accumulator of the preferred type).
//
//   in : a (m, k), b (k, n), both row-major int8 [s8] or bf16 [bf16]; g >= 1;
//        bt: scratch of b's size
//   out: o (m, n) int32 [s8] or float32 [bf16], o = sum of g products A @ B.
//        The int32 sum wraps mod 2^32 as the TPU's accumulator does (no
//        .satfinite); the float32 sum is taken in the kernel's own order
//        (k innermost within a pass, then pass after pass).
//
// Bound on the H100: operations.  At the tool's m = k = n = 1024, g = 512
// the product is 1.1e15 multiply-add operations over 6 MB of operands, so
// its least time is ops / tensor-core peak (1,979 TOP/s int8: 0.556 ms;
// 989 TFLOP/s bf16: 1.11 ms); the bytes take 2 us.  "Resident" cannot mean
// what it means on the TPU: A and B (1 MB each at s8) do not fit one SM's
// 228 KB of shared memory, so here they are L2-resident (2-4 MB of the
// 50 MB L2) and every block re-stages its tiles from L2 on each pass.
//
// Design: the rule form, warp-level mma.sync on operands staged in shared
// memory.  A warp computes a 64 x 32 part of the output as 4 x 4 MMA tiles
// (m16n8k32 for s8, m16n8k16 for bf16: both are 32 bytes deep), 64
// accumulator registers a thread, held over all g passes and stored
// once.  Both fragment layouts want 4 consecutive bytes along k in one
// register.  A is row-major, so it is copied as it lies.  B is (k, n)
// row-major but its fragment is column-major, so the launch first
// transposes B once into the scratch bt (n, k) with a small tiled kernel
// (1-2 MB each way, about 1% of the call; on the device, inside the
// timed call), and B is then copied as it lies too: 16-byte cp.async
// into shared rows padded by 16 bytes, so that the 8 rows x 16 bytes of
// one ldmatrix phase fall on 8 distinct bank groups.  Fragments are read
// with ldmatrix.x4 (a 16 x 32-byte A fragment, or two 8 x 32-byte B
// fragments, per instruction) as 8 x 8 b16 matrices, which hand thread
// (g, t) the word at row g, bytes 4t..4t+3: the MMA's a/b register for
// either type.  What bounds the product on this card is feeding the
// tensor cores, so the launch picks, from k, the form that keeps the
// operands closest:
//   * resident, wide: a block of 4 warps owns a 128 x 64 tile (2 x 2
//     parts; 128 blocks at 1024 x 1024, one per SM) when its 128 rows of
//     A and 64 rows of bt fit in shared memory over all of k (192 x (k
//     bytes + 16) <= 227 KB: s8 up to k = 1024, bf16 up to 512).  They
//     are staged once, then all g passes run from shared memory with no
//     barrier and no L2 traffic, which is what "resident" means on the
//     TPU;
//   * resident, narrow: a block owns one 64 x 32 part, so twice the k
//     fits (s8 up to 2304, bf16 up to 1152), and the 4 warps split k:
//     each takes every 4th k-step and the four partial sums are added
//     through shared memory at the end (the same shared bytes per MMA as
//     the wide tile; 512 blocks at 1024 x 1024, four waves);
//   * streaming, for any k: 128 x 64 tiles, 64-byte-deep k-tiles through
//     a ring of 4 shared buffers, 3 tiles in flight ahead of the MMAs,
//     one __syncthreads per tile.  Each block pulls 12 KB from L2 per 64
//     bytes of k, all 128 blocks together about 4.6 TB/s at the measured
//     rate: it is bound by the L2's bandwidth, not by the tensor cores.
// (The first version transposed B in registers on every staging pass and
// waited one L2 latency per tile: 12.7% of the int8 peak.)  A warpgroup
// (wgmma m64nNk32 / m64nNk16) version reads its operands from shared
// memory without passing them through registers, and clusters could
// share staged tiles between SMs; both are later work.
//
// m, k and n must be multiples of 128 (the wrapper refuses others).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;       // 4 warps
constexpr int kTr = 32;             // transpose tile edge, elements
constexpr int kMaxShared = 232448;  // the most a block may ask for (227 KB)

// A block's output tile: WM x WN warps of 64 x 32 outputs each.  With
// fewer than 4 such parts the 4 warps share them by splitting k.
template <int WM, int WN>
struct Tile {
  static constexpr int kBM = 64 * WM, kBN = 32 * WN;
  static constexpr int kRows = kBM + kBN;          // staged rows: A, then bt
  static constexpr int kSplit = 4 / (WM * WN);     // warps sharing a part
};
using Wide = Tile<2, 2>;            // 128 x 64, a warp a part
using Narrow = Tile<1, 1>;          // 64 x 32, the 4 warps split k

// the streaming kernel's ring of staged tiles
constexpr int kBKBytes = 64;        // staged k depth, in bytes
constexpr int kStages = 4;
constexpr int kRowBytes = kBKBytes + 16;              // shared row pitch
constexpr int kStageBytes = Wide::kRows * kRowBytes;
constexpr int kRingBytes = kStages * kStageBytes;     // 61,440

struct S8 {
  using Acc = int32_t;
  using Elem = uint8_t;
  __device__ static __forceinline__ void mma(Acc (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

struct BF16 {
  using Acc = float;
  using Elem = uint16_t;
  __device__ static __forceinline__ void mma(Acc (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// b (k, n) -> bt (n, k), through a padded shared tile so that both the
// loads and the stores are coalesced.  k and n multiples of kTr.
template <class E>
__global__ void __launch_bounds__(kTr * 8)
transpose_kernel(const E* __restrict__ b, E* __restrict__ bt, int k, int n) {
  __shared__ E tile[kTr][kTr + 1];
  const int n0 = blockIdx.x * kTr, k0 = blockIdx.y * kTr;
  for (int r = threadIdx.y; r < kTr; r += 8)
    tile[r][threadIdx.x] = b[(int64_t)(k0 + r) * n + n0 + threadIdx.x];
  __syncthreads();
  for (int r = threadIdx.y; r < kTr; r += 8)
    bt[(int64_t)(n0 + r) * k + k0 + threadIdx.x] = tile[threadIdx.x][r];
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Where a lane points ldmatrix.x4 within a staged block of `bm` rows of A
// followed by rows of bt, all `pitch` bytes apart, for the warp's part
// (wm, wn).  A, per 16-row tile: lanes 0-7 rows 0-7 bytes 0-15 (a0), 8-15
// rows 8-15 bytes 0-15 (a1), 16-23 rows 0-7 bytes 16-31 (a2), 24-31 rows
// 8-15 bytes 16-31 (a3).  B, per pair of 8-column tiles: lanes 0-7
// columns 0-7 bytes 0-15 (b0), 8-15 the same columns bytes 16-31 (b1),
// 16-31 the next 8 columns.
struct Lanes {
  uint32_t a, b;
  __device__ Lanes(int lane, int wm, int wn, int pitch, int bm)
      : a((wm * 64 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch
          + (lane >> 4) * 16),
        b((bm + wn * 32 + (lane & 7) + (lane >> 4) * 8) * pitch
          + ((lane >> 3) & 1) * 16) {}
};

// One 32-byte k-step of a warp's 64 x 32 part: its fragments from the
// staged block at `base` (k offset included), then 16 MMAs.
struct Frags {
  uint32_t a[4][4], b[2][4];
  __device__ __forceinline__ void load(uint32_t base, const Lanes& at,
                                       int pitch) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldmatrix_x4(a[mi], base + at.a + mi * 16 * pitch);
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldmatrix_x4(b[np], base + at.b + np * 16 * pitch);
  }
  template <class T>
  __device__ __forceinline__ void mma(typename T::Acc (&acc)[4][4][4]) const {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        T::mma(acc[mi][ni], a[mi], &b[ni >> 1][(ni & 1) * 2]);
  }
};

template <class Acc>
__device__ __forceinline__ void clear(Acc (&acc)[4][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
}

// Store one 16 x 32 strip of MMA tiles at (row0, col0): c0, c1 at (row
// grp, columns 2*t4, 2*t4+1), c2, c3 at row grp + 8 of each 16 x 8 tile.
template <class Acc>
__device__ __forceinline__ void store_strip(const Acc (&c)[4][4], Acc* out,
                                            int n, int64_t row0, int col0,
                                            int lane) {
  using Acc2 = typename std::conditional<std::is_same<Acc, float>::value,
                                         float2, int2>::type;
  const int64_t row = row0 + (lane >> 2);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = col0 + ni * 8 + 2 * (lane & 3);
    Acc2 lo, hi;
    lo.x = c[ni][0]; lo.y = c[ni][1];
    hi.x = c[ni][2]; hi.y = c[ni][3];
    *reinterpret_cast<Acc2*>(out + row * n + col) = lo;
    *reinterpret_cast<Acc2*>(out + (row + 8) * n + col) = hi;
  }
}

// kBytes of k of a block's `bm` rows of A and `rows - bm` rows of bt,
// from k offset kbyte0, global -> shared at `base`, rows `pitch` bytes
// apart: one 16-byte cp.async per chunk, neighbouring lanes on
// neighbouring chunks of a row.  kBytes == 0: `bytes` is given at run
// time.
template <int kBytes>
__device__ __forceinline__ void stage(uint32_t base, int pitch,
                                      const uint8_t* a, const uint8_t* bt,
                                      int64_t ld, int kbyte0, int tid, int bm,
                                      int rows, int bytes = kBytes) {
  if constexpr (kBytes != 0) {
    constexpr int kChunks = kBytes / 16, kRowsPerPass = kThreads / kChunks;
    const int c = tid % kChunks, r0 = tid / kChunks;
#pragma unroll
    for (int i = 0; i < Wide::kRows / kRowsPerPass; ++i) {
      const int r = r0 + kRowsPerPass * i;    // bm a multiple of kRowsPerPass
      const uint8_t* src = r < bm ? a + r * ld : bt + (r - bm) * ld;
      cp_async16(base + r * pitch + 16 * c, src + kbyte0 + 16 * c);
    }
  } else {
    const int chunks = bytes / 16;
    for (int idx = tid; idx < rows * chunks; idx += kThreads) {
      const int r = idx / chunks, c = idx - r * chunks;
      const uint8_t* src = r < bm ? a + r * ld : bt + (r - bm) * ld;
      cp_async16(base + r * pitch + 16 * c, src + kbyte0 + 16 * c);
    }
  }
}

// Streaming form, any k: 128 x 64 output tiles; k-tiles of kBKBytes move
// through a ring of kStages shared buffers, kStages - 1 tiles in flight
// ahead of the MMAs, one __syncthreads per tile; every pass re-stages A
// and B from L2.
template <class T>
__global__ void __launch_bounds__(kThreads)
mm_probe_stream_kernel(const uint8_t* __restrict__ a,
                       const uint8_t* __restrict__ bt,
                       typename T::Acc* __restrict__ out, int k, int n, int g) {
  extern __shared__ __align__(16) uint8_t shared[];
  const uint32_t sh = (uint32_t)__cvta_generic_to_shared(shared);
  constexpr int kBM = Wide::kBM, kBN = Wide::kBN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;       // warp's 64 x 32 part
  const int64_t ld = (int64_t)k * sizeof(typename T::Elem);  // row pitch, bytes
  const uint8_t* a_blk = a + (int64_t)blockIdx.y * kBM * ld;
  const uint8_t* b_blk = bt + (int64_t)blockIdx.x * kBN * ld;
  const Lanes at(lane, wm, wn, kRowBytes, kBM);

  typename T::Acc acc[4][4][4];
  clear(acc);

  const int k_tiles = (int)(ld / kBKBytes);
  const int tiles = g * k_tiles;
  int kt_load = 0;                      // k-tile of the next tile to stage
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      stage<kBKBytes>(sh + s * kStageBytes, kRowBytes, a_blk, b_blk, ld,
                      kt_load * kBKBytes, tid, kBM, Wide::kRows);
      kt_load = kt_load + 1 == k_tiles ? 0 : kt_load + 1;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  for (int it = 0; it < tiles; ++it) {
    // tile `it` has landed (all but the newest kStages - 2 groups are done),
    // and every warp is past the MMAs of tile it - 1, whose buffer is the
    // one staged next
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    const int ahead = it + kStages - 1;
    if (ahead < tiles) {
      stage<kBKBytes>(sh + (ahead % kStages) * kStageBytes, kRowBytes, a_blk,
                      b_blk, ld, kt_load * kBKBytes, tid, kBM, Wide::kRows);
      kt_load = kt_load + 1 == k_tiles ? 0 : kt_load + 1;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");

    const uint32_t tile = sh + (it % kStages) * kStageBytes;
#pragma unroll
    for (int ks = 0; ks < kBKBytes / 32; ++ks) {
      Frags f;
      f.load(tile + ks * 32, at, kRowBytes);
      f.template mma<T>(acc);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
    store_strip(acc[mi], out, n,
                (int64_t)blockIdx.y * kBM + wm * 64 + mi * 16,
                blockIdx.x * kBN + wn * 32, lane);
}

// Resident form, when a block's rows of A and of bt fit in shared memory
// over all of k: they are staged once and all g passes run from shared
// memory, with no barrier and no L2 traffic after the first: resident as
// on the TPU.  Fragments are double-buffered in registers.  With the
// Wide tile each warp owns a 64 x 32 part over all of k; with the Narrow
// tile (half the rows, so twice the k fits) the 4 warps take every 4th
// k-step of the one part and their sums are added through shared memory
// at the end, in warp order.
template <class T, class Shape>
__global__ void __launch_bounds__(kThreads)
mm_probe_resident_kernel(const uint8_t* __restrict__ a,
                         const uint8_t* __restrict__ bt,
                         typename T::Acc* __restrict__ out, int k, int n,
                         int g) {
  using Acc = typename T::Acc;
  extern __shared__ __align__(16) uint8_t shared[];
  const uint32_t sh = (uint32_t)__cvta_generic_to_shared(shared);
  constexpr int kBM = Shape::kBM, kBN = Shape::kBN, kSplit = Shape::kSplit;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = kSplit == 1 ? warp >> 1 : 0, wn = kSplit == 1 ? warp & 1 : 0;
  const int64_t ld = (int64_t)k * sizeof(typename T::Elem);
  const int k_bytes = (int)ld;
  const int pitch = k_bytes + 16;     // an odd number of 16-byte units
  const Lanes at(lane, wm, wn, pitch, kBM);

  stage<0>(sh, pitch, a + (int64_t)blockIdx.y * kBM * ld,
           bt + (int64_t)blockIdx.x * kBN * ld, ld, 0, tid, kBM, Shape::kRows,
           k_bytes);
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  Acc acc[4][4][4];
  clear(acc);

  // this warp's k-steps: byte offsets first, first + stride, ... < k_bytes,
  // g times over
  const int first = kSplit == 1 ? 0 : warp * 32, stride = 32 * kSplit;
  const int64_t steps = (int64_t)g * (k_bytes / stride);
  auto next = [&](int kb) { return kb + stride >= k_bytes ? first : kb + stride; };
  Frags f0, f1;
  int kb = first;
  f0.load(sh + kb, at, pitch);
  int64_t i = 0;
  for (; i + 1 < steps; i += 2) {
    kb = next(kb);
    f1.load(sh + kb, at, pitch);
    f0.template mma<T>(acc);
    kb = next(kb);
    f0.load(sh + kb, at, pitch);        // after the last step: unused
    f1.template mma<T>(acc);
  }
  if (i < steps) f0.template mma<T>(acc);

  const int64_t row0 = (int64_t)blockIdx.y * kBM + wm * 64;
  const int col0 = blockIdx.x * kBN + wn * 32;
  if constexpr (kSplit == 1) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      store_strip(acc[mi], out, n, row0 + mi * 16, col0, lane);
  } else {
    // the 4 warps' partial sums through shared memory (the operands are
    // done with): warp w then adds and stores the part's w-th 16-row strip
    Acc* part = reinterpret_cast<Acc*>(shared);
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          part[(((warp * 4 + mi) * 4 + ni) * 4 + r) * 32 + lane] =
              acc[mi][ni][r];
    __syncthreads();
    Acc sum[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sum[ni][r] = 0;
#pragma unroll
        for (int w = 0; w < 4; ++w)
          sum[ni][r] += part[(((w * 4 + warp) * 4 + ni) * 4 + r) * 32 + lane];
      }
    store_strip(sum, out, n, row0 + warp * 16, col0, lane);
  }
}

template <class T>
int launch(const void* a, const void* b, void* bt, void* out, int m, int k,
           int n, int g, void* stream) {
  using E = typename T::Elem;
  const cudaStream_t s = (cudaStream_t)stream;
  transpose_kernel<E><<<dim3(n / kTr, k / kTr), dim3(kTr, 8), 0, s>>>(
      (const E*)b, (E*)bt, k, n);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;

  // the widest tile whose staged rows fit in shared memory over all of k
  const int64_t row_bytes = (int64_t)k * sizeof(E) + 16;
  auto kernel = mm_probe_stream_kernel<T>;
  dim3 grid(n / Wide::kBN, m / Wide::kBM);
  int shared = kRingBytes;
  if (Wide::kRows * row_bytes <= kMaxShared) {
    kernel = mm_probe_resident_kernel<T, Wide>;
    shared = (int)(Wide::kRows * row_bytes);
  } else if (Narrow::kRows * row_bytes <= kMaxShared) {
    kernel = mm_probe_resident_kernel<T, Narrow>;
    grid = dim3(n / Narrow::kBN, m / Narrow::kBM);
    shared = (int)(Narrow::kRows * row_bytes);   // > 4 x 8 KB of partial sums
  }
  code = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (code != 0) return code;
  kernel<<<grid, kThreads, shared, s>>>(
      (const uint8_t*)a, (const uint8_t*)bt, (typename T::Acc*)out, k, n, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ieache_mm_s8(const void* a, const void* b, void* bt, void* out,
                            int m, int k, int n, int g, void* stream) {
  return launch<S8>(a, b, bt, out, m, k, n, g, stream);
}

extern "C" int ieache_mm_bf16(const void* a, const void* b, void* bt,
                              void* out, int m, int k, int n, int g,
                              void* stream) {
  return launch<BF16>(a, b, bt, out, m, k, n, g, stream);
}
