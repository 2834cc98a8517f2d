// Device code shared by the blind rotation's CUDA kernels: the rotation +
// diff + gadget decomposition of a CMux step, by coefficient (rot_diff),
// by run of coefficients from aligned quads (rot_diff_run:
// rot_diff_decompose.cu), and as a tile of digits in shared memory
// (decompose_tile: cmux_step.cu, cmux_step_overlap.cu,
// blind_rotate_scan.cu), with a digit
// row's four bytes packed into one word (digit_word); the block's
// barriers, and the constants of the product tile that mma_tile.cuh
// builds on the int8 tensor cores.
//
// Layouts, as in the JAX package's Pallas kernels (pallas_kernels.py):
//   acc    (k+1, B, N) int32   accumulator, transposed
//   digits (rows, B, N) int8   row p = u*l + jl, the bootstrapping key's
//                               row order
//   bk_i   (rows, k+1, N) int32 one TRGSW step of the bootstrapping key
// All torus arithmetic is uint32_t: it wraps mod 2^32, where signed
// overflow in C++ is undefined.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ieache {

constexpr int TB = 16;             // batch rows of a product tile
constexpr int kTileThreads = 128;  // threads of a product tile: 4 warps

// A global load.  kCg = true reads through L2 only (ld.global.cg): for
// data that other blocks wrote earlier in the same launch (the scan
// kernel), which a stale L1 line must not serve.
template <bool kCg>
__device__ __forceinline__ uint32_t load_u32(const uint32_t* p) {
  if constexpr (kCg) return __ldcg(reinterpret_cast<const unsigned int*>(p));
  else return *p;
}

// (X^a * c - c)[j] + offset for one polynomial c (N a power of two, a in
// [0, 2N)): coefficient j of X^a * c is c_i with i = (j - a) mod 2N when
// i < N, else -c_{i-N}.
template <bool kCg>
__device__ __forceinline__ uint32_t rot_diff(const uint32_t* c, uint32_t a,
                                             int j, int n, uint32_t offset) {
  const uint32_t i = ((uint32_t)j - a) & (uint32_t)(2 * n - 1);
  const uint32_t rotated =
      i < (uint32_t)n ? load_u32<kCg>(c + i) : 0u - load_u32<kCg>(c + i - n);
  return (rotated - load_u32<kCg>(c + j)) + offset;
}

// Balanced gadget digit jl of v (offset already added).
__device__ __forceinline__ int8_t gadget_digit(uint32_t v, int jl,
                                               int bg_bit) {
  const int shift = 32 - (jl + 1) * bg_bit;
  const uint32_t mask = (1u << bg_bit) - 1u;
  return (int8_t)((int)((v >> shift) & mask) - (1 << (bg_bit - 1)));
}

// Digit jl of four consecutive coefficients v[0..3], packed little-endian
// into one word (byte s is coefficient s's digit).  With Bg = 2^8 (every
// preset with single-limb digits) digit jl is byte 3 - jl of v, less 128:
// three byte permutes gather the four bytes and a xor flips their top bits.
__device__ __forceinline__ uint32_t digit_word(const uint32_t* v, int jl,
                                               int bg_bit) {
  if (bg_bit == 8) {
    const uint32_t pick = (uint32_t)(3 - jl) | ((uint32_t)(7 - jl) << 4);
    return __byte_perm(__byte_perm(v[0], v[1], pick),
                       __byte_perm(v[2], v[3], pick), 0x5410) ^
           0x80808080u;
  }
  uint32_t word = 0u;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    word |= (uint32_t)(uint8_t)gadget_digit(v[s], jl, bg_bit) << (8 * s);
  return word;
}

// Four consecutive words at p: one 16-byte load when kVec (p 16-byte
// aligned), else four.
template <bool kVec, bool kCg>
__device__ __forceinline__ uint4 load_quad(const uint32_t* p) {
  if constexpr (kVec) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    if constexpr (kCg) return __ldcg(q);
    else return *q;
  } else {
    return make_uint4(load_u32<kCg>(p), load_u32<kCg>(p + 1),
                      load_u32<kCg>(p + 2), load_u32<kCg>(p + 3));
  }
}

// Coefficients j0 .. j0 + R - 1 of X^a * c - c + offset for one
// polynomial c (N a power of two, j0 a multiple of R, R a multiple of 4
// that divides N, a in [0, 2N)), into v.  The rotated run is e_i for
// i = i0, i0 + 1, ... (i0 = (j0 - a) mod 2N) of e = (c, -c), so R / 4 + 1
// aligned quads from i0 & ~3 cover it and it starts s = i0 & 3 words into
// them: s is the same for every run of the polynomial, so no word is
// gathered.  A quad lies wholly below N or wholly in [N, 2N) (N % 4 == 0)
// and is negated as a whole; the wrap at 2N falls between quads.  The
// words are then shifted down by s, by 2 and by 1, with selects.  Every
// load is issued before any arithmetic; the quad past the run is read
// only when s != 0.
template <int R, bool kVec, bool kCg>
__device__ __forceinline__ void rot_diff_run(const uint32_t* c, uint32_t a,
                                             int j0, int n, uint32_t offset,
                                             uint32_t (&v)[R]) {
  constexpr int kQ = R / 4;
  const uint32_t mask2n = (uint32_t)(2 * n - 1);
  const uint32_t i0 = ((uint32_t)j0 - a) & mask2n;
  const uint32_t s = i0 & 3u;
  uint4 cur[kQ], rot[kQ + 1];
#pragma unroll
  for (int t = 0; t < kQ; ++t) cur[t] = load_quad<kVec, kCg>(c + j0 + 4 * t);
  uint32_t neg = 0u;
#pragma unroll
  for (int t = 0; t <= kQ; ++t) {
    const uint32_t q = ((i0 & ~3u) + 4u * t) & mask2n;
    const bool hi = q >= (uint32_t)n;
    neg |= (uint32_t)hi << t;
    rot[t] = make_uint4(0u, 0u, 0u, 0u);
    if (t < kQ || s != 0u) rot[t] = load_quad<kVec, kCg>(c + (hi ? q - n : q));
  }
  uint32_t w[R + 4];
#pragma unroll
  for (int t = 0; t <= kQ; ++t) {
    const uint32_t m = 0u - ((neg >> t) & 1u);  // all ones: negate
    w[4 * t] = (rot[t].x ^ m) - m;
    w[4 * t + 1] = (rot[t].y ^ m) - m;
    w[4 * t + 2] = (rot[t].z ^ m) - m;
    w[4 * t + 3] = (rot[t].w ^ m) - m;
  }
#pragma unroll
  for (int k = 0; k < R + 2; ++k) w[k] = (s & 2u) ? w[k + 2] : w[k];
#pragma unroll
  for (int k = 0; k < R; ++k) w[k] = (s & 1u) ? w[k + 1] : w[k];
#pragma unroll
  for (int t = 0; t < kQ; ++t) {
    v[4 * t] = (w[4 * t] - cur[t].x) + offset;
    v[4 * t + 1] = (w[4 * t + 1] - cur[t].y) + offset;
    v[4 * t + 2] = (w[4 * t + 2] - cur[t].z) + offset;
    v[4 * t + 3] = (w[4 * t + 3] - cur[t].w) + offset;
  }
}

// Bytes of one row of a digit tile in shared memory: N digits and 16
// bytes of padding, so that the 8 rows of an ldmatrix fall on 8 distinct
// groups of 4 banks.
__host__ __device__ inline int digit_pitch(int n) { return n + 16; }

// Bytes of a block's digit tile, (rows, TB, digit_pitch(N)) int8.
__host__ __device__ inline size_t digit_tile_bytes(int rows, int n) {
  return (size_t)rows * TB * digit_pitch(n);
}

// Rotate, diff and decompose batch rows b0+bl_lo .. b0+bl_hi-1 of acc into
// rows bl_lo .. bl_hi-1 of the shared (rows, TB, digit_pitch(N)) int8 tile
// dsm: digit rows p_lo .. p_hi (p = u*l + jl) at columns col_lo ..
// col_hi-1 (col_lo a multiple of 4, their count a power of two of at least
// 4); nothing else of the tile is written.  Rows past the batch get zero
// digits.  Batch row b0 + bl's amount is bara[bl * bara_stride] (bara
// points at row b0's).  kCg reads acc through L2 only, for an accumulator
// other blocks wrote earlier in the same launch (the scan kernel).  Run by
// `nthreads`
// threads numbered from `tid`.  A thread takes four consecutive
// coefficients of one polynomial: X^bara * acc - acc once, then one 4-byte
// store for each digit row of it.  Consecutive threads take consecutive
// quads of one batch row, then the next row: the reads are coalesced, and
// a whole row (both its plain and its rotated read, the same 4 N bytes)
// is in flight at once, so L1 serves one of the two.  Each thread loads
// kI items' operands before it stores any digit; a digit row's four bytes
// are one word (digit_word).
template <bool kCg = false>
__device__ __forceinline__ void decompose_tile(
    const uint32_t* acc, const int32_t* bara, int8_t* dsm, int batch, int n,
    int b0, int bg_bit, int l, uint32_t offset, int bl_lo, int bl_hi,
    int p_lo, int p_hi, int col_lo, int col_hi, int tid, int nthreads,
    int bara_stride = 1) {
  constexpr int kI = 4;
  const int pitch = digit_pitch(n);
  const uint32_t mask2n = (uint32_t)(2 * n - 1);
  // item = (batch row, quad of the column range)
  const int quads = (col_hi - col_lo) >> 2;
  const int qshift = __ffs(quads) - 1;
  const int items = (bl_hi - bl_lo) * quads;
  for (int u = p_lo / l; u <= p_hi / l; ++u) {
    for (int it0 = tid; it0 < items; it0 += kI * nthreads) {
      uint32_t rot[kI][4];
      uint4 cur[kI];
#pragma unroll
      for (int k = 0; k < kI; ++k) {
        const int it = it0 + k * nthreads;
        const int b = b0 + bl_lo + (it >> qshift);
        cur[k] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int s = 0; s < 4; ++s) rot[k][s] = 0u;
        if (it >= items || b >= batch) continue;
        const int j = col_lo + 4 * (it & (quads - 1));
        const uint32_t* c = acc + ((int64_t)u * batch + b) * n;
        const uint32_t i0 =
            (uint32_t)j - (uint32_t)bara[(int64_t)(b - b0) * bara_stride];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t i = (i0 + s) & mask2n;
          rot[k][s] = i < (uint32_t)n ? load_u32<kCg>(c + i)
                                      : 0u - load_u32<kCg>(c + i - n);
        }
        cur[k] = load_quad<true, kCg>(c + j);
      }
#pragma unroll
      for (int k = 0; k < kI; ++k) {
        const int it = it0 + k * nthreads;
        if (it >= items) continue;
        const int bl = bl_lo + (it >> qshift);
        const int j = col_lo + 4 * (it & (quads - 1));
        const bool valid = b0 + bl < batch;
        const uint32_t v[4] = {rot[k][0] - cur[k].x + offset,
                               rot[k][1] - cur[k].y + offset,
                               rot[k][2] - cur[k].z + offset,
                               rot[k][3] - cur[k].w + offset};
        for (int jl = 0; jl < l; ++jl) {
          const int p = u * l + jl;
          if (p < p_lo || p > p_hi) continue;
          *reinterpret_cast<uint32_t*>(dsm + (p * TB + bl) * pitch + j) =
              valid ? digit_word(v, jl, bg_bit) : 0u;
        }
      }
    }
  }
}

// A barrier over the whole block.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// A named barrier over the tile's kTileThreads threads only (the block
// holds other warps too).
template <int kId>
struct TileSync {
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(kId), "r"(kTileThreads)
                 : "memory");
  }
};

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace ieache
