// The external product's output tile on the int8 tensor cores, which every
// product kernel runs: external_product.cu, blind_rotate_scan.cu,
// cmux_step.cu and cmux_step_overlap.cu as below; external_product_tr.cu
// builds the same planes and windows with the roles of the two operands
// swapped (its note says how).
//
// The function, for one output component o, as a matrix product:
//   out[b, j] = sum_p sum_m d[p, b, m] * T_p[m, j],  T_p[m, j] = e_p[N + j - m],
//   e_p = concat(-g_p, g_p), g_p = bk[p, o, :],
// with T split into four balanced int8 limbs (T = sum_v T_v << 8v, each
// limb in [-128, 127]), four s8 x s8 -> s32 products S_v, and the result
// sum_v S_v << 8v taken in uint32_t, which wraps mod 2^32.  It is what the
// TPU kernel and the plain twin (external_product_plain) compute.
//
// Design, for mma.sync.m16n8k32 (s8, s8 -> s32, wrapping: no .satfinite):
//
// * Which operand is which.  The digits are the MMA's A operand (16 batch
//   rows x 32 digit columns, row-major: exactly how (B, N) int8 digits
//   lie, so a staged tile is read with ldmatrix as it is), the Toeplitz
//   limb tile its B operand (32 digit columns x 8 coefficients).  The
//   result fragment then holds two neighbouring coefficients of one batch
//   row a thread, and a group of four threads writes 32 contiguous bytes
//   along N.  With the batch on the 8-wide side instead, a thread's
//   results would lie 4 bytes apart in two rows of N and would need a
//   transpose through shared memory.  The price is padding at B = 8 (half
//   of each MMA), which costs nothing that can be measured: a step at
//   B <= 16 is bound by latency, not by the tensor cores.
// * Nothing of the Toeplitz operand exists in device memory.  A block
//   reads the 4 KB key polynomial g_p and builds, in shared memory, the
//   byte planes of the part of e_p its tile needs.  Balanced limbs come
//   from one add and one xor per word: byte v of
//   (e + 0x80808080) ^ 0x80808080, sign-extended, is limb v of e.
// * Unaligned fragments.  A B-fragment register holds four consecutive m
//   of one coefficient j, and T runs backwards in m, so each plane is
//   stored reversed, R_v[i] = limb_v(e[2N - 1 - i]); the register is then
//   the four bytes at R_v[N - 1 - j + m ..], whose alignment is
//   (3 - j) mod 4.  Each plane is kept in four copies, copy s shifted by s
//   bytes, so that every fragment register is one aligned 32-bit load of
//   the copy s = 3 - (j mod 4).  The copies lie 8 banks apart, which makes
//   a warp's load conflict-free (within a copy its 32 lanes touch 5
//   neighbouring words).
// * Reuse along diagonals.  A fragment depends on m0 - j0 only.  A warp
//   owns NI neighbouring 8-coefficient tiles and walks the digit columns in
//   steps of 32, so per step and limb it needs the diagonals
//   4 ks - NI + 1 .. 4 ks + 2 (in units of 8): a window of NI + 2
//   registers that slides by 4.  Four 32-bit loads per limb and k-step
//   feed NI MMAs, whatever NI is.
// * Four limbs, one read of the digits.  A warp tile is 16 batch rows x
//   8 NI coefficients; its four limb accumulators are 16 NI registers
//   (128 at NI = 8), the windows 4 (NI + 2).  One ldmatrix.x4 of digits
//   then feeds 4 NI MMAs.  The four sums are folded once, after the whole
//   sum, as sum_v (uint32_t)S_v << 8v.  Each S_v is exact in s32 while
//   rows * N * 2^14 < 2^31; the launches refuse rows * N >= 2^17.
// * A block is 4 warps side by side along N: a 16 x T tile, T = min(N,
//   256), NI = T / 32; a launch may split a tile's sum over its (p, chunk)
//   pairs (split_for) and add the parts atomically.  Digits stream in
//   chunks of T columns through a ring of 4 shared buffers (16-byte
//   cp.async.cg, rows past the batch zero-filled, 3 chunks in flight);
//   rows are padded by 16 bytes so that ldmatrix's 8 rows fall on 8
//   distinct bank groups.  The planes are built per TRGSW row p for up to
//   4 chunks of digit columns at a time (T + 4T - 1 bytes of each of the 16
//   copies: 21 KB at N = 1024).  Shared memory: 38.4 KB a block at
//   N >= 256, so two blocks fit an SM beside their registers.
// * Two sources of digits (the template parameter Digits).  GlobalDigits
//   is the ring above, fed from a (rows, B, N) int8 tensor in device
//   memory (external_product.cu).  SharedDigits points ldmatrix straight
//   into a (rows, 16, N + 16) int8 tile that the block itself decomposed
//   into shared memory (ieache::decompose_tile; cmux_step.cu,
//   cmux_step_overlap.cu, blind_rotate_scan.cu): no ring, no cp.async,
//   no wait, and the 16-byte row padding again puts ldmatrix's 8 rows on
//   8 bank groups.  The block-wide barriers are a functor (Sync), since in a
//   warp-specialised block only the consumer warps run the tile.
//
// N must be a power of two, at least 64.

#pragma once

#include "cmux_common.cuh"

namespace ieache {
namespace mma {

constexpr int kThreads = kTileThreads;  // 4 warps
constexpr int BM = TB;                  // batch rows per tile: the MMA's m
constexpr int kStages = 4;              // ring of staged digit chunks
constexpr int kSegChunks = 4;           // chunks per build of the planes
constexpr int kMaxTerms = 1 << 17;      // rows * N below this: S_v exact

// Geometry of a block's tile for NI 8-coefficient MMA tiles a warp.
template <int NI>
struct Shape {
  static constexpr int T = 32 * NI;           // coefficients, and chunk columns
  static constexpr int kPitch = T + 16;       // staged digit row, bytes
  static constexpr int kStageBytes = BM * kPitch;
  static constexpr int kPlaneWords = (T + kSegChunks * T) / 4;
  // a copy's stride in words, 8 mod 32: the 4 copies 8 banks apart
  static constexpr int kPlaneStride =
      kPlaneWords + ((8 - kPlaneWords % 32) + 32) % 32;
  static constexpr int kPlanesBytes = 16 * kPlaneStride * 4;  // 4 limbs x 4
  static constexpr int kSmemBytes = kPlanesBytes + kStages * kStageBytes;
};

// Whether the tile takes the shape; the launches return
// cudaErrorInvalidValue otherwise.
inline bool shape_ok(int rows, int n) {
  return n >= 64 && (n & (n - 1)) == 0 && (int64_t)rows * n < kMaxTerms;
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// 16 bytes global -> shared through L2 only; `bytes` of them are read (16
// or 0), the rest is written as zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// The planes of one key polynomial g = bk[p, o, :] for a tile whose first
// coefficient is jb and digit columns ma .. ma + mcols - 1: word x of copy
// s of limb v holds R_v[lo + 4x + s ..+3], lo = N - jb - T + ma, that is
// limb v of e[i0 - s], e[i0 - s - 1], .. with i0 = N - 1 + jb + T - ma - 4x
// (e[i] = 0 for i < 0: such bytes pad the last words and are never used).
template <int NI>
__device__ __forceinline__ void build_planes(uint32_t* planes,
                                             const uint32_t* g, int n, int jb,
                                             int ma, int mcols, int tid) {
  using S = Shape<NI>;
  constexpr uint32_t kBias = 0x80808080u;
  const int nwords = (S::T + mcols) / 4;
  for (int x = tid; x < nwords; x += kThreads) {
    const int i0 = n - 1 + jb + S::T - ma - 4 * x;
    uint32_t bx[7];   // the biased words: byte v is limb v
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const int i = i0 - q;
      const uint32_t e = i >= n ? g[i - n] : (i >= 0 ? 0u - g[i] : 0u);
      bx[q] = (e + kBias) ^ kBias;
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      // byte v of bx[0..3] and of bx[4..6], lowest index in the lowest byte
      const uint32_t pick = (uint32_t)v | ((uint32_t)(4 + v) << 4);
      const uint32_t lo = __byte_perm(__byte_perm(bx[0], bx[1], pick),
                                      __byte_perm(bx[2], bx[3], pick), 0x5410);
      const uint32_t hi = __byte_perm(__byte_perm(bx[4], bx[5], pick), bx[6],
                                      0x0010u | ((uint32_t)(4 + v) << 8));
#pragma unroll
      for (int s = 0; s < 4; ++s)
        planes[(v * 4 + s) * S::kPlaneStride + x] =
            __funnelshift_r(lo, hi, 8 * s);
    }
  }
}

// Digit columns m0c .. m0c + T - 1 of row p, batch rows b0 .. b0 + BM - 1,
// from the global (rows, batch, N) int8 tensor into one ring buffer.
template <int NI>
__device__ __forceinline__ void stage_digits(uint32_t dst, const int8_t* d,
                                             int p, int m0c, int batch, int n,
                                             int b0, int tid) {
  using S = Shape<NI>;
  constexpr int kPieces = S::T / 16;
  for (int q = tid; q < BM * kPieces; q += kThreads) {
    const int r = q / kPieces, c = q - r * kPieces;
    const bool valid = b0 + r < batch;
    const int8_t* src =
        d + ((int64_t)p * batch + (valid ? b0 + r : 0)) * n + m0c + 16 * c;
    cp_async16(dst + r * S::kPitch + 16 * c, src, valid ? 16 : 0);
  }
}

// Digit source: batch rows b0 .. b0 + BM - 1 of a (rows, batch, N) int8
// tensor in device memory, streamed chunk by chunk through the ring of
// kStages buffers behind the planes.
template <int NI>
struct GlobalDigits {
  static constexpr bool kRing = true;
  const int8_t* d;
  int batch, n, b0;
  __device__ __forceinline__ int pitch() const { return Shape<NI>::kPitch; }
  // Start chunk c's copy into its ring buffer (nothing when c is past the
  // range) and commit the group.
  __device__ __forceinline__ void stage(uint32_t ring, int c, int c_begin,
                                        int c_end, int tid) const {
    using S = Shape<NI>;
    if (c < c_end) {
      const int nchunk = n / S::T, p = c / nchunk;
      stage_digits<NI>(ring + ((c - c_begin) % kStages) * S::kStageBytes, d, p,
                       (c - p * nchunk) * S::T, batch, n, b0, tid);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
};

// Digit source: a (rows, BM, row_bytes) int8 tile in shared memory that
// the block decomposed itself (ieache::decompose_tile), row_bytes =
// digit_pitch(N).  `tile` is its shared-space address, 16-byte aligned.
// The caller makes the tile's writes visible to the tile's threads before
// the call (the first sync() of the product is enough when the same
// threads wrote it).
struct SharedDigits {
  static constexpr bool kRing = false;
  uint32_t tile;
  int row_bytes;
  __device__ __forceinline__ int pitch() const { return row_bytes; }
};

// acc[v] += the tile's share of sum_p d[p] x T_{p,v} over the (p, chunk)
// pairs c_begin .. c_end-1, pair c = p * (N / T) + chunk, for the 16 x T
// tile at coefficient jb of component o, the digits of its batch rows
// from `dg`.  Run by kThreads threads (tid 0 .. kThreads - 1) with the
// same arguments, which `sync` joins in a barrier; smem holds
// Shape<NI>::kPlanesBytes bytes, 16-byte aligned, and behind them, for a
// ring source, kStages * kStageBytes more (Shape<NI>::kSmemBytes in all).
// Thread (warp, lane) ends with, in acc[v][ni][0..3], limb v's sums for
// batch rows lane/4 (0, 1) and lane/4 + 8 (2, 3) of the tile at
// coefficients jb + warp * 8 NI + 8 ni + 2 (lane % 4) and the next.
// `planes_ready`: the caller built the planes of the first segment (the
// pairs from c_begin up to kSegChunks chunks, within c_begin's row p)
// itself, with build_planes, after the last readers of the planes.
template <int NI, class Digits, class Sync>
__device__ __forceinline__ void product_accumulate_mma(
    uint8_t* smem, const Digits& dg, const uint32_t* bk, int kp1, int n, int o,
    int jb, int c_begin, int c_end, int tid, const Sync& sync,
    int32_t (&acc)[4][NI][4], bool planes_ready = false) {
  using S = Shape<NI>;
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem);
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, t4 = lane & 3;
  const int nchunk = n / S::T;

  // this thread's word of diagonal 0 in limb 0's copy 3 - grp % 4
  const uint32_t* wp = planes + (3 - (grp & 3)) * S::kPlaneStride +
                       (S::T - warp * 8 * NI) / 4 + t4 - 1 - (grp >> 2);
  // where this lane points ldmatrix.x4 in a chunk of digits: lanes 0-7
  // rows 0-7 bytes 0-15, 8-15 rows 8-15, 16-31 the same rows' bytes 16-31
  const uint32_t lm = ((lane & 7) + ((lane >> 3) & 1) * 8) * dg.pitch() +
                      (lane >> 4) * 16;

  uint32_t ring = 0;
  if constexpr (Digits::kRing) {
    ring = (uint32_t)__cvta_generic_to_shared(smem + S::kPlanesBytes);
    sync();  // an earlier tile's readers of the ring are done
    for (int s = 0; s < kStages - 1; ++s)
      dg.stage(ring, c_begin + s, c_begin, c_end, tid);
  }

  uint32_t win[4][NI + 2];  // win[v][i]: diagonal 4 kseg - NI + 1 + i
  int c = c_begin;
  while (c < c_end) {
    const int p = c / nchunk, ch0 = c - p * nchunk;
    int nseg = c_end - c < nchunk - ch0 ? c_end - c : nchunk - ch0;
    if (nseg > kSegChunks) nseg = kSegChunks;
    if (!planes_ready || c != c_begin) {
      sync();  // the previous planes' readers are done
      build_planes<NI>(planes, bk + ((int64_t)p * kp1 + o) * n, n, jb,
                       ch0 * S::T, nseg * S::T, tid);
    }
    for (int i = 0; i < nseg; ++i, ++c) {
      uint32_t chunk;  // this lane's ldmatrix row in chunk c
      if constexpr (Digits::kRing) {
        // chunk c has landed, the planes are built, and every warp is
        // past chunk c - 1, whose buffer is the one staged next
        asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");
        sync();
        dg.stage(ring, c + kStages - 1, c_begin, c_end, tid);
        chunk = ring + ((c - c_begin) % kStages) * S::kStageBytes + lm;
      } else {
        if (i == 0) sync();  // the planes are built
        chunk = dg.tile + p * BM * dg.pitch() + (ch0 + i) * S::T + lm;
      }
      if (i == 0) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int w = 0; w < NI - 2; ++w)
            win[v][w + 4] = wp[v * 4 * S::kPlaneStride + 2 * (w - NI + 1)];
      }
      const uint32_t* wk = wp + 8 * NI * i;  // diagonal 4 kseg, kseg = NI i
#pragma unroll
      for (int ks = 0; ks < NI; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, chunk + 32 * ks);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
#pragma unroll
          for (int w = 0; w < NI - 2; ++w) win[v][w] = win[v][w + 4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            win[v][NI - 2 + q] =
                wk[v * 4 * S::kPlaneStride + 2 * (4 * ks - 1 + q)];
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_s8(acc[v][ni], a, win[v][NI - 1 - ni], win[v][NI + 1 - ni]);
        }
      }
    }
  }
  if constexpr (Digits::kRing)
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int NI>
__device__ __forceinline__ void zero_acc(int32_t (&acc)[4][NI][4]) {
#pragma unroll
  for (int v = 0; v < 4; ++v)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[v][ni][r] = 0;
}

// sum_v S_v << 8v for one result register, in uint32_t: it wraps.
template <int NI>
__device__ __forceinline__ uint32_t fold(const int32_t (&acc)[4][NI][4],
                                         int ni, int r) {
  return (uint32_t)acc[0][ni][r] + ((uint32_t)acc[1][ni][r] << 8) +
         ((uint32_t)acc[2][ni][r] << 16) + ((uint32_t)acc[3][ni][r] << 24);
}

// out[o, b, j] = add[o, b, j] (when add is not null) + the folded tile.
template <int NI, bool kCg>
__device__ __forceinline__ void store_tile_mma(
    const int32_t (&acc)[4][NI][4], int o, int b0, int jb, int tid,
    const uint32_t* add, uint32_t* out, int batch, int n) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int b = b0 + (lane >> 2) + 8 * half;
    if (b >= batch) continue;
    const int64_t row =
        ((int64_t)o * batch + b) * n + jb + warp * 8 * NI + 2 * (lane & 3);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      uint2 v = make_uint2(fold<NI>(acc, ni, 2 * half),
                           fold<NI>(acc, ni, 2 * half + 1));
      if (add != nullptr) {
        const uint2* src = reinterpret_cast<const uint2*>(add + row + 8 * ni);
        const uint2 a = kCg ? __ldcg(src) : *src;
        v.x += a.x;
        v.y += a.y;
      }
      *reinterpret_cast<uint2*>(out + row + 8 * ni) = v;
    }
  }
}

// out[o, b, j] += the folded tile (+ add[(b - b0) * add_pitch + j - jb],
// a 16 x T tile in any memory space, when add is not null), atomically
// (wrapping, so exact in any order).
template <int NI>
__device__ __forceinline__ void atomic_add_tile_mma(
    const int32_t (&acc)[4][NI][4], int o, int b0, int jb, int tid,
    uint32_t* out, int batch, int n, const uint32_t* add = nullptr,
    int add_pitch = 0) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int b = b0 + (lane >> 2) + 8 * half;
    if (b >= batch) continue;
    unsigned int* dst = reinterpret_cast<unsigned int*>(
        out + ((int64_t)o * batch + b) * n + jb + warp * 8 * NI +
        2 * (lane & 3));
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      uint2 v = make_uint2(fold<NI>(acc, ni, 2 * half),
                           fold<NI>(acc, ni, 2 * half + 1));
      if (add != nullptr) {
        const uint2 a = *reinterpret_cast<const uint2*>(
            add + (b - b0) * add_pitch + warp * 8 * NI + 2 * (lane & 3) +
            8 * ni);
        v.x += a.x;
        v.y += a.y;
      }
      atomicAdd(dst + 8 * ni, v.x);
      atomicAdd(dst + 8 * ni + 1, v.y);
    }
  }
}

// The smallest divisor of a tile's `nchunks` (p, chunk) pairs that gives
// at least one part per SM, for a launch of `ntiles` tiles.
inline int split_for(int ntiles, int nchunks, int sms) {
  int split = 1;
  while (ntiles * split < sms && split < nchunks) {
    do {
      ++split;
    } while (nchunks % split);
  }
  return split;
}

}  // namespace mma
}  // namespace ieache
