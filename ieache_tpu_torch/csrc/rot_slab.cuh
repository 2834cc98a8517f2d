// The negacyclic rotation in the transposed (k+1, N, B) layout, batch
// innermost, shared by the tr step's rotation (rot_diff_decompose_tr.cu)
// and the rotation probe's sublane kernel (rotate_probe.cu).
//
// In this layout the rotated read acc[u, (j - a_b) mod N, b] lands on
// another row of the accumulator for every batch lane b, since each lane
// has its own amount a_b: read from device memory, that is a gather, one
// 32-byte sector per 4-byte word.  So a block first copies all N rows of
// 16 lanes of one polynomial, acc[u, :, b0 .. b0 + 15], into shared memory
// (the slab: 64 KB at N = 1024) by cp.async, 16 bytes a copy, all of a
// thread's copies in flight at once, coalesced (load_slab), and then reads
// every coefficient's words from there (slab_rotated).  A warp takes 2
// rows x 16 lanes: lane b reads slab word 16 i_b + b, so its bank's low
// four bits are b and the 16 lanes never meet, and its two rows' reads
// lie 16 banks apart (the rows' parities differ); the reads are free of
// bank conflicts whatever the amounts (ops/kernels.py: rot_tr_slab_banks,
// pinned over random amounts in the CPU tests).  Each thread stores the
// words of its (j, b), so a warp writes two 64-byte pieces of a row.
//
// The launch takes `splits` from the caller (ops/kernels.py:rot_tr_route,
// the one place the policy lives): with fewer slabs than SMs that many
// blocks share a slab, each loading all of it and computing N / splits of
// its rows; 0 means the gather, where the blocks a slab would be so many
// that re-reading the slab moves more bytes than the gather's sectors (a
// small batch), or where the slab does not fit a block's shared memory.
// The gather takes one thread per (u, j, b), b fastest, so the plain read
// and every store are coalesced.

#pragma once

#include "cmux_common.cuh"

namespace ieache {

constexpr int kSlabLanes = 16;    // batch lanes of a slab
constexpr int kSlabThreads = 256; // kSlabThreads / kSlabLanes rows at a time
constexpr int kGatherLanes = 32;  // batch lanes of a gather block
constexpr int kGatherRows = 8;    // coefficients of a gather block

// Bytes of a slab: N rows of kSlabLanes words.
inline size_t slab_bytes(int n) {
  return (size_t)n * kSlabLanes * sizeof(uint32_t);
}

// The slab of block blockIdx.x / splits, polynomial u: (N, kSlabLanes)
// words of acc (k+1, N, B) from lane b0; lanes past the batch read zero.
// `vec`: B % 4 == 0 and acc 16-byte aligned, so four lanes are one
// 16-byte copy.  Run by a block of kSlabThreads; ends with its barrier.
__device__ __forceinline__ void load_slab(const uint32_t* acc, uint32_t* slab,
                                          int u, int b0, int batch, int n,
                                          int vec) {
  const uint32_t* src = acc + (int64_t)u * n * batch + b0;
  const uint32_t slab_s = (uint32_t)__cvta_generic_to_shared(slab);
  for (int x = threadIdx.x; x < n * (kSlabLanes / 4); x += kSlabThreads) {
    const int r = x / (kSlabLanes / 4), b = 4 * (x % (kSlabLanes / 4));
    const uint32_t* row = src + (int64_t)r * batch + b;
    if (vec) {
      // all of a thread's copies in flight at once; past the batch, zeros
      const bool valid = b0 + b < batch;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                       slab_s + (uint32_t)(r * kSlabLanes + b) * 4u),
                   "l"(valid ? row : src), "r"(valid ? 16 : 0)
                   : "memory");
    } else {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (b0 + b < batch) w.x = row[0];
      if (b0 + b + 1 < batch) w.y = row[1];
      if (b0 + b + 2 < batch) w.z = row[2];
      if (b0 + b + 3 < batch) w.w = row[3];
      *reinterpret_cast<uint4*>(slab + r * kSlabLanes + b) = w;
    }
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// Coefficient j of X^a * c for the slab's lane bl: c_i with
// i = (j - a) mod 2N when i < N, else -c_{i-N}.
__device__ __forceinline__ uint32_t slab_rotated(const uint32_t* slab,
                                                 uint32_t a, int j, int n,
                                                 int bl) {
  const uint32_t i = ((uint32_t)j - a) & (uint32_t)(2 * n - 1);
  return i < (uint32_t)n ? slab[i * kSlabLanes + bl]
                         : 0u - slab[(i - n) * kSlabLanes + bl];
}

// The same from device memory: c is a column, coefficient i at
// c[i * stride].
__device__ __forceinline__ uint32_t column_rotated(const uint32_t* c,
                                                   int64_t stride, uint32_t a,
                                                   int j, int n) {
  const uint32_t i = ((uint32_t)j - a) & (uint32_t)(2 * n - 1);
  return i < (uint32_t)n ? c[(int64_t)i * stride]
                         : 0u - c[(int64_t)(i - n) * stride];
}

// The launch shapes: the gather's grid (x lanes, y rows, z polynomials)
// and block, and the slab's grid ((slabs x splits), polynomials).
inline dim3 gather_grid(int kp1, int batch, int n) {
  return dim3((batch + kGatherLanes - 1) / kGatherLanes, n / kGatherRows, kp1);
}
inline dim3 gather_block() { return dim3(kGatherLanes, kGatherRows); }
inline dim3 slab_grid(int kp1, int batch, int splits) {
  return dim3((batch + kSlabLanes - 1) / kSlabLanes * splits, kp1);
}

// Whether `splits` is a launch the slab kernels take at ring degree n:
// 0 (the gather; N >= kGatherRows), or a power of two that divides N.
inline bool slab_splits_ok(int n, int splits) {
  if (n < kGatherRows || (n & (n - 1)) != 0) return false;
  return splits == 0 || (splits > 0 && (splits & (splits - 1)) == 0 &&
                         splits <= n);
}

// Whether the slab vectorizes its copies.
inline int slab_vec(const void* acc, int batch) {
  return batch % 4 == 0 && ((uintptr_t)acc & 15) == 0;
}

}  // namespace ieache
