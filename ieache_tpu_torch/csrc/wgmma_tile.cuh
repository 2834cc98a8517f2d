// The external product's output tile on Hopper's warpgroup MMA
// (wgmma.mma_async m64nNk32, s8 x s8 -> s32, sm_90a), which
// external_product.cu runs in its "wgmma" form.  It computes what
// mma_tile.cuh's tile computes, exactly, mod 2^32: for one component o,
//   out[b, j] = sum_p sum_m d[p, b, m] * T_p[m, j],  T_p[m, j] = e_p[N + j - m],
// with T split into four balanced int8 limbs, one s32 sum S_v a limb and the
// result sum_v S_v << 8v in uint32_t (mma_tile.cuh's note has the
// arithmetic, the planes and the limbs).
//
// Design (the plain model: ops/kernels.py, wgmma_toeplitz_tile,
// wgmma_stage_model, wgmma_descriptor_reads, wgmma_epilogue_model,
// external_product_wgmma_model):
//
// * Which operand is which.  For s8, wgmma takes both operands K-major
//   only.  The digits (B, N) int8 lie K-major already, a batch row at a
//   time, so they are the B operand, from shared memory, batch rows along
//   the wgmma's n.  The Toeplitz operand cannot be described to wgmma from
//   shared memory without expanding it (its rows shift by one byte; the
//   descriptor's strides count 16 bytes), so it is the A operand, from
//   registers, built from mma_tile.cuh's shifted byte planes.
// * The 64 rows of a wgmma are four limbs of 16 coefficients: warp w of a
//   warpgroup holds limb w.  A warp's slice of the A fragment has the
//   m16n8k32 A layout, so its registers are aligned 32-bit loads of the
//   planes (copy 3 - grp % 4, as in external_product_tr.cu).  A consumer
//   warpgroup computes 64 coefficients as four chains of 16 (one wgmma
//   each a k-step, its own accumulator), and the chains' operands lie on
//   neighbouring diagonals: a commit group of 2 k-steps loads 14 plane
//   words a thread for its 8 wgmmas.  Each wgmma takes its A registers as
//   an aligned quad, so a group in flight holds 32 registers whatever it
//   loads; with the accumulators (4 chains x BN / 2, 128 at BN = 64) two
//   groups in flight fit a consumer's registers, and longer groups made
//   ptxas serialize the wgmmas.
// * A block: BN = 32 or 64 batch rows (the wgmma's n) x T = 128
//   coefficients (min(N, 128)), T / 64 consumer warpgroups beside one
//   producer warpgroup, whose registers go to them (setmaxnreg).  Every
//   block of a batch tile reads its digits: at T = 128, 16 blocks read
//   each byte at B = 1024 (64 MB from L2), and the 64 x 128 block is one an
//   SM (139 KB of shared memory, 232 registers a consumer thread).
// * The producer's first warp stages the digits with the tensor-memory
//   accelerator: one thread asks for a chunk's KC / SW boxes (SW x BN x 1
//   bytes of the tensor map (N, B, rows), rows past the batch read as
//   zeros) into a ring of kStages stages, and the stage's mbarrier, told
//   to expect the chunk's bytes, completes when they land; the copy is in
//   the async proxy, which the wgmmas read.  The boxes are swizzled in
//   SW-byte spans (128; 64 for 64-column chunks), as the descriptor
//   (SBO = 8 SW, the swizzle mode) reads them; a k-step starts 32 bytes
//   further into a box row.  Its other three warps build the planes of each
//   segment of up to 1024 digit columns into one of two buffers while the
//   consumers read the other.  Staging with cp.async instead cost the
//   producer more than the wgmmas took (PERF.md).
// * The consumers, for each chunk: wait for its stage (and at a segment's
//   first chunk, its planes), then for each commit group load its A words,
//   wgmma.fence, issue, commit, and wait for the group before it
//   (wgmma.wait_group 1), whose stage (at a chunk's first group) and A
//   registers are then free.  Alternate groups load into two register sets:
//   a group never writes registers a wgmma in flight reads.  Stage and plane
//   releases are named barriers, arrived on by the consumers and waited on
//   by the producer's warps.
// * The epilogue: the fragments hold coefficients down the rows and batch
//   lanes along n.  Each warp stores (uint32_t)S_v << 8v of its limb into
//   a slab of its own in shared memory, batch row by coefficient (rows of
//   68 words: a fragment register's 32 stores fall on 32 banks), over the
//   ring and planes; then 16-byte quads of a warpgroup's four slabs are
//   added (wrapping) to acc and stored along N, or added atomically
//   (wrapping atomicAdd on unsigned int) when the launch splits a tile's
//   (p, chunk) pairs over blocks into an output that holds acc or zero.
// * Each S_v stays exact in s32 while rows * N < 2^17 (mma::shape_ok).
//
// N must be a power of two, at least 64.

#pragma once

#include "mma_tile.cuh"

namespace ieache {
namespace wg {

constexpr int kWgThreads = 128;  // a warpgroup
constexpr int kSegCols = 1024;   // digit columns a build of the planes covers
constexpr int kStages = 4;       // ring of staged digit chunks
constexpr int kStagers = 32;     // the producer's warp that stages digits
constexpr int kBuilders = 96;    // its three warps that build planes
constexpr int kGroupSteps = 2;   // k-steps of a commit group
constexpr int kPlaneBufs = 2;    // plane buffers: one read, one built
constexpr int kAlign = 1024;     // a swizzle atom's alignment

// Named barriers (0 is __syncthreads'): a stage empty, a plane buffer full
// and empty, and the consumers' own.  A stage full is an mbarrier: the
// tensor-memory accelerator completes it.
constexpr int kEmptyBar = 1;
constexpr int kPlanesFullBar = kEmptyBar + kStages;
constexpr int kPlanesEmptyBar = kPlanesFullBar + kPlaneBufs;
constexpr int kConsumerBar = kPlanesEmptyBar + kPlaneBufs;
static_assert(kConsumerBar < 16, "16 named barriers a block");

// The tile of a block: BN (32 or 64) batch rows x T (64 or 128)
// coefficients, computed by W = T / 64 consumer warpgroups of C = 4 chains
// of 16 coefficients (warpgroup g: coefficients 64 g ..) beside one
// producer warpgroup; KC digit columns a chunk (one stage of the ring,
// KC / 64 commit groups of 2 k-steps).  A stage holds KC / SW boxes of BN
// rows x SW bytes, SW the swizzle span (128 bytes; 64 at N = 64, whose
// chunks are 64 columns), as the tensor-memory accelerator writes
// them (ops/kernels.py: wgmma_stage_offset).  Shared memory, from a
// 1024-byte boundary: the ring, then kPlaneBufs plane buffers (the
// epilogue's slabs, four a consumer warpgroup, one a limb, over both),
// then the stages' mbarriers.
template <int BN, int T, int KC>
struct Tile {
  static constexpr int C = 4;
  static constexpr int W = T / (16 * C);
  static constexpr int kConsumers = kWgThreads * W;
  static constexpr int kThreads = kConsumers + kWgThreads;
  // blocks an SM holds: two consumer warpgroups an SM either way
  static constexpr int kBlocksPerSm = W == 1 ? 2 : 1;
  // registers a thread at launch, and the consumers' once the producer
  // has given its share up (setmaxnreg)
  static constexpr int kLaunchRegs = 65536 / (kThreads * kBlocksPerSm) / 8 * 8;
  static constexpr int kProducerRegs = W == 1 ? 40 : 56;
  static constexpr int kConsumerRegs =
      kLaunchRegs + (kLaunchRegs - kProducerRegs) / W / 8 * 8;
  // the named barriers' thread counts: consumers and stager, consumers
  // and builders
  static constexpr int kStageBarThreads = kConsumers + kStagers;
  static constexpr int kPlaneBarThreads = kConsumers + kBuilders;
  static constexpr int SW = KC >= 128 ? 128 : 64;
  static constexpr int kBoxBytes = BN * SW;
  static constexpr int kStageBytes = BN * KC;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // a copy of a plane: the tile and a segment of digit columns
  static constexpr int kPlaneWords = (T + kSegCols) / 4;
  // a copy's stride in words, 8 mod 32: the 4 copies 8 banks apart
  static constexpr int kPlaneStride =
      kPlaneWords + ((8 - kPlaneWords % 32) + 32) % 32;
  static constexpr int kPlanesWords = 16 * kPlaneStride;  // a buffer
  // a slab row: a warpgroup's 16 C coefficients and 4 words of padding,
  // so that a fragment register's 32 stores fall on 32 banks
  static constexpr int kSlabPitch = 16 * C + 4;
  static constexpr int kSlabWords = BN * kSlabPitch;
  static constexpr int kSlabsBytes = 4 * W * kSlabWords * 4;
  static constexpr int kMainBytes = kRingBytes + kPlaneBufs * kPlanesWords * 4;
  static constexpr int kBarOffset =
      kMainBytes > kSlabsBytes ? kMainBytes : kSlabsBytes;
  static constexpr int kSmemBytes = kAlign + kBarOffset + 8 * kStages;
  static_assert(W * 16 * C == T, "whole warpgroups");
  static_assert(kConsumerRegs <= 256, "setmaxnreg's limit");
  static_assert(kBoxBytes % kAlign == 0 || SW == 64, "boxes on atoms");
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}
// One arrival that also expects `bytes` from the tensor-memory accelerator.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Waits until the mbarrier's phase `parity` has completed.  (A loop in
// C++ around try_wait, or a trap on a bound, makes ptxas serialize the
// wgmmas of the whole kernel.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// A box of the 3-D tensor map at coordinates (x, y, z) into shared memory
// at `dst`, completing `bar`'s expected bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const void* map, int x,
                                         int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// The matrix descriptor of a K-major operand at shared address `addr` in
// the layout the tensor-memory accelerator writes with a swizzle span of
// SW bytes (128 or 64): rows of SW bytes, 8-row groups SBO = 8 SW apart,
// the 16-byte pieces of a row permuted by the address's bits 7.. (the
// hardware's swizzle), LBO unused (1).  A k-step SW bytes into a box
// starts 32 bytes on within the row, its atom's bits 7.. unchanged.
template <int SW>
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  constexpr uint64_t kLayout = SW == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * SW >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving a register's reads or writes across the
// point (the wgmmas that write it run asynchronously).
template <int N>
__device__ __forceinline__ void fence_operands(int32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (m64nBN s32, this thread's BN / 2 registers) += A (this thread's four
// registers of the m64k32 s8 fragment) x B (the descriptor's k32nBN s8).
template <int BN>
__device__ __forceinline__ void mma_async(int32_t (&d)[BN / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t desc);

template <>
__device__ __forceinline__ void mma_async<32>(int32_t (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void mma_async<64>(int32_t (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


// The planes of one key polynomial g = bk[p, o, :] for the tile of T
// coefficients at jb, digit columns ma .. ma + mcols - 1, by `nthreads`
// builders (tid 0 .. nthreads - 1; by default the producer's three
// warps): mma::build_planes with this tile's width and TL's copy stride
// (word x of copy s of limb v holds R_v[lo + 4x + s ..+3], lo = N - jb -
// T + ma).
template <class TL, int T>
__device__ __forceinline__ void build_planes(uint32_t* planes,
                                             const uint32_t* g, int n, int jb,
                                             int ma, int mcols, int tid,
                                             int nthreads = kBuilders) {
  constexpr uint32_t kBias = 0x80808080u;
  const int nwords = (T + mcols) / 4;
  for (int x = tid; x < nwords; x += nthreads) {
    const int i0 = n - 1 + jb + T - ma - 4 * x;
    uint32_t bx[7];  // the biased words: byte v is limb v
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const int i = i0 - q;
      const uint32_t e = i >= n ? g[i - n] : (i >= 0 ? 0u - g[i] : 0u);
      bx[q] = (e + kBias) ^ kBias;
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint32_t pick = (uint32_t)v | ((uint32_t)(4 + v) << 4);
      const uint32_t lo = __byte_perm(__byte_perm(bx[0], bx[1], pick),
                                      __byte_perm(bx[2], bx[3], pick), 0x5410);
      const uint32_t hi = __byte_perm(__byte_perm(bx[4], bx[5], pick), bx[6],
                                      0x0010u | ((uint32_t)(4 + v) << 8));
#pragma unroll
      for (int s = 0; s < 4; ++s)
        planes[(v * 4 + s) * TL::kPlaneStride + x] =
            __funnelshift_r(lo, hi, 8 * s);
    }
  }
}

// A thread's A words of one commit group: diagonals -(2C - 1) ..
// 4 kGroupSteps - 2 of its limb, against the group's first k-step.
template <class TL>
struct GroupWords {
  static constexpr int E = 4 * kGroupSteps + 2 * TL::C - 2;
  uint32_t w[E];  // w[i]: diagonal i - (2C - 1)
  // Holds the words in their registers up to this point: the compiler
  // does not see that a wgmma reads them until its group is done.
  __device__ __forceinline__ void keep() const {
#pragma unroll
    for (int i = 0; i < E; ++i) asm volatile("" ::"r"(w[i]) : "memory");
  }
};

// One commit group: k-steps ks0 .. ks0 + kGroupSteps - 1 of the stage at
// `buf`, one wgmma a chain and k-step.  This thread's A words are loaded
// into `gw` from `wk`, the group's diagonal 0 word, then one fence, the
// wgmmas, a commit.  The wgmmas read `gw` until the group is done: the
// caller alternates two of them, so that a group's loads never write the
// registers of the group still in flight.  (Each wgmma takes its four A
// registers as an aligned quad, so a group holds 4 C kGroupSteps registers
// however many words it loads: the group is kept short.)
template <class TL, int BN, int KC>
__device__ __forceinline__ void issue_group(int32_t (&acc)[TL::C][BN / 2],
                                            GroupWords<TL>& gw,
                                            const uint32_t* wk, uint32_t buf,
                                            int ks0) {
  constexpr int C = TL::C;
#pragma unroll
  for (int i = 0; i < GroupWords<TL>::E; ++i)
    gw.w[i] = wk[2 * (i - (2 * C - 1))];
  fence();
#pragma unroll
  for (int ks = 0; ks < kGroupSteps; ++ks) {
    // k-step ks0 + ks: box 32 (ks0 + ks) / SW, 32 (ks0 + ks) % SW bytes in
    constexpr int SW = TL::SW;
    const int kb = 32 * (ks0 + ks);
    const uint64_t desc = descriptor<SW>(buf + (kb / SW) * TL::kBoxBytes +
                                         kb % SW);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // registers a0..a3 lie on diagonals 0, -1, 2, 1 against a0's
      const int e = 4 * ks + 2 * C - 1 - 2 * c;
      const uint32_t a[4] = {gw.w[e], gw.w[e - 1], gw.w[e + 2], gw.w[e + 1]};
      mma_async<BN>(acc[c], a, desc);
    }
  }
  commit();
}

// Where the segments of a part's chunks begin: a segment is the chunks of
// one row p whose planes one build covers (up to kSegCols columns).
template <int KC>
__device__ __forceinline__ int segment_end(int c, int c_end, int nchunk) {
  const int ch = c % nchunk;
  int nseg = c_end - c < nchunk - ch ? c_end - c : nchunk - ch;
  if (nseg > kSegCols / KC) nseg = kSegCols / KC;
  return c + nseg;
}

// The producer warpgroup (ptid 0 .. 127) of the part's chunks c_begin ..
// c_end - 1 (pair c = p * (N / KC) + chunk) for the T x BN tile at
// coefficient jb of component o and batch row b0; `smem` is the tile's
// 1024-byte aligned shared memory, `map` the digits' tensor map
// (dimensions N, batch, rows; boxes of SW x BN x 1 bytes, rows past the
// batch read as zeros).  Its first warp stages chunk i into stage i %
// kStages, once the consumers are done with chunk i - kStages: one thread
// tells the stage's mbarrier to expect the chunk's bytes and asks the
// tensor-memory accelerator for its KC / SW boxes, which complete it.  Its
// other three warps build each segment's planes into plane buffer j %
// kPlaneBufs (once the consumers are done with segment j - kPlaneBufs) and
// mark it full.  Each ends by waiting for the consumers' last releases,
// so that no arrival on a named barrier is left unmatched.
template <int BN, int T, int KC>
__device__ __forceinline__ void produce(uint8_t* smem, const void* map,
                                        const uint32_t* bk, int kp1, int n,
                                        int o, int jb, int b0, int c_begin,
                                        int c_end, int ptid) {
  using TL = Tile<BN, T, KC>;
  const int nchunk = n / KC, nch = c_end - c_begin;
  if (ptid < kStagers) {
    const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
    const uint32_t full = ring + TL::kBarOffset;
    for (int i = 0; i < nch; ++i) {
      const int c = c_begin + i, p = c / nchunk;
      if (i >= kStages)
        bar_sync(kEmptyBar + i % kStages, TL::kStageBarThreads);
      if (ptid == 0) {
        const uint32_t bar = full + 8 * (i % kStages);
        const uint32_t dst = ring + (i % kStages) * TL::kStageBytes;
        mbar_expect(bar, TL::kStageBytes);
#pragma unroll
        for (int box = 0; box < KC / TL::SW; ++box)
          tma_load(dst + box * TL::kBoxBytes, map,
                   (c - p * nchunk) * KC + box * TL::SW, b0, p, bar);
      }
      __syncwarp();
    }
    for (int i = nch - kStages > 0 ? nch - kStages : 0; i < nch; ++i)
      bar_sync(kEmptyBar + i % kStages, TL::kStageBarThreads);
    return;
  }
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + TL::kRingBytes);
  int j = 0;
  for (int c = c_begin; c < c_end; ++j) {
    const int p = c / nchunk, seg_end = segment_end<KC>(c, c_end, nchunk);
    if (j >= kPlaneBufs)
      bar_sync(kPlanesEmptyBar + j % kPlaneBufs, TL::kPlaneBarThreads);
    build_planes<TL, T>(planes + (j % kPlaneBufs) * TL::kPlanesWords,
                        bk + ((int64_t)p * kp1 + o) * n, n, jb,
                        (c - p * nchunk) * KC, (seg_end - c) * KC,
                        ptid - kStagers);
    bar_arrive(kPlanesFullBar + j % kPlaneBufs, TL::kPlaneBarThreads);
    c = seg_end;
  }
  for (int s = j - kPlaneBufs > 0 ? j - kPlaneBufs : 0; s < j; ++s)
    bar_sync(kPlanesEmptyBar + s % kPlaneBufs, TL::kPlaneBarThreads);
}

// acc[c] += the tile's share of sum_p T_{p,v} x d[p]^T over the part's
// chunks, by the consumer warpgroups (tid 0 .. 128 W - 1): for each chunk,
// wait until its stage (its mbarrier's phase i / kStages) and, at a
// segment's first chunk, its planes are full, issue its commit groups,
// release the segment's planes after its last chunk's A words are loaded,
// and release chunk i - 1's stage once its last group is done.  Thread
// (warpgroup g, warp v = its limb, lane = 4 grp + t4) ends with limb v's
// sums: register i of chain c at coefficient jb + 16 (C g + c) + grp +
// 8 ((i / 2) % 2), batch row b0 + 8 (i / 4) + 2 t4 + i % 2.
template <int BN, int T, int KC>
__device__ __forceinline__ void consume(
    uint8_t* smem, int n, int c_begin, int c_end, int tid,
    int32_t (&acc)[Tile<BN, T, KC>::C][BN / 2]) {
  using TL = Tile<BN, T, KC>;
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t* planes =
      reinterpret_cast<const uint32_t*>(smem + TL::kRingBytes);
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = tid >> 7;
  const int grp = lane >> 2, t4 = lane & 3;
  const int nchunk = n / KC, nch = c_end - c_begin;
  // this thread's word of diagonal 0 in copy 3 - grp % 4 of limb warp
  const int wp = (warp * 4 + 3 - (grp & 3)) * TL::kPlaneStride + T / 4 - 1 -
                 4 * TL::C * g - (grp >> 2) + t4;
  constexpr int kGroups = KC / 32 / kGroupSteps;  // commit groups a chunk
  GroupWords<TL> even = {}, odd = {};  // the A words of alternate groups
  int seg_begin = c_begin, seg_end = c_begin, k = 0;
  for (int i = 0; i < nch; ++i) {
    const int c = c_begin + i;
    if (c == seg_end) {
      seg_begin = c;
      seg_end = segment_end<KC>(c, c_end, nchunk);
      bar_sync(kPlanesFullBar + k % kPlaneBufs, TL::kPlaneBarThreads);
      ++k;
    }
    mbar_wait(ring + TL::kBarOffset + 8 * (i % kStages), (i / kStages) & 1);
    const uint32_t* wk = planes + ((k - 1) % kPlaneBufs) * TL::kPlanesWords +
                         wp + 8 * (c - seg_begin) * (KC / 32);
    const uint32_t buf = ring + (i % kStages) * TL::kStageBytes;
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      const int ks0 = h * kGroupSteps;
      if ((i * kGroups + h) & 1)
        issue_group<TL, BN, KC>(acc, odd, wk + 8 * ks0, buf, ks0);
      else
        issue_group<TL, BN, KC>(acc, even, wk + 8 * ks0, buf, ks0);
      if (h == kGroups - 1 && c + 1 == seg_end)
        bar_arrive(kPlanesEmptyBar + (k - 1) % kPlaneBufs,
                   TL::kPlaneBarThreads);
      // the group before this one is done: its A words (the ones the next
      // group loads over) are free, and at a chunk's first group, so is
      // the stage of chunk i - 1
      wait<1>();
      even.keep();
      odd.keep();
      if (h == 0 && i >= 1)
        bar_arrive(kEmptyBar + (i - 1) % kStages, TL::kStageBarThreads);
    }
  }
  wait<0>();
  even.keep();
  odd.keep();
  bar_arrive(kEmptyBar + (nch - 1) % kStages, TL::kStageBarThreads);
#pragma unroll
  for (int c = 0; c < TL::C; ++c) fence_operands(acc[c]);
}

template <int C, int BN>
__device__ __forceinline__ void zero(int32_t (&acc)[C][BN / 2]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[c][i] = 0;
    fence_operands(acc[c]);
  }
}

// The epilogue: out[o, b, j] = add[o, b, j] (when add is not null) + the
// folded tile, or out += the folded tile atomically (wrapping, so exact in
// any order).  Each warp stores its limb's (uint32_t)S_v << 8v to its slab
// (batch row by its warpgroup's coefficients); 16-byte quads of a
// warpgroup's four slabs are then added.  Run by the consumer warpgroups
// (tid 0 .. 128 W - 1) after their last chunk: every write of the producer
// has landed by then.  Reuses all of smem.  kCg reads add through L2
// only, for an addend other blocks wrote earlier in the launch.
template <int BN, int T, int KC, bool kCg = false>
__device__ __forceinline__ void store_tile(
    const int32_t (&acc)[Tile<BN, T, KC>::C][BN / 2], uint8_t* smem, int o,
    int jb, int b0, int tid, const uint32_t* add, uint32_t* out, int batch,
    int n, bool atomic) {
  using TL = Tile<BN, T, KC>;
  constexpr int kQuads = 4 * TL::C;  // quads of a warpgroup's row
  uint32_t* slabs = reinterpret_cast<uint32_t*>(smem);
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, t4 = lane & 3;
  bar_sync(kConsumerBar, TL::kConsumers);  // every wgmma is done
  uint32_t* slab = slabs + warp * TL::kSlabWords;
#pragma unroll
  for (int c = 0; c < TL::C; ++c)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int row = grp + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
      slab[col * TL::kSlabPitch + 16 * c + row] = (uint32_t)acc[c][i]
                                                  << (8 * (warp & 3));
    }
  bar_sync(kConsumerBar, TL::kConsumers);
  for (int x = tid; x < BN * TL::W * kQuads; x += TL::kConsumers) {
    const int b = x / (TL::W * kQuads), q = x % (TL::W * kQuads);
    if (b0 + b >= batch) continue;
    const uint32_t* src = slabs + 4 * (q / kQuads) * TL::kSlabWords +
                          b * TL::kSlabPitch + 4 * (q % kQuads);
    uint4 s = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint4 w =
          *reinterpret_cast<const uint4*>(src + v * TL::kSlabWords);
      s.x += w.x;
      s.y += w.y;
      s.z += w.z;
      s.w += w.w;
    }
    const int64_t at = ((int64_t)o * batch + b0 + b) * n + jb + 4 * q;
    if (atomic) {
      unsigned int* dst = reinterpret_cast<unsigned int*>(out + at);
      atomicAdd(dst, s.x);
      atomicAdd(dst + 1, s.y);
      atomicAdd(dst + 2, s.z);
      atomicAdd(dst + 3, s.w);
    } else {
      if (add != nullptr) {
        const uint4 a = load_quad<true, kCg>(add + at);
        s.x += a.x;
        s.y += a.y;
        s.z += a.z;
        s.w += a.w;
      }
      *reinterpret_cast<uint4*>(out + at) = s;
    }
  }
}

}  // namespace wg
}  // namespace ieache
