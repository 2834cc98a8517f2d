// The fused CMux step's work item on Hopper's warpgroup MMA: one T x BN
// output tile of acc + sum_p digits_p(X^bara acc - acc) (*) bk[p, o], the
// digits computed into the stages the wgmmas read.  cmux_step.cu runs it
// once (its "wgmma" form), blind_rotate_scan.cu every step inside one
// persistent launch.
//
// Replaces, with its two kernels: ieache_tpu/ops/pallas_kernels.py,
// _cmux_step_kernel (cmux_step_pallas) and _blind_rotate_scan_kernel +
// _rotate_decompose_into (blind_rotate_scan_pallas).
//
// Bound on the H100: operations, as external_product.cu: at B=1024,
// N=1024, k=1, l=2 a step is 68.7 G int8 operations on the tensor cores,
// 0.0347 ms at their peak; its bytes (8 MB of accumulator in and out, 16
// KB of key) take 0.003 ms.
//
// Design (the plain model: ops/kernels.py, wgmma_step_unit_model,
// wgmma_step_copy_ranges, wgmma_step_stages, cmux_step_wgmma_model; the
// launch: step_launch, scan_launch):
//
// * The consumers are wgmma_tile.cuh's, unchanged: the Toeplitz limbs as
//   the A operand from registers, built from the byte planes; the digits
//   as the B operand from stages of BN rows x KC columns in the swizzled
//   layout the descriptor reads (ops/kernels.py: wgmma_stage_offset);
//   commit groups of 2 k-steps in two alternating register sets;
//   setmaxnreg; the epilogue through the slabs, adding the accumulator.
// * The producer computes the stages in place of the tensor-memory
//   accelerator.  A unit is one polynomial u of the accumulator and one
//   chunk of KC digit columns: its l digit rows p = u l + jl come from one
//   rotation, so the producer writes the unit's l stages at once and the
//   consumers take the (p, chunk) pairs in the order (u, chunk, jl).  Two
//   unit buffers of l stages turn: the producer fills one while the
//   consumers read the other.
// * The blocks that compute tiles of the same BN batch rows (N/T x (k+1)
//   of them, 16 at N=1024, k=1) are launched as thread-block clusters of
//   c: rank r decomposes rows r BN / c .. (r + 1) BN / c - 1 of each unit,
//   so each accumulator word is read and decomposed by one block of the
//   cluster, not by c.  For each polynomial u the bulk-copy engine brings
//   the rank's rows (N words each) into shared memory; the producer's
//   first three warps take runs of 8 coefficients of them (rot_diff_run,
//   the split rotation's aligned-quad arithmetic), pack each digit row's
//   8 bytes (digit_word: three byte permutes at Bg = 2^8) and store them
//   into the block's own stages at the swizzled offset; then one thread
//   asks the bulk-copy engine to send the rank's rows of each stage box
//   (whole 16-byte pieces: the swizzle permutes within a row) into every
//   peer's stages, completing the peer's full mbarrier by their bytes.
//   The fourth warp builds each pair's planes.
// * Hand-over.  The producer's stores are generic-proxy writes that the
//   wgmmas and the copies read through the async proxy: each producer
//   thread issues fence.proxy.async.shared::cta after them, the producer
//   warps meet at a named barrier, and one thread sends the copies and
//   arrives on its own full mbarrier, expecting the peers' bytes.  The
//   consumers wait on it (acquire, cluster scope).  A unit buffer is
//   written again only once every rank's consumers have released it: each
//   consumer warp arrives on the buffer's empty mbarrier in every rank
//   (count: 4 W x c) once the wgmmas that read it are done, and the
//   producer waits on its own.  The planes' hand-over is named barriers
//   inside the block.  The epilogue's slabs lie over the stages, planes
//   and rows: in a persistent launch the cluster synchronizes between
//   two items, so that no peer copies the next item's stages into a block
//   still in its epilogue.
// * Departures from the plan it was built to (each from a chip run on an
//   NVIDIA H100 80GB HBM3, 700 W; PERF.md): the producer first stored
//   each digit into every rank's stage itself (st.shared::cluster) and
//   read the accumulator through L2 a run at a time, and took several
//   times the consumers' time, more with more ranks; the rows and the
//   copies by the bulk-copy engine brought a step at B=1024 to 0.1195 ms
//   in clusters of 2 (tools/tile_bench.py).  What is left (a %globaltimer
//   trace of each unit on a patched copy, PERF.md): the decomposition
//   (three warps, one a scheduler, each running a chain of dependent
//   instructions) outlasts the consumers' work on a pair; in clusters of
//   4 or 8 the card holds 120 blocks, not 132.
//
// N must be a power of two, at least 64; rows = (k+1) l, l <= kMaxLevels.

#pragma once

#include "wgmma_tile.cuh"

namespace ieache {
namespace wgs {

constexpr int kDecomposers = 96;    // the producer's warps 0-2
constexpr int kPlaneBuilders = 32;  // its warp 3
constexpr int kRun = 8;             // coefficients a decomposer's item
constexpr int kUnitBufs = 2;        // unit buffers: one read, one written
constexpr int kPlaneBufs = 2;       // plane buffers (a pair each)
constexpr int kMaxCluster = 8;      // blocks a cluster
constexpr int kMaxLevels = 4;       // gadget levels l a unit holds
constexpr int kTile = 64;           // batch rows BN of a block's tile

// Named barriers (0 is __syncthreads', wg::kConsumerBar the epilogue's):
// a plane buffer full and empty, and the decomposers' own.
constexpr int kPlanesFullBar = 1;
constexpr int kPlanesEmptyBar = kPlanesFullBar + kPlaneBufs;
constexpr int kDecompBar = kPlanesEmptyBar + kPlaneBufs;
static_assert(kDecompBar < wg::kConsumerBar, "barrier ids apart");

// The work item's layout: the tile of wg::Tile<BN, T, KC> (its consumers,
// registers and slabs), stages of BN x KC digits, planes of one (p,
// chunk) pair.  Shared memory from a 1024-byte boundary: kUnitBufs x l
// stages, kPlaneBufs plane buffers and this rank's BN / c rows of one
// polynomial of the accumulator (N words each; the epilogue's slabs lie
// over all three, which are done with by then), then the five mbarriers
// (full[2], empty[2], rows) and the BN batch rows' amounts.
template <int BN, int T, int KC>
struct StepTile {
  using TL = wg::Tile<BN, T, KC>;
  static constexpr int kStageBytes = BN * KC;
  static constexpr int kPlaneWords = (T + KC) / 4;
  // a copy's stride in words, 8 mod 32: the 4 copies 8 banks apart
  static constexpr int kPlaneStride =
      kPlaneWords + ((8 - kPlaneWords % 32) + 32) % 32;
  static constexpr int kPlanesWords = 16 * kPlaneStride;  // a buffer
  static constexpr int kPlaneBarThreads = TL::kConsumers + kPlaneBuilders;
  static constexpr int kReleases = 4 * TL::W;  // consumer warps
  static constexpr int kBars = 2 * kUnitBufs + 1;
  __host__ __device__ static int ring_bytes(int l) {
    return kUnitBufs * l * kStageBytes;
  }
  __host__ __device__ static int rows_offset(int l) {
    return ring_bytes(l) + kPlaneBufs * kPlanesWords * 4;
  }
  __host__ __device__ static int bar_offset(int l, int csize, int n) {
    const int main = rows_offset(l) + BN / csize * n * 4;
    const int most = main > TL::kSlabsBytes ? main : TL::kSlabsBytes;
    return (most + 15) / 16 * 16;
  }
  __host__ __device__ static int smem_bytes(int l, int csize, int n) {
    return wg::kAlign + bar_offset(l, csize, n) + 8 * kBars + 4 * BN;
  }
};

// Where a work item runs: its aligned shared memory and shape.
struct Item {
  uint8_t* smem;
  int l, csize, crank, kp1, batch, n;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
// Every thread of the cluster's blocks (that has not exited) arrives, with
// release, then waits, with acquire.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// The address in the shared memory of cluster rank `rank` of this block's
// shared address `local`.
__device__ __forceinline__ uint32_t peer(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
// One arrival, with release at cluster scope, on the mbarrier at `addr` of
// any rank (a shared::cluster address from peer()).
__device__ __forceinline__ void arrive_peer(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          addr)
      : "memory");
}
// Waits, with acquire at cluster scope, until this block's mbarrier at
// `bar` has completed its phase `parity`.
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_CLUSTER:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT_CLUSTER;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Byte offset of digit (batch row `row`, column `col` of the chunk) in a
// stage of BN x KC digits as the descriptor reads it (wgmma_tile.cuh's
// TMA writes the same layout): box col / SW of BN rows x SW bytes, its
// 16-byte pieces permuted by the row's bits (ops/kernels.py:
// wgmma_stage_offset).
template <int BN, int KC>
__device__ __forceinline__ uint32_t stage_offset(int row, int col) {
  constexpr int SW = KC >= 128 ? 128 : 64;
  const uint32_t lin = (uint32_t)(row * SW + col % SW);
  return (uint32_t)((col / SW) * BN * SW) +
         (lin ^ (((lin >> 7) & (uint32_t)(SW / 16 - 1)) << 4));
}

// The barriers of a work item: at `bars`, full[0], full[1], empty[0],
// empty[1], rows.
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int j) {
  return bars + 8 * (j & 1);
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int j) {
  return bars + 8 * (kUnitBufs + (j & 1));
}
__device__ __forceinline__ uint32_t rows_bar(uint32_t bars) {
  return bars + 8 * 2 * kUnitBufs;
}
template <int BN, int T, int KC>
__device__ __forceinline__ uint32_t item_bars(const Item& it) {
  return smem_addr(it.smem) +
         StepTile<BN, T, KC>::bar_offset(it.l, it.csize, it.n);
}
template <int BN, int T, int KC>
__device__ __forceinline__ int32_t* item_amounts(const Item& it) {
  return reinterpret_cast<int32_t*>(
      it.smem + StepTile<BN, T, KC>::bar_offset(it.l, it.csize, it.n) +
      8 * StepTile<BN, T, KC>::kBars);
}

// Initializes the mbarriers (full: the producer's one arrival with the
// bytes its peers' copies bring; empty: every consumer warp of every
// rank; rows: one arrival with their bytes) and synchronizes the
// cluster, so that no rank reaches a barrier not yet initialized.  Run
// by every thread.
template <int BN, int T, int KC>
__device__ __forceinline__ void setup(const Item& it) {
  const uint32_t bars = item_bars<BN, T, KC>(it);
  if (threadIdx.x < kUnitBufs) {
    wg::mbar_init(full_bar(bars, threadIdx.x), 1);
    wg::mbar_init(empty_bar(bars, threadIdx.x),
                  StepTile<BN, T, KC>::kReleases * it.csize);
    if (threadIdx.x == 0) wg::mbar_init(rows_bar(bars), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync();
}

// The amounts of batch rows b0 .. b0 + BN - 1 (bara[b * stride] for row
// b; 0 past the batch) into the item's smem, by threads tid of nthreads.
template <int BN, int T, int KC>
__device__ __forceinline__ void load_amounts(const Item& it,
                                             const int32_t* bara, int stride,
                                             int b0, int tid, int nthreads) {
  int32_t* amounts = item_amounts<BN, T, KC>(it);
  for (int r = tid; r < BN; r += nthreads)
    amounts[r] = b0 + r < it.batch ? bara[(int64_t)(b0 + r) * stride] : 0;
}

// `bytes` from global `src` into this block's shared memory at `dst`
// (both 16-byte aligned, bytes a multiple of 16) by the bulk-copy engine,
// completing the mbarrier at `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// `bytes` of this block's shared memory at `src` into a peer's at `dst`
// (a shared::cluster address), completing the peer's mbarrier `bar`.
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The decomposers (dtid 0 .. 95) of one item, for the batch tile at b0:
// `units` units from unit counter j0 (unit uu: polynomial u = uu / nchunk,
// chunk uu % nchunk).  For each polynomial, one thread asks the bulk-copy
// engine for this rank's rows of it (rows past the batch are not read);
// for each of its units, once every rank's consumers have released unit
// buffer j & 1, each thread takes runs of 8 coefficients of those rows
// from shared memory (rot_diff_run), and stores each digit row's 8 bytes
// into this block's stage (stage_offset); then, the stores fenced to the
// async proxy, one thread sends this rank's rows of each stage box to
// every peer's stages (bulk_to_peer, completing the peer's full barrier)
// and arrives on its own full barrier, expecting the peers' bytes.  The
// amounts are in smem (load_amounts); `rows_uses` counts the rows
// barrier's phases.  Global reads go through the bulk-copy engine, which
// reads L2: an accumulator other blocks wrote earlier in the launch is
// read fresh (after a proxy fence).
template <int BN, int T, int KC>
__device__ __forceinline__ void decompose_units(
    const Item& it, const uint32_t* acc, int b0, int bg_bit, uint32_t offset,
    int units, int j0, int& rows_uses, int dtid) {
  using ST = StepTile<BN, T, KC>;
  constexpr int SW = KC >= 128 ? 128 : 64;
  constexpr int kItemsRow = KC / kRun;
  const int n = it.n, l = it.l, csize = it.csize, crank = it.crank;
  const uint32_t ring = smem_addr(it.smem);
  const uint32_t bars = item_bars<BN, T, KC>(it);
  const uint32_t rows_at = ring + ST::rows_offset(l);
  const uint32_t* rows =
      reinterpret_cast<const uint32_t*>(it.smem + ST::rows_offset(l));
  const int32_t* amounts = item_amounts<BN, T, KC>(it);
  const int nchunk = n / KC;
  const int share = BN / csize, r_lo = crank * share;
  const int items = share * kItemsRow;
  int valid = it.batch - (b0 + r_lo);
  valid = valid < 0 ? 0 : (valid > share ? share : valid);
  for (int uu = 0; uu < units; ++uu) {
    const int j = j0 + uu, u = uu / nchunk, ch = uu % nchunk;
    if (ch == 0) {
      if (dtid == 0) {
        asm volatile("fence.proxy.async.global;" ::: "memory");
        wg::mbar_expect(rows_bar(bars), valid * n * 4);
        for (int r = 0; r < valid; ++r)
          bulk_load(rows_at + r * n * 4,
                    acc + ((int64_t)u * it.batch + b0 + r_lo + r) * n, n * 4,
                    rows_bar(bars));
      }
      wait_cluster(rows_bar(bars), rows_uses & 1);
      ++rows_uses;
    }
    if (j >= kUnitBufs)
      wait_cluster(empty_bar(bars, j), ((j >> 1) + 1) & 1);
    uint8_t* stages = it.smem + (j & 1) * l * ST::kStageBytes;
    for (int x = dtid; x < items; x += kDecomposers) {
      const int row = x / kItemsRow, col = kRun * (x % kItemsRow);
      uint32_t v[kRun];
      rot_diff_run<kRun, true, false>(rows + row * n,
                                      (uint32_t)amounts[r_lo + row],
                                      ch * KC + col, n, offset, v);
      const bool ok = row < valid;
      uint8_t* at = stages + stage_offset<BN, KC>(r_lo + row, col);
      for (int jl = 0; jl < l; ++jl)
        *reinterpret_cast<uint2*>(at + jl * ST::kStageBytes) =
            ok ? make_uint2(digit_word(v, jl, bg_bit),
                            digit_word(v + 4, jl, bg_bit))
               : make_uint2(0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wg::bar_sync(kDecompBar, kDecomposers);
    if (dtid == 0) {
      const uint32_t src = smem_addr(stages);
      for (int r = 1; r < csize; ++r) {
        const int to = (crank + r) % csize;
        const uint32_t dst = peer(src, to), bar = peer(full_bar(bars, j), to);
        for (int jl = 0; jl < l; ++jl)
          for (int box = 0; box < KC / SW; ++box) {
            const int at = jl * ST::kStageBytes + box * BN * SW + r_lo * SW;
            bulk_to_peer(dst + at, src + at, share * SW, bar);
          }
      }
      wg::mbar_expect(full_bar(bars, j),
                      (csize - 1) * share * KC * l);
    }
  }
}

// The planes of pair i (p = (i / l) / nchunk * l + i % l, chunk (i / l) %
// nchunk) of the tile at coefficient jb of component o into plane buffer
// i % 2, from bk, by the builders.
template <int BN, int T, int KC>
__device__ __forceinline__ void build_pair_planes(const Item& it,
                                                  const uint32_t* bk, int o,
                                                  int i, int jb, int btid) {
  using ST = StepTile<BN, T, KC>;
  const int l = it.l, n = it.n, nchunk = n / KC, uu = i / l;
  const int p = uu / nchunk * l + i % l;
  wg::build_planes<ST, T>(
      reinterpret_cast<uint32_t*>(it.smem + ST::ring_bytes(l)) +
          (i % kPlaneBufs) * ST::kPlanesWords,
      bk + ((int64_t)p * it.kp1 + o) * n, n, jb, uu % nchunk * KC, KC, btid,
      kPlaneBuilders);
}

// The plane builders (btid 0 .. 31) of one item: the planes of each (p,
// chunk) pair, in the consumers' order, into plane buffer i % 2 once the
// consumers are done with pair i - 2, for the T x BN tile at coefficient
// jb of component o; pair 0's are already built when `first_ready` (the
// persistent launch builds them before the item begins).  Ends by
// waiting for the consumers' last releases, so that no arrival on a named
// barrier is left unmatched.
template <int BN, int T, int KC>
__device__ __forceinline__ void build_item_planes(const Item& it,
                                                  const uint32_t* bk, int o,
                                                  int jb, int units,
                                                  bool first_ready,
                                                  int btid) {
  using ST = StepTile<BN, T, KC>;
  const int np = units * it.l;
  for (int i = 0; i < np; ++i) {
    if (i >= kPlaneBufs)
      wg::bar_sync(kPlanesEmptyBar + i % kPlaneBufs, ST::kPlaneBarThreads);
    if (i != 0 || !first_ready)
      build_pair_planes<BN, T, KC>(it, bk, o, i, jb, btid);
    wg::bar_arrive(kPlanesFullBar + i % kPlaneBufs, ST::kPlaneBarThreads);
  }
  for (int s = np - kPlaneBufs > 0 ? np - kPlaneBufs : 0; s < np; ++s)
    wg::bar_sync(kPlanesEmptyBar + s % kPlaneBufs, ST::kPlaneBarThreads);
}

// The consumers (tid 0 .. 128 W - 1) of one item: acc[c] += the tile's
// sum over every (p, chunk) pair, unit by unit from unit counter j0 (wait
// for the unit buffer to be full, then each of its l pairs: its planes,
// its KC / 64 commit groups), releasing each unit buffer in every rank
// once its last group is done.  Thread (warpgroup g, warp v = its limb,
// lane = 4 grp + t4) ends with limb v's sums, as wg::consume leaves them.
template <int BN, int T, int KC>
__device__ __forceinline__ void consume_units(
    const Item& it, int units, int j0, int tid,
    int32_t (&acc)[wg::Tile<BN, T, KC>::C][BN / 2]) {
  using TL = wg::Tile<BN, T, KC>;
  using ST = StepTile<BN, T, KC>;
  const int l = it.l, csize = it.csize;
  const uint32_t ring = smem_addr(it.smem);
  const uint32_t bars = item_bars<BN, T, KC>(it);
  const uint32_t* planes =
      reinterpret_cast<const uint32_t*>(it.smem + ST::ring_bytes(l));
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = tid >> 7;
  const int grp = lane >> 2, t4 = lane & 3;
  // this thread's word of diagonal 0 in copy 3 - grp % 4 of limb warp
  const int wp = (warp * 4 + 3 - (grp & 3)) * ST::kPlaneStride + T / 4 - 1 -
                 4 * TL::C * g - (grp >> 2) + t4;
  constexpr int kGroups = KC / 32 / wg::kGroupSteps;  // a pair's groups
  const auto release = [&](int j) {
    __syncwarp();
    if (lane == 0)
      for (int r = 0; r < csize; ++r) arrive_peer(peer(empty_bar(bars, j), r));
  };
  wg::GroupWords<TL> even = {}, odd = {};  // the A words of alternate groups
  int i = 0;                               // the item's pair
  for (int uu = 0; uu < units; ++uu) {
    const int j = j0 + uu;
    wait_cluster(full_bar(bars, j), (j >> 1) & 1);
    for (int jl = 0; jl < l; ++jl, ++i) {
      wg::bar_sync(kPlanesFullBar + i % kPlaneBufs, ST::kPlaneBarThreads);
      const uint32_t* wk = planes + (i % kPlaneBufs) * ST::kPlanesWords + wp;
      const uint32_t buf = ring + ((j & 1) * l + jl) * ST::kStageBytes;
#pragma unroll
      for (int h = 0; h < kGroups; ++h) {
        const int ks0 = h * wg::kGroupSteps;
        if ((i * kGroups + h) & 1)
          wg::issue_group<TL, BN, KC>(acc, odd, wk + 8 * ks0, buf, ks0);
        else
          wg::issue_group<TL, BN, KC>(acc, even, wk + 8 * ks0, buf, ks0);
        if (h == kGroups - 1)
          wg::bar_arrive(kPlanesEmptyBar + i % kPlaneBufs,
                         ST::kPlaneBarThreads);
        // the group before this one is done: its A words are free, and at
        // a unit's first group, so is the unit buffer before
        wg::wait<1>();
        even.keep();
        odd.keep();
        if (h == 0 && jl == 0 && uu >= 1) release(j - 1);
      }
    }
  }
  wg::wait<0>();
  even.keep();
  odd.keep();
  release(j0 + units - 1);
#pragma unroll
  for (int c = 0; c < TL::C; ++c) wg::fence_operands(acc[c]);
}

}  // namespace wgs
}  // namespace ieache
