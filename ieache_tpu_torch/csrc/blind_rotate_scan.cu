// The whole blind rotation, all n CMux steps, as one cooperative launch.
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _blind_rotate_scan_kernel
// (with its helper _rotate_decompose_into) behind
// blind_rotate_scan_pallas (the `scan` step mode).
//
//   in : acc (k+1, B, N) int32, bara (B, n) int32 in [0, 2N),
//        bk (n, rows, k+1, N) int32 the bootstrapping key
//   out: the accumulator after the n CMux steps, exact mod 2^32; equal
//        to n steps of cmux_step.cu.  acc is never written.
//
// Bound on the H100: operations, the external product's 68.7 G int8
// operations a step at B=1024, N=1024, k=1, l=2: 17.36 ms a rotation of
// 500 steps at the tensor cores' peak.
//
// Two forms, each the work item of the fused step's form of the same name
// (cmux_step.cu), launched as ops/kernels.py's scan_launch says: "wgmma"
// where the fused step's policy takes it (its 64-row grid fits the card in
// one wave) from 272 lanes (B = 272 .. 512 at 4 rows, 272 .. 448 at 6),
// "mma" elsewhere.
//
// * "wgmma" (form 1): wgmma_step.cuh's work item, one block an SM, the
//   blocks of a batch tile in clusters that share its decomposition; the
//   clusters walk their items each step, the cluster synchronizing
//   between two items, one grid barrier a step, two buffers; the barrier's
//   `between` loads the first item's amounts and builds its first pair's
//   planes.  The grid is the clusters the card holds at once
//   (the occupancy query ieache_blind_rotate_scan_clusters, which
//   scan_launch reads).  The accumulator a step reads reaches shared
//   memory through the bulk-copy engine, which reads L2, after a proxy
//   fence.
// * "mma" (form 0), the design below.
//
// Design of the mma form: the TPU kernel runs its grid as a loop on one
// core, with the accumulator resident in VMEM.  Here every block of a
// persistent cooperative launch is resident at once, and each step is the
// work item of the fused step (cmux_step_parts.cuh) over the whole grid: a block
// rotates, diffs and decomposes the digit rows and columns of its item
// from the current accumulator into its own shared memory
// (decompose_shared; in thread-block clusters of two the blocks that
// share 16 batch rows split that work and copy each other's rows through
// distributed shared memory), then runs the tensor-core product
// (mma_tile.cuh) from there for the item's output tiles.  No digit leaves
// the SM.  Step s + 1 reads all of step s's accumulator, and nothing else
// crosses blocks, so one grid-wide barrier a step is enough.
//
// The launch policy is ops/kernels.py:scan_launch, passed down as it is:
// `split` (each tile's sum over its (p, chunk) pairs cut in `split` parts
// when the tiles are fewer than the SMs), `per_item` (the output tiles a
// block computes from one decomposition), the grid (every block resident)
// and the cluster size.  The accumulator turns through buffers, and the
// last step lands in `out`:
//   split == 1: two buffers.  Step s reads one and stores cur + sum into
//     the other.
//   split > 1: three buffers.  The parts add their sums into the step's
//     buffer with atomicAdd on unsigned int (wrapping: exact in any
//     order), the part that holds pair 0 also cur's tile (copied into
//     shared memory by cp.async while its product runs; only such a
//     launch reserves that tile, and the policy keeps each tile whole
//     where it does not fit); so the buffer must be zero before the step: the first is zeroed before the loop
//     (the one barrier more), and during step s every block zeroes its
//     share of the buffer that step s - 1 read, which step s + 1 adds to.
// The barrier is written here in two halves (grid_barrier): between a
// block's arrival and its wait it loads what the next step needs and no
// step writes, its first item's amounts into shared memory and the byte
// planes of that item's first tile from the next step's key, so that
// after the barrier only the accumulator's reads wait on memory.  The
// current accumulator was written earlier in the launch by other blocks,
// so it is read through L2 only (ld.global.cg, cp.async.cg).  The launch
// refuses what the tile refuses: rows * N >= 2^17, an N that is not a
// power of two of at least 64, or shared memory over a block's
// (cudaErrorInvalidValue).
//
// On an NVIDIA H100 80GB HBM3 at 700 W (tools/tile_bench.py,
// IEACHE_110_FAST, 500 steps): the wgmma form 31.9 ms a rotation at B=272
// and 32.0 at B=384 in clusters of 4 (the mma form 34.9 and 35.8), 34.9 at
// B=512 in clusters of 2 (36.2); at B=257 31.6 against the mma form's
// 29.4 (its last 16-row tile holds one lane), so the scan takes the form
// from 272 lanes; at B=1024 94 ms in clusters of 4 and 70 in clusters of
// 2 (the mma form 57.0: the wgmma grid needs two turns of its items and
// each unit's decomposition outlasts its MMAs, PERF.md).  IEACHE_110 (6
// rows): 41.3 against 52.8 .. 53.0 at B = 257 .. 448.
// The mma form: 57.3 ms a rotation at B=1024, 30% of its
// 17.36 ms bound (the tensor cores' operations), against 74.8 for the
// two-phase kernel this design replaced; there the product is most of a
// step (13.5 ms without it, 43.7 without the decomposition).  At B=8
// 4.46 ms, 3% of its 0.136 ms bound and slower than that kernel's 3.7: a
// step is then a chain of latencies, the decomposition's reads of the
// new accumulator (2.81 ms without them), the product with its atomic
// adds (2.77 without) and the prefetch and zeroing around the barrier
// (0.98 with nothing else).  No other split or run of tiles a block is
// faster at any batch tools/tile_bench.py timed at 4 rows; at 6 rows and
// B=257 one (split 6, runs of 8) was (PERF.md).  The barrier
// written here beat cooperative groups' this_grid().sync() by 0.4 ms at
// B=8 and 1.8 ms at B=1024.
#include <cooperative_groups.h>

#include "cmux_step_parts.cuh"
#include "wgmma_step.cuh"

using namespace ieache;
namespace cg = cooperative_groups;

namespace {

struct ScanArgs {
  const uint32_t* acc_in;
  const int32_t* bara;   // (B, nsteps)
  const uint32_t* bk;    // (nsteps, rows, kp1, N)
  // the accumulator's buffers: ring[0] is out; step s writes
  // ring[(nsteps - 1 - s) % nring]
  uint32_t* ring[3];
  unsigned int* barrier;  // the grid barrier's word, 0 at the launch
  int nring, rows, kp1, batch, n, nsteps, bg_bit, l, split, per_item;
  uint32_t offset;
};

// Shared memory of a block: the fused step's (the byte planes, one digit
// tile), the amounts of its first work item's 16 batch rows and, in a
// launch that splits each tile's sum (`atomic`), a 16 x T tile of the
// accumulator for the part that adds it.
template <int NI>
inline size_t scan_smem_bytes(int rows, int n, bool atomic) {
  return fused::step_smem_bytes<NI>(rows, n) + mma::BM * sizeof(int32_t) +
         (atomic ? fused::add_tile_bytes<NI>() : 0);
}

// The grid-wide barrier between steps, in two halves around `between`
// (work that reads nothing written in the step).  One word, 0 at the
// launch: block 0 adds 2^31 - (G - 1) and every other block 1, so its top
// bit flips once all G blocks have arrived, and its low bits are 0 again.
// Thread 0 arrives with a release after the block barrier that follows the
// block's writes, and waits with an acquire before the block barrier that
// precedes its reads, as CUTLASS's grid barrier does.  The cooperative
// launch keeps every block resident, so the wait ends.
template <class Between>
__device__ __forceinline__ void grid_barrier(unsigned int* word,
                                             const Between& between) {
  __syncthreads();
  unsigned int seen = 0u;
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                 : "=r"(seen) : "l"(word) : "memory");
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
                 :: "l"(word), "r"(add) : "memory");
  }
  between();
  if (threadIdx.x == 0) {
    unsigned int now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(now) : "l"(word) : "memory");
    } while (((now ^ seen) & 0x80000000u) == 0u);
  }
  __syncthreads();
}

// This block's share of `words` zeros at buf (16-byte aligned, words a
// multiple of 4).
__device__ __forceinline__ void zero_share(uint32_t* buf, int64_t words) {
  uint4* q = reinterpret_cast<uint4*>(buf);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < words / 4; i += stride)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

template <int NI>
__global__ void __launch_bounds__(mma::kThreads, 2)
    blind_rotate_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  using S = mma::Shape<NI>;
  int8_t* dsm = reinterpret_cast<int8_t*>(smem + S::kPlanesBytes);
  int32_t* amounts = reinterpret_cast<int32_t*>(
      smem + fused::step_smem_bytes<NI>(a.rows, a.n));
  uint32_t* add_tile = reinterpret_cast<uint32_t*>(amounts + mma::BM);
  const int tid = threadIdx.x;
  const int csize = (int)cg::this_cluster().num_blocks();
  const int crank = (int)cg::this_cluster().block_rank();
  const int njt = a.n / S::T, group = njt * a.kp1;
  const int nbt = (a.batch + mma::BM - 1) / mma::BM;
  // a cluster's item: `csize` neighbouring runs of one row group's tiles
  // (or of one part's), one a block
  const int runs = (group + a.per_item - 1) / a.per_item / csize;
  const int nitems = nbt * a.split * runs;
  const int cluster = blockIdx.x / csize, nclusters = gridDim.x / csize;
  const int64_t words = (int64_t)a.kp1 * a.batch * a.n;
  const bool atomic = a.split > 1;

  // The block's first item, the same every step: while the grid barrier
  // before step s completes, the block loads that item's amounts of step s
  // and builds its first tile's first planes from bk[s], neither of which
  // waits for the accumulator.
  const int b0_first = (cluster / runs / a.split) * mma::BM;
  const fused::PartRange r_first = fused::part_range(
      cluster / runs % a.split, a.split, a.rows, njt, S::T, a.n);
  const int t_first = ((cluster % runs) * csize + crank) * a.per_item;
  const auto prefetch = [&](int s) {
    if (tid < mma::BM && b0_first + tid < a.batch)
      amounts[tid] = a.bara[(int64_t)(b0_first + tid) * a.nsteps + s];
    const int c = r_first.c_begin, p = c / njt, ch0 = c - p * njt;
    int nseg = r_first.c_end - c < njt - ch0 ? r_first.c_end - c : njt - ch0;
    if (nseg > mma::kSegChunks) nseg = mma::kSegChunks;
    mma::build_planes<NI>(
        reinterpret_cast<uint32_t*>(smem),
        a.bk + (((int64_t)s * a.rows + p) * a.kp1 + t_first / njt) * a.n, a.n,
        (t_first % njt) * S::T, ch0 * S::T, nseg * S::T, tid);
  };

  if (atomic) {
    zero_share(a.ring[(a.nsteps - 1) % a.nring], words);
    grid_barrier(a.barrier, [&] { prefetch(0); });
  } else {
    prefetch(0);
  }
  for (int s = 0; s < a.nsteps; ++s) {
    uint32_t* dst = a.ring[(a.nsteps - 1 - s) % a.nring];
    const uint32_t* cur =
        s == 0 ? a.acc_in : a.ring[(a.nsteps - s) % a.nring];
    const uint32_t* bk_s = a.bk + (int64_t)s * a.rows * a.kp1 * a.n;
    for (int it = cluster; it < nitems; it += nclusters) {
      const bool first = it == cluster;
      const int g = it / runs;  // row group x part
      const int b0 = (g / a.split) * mma::BM, q = g % a.split;
      const int t0 = ((it % runs) * csize + crank) * a.per_item;
      const int t1 = t0 + a.per_item < group ? t0 + a.per_item : group;
      const fused::PartRange r =
          fused::part_range(q, a.split, a.rows, njt, S::T, a.n);
      __syncthreads();  // the last item's readers of the tile are done
      fused::decompose_shared<true>(
          cur, first ? amounts : a.bara + (int64_t)b0 * a.nsteps + s,
          first ? 1 : a.nsteps, dsm, a.rows, a.batch, a.n, b0, a.bg_bit, a.l,
          a.offset, r, tid);
      fused::tiles_from_shared<NI, true>(
          smem, dsm, cur, bk_s, dst, a.kp1, a.batch, a.n, b0, r, t0, t1,
          atomic, atomic && q == 0 ? add_tile : nullptr, first, tid);
    }
    if (s + 1 == a.nsteps) break;
    // the buffer step s - 1 read is the one step s + 1 adds to
    if (atomic) zero_share(a.ring[(a.nsteps - 2 - s) % a.nring], words);
    grid_barrier(a.barrier, [&] { prefetch(s + 1); });
  }
}

// The wgmma form (split 1, per_item 1): one block an SM, wgmma_step.cuh's
// work item.  A cluster's item is BN batch rows and `cluster` neighbouring
// tiles of them, one a rank: every rank decomposes its share of the rows
// into every rank's stages.  Clusters walk items cluster, + nclusters, ...
// each step, synchronizing between two items (the epilogue's slabs lie
// over the stages peers write); the grid barrier's `between` loads the
// first item's amounts and builds its first pair's planes.  The
// consumers and the producer run their own loops from the start, so that
// the producer's few registers hold its state alone.
struct ScanWalk {
  int cluster, nclusters, csize, runs, nitems, njt, units;
  // item i's batch rows and rank crank's tile (component o, coefficient jb)
  template <int BN, int T>
  __device__ __forceinline__ void tile(int i, int crank, int* b0, int* o,
                                       int* jb) const {
    *b0 = i / runs * BN;
    const int t = i % runs * csize + crank;
    *o = t / njt;
    *jb = t % njt * T;
  }
};

template <int BN, int T, int KC>
__device__ __forceinline__ ScanWalk scan_walk(const ScanArgs& a,
                                              const wgs::Item& it) {
  ScanWalk w;
  w.cluster = blockIdx.x / it.csize;
  w.nclusters = gridDim.x / it.csize;
  w.njt = a.n / T;
  w.runs = w.njt * a.kp1 / it.csize;
  w.nitems = (a.batch + BN - 1) / BN * w.runs;
  w.units = a.kp1 * (a.n / KC);
  w.csize = it.csize;
  return w;
}

template <int BN, int T, int KC>
__device__ __forceinline__ void scan_consumers(const ScanArgs& a,
                                               const wgs::Item& it) {
  using TL = wg::Tile<BN, T, KC>;
  const ScanWalk w = scan_walk<BN, T, KC>(a, it);
  const int tid = threadIdx.x;
  __syncthreads();  // the producer's prefetch of step 0
  int j0 = 0;
  for (int s = 0; s < a.nsteps; ++s) {
    uint32_t* dst = a.ring[(a.nsteps - 1 - s) % a.nring];
    const uint32_t* cur =
        s == 0 ? a.acc_in : a.ring[(a.nsteps - s) % a.nring];
    for (int i = w.cluster; i < w.nitems; i += w.nclusters, j0 += w.units) {
      if (i != w.cluster) wgs::cluster_sync();  // every rank's epilogue done
      int b0, o, jb;
      w.tile<BN, T>(i, it.crank, &b0, &o, &jb);
      int32_t sum[TL::C][BN / 2];
      wg::zero<TL::C, BN>(sum);
      wgs::consume_units<BN, T, KC>(it, w.units, j0, tid, sum);
      wg::store_tile<BN, T, KC, true>(sum, it.smem, o, jb, b0, tid, cur, dst,
                                      a.batch, a.n, false);
      // the slabs' stores before the next item's copies into those bytes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    if (s + 1 == a.nsteps) break;
    grid_barrier(a.barrier, [] {});
  }
}

template <int BN, int T, int KC>
__device__ __forceinline__ void scan_producer(const ScanArgs& a,
                                              const wgs::Item& it) {
  const ScanWalk w = scan_walk<BN, T, KC>(a, it);
  const int ptid = threadIdx.x - wg::Tile<BN, T, KC>::kConsumers;
  const bool decomposer = ptid < wgs::kDecomposers;
  int b0_first, o_first, jb_first;
  w.tile<BN, T>(w.cluster, it.crank, &b0_first, &o_first, &jb_first);
  // what the block's first item, the same every step, needs before the
  // accumulator: its amounts of step s, its first pair's planes
  int j0 = 0, rows_uses = 0;
  const auto prefetch = [&](int s) {
    if (decomposer)
      wgs::load_amounts<BN, T, KC>(it, a.bara + s, a.nsteps, b0_first, ptid,
                                   wgs::kDecomposers);
    else
      wgs::build_pair_planes<BN, T, KC>(
          it, a.bk + (int64_t)s * a.rows * a.kp1 * a.n, o_first, 0, jb_first,
          ptid - wgs::kDecomposers);
  };
  prefetch(0);
  __syncthreads();
  for (int s = 0; s < a.nsteps; ++s) {
    const uint32_t* cur =
        s == 0 ? a.acc_in : a.ring[(a.nsteps - s) % a.nring];
    const uint32_t* bk_s = a.bk + (int64_t)s * a.rows * a.kp1 * a.n;
    for (int i = w.cluster; i < w.nitems; i += w.nclusters, j0 += w.units) {
      const bool first = i == w.cluster;
      if (!first) wgs::cluster_sync();
      int b0, o, jb;
      w.tile<BN, T>(i, it.crank, &b0, &o, &jb);
      if (decomposer) {
        if (!first)
          wgs::load_amounts<BN, T, KC>(it, a.bara + s, a.nsteps, b0, ptid,
                                       wgs::kDecomposers);
        wg::bar_sync(wgs::kDecompBar, wgs::kDecomposers);
        wgs::decompose_units<BN, T, KC>(it, cur, b0, a.bg_bit, a.offset,
                                        w.units, j0, rows_uses, ptid);
      } else {
        wgs::build_item_planes<BN, T, KC>(it, bk_s, o, jb, w.units, first,
                                          ptid - wgs::kDecomposers);
      }
    }
    if (s + 1 == a.nsteps) break;
    grid_barrier(a.barrier, [&] { prefetch(s + 1); });
  }
}

template <int BN, int T, int KC>
__global__ void __launch_bounds__(wg::Tile<BN, T, KC>::kThreads,
                                  wg::Tile<BN, T, KC>::kBlocksPerSm)
    blind_rotate_scan_wgmma_kernel(ScanArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  using TL = wg::Tile<BN, T, KC>;
  const uint32_t raw = wgs::smem_addr(smem_raw);
  const wgs::Item it{
      smem_raw + ((wg::kAlign - raw % wg::kAlign) % wg::kAlign), a.l,
      wgs::cluster_size(), wgs::cluster_rank(), a.kp1, a.batch, a.n};
  wgs::setup<BN, T, KC>(it);
  if (threadIdx.x < TL::kConsumers) {
    wg::regs_inc<TL::kConsumerRegs>();
    scan_consumers<BN, T, KC>(a, it);
  } else {
    wg::regs_dec<TL::kProducerRegs>();
    scan_producer<BN, T, KC>(a, it);
  }
  // no block leaves while a peer may still reach its shared memory
  wgs::cluster_sync();
}

template <int NI>
int launch(const ScanArgs& args, int grid, int cluster, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes<NI>(args.rows, args.n, args.split > 1);
  cudaError_t err = allow_smem(blind_rotate_scan_kernel<NI>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(mma::kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attrs[2] = {};
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = cluster;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  config.attrs = attrs;
  config.numAttrs = cluster > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&config, blind_rotate_scan_kernel<NI>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The wgmma form's launch: `grid` blocks in clusters of `cluster`,
// cooperative (every block resident).
template <int BN, int T, int KC>
int launch_wgmma(const ScanArgs& args, int grid, int cluster,
                 cudaStream_t stream) {
  const size_t smem =
      wgs::StepTile<BN, T, KC>::smem_bytes(args.l, cluster, args.n);
  cudaError_t err = allow_smem(blind_rotate_scan_wgmma_kernel<BN, T, KC>,
                               smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(wg::Tile<BN, T, KC>::kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attrs[2] = {};
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = cluster;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  config.attrs = attrs;
  config.numAttrs = 2;
  err = cudaLaunchKernelEx(&config, blind_rotate_scan_wgmma_kernel<BN, T, KC>,
                           args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `cluster` blocks of the wgmma form's kernel the device holds
// at once, into *out.
template <int BN, int T, int KC>
int wgmma_clusters(int l, int cluster, int n, int* out) {
  const size_t smem = wgs::StepTile<BN, T, KC>::smem_bytes(l, cluster, n);
  cudaError_t err = allow_smem(blind_rotate_scan_wgmma_kernel<BN, T, KC>,
                               smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(wg::Tile<BN, T, KC>::kThreads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, blind_rotate_scan_wgmma_kernel<BN, T, KC>, &config);
}

// The wgmma form's kernel for (N, BN): its launch and cluster query.
struct WgForm {
  int (*launch)(const ScanArgs&, int, int, cudaStream_t);
  int (*clusters)(int, int, int, int*);
};

template <int BN, int T, int KC>
WgForm wg_form() {
  return {launch_wgmma<BN, T, KC>, wgmma_clusters<BN, T, KC>};
}

// The tile of ops/kernels.py's WG_STEP_TILE: BN = 64 rows x T = min(N,
// 128) coefficients, chunks of min(N, 256) columns.
WgForm wgmma_form_for(int n) {
  static_assert(wgs::kTile == 64, "the forms below are BN = 64's");
  if (n >= 256) return wg_form<64, 128, 256>();
  if (n == 128) return wg_form<64, 128, 128>();
  return wg_form<64, 64, 64>();
}

// Blocks of the kernel for N's tile an SM holds at once, with the add
// tile where it fits (a launch without it holds no more shared memory).
template <int NI>
int per_sm(int rows, int n, int smem_optin, int* out) {
  size_t smem = scan_smem_bytes<NI>(rows, n, true);
  if (smem > (size_t)smem_optin) smem = scan_smem_bytes<NI>(rows, n, false);
  cudaError_t err = allow_smem(blind_rotate_scan_kernel<NI>, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, blind_rotate_scan_kernel<NI>, mma::kThreads, smem);
}

// Whether the shape is one the kernel takes: the tile's, with a digit
// tile (and, where `atomic`, the add tile) that fits a block's shared
// memory, whose size lands in *smem_optin.
cudaError_t shape_check(int rows, int n, bool atomic, int* smem_optin) {
  if (!mma::shape_ok(rows, n)) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = fused::device_limits(&sms, smem_optin);
  if (err != cudaSuccess) return err;
  const size_t smem = n >= 256   ? scan_smem_bytes<8>(rows, n, atomic)
                      : n == 128 ? scan_smem_bytes<4>(rows, n, atomic)
                                 : scan_smem_bytes<2>(rows, n, atomic);
  return smem > (size_t)*smem_optin ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

// Blocks of the scan kernel an SM holds at once at (rows, N), into
// *blocks; the launch policy (ops/kernels.py:scan_launch) reads it.
extern "C" int ieache_blind_rotate_scan_per_sm(int rows, int n, int* blocks) {
  int optin = 0;
  const cudaError_t err = shape_check(rows, n, false, &optin);
  if (err != cudaSuccess) return (int)err;
  if (n >= 256) return per_sm<8>(rows, n, optin, blocks);
  if (n == 128) return per_sm<4>(rows, n, optin, blocks);
  return per_sm<2>(rows, n, optin, blocks);
}

// Clusters of `cluster` blocks of the wgmma form the device holds at once
// at (rows, k+1, N), into *clusters; the launch policy
// (ops/kernels.py:scan_launch) makes its grid from it.
extern "C" int ieache_blind_rotate_scan_clusters(int rows, int kp1, int n,
                                                 int cluster, int* clusters) {
  if (!mma::shape_ok(rows, n) || rows % kp1 || rows / kp1 > wgs::kMaxLevels ||
      cluster < 1 || cluster > wgs::kMaxCluster)
    return (int)cudaErrorInvalidValue;
  return wgmma_form_for(n).clusters(rows / kp1, cluster, n, clusters);
}

// `scratch1` (nsteps > 1) and `scratch2` (split > 1 and nsteps > 2) are
// buffers of acc's size beside `out`, null where not needed; none may
// alias acc or another.  `barrier` is one 32-bit word holding 0, which
// the launch leaves at 0 or 2^31.  Every block must have a work item.
// form 0 (mma.sync, 16-row tiles) or 1 (wgmma, 64 batch rows x min(N,
// 128) coefficients a tile, split 1, per_item 1), as scan_launch gives it.
extern "C" int ieache_blind_rotate_scan(
    const void* acc, const void* bara, const void* bk, void* out,
    void* scratch1, void* scratch2, void* barrier, int rows, int kp1,
    int batch, int n, int nsteps, int bg_bit, int l, uint32_t offset,
    int split, int per_item, int grid, int cluster, int form, void* stream) {
  int optin = 0;
  cudaError_t err = cudaSuccess;
  WgForm wgf;
  int t = 0, bm = 0;
  if (form == 1) {
    if (!mma::shape_ok(rows, n) || rows != kp1 * l || l > wgs::kMaxLevels ||
        split != 1 || per_item != 1 || cluster > wgs::kMaxCluster)
      return (int)cudaErrorInvalidValue;
    wgf = wgmma_form_for(n);
    t = n < 128 ? n : 128;
    bm = wgs::kTile;
  } else {
    err = shape_check(rows, n, split > 1, &optin);
    if (err != cudaSuccess) return (int)err;
    if (form != 0) return (int)cudaErrorInvalidValue;
    t = n < 256 ? n : 256;
    bm = mma::BM;
  }
  const int group = (n / t) * kp1;
  const int runs = per_item < 1 ? 0 : (group + per_item - 1) / per_item;
  if (split < 1 || split > rows * (n / t) || per_item < 1 || cluster < 1 ||
      runs % cluster || grid < cluster || grid % cluster ||
      grid / cluster > (batch + bm - 1) / bm * split * runs / cluster ||
      barrier == nullptr || (nsteps > 1 && scratch1 == nullptr) ||
      (split > 1 && nsteps > 2 && scratch2 == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;

  ScanArgs args{};
  args.acc_in = (const uint32_t*)acc;
  args.bara = (const int32_t*)bara;
  args.bk = (const uint32_t*)bk;
  args.ring[0] = (uint32_t*)out;
  args.ring[1] = (uint32_t*)scratch1;
  args.ring[2] = (uint32_t*)scratch2;
  args.barrier = (unsigned int*)barrier;
  args.nring = split > 1 ? 3 : 2;
  args.rows = rows;
  args.kp1 = kp1;
  args.batch = batch;
  args.n = n;
  args.nsteps = nsteps;
  args.bg_bit = bg_bit;
  args.l = l;
  args.split = split;
  args.per_item = per_item;
  args.offset = offset;
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == 1) return wgf.launch(args, grid, cluster, s);
  if (n >= 256) return launch<8>(args, grid, cluster, s);
  if (n == 128) return launch<4>(args, grid, cluster, s);
  return launch<2>(args, grid, cluster, s);
}
