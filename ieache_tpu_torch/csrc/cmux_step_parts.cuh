// One whole CMux step on the int8 tensor-core tile, the digits decomposed
// by each block into its own shared memory: the kernel of cmux_step.cu,
// which cmux_step_overlap.cu also launches for a batch too small to fill
// the card with whole tiles.  Its work item (decompose_shared, then
// tiles_from_shared) is also the step body of blind_rotate_scan.cu, which
// runs it for all n steps inside one launch.
//
// 16 batch rows have N/T x (k+1) output tiles of 16 x T, T = min(N, 256):
// tile t is coefficient block t % (N/T) of component t / (N/T).  A block
// rotates, diffs and decomposes its 16 rows into shared memory once
// (ieache::decompose_tile) and runs mma::product_accumulate_mma from that
// tile for a run of `per_item` of the rows' tiles, adding the accumulator
// and storing each: the longer the run, the fewer blocks decompose the
// same rows.  The blocks that share batch rows, (x, 0 .. gridDim.y - 1),
// are launched in thread-block clusters of neighbours along y: a block
// decomposes its share of the 16 rows and copies the others from its
// peers' shared memory.
//
// The launch (split, per_item, cluster) is ops/kernels.py's step_launch,
// taken as it is.  A launch with fewer tiles than SMs splits each tile's
// sum (per_item is then 1): a block computes part q of `split` of one tile,
// the (p, chunk) pairs q * nchunks / split .. (q + 1) * nchunks / split - 1,
// pair c = p * (N / T) + chunk, and decomposes only the digits those pairs
// read (part_range: one digit row's columns of its chunks, or all columns
// of every row the part touches).  The launch has copied the accumulator
// into the output, and the part adds its share with atomicAdd on unsigned
// int, which wraps: exact in any order.

#pragma once

#include <cooperative_groups.h>

#include "mma_tile.cuh"

namespace ieache {
namespace fused {

namespace cg = cooperative_groups;

// Shared memory of a block: the byte planes, then one digit tile.
template <int NI>
__host__ __device__ inline size_t step_smem_bytes(int rows, int n) {
  return mma::Shape<NI>::kPlanesBytes + digit_tile_bytes(rows, n);
}

// Tiles per work item of the overlap kernel (ops/kernels.py's
// tiles_per_item, which step_launch gives the fused2 kernel): of the ways to
// cut a row group's `group` tiles into equal runs, the one whose busiest
// place ends soonest when `nbt` row groups are dealt to `places` blocks
// resident at once, a run costing its tiles and a quarter of a tile for
// its decomposition (0.03 of 0.115 ms measured); of equal ones the longest
// run, which decomposes least.
inline int tiles_per_item(int nbt, int group, int places) {
  int best = group;
  int64_t best_cost = INT64_MAX;
  for (int parts = 1; parts <= group; ++parts) {
    const int per = (group + parts - 1) / parts;
    const int64_t items = (int64_t)nbt * ((group + per - 1) / per);
    const int64_t cost = ((items + places - 1) / places) * (4 * per + 1);
    if (cost < best_cost) {
      best_cost = cost;
      best = per;
    }
  }
  return best;
}

// What a part of a split tile sums and decomposes.
struct PartRange {
  int c_begin, c_end;    // its (p, chunk) pairs
  int p_lo, p_hi;        // the digit rows it decomposes,
  int col_lo, col_hi;    // and their columns
};

// Part q of `split` of a tile's rows * nchunk pairs, chunks of t columns.
// A part inside one digit row decomposes the columns of its chunks when
// their count is a power of two (decompose_tile wants one), else, and when
// it spans several rows, all n columns of its rows.
__host__ __device__ inline PartRange part_range(int q, int split, int rows,
                                                int nchunk, int t, int n) {
  PartRange r;
  const int nchunks = rows * nchunk;
  r.c_begin = q * nchunks / split;
  r.c_end = (q + 1) * nchunks / split;
  r.p_lo = r.c_begin / nchunk;
  r.p_hi = (r.c_end - 1) / nchunk;
  const int count = r.c_end - r.c_begin;
  if (r.p_lo == r.p_hi && (count & (count - 1)) == 0) {
    r.col_lo = (r.c_begin - r.p_lo * nchunk) * t;
    r.col_hi = r.col_lo + count * t;
  } else {
    r.col_lo = 0;
    r.col_hi = n;
  }
  return r;
}

// The digit rows and columns r of batch rows b0 .. b0 + 15 into the
// block's tile dsm: the blocks of a cluster (neighbours that share these
// rows) each decompose their share of the rows, then copy the others' from
// the peers' shared memory into their own tile, which ldmatrix can only
// read locally.  Batch row b0 + bl's amount is bara[bl * bara_stride]; kCg
// reads acc through L2 only (decompose_tile).
template <bool kCg>
__device__ __forceinline__ void decompose_shared(
    const uint32_t* acc, const int32_t* bara, int bara_stride, int8_t* dsm,
    int rows, int batch, int n, int b0, int bg_bit, int l, uint32_t offset,
    const PartRange& r, int tid) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int crank = (int)cluster.block_rank();
  decompose_tile<kCg>(acc, bara, dsm, batch, n, b0, bg_bit, l, offset,
                      crank * mma::BM / csize, (crank + 1) * mma::BM / csize,
                      r.p_lo, r.p_hi, r.col_lo, r.col_hi, tid, mma::kThreads,
                      bara_stride);
  if (csize > 1) {
    cluster.sync();
    const int pitch = digit_pitch(n), pieces = n / 16;
    for (int peer = 1; peer < csize; ++peer) {
      const int from = (crank + peer) % csize;  // spread over the peers
      const int8_t* src = cluster.map_shared_rank(dsm, from);
      const int bl_lo = from * mma::BM / csize;
      const int nrow = (from + 1) * mma::BM / csize - bl_lo;
      for (int i = tid; i < rows * nrow * pieces; i += mma::kThreads) {
        const int piece = i % pieces, row = i / pieces;
        const int at = ((row / nrow) * mma::BM + bl_lo + row % nrow) * pitch +
                       16 * piece;
        *reinterpret_cast<uint4*>(dsm + at) =
            *reinterpret_cast<const uint4*>(src + at);
      }
    }
    cluster.sync();  // no block leaves while a peer still reads its tile
  }
}

// Words a row of a 16 x T tile of the accumulator in shared memory: T
// and 8 of padding, which spreads the 8 rows a warp's epilogue reads at
// once over the banks.
template <int NI>
__host__ __device__ constexpr int add_pitch() {
  return mma::Shape<NI>::T + 8;
}

template <int NI>
__host__ __device__ constexpr size_t add_tile_bytes() {
  return (size_t)mma::BM * add_pitch<NI>() * sizeof(uint32_t);
}

// Start the copy of acc[o, b0 .. b0 + 15, jb .. jb + T - 1] into the shared
// tile `tile` (rows past the batch zero), through L2 only, and commit it.
template <int NI>
__device__ __forceinline__ void stage_add_tile(uint32_t* tile,
                                               const uint32_t* acc, int o,
                                               int b0, int jb, int batch,
                                               int n, int tid) {
  constexpr int kPieces = mma::Shape<NI>::T / 4;  // 16 bytes each
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(tile);
  for (int i = tid; i < mma::BM * kPieces; i += mma::kThreads) {
    const int row = i / kPieces, piece = i - row * kPieces;
    const bool valid = b0 + row < batch;
    mma::cp_async16(
        base + (row * add_pitch<NI>() + 4 * piece) * sizeof(uint32_t),
        acc + ((int64_t)o * batch + (valid ? b0 + row : b0)) * n + jb +
            4 * piece,
        valid ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Output tiles t0 .. t1 - 1 of batch rows b0 (tile t at coefficient
// (t % (N/T)) T of component t / (N/T)) from the digit tile at dsm, each
// summed over the pairs r.c_begin .. r.c_end - 1: out = acc + the sum, or,
// when `atomic`, out += the sum with atomicAdd, and where add_tile (16 x
// add_pitch words of shared memory) is not null, + acc's tile, copied
// there while the product runs.  planes_ready: the caller built the first
// tile's first planes (mma::product_accumulate_mma).  kCg reads acc
// through L2 only.
template <int NI, bool kCg>
__device__ __forceinline__ void tiles_from_shared(
    uint8_t* smem, int8_t* dsm, const uint32_t* acc, const uint32_t* bk,
    uint32_t* out, int kp1, int batch, int n, int b0, const PartRange& r,
    int t0, int t1, bool atomic, uint32_t* add_tile, bool planes_ready,
    int tid) {
  using S = mma::Shape<NI>;
  const int njt = n / S::T;
  const mma::SharedDigits digits{(uint32_t)__cvta_generic_to_shared(dsm),
                                 digit_pitch(n)};
  for (int t = t0; t < t1; ++t) {
    const int jb = (t % njt) * S::T, o = t / njt;
    if (add_tile != nullptr) {
      if (t != t0) __syncthreads();  // the last epilogue read the tile
      stage_add_tile<NI>(add_tile, acc, o, b0, jb, batch, n, tid);
    }
    int32_t sum[4][NI][4];
    mma::zero_acc<NI>(sum);
    // the product's first barrier makes the digits visible to every warp
    mma::product_accumulate_mma<NI>(smem, digits, bk, kp1, n, o, jb, r.c_begin,
                                    r.c_end, tid, BlockSync{}, sum,
                                    planes_ready && t == t0);
    if (atomic) {
      if (add_tile != nullptr) {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncthreads();
      }
      mma::atomic_add_tile_mma<NI>(sum, o, b0, jb, tid, out, batch, n,
                                   add_tile, add_pitch<NI>());
    } else {
      mma::store_tile_mma<NI, kCg>(sum, o, b0, jb, tid, acc, out, batch, n);
    }
  }
}

// Block (x, y): part x % split of the sum of tile y (split > 1), or the
// tiles y * per_item .. of batch rows 16 x .. (split == 1).
template <int NI>
__global__ void __launch_bounds__(mma::kThreads, 2) cmux_step_parts_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    const uint32_t* __restrict__ bk, uint32_t* __restrict__ out, int rows,
    int kp1, int batch, int n, int bg_bit, int l, uint32_t offset, int split,
    int per_item) {
  extern __shared__ __align__(16) uint8_t smem[];
  using S = mma::Shape<NI>;
  int8_t* dsm = reinterpret_cast<int8_t*>(smem + S::kPlanesBytes);
  const int b0 = (blockIdx.x / split) * mma::BM;
  const int njt = n / S::T, group = njt * kp1;
  const PartRange r =
      part_range(blockIdx.x % split, split, rows, njt, S::T, n);
  decompose_shared<false>(acc, bara + b0, 1, dsm, rows, batch, n, b0, bg_bit,
                          l, offset, r, threadIdx.x);
  const int t0 = blockIdx.y * per_item;
  const int t1 = t0 + per_item < group ? t0 + per_item : group;
  tiles_from_shared<NI, false>(smem, dsm, acc, bk, out, kp1, batch, n, b0, r,
                               t0, t1, split > 1, nullptr, false, threadIdx.x);
}

// The launch for N's tile, NI = min(N, 256) / 32, as ops/kernels.py's
// step_launch gives it: each tile's sum in `split` parts over its (p,
// chunk) pairs, runs of `per_item` tiles a block, the blocks that share
// batch rows in clusters of `cluster`; the C side computes none of these
// and refuses what the kernel cannot run (cudaErrorInvalidValue).  `out`
// must not alias `acc`, which blocks read while others write `out`.  A
// digit tile that does not fit the block's shared memory is refused.
template <int NI>
int launch_step_parts(const void* acc, const void* bara, const void* bk,
                      void* out, int rows, int kp1, int batch, int n,
                      int bg_bit, int l, uint32_t offset, int split,
                      int per_item, int cluster, int smem_optin,
                      cudaStream_t s) {
  using S = mma::Shape<NI>;
  const size_t smem = step_smem_bytes<NI>(rows, n);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  const int nbt = (batch + mma::BM - 1) / mma::BM, njt = n / S::T;
  const int group = njt * kp1;
  const int nper = per_item < 1 ? 0 : (group + per_item - 1) / per_item;
  if (split < 1 || split > rows * njt || per_item < 1 || per_item > group ||
      (split > 1 && per_item != 1) || cluster < 1 || cluster > 8 ||
      nper % cluster)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(cmux_step_parts_kernel<NI>, smem);
  if (err != cudaSuccess) return (int)err;
  if (split > 1) {
    err = cudaMemcpyAsync(out, acc, (size_t)kp1 * batch * n * sizeof(uint32_t),
                          cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(nbt * split, nper);
  config.blockDim = dim3(mma::kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  // the blocks that share batch rows (along y) in clusters
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, cmux_step_parts_kernel<NI>,
                           (const uint32_t*)acc, (const int32_t*)bara,
                           (const uint32_t*)bk, (uint32_t*)out, rows, kp1,
                           batch, n, bg_bit, l, offset, split, per_item);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the kernel for N's tile an SM holds at once at (rows, N), into
// *blocks; ops/kernels.py's step_launch reads it.
template <int NI>
int step_parts_per_sm(int rows, int n, int smem_optin, int* blocks) {
  const size_t smem = step_smem_bytes<NI>(rows, n);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(cmux_step_parts_kernel<NI>, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, cmux_step_parts_kernel<NI>, mma::kThreads, smem);
}

// The SM count and the most dynamic shared memory a block may ask for on
// the current device.
inline cudaError_t device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(smem_optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace fused
}  // namespace ieache
