// One CMux step with the next batch rows' rotate + decompose overlapped
// with these rows' external product: warp specialisation.
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _cmux_overlap_kernel
// behind cmux_step_overlap_pallas and cmux_step_overlap2_pallas (the
// `overlap` and `overlap2` step modes; overlap2's shifted operand copies
// were a TPU compiler workaround, and both modes launch this kernel).
//
//   in/out: as cmux_step.cu, and bit-identical to it
//
// Bound on the H100: operations, as cmux_step.cu (34.4 G int8
// multiply-adds a step at B=1024, N=1024, k=1, l=2: 0.035 ms at the tensor
// cores' peak).  On the TPU the overlap gave the vector unit's rotation and
// the matrix unit's products independent work to interleave.  Here the two
// are different warps of one block: the decomposition is integer work on
// the CUDA cores, the product runs on the tensor cores.
//
// Design: a persistent block of 256 threads an SM.  A work item is 16 batch
// rows and a run of `per_item` of their N/T x (k+1) output tiles
// (T = min(N, 256); tile t of the rows is coefficient block t % (N/T) of
// component t / (N/T)); items are numbered rows-major, so the blocks that
// share batch rows run side by side, and a block takes items blockIdx.x,
// + gridDim.x, ...  Warps 4-7 (producers) rotate, diff and decompose an
// item's batch rows into one of two (rows, 16, N + 16) int8 stages in
// shared memory, once for all its tiles; warps 0-3 (consumers) run the
// tensor-core tile (mma_tile.cuh) over the item's tiles with ldmatrix
// reading the stage as it lies, while the producers fill the other stage
// for the next item.  The stages are handed over with named barriers:
// FULL[s] (the producers arrive when stage s is written, the consumers
// wait) and EMPTY[s] (the consumers arrive when they are done reading
// stage s, the producers wait before they overwrite it); the tile's own
// barriers are a third named barrier over the 128 consumer threads.  The
// block's first item has nothing to hide behind, so all 8 warps decompose
// it.  per_item is the run that ends soonest, counted in tiles a block
// computes one after another (fused::tiles_per_item): at B=1024, N=1024,
// k=1 the 64 row groups of 8 tiles become 128 items of 4, so each digit
// tile is decomposed twice; from B=2048 an item is all 8 tiles of its
// rows.  Shared memory: 21 KB of byte planes and two stages of 66.6 KB
// (154 KB at N=1024 and 4 rows; 221 KB at 6 rows), one block an SM.
//
// On an H100 (700 W) at B=1024, N=1024, k=1, l=2: 0.113 ms a step against
// 0.103 for cmux_step.cu.  With the decomposition taken out the step takes
// 0.101 ms (cmux_step.cu: 0.084): at B=1024 a block has one item, so
// nothing is overlapped, and its four consumer warps compute a tile in
// 25 us where the two 4-warp blocks an SM of cmux_step.cu take 21 us a
// tile between them; eight consumer warps would need more registers than
// an SM has beside the producers'.
//
// A batch with fewer tiles than SMs (B <= 256 at N=1024) would leave most
// of the card idle under whole tiles, and a persistent block cannot split
// a tile's sum without decomposing for every part: there ops/kernels.py
// (_cmux_step_launch) passes the mma.sync launch of cmux_step.cu's kernel
// (cmux_step_parts.cuh; step_shape: split, per_item, cluster), which
// splits each tile's sum over (p, chunk) parts, and the entry runs it as
// it is; a split of 0 runs this kernel.  The launch refuses what the tile
// refuses (cudaErrorInvalidValue), and two stages that do not fit the
// block's shared memory.

#include "cmux_step_parts.cuh"

using namespace ieache;

namespace {

constexpr int kThreads = 2 * mma::kThreads;
constexpr int kTileBar = 1;   // consumers only
constexpr int kFullBar = 2;   // + stage
constexpr int kEmptyBar = 4;  // + stage

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

template <int NI>
__global__ void __launch_bounds__(kThreads, 1) cmux_step_overlap_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    const uint32_t* __restrict__ bk, uint32_t* __restrict__ out, int rows,
    int kp1, int batch, int n, int bg_bit, int l, uint32_t offset,
    int per_item) {
  extern __shared__ __align__(16) uint8_t smem[];
  using S = mma::Shape<NI>;
  int8_t* stage0 = reinterpret_cast<int8_t*>(smem + S::kPlanesBytes);
  const int stage_bytes = (int)digit_tile_bytes(rows, n);
  const int nbt = (batch + mma::BM - 1) / mma::BM, njt = n / S::T;
  const int group = njt * kp1;                         // tiles of 16 rows
  const int nper = (group + per_item - 1) / per_item;  // items of 16 rows
  const int nitems = nbt * nper;
  // this block's items: blockIdx.x + i * gridDim.x, i < count; item w is
  // run w % nper of batch rows 16 (w / nper) ..
  const int count =
      (nitems - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  // the block's first item has nothing to hide behind: all 8 warps
  // decompose it
  decompose_tile(acc, bara + (blockIdx.x / nper) * mma::BM, stage0, batch, n,
                 (blockIdx.x / nper) * mma::BM, bg_bit, l, offset, 0, mma::BM,
                 0, rows - 1, 0, n, threadIdx.x, kThreads);
  __syncthreads();

  if (threadIdx.x >= mma::kThreads) {  // producers
    const int ptid = threadIdx.x - mma::kThreads;
    for (int i = 1; i < count; ++i) {
      const int s = i & 1;
      if (i >= 2) bar_sync(kEmptyBar + s);
      const int w = blockIdx.x + i * gridDim.x;
      decompose_tile(acc, bara + (w / nper) * mma::BM,
                     stage0 + s * stage_bytes, batch, n, (w / nper) * mma::BM,
                     bg_bit, l, offset, 0, mma::BM, 0, rows - 1, 0, n, ptid,
                     mma::kThreads);
      __threadfence_block();
      bar_arrive(kFullBar + s);
    }
    return;
  }

  const int tid = threadIdx.x;
  for (int i = 0; i < count; ++i) {
    const int s = i & 1;
    const int w = blockIdx.x + i * gridDim.x;
    const int b0 = (w / nper) * mma::BM, t0 = (w % nper) * per_item;
    const int t1 = t0 + per_item < group ? t0 + per_item : group;
    const mma::SharedDigits digits{
        (uint32_t)__cvta_generic_to_shared(stage0 + s * stage_bytes),
        digit_pitch(n)};
    if (i >= 1) bar_sync(kFullBar + s);
    for (int t = t0; t < t1; ++t) {
      const int jb = (t % njt) * S::T, o = t / njt;
      int32_t sum[4][NI][4];
      mma::zero_acc<NI>(sum);
      mma::product_accumulate_mma<NI>(smem, digits, bk, kp1, n, o, jb, 0,
                                      rows * njt, tid, TileSync<kTileBar>{},
                                      sum);
      // the producers wait on EMPTY[s] only before an item i + 2
      if (t == t1 - 1 && i + 2 < count) bar_arrive(kEmptyBar + s);
      mma::store_tile_mma<NI, false>(sum, o, b0, jb, tid, acc, out, batch, n);
    }
  }
}

// The launch for N's tile, NI = min(N, 256) / 32: this kernel, or with
// parts_split >= 1 the fused2 kernel under (parts_split, parts_per_item,
// parts_cluster).
template <int NI>
int launch(const void* acc, const void* bara, const void* bk, void* out,
           int rows, int kp1, int batch, int n, int bg_bit, int l,
           uint32_t offset, int parts_split, int parts_per_item,
           int parts_cluster, int sms, int smem_optin, cudaStream_t s) {
  using S = mma::Shape<NI>;
  const int nbt = (batch + mma::BM - 1) / mma::BM, group = (n / S::T) * kp1;
  const size_t smem = S::kPlanesBytes + 2 * digit_tile_bytes(rows, n);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  if (parts_split >= 1)
    return fused::launch_step_parts<NI>(acc, bara, bk, out, rows, kp1, batch,
                                        n, bg_bit, l, offset, parts_split,
                                        parts_per_item, parts_cluster,
                                        smem_optin, s);
  cudaError_t err = allow_smem(cmux_step_overlap_kernel<NI>, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cmux_step_overlap_kernel<NI>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int per_item = fused::tiles_per_item(nbt, group, sms * per_sm);
  const int nitems = nbt * ((group + per_item - 1) / per_item);
  const int grid = nitems < sms * per_sm ? nitems : sms * per_sm;
  cmux_step_overlap_kernel<NI><<<grid, kThreads, smem, s>>>(
      (const uint32_t*)acc, (const int32_t*)bara, (const uint32_t*)bk,
      (uint32_t*)out, rows, kp1, batch, n, bg_bit, l, offset, per_item);
  return (int)cudaGetLastError();
}

}  // namespace

// parts_split 0: this kernel; >= 1: the fused2 kernel's parts under the
// launch (parts_split, parts_per_item, parts_cluster) ops/kernels.py gives.
extern "C" int ieache_cmux_step_overlap(const void* acc, const void* bara,
                                        const void* bk, void* out, int rows,
                                        int kp1, int batch, int n, int bg_bit,
                                        int l, uint32_t offset,
                                        int parts_split, int parts_per_item,
                                        int parts_cluster, void* stream) {
  if (!mma::shape_ok(rows, n)) return (int)cudaErrorInvalidValue;
  int sms = 0, smem_optin = 0;
  const cudaError_t err = fused::device_limits(&sms, &smem_optin);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n >= 256)
    return launch<8>(acc, bara, bk, out, rows, kp1, batch, n, bg_bit, l,
                     offset, parts_split, parts_per_item, parts_cluster, sms,
                     smem_optin, s);
  if (n == 128)
    return launch<4>(acc, bara, bk, out, rows, kp1, batch, n, bg_bit, l,
                     offset, parts_split, parts_per_item, parts_cluster, sms,
                     smem_optin, s);
  return launch<2>(acc, bara, bk, out, rows, kp1, batch, n, bg_bit, l, offset,
                   parts_split, parts_per_item, parts_cluster, sms, smem_optin,
                   s);
}
