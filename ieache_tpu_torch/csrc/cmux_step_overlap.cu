// One CMux step with the next tile's rotate + decompose overlapped with
// this tile's external product: warp specialisation.
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _cmux_overlap_kernel
// behind cmux_step_overlap_pallas and cmux_step_overlap2_pallas (the
// `overlap` and `overlap2` step modes; overlap2's shifted operand copies
// were a TPU compiler workaround, and both modes launch this kernel).
//
//   in/out: as cmux_step.cu, and bit-identical to it
//
// Bound on the H100: the rate at which its 4 consumer warps per SM
// issue integer multiply-adds (see the end of the design note).  On the
// TPU the overlap gave the vector unit's rotation and the matrix unit's
// products independent work to interleave.  Here the two are different
// warps of one block, sharing the SM's issue slots.
//
// Design: a persistent block of 256 threads per SM walks over the output
// tiles of cmux_step.cu (16 batch rows x 256 coefficients of one
// component o) with a stride of the grid size.  Warps 4-7 (producers)
// rotate, diff and decompose the batch rows of the block's next tile into
// one of two shared-memory digit stages, while warps 0-3 (consumers) run
// the external product of the current tile from the other stage.  The
// stages are handed over with named barriers: FULL[s] (the producers
// arrive when stage s is written, the consumers wait) and EMPTY[s] (the
// consumers arrive when they are done reading stage s, the producers
// wait before they overwrite it).  The consumers' own barrier inside the
// tile loop is a third named barrier over their 128 threads.  The first
// tile's decomposition is the only one not hidden.  Shared memory: two
// stages of (rows, 16, N) int8 (128 KB at N=1024 and 4 rows) plus the
// tile loop's 24.6 KB, one block per SM.  That leaves 4 warps per SM
// to issue the product's multiply-adds, against about 20 in
// external_product.cu (five 4-warp blocks).

#include "cmux_common.cuh"

using namespace ieache;

namespace {

constexpr int kThreads = 2 * kTileThreads;
constexpr int kTileBar = 1;   // consumers only
constexpr int kFullBar = 2;   // + stage
constexpr int kEmptyBar = 4;  // + stage

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__global__ void __launch_bounds__(kThreads) cmux_step_overlap_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    const uint32_t* __restrict__ bk, uint32_t* __restrict__ out, int rows,
    int kp1, int batch, int n, int bg_bit, int l, uint32_t offset) {
  extern __shared__ __align__(16) uint32_t smem[];
  int8_t* stage0 = reinterpret_cast<int8_t*>(smem + product_smem_words(n));
  const int stage_bytes = rows * TB * n;
  const int nbt = (batch + TB - 1) / TB, njt = (n + TJ - 1) / TJ;
  const int ntiles = nbt * njt * kp1;
  // this block's tiles: blockIdx.x + i * gridDim.x, i < count; tile
  // (bt, jt, o) is numbered (o * njt + jt) * nbt + bt
  const int count =
      (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (threadIdx.x >= kTileThreads) {  // producers
    const int ptid = threadIdx.x - kTileThreads;
    for (int i = 0; i < count; ++i) {
      const int s = i & 1;
      if (i >= 2) bar_sync(kEmptyBar + s);
      const int tile = blockIdx.x + i * gridDim.x;
      decompose_tile(acc, bara, 1, stage0 + s * stage_bytes, kp1, batch, n,
                     (tile % nbt) * TB, bg_bit, l, offset, ptid,
                     kTileThreads);
      bar_arrive(kFullBar + s);
    }
    return;
  }

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  for (int i = 0; i < count; ++i) {
    const int s = i & 1;
    const int tile = blockIdx.x + i * gridDim.x;
    const Tile t = make_tile(tile % nbt, (tile / nbt) % njt,
                             tile / (nbt * njt), n, tx);
    bar_sync(kFullBar + s);
    uint32_t sum[RB][RJ];
    zero_sum(sum);
    product_accumulate(smem, bk, kp1, n, t, 0, rows * (n / chunk_cols(n)),
                       tid, ty, SharedDigits{stage0 + s * stage_bytes, n, tid},
                       TileSync<kTileBar>{}, sum);
    // the producers wait on EMPTY[s] only before a tile i + 2
    if (i + 2 < count) bar_arrive(kEmptyBar + s);
    store_tile<false>(sum, t, ty, acc, out, batch, n);
  }
}

}  // namespace

extern "C" int ieache_cmux_step_overlap(const void* acc, const void* bara,
                                        const void* bk, void* out, int rows,
                                        int kp1, int batch, int n, int bg_bit,
                                        int l, uint32_t offset, void* stream) {
  const size_t smem = (size_t)product_smem_words(n) * sizeof(uint32_t) +
                      2 * (size_t)rows * TB * n;
  cudaError_t err = allow_smem(cmux_step_overlap_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cmux_step_overlap_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ntiles =
      ((batch + TB - 1) / TB) * ((n + TJ - 1) / TJ) * kp1;
  const int grid = ntiles < sms * per_sm ? ntiles : sms * per_sm;
  cmux_step_overlap_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)bara, (const uint32_t*)bk,
      (uint32_t*)out, rows, kp1, batch, n, bg_bit, l, offset);
  return (int)cudaGetLastError();
}
