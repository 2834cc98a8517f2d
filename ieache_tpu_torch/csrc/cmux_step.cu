// One whole CMux step as one kernel, the digits never in device memory.
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _cmux_step_kernel behind
// cmux_step_pallas (the `fused2` step mode).
//
//   in : acc (k+1, B, N) int32, bara (B,) int32 in [0, 2N),
//        bk (rows, k+1, N) int32 one TRGSW step
//   out: acc + sum_p digits_p(X^bara * acc - acc) (*) bk[p, o],
//        negacyclic, exact mod 2^32; equal to rot_diff_decompose.cu
//        followed by external_product.cu with the accumulator fused
//
// Bound on the H100: operations, as external_product.cu: 68.7 G int8
// operations a step at B=1024, N=1024, k=1, l=2 on the tensor cores,
// 0.0347 ms at their peak; the bytes (8 MB of accumulator in and out, 16
// KB of key) take 0.003 ms.  What fusing saves over the split pair is the
// digit tensor's round trip through device memory (4 MB written and read
// a step at B=1024), one launch a step, and the host's second wrapper call.
//
// Two forms of one function, launched as ops/kernels.py's step_launch
// says (form, batch tile, coefficients, split, per_item, cluster; the C
// side keeps no policy and refuses what a form cannot run with
// cudaErrorInvalidValue):
//
// * "wgmma" (form 1, wgmma_step.cuh on wgmma_tile.cuh): a block computes
//   T = min(N, 128) coefficients x BN = 64 batch rows of one
//   component on Hopper's warpgroup MMA, two consumer warpgroups beside a
//   producer warpgroup that rotates, diffs and decomposes the digits
//   straight into the swizzled stages the wgmmas read (wgmma_step.cuh's
//   note has the design); the blocks of the same batch rows form clusters
//   of `cluster`, each decomposing its share of the rows into every
//   rank's stages.  Each tile whole (split 1, per_item 1): the policy
//   keeps the batches that would need a tile's sum split on "mma".
// * "mma" (form 0, cmux_step_parts.cuh on mma_tile.cuh): mma.sync
//   m16n8k32 with its digits read by ldmatrix from a (rows, 16, N + 16)
//   int8 tile the block decomposed into its own shared memory (66.6 KB at
//   N=1024 and 4 rows), a run of `per_item` of its 16 rows' tiles from one
//   decomposition, in clusters of two that share it; with fewer tiles than
//   SMs each tile's sum split over `split` (p, chunk) parts that add
//   atomically, a part decomposing only the digits it reads.
//
// The policy (step_launch) takes the wgmma form's 64-row tile where the
// mma form keeps every tile whole and the card holds the wgmma grid in
// one wave, in clusters of 4, else 2 (the occupancy query
// ieache_cmux_step_clusters): B = 257 .. 512 at 4 rows, 257 .. 448 at 6.
// On an NVIDIA H100 80GB HBM3 at 700 W (tools/tile_bench.py, PERF.md):
// IEACHE_110_FAST, the wgmma form 0.0592 .. 0.0605 ms a step at B = 257
// .. 512 against the mma form's 0.0609 .. 0.0617; at B=1024 0.1195 in
// clusters of 2 against 0.1016 (two waves, and each unit's decomposition
// outlasts the consumers' work on a pair, PERF.md); IEACHE_110 (6 rows)
// 0.0812 .. 0.0819 against 0.0926 .. 0.0937 at B = 257 .. 448.  The mma
// form: 0.103 ms a step at B=1024 (33% of the bound), 0.084 with its
// decomposition taken out; 0.0095 and 0.0118 ms at B = 8 and 16.  The
// output must not alias the accumulator.  The launch refuses what the
// tiles refuse: an N that is not a power of two of at least 64, rows * N
// >= 2^17, and shared memory over a block's.

#include <atomic>

#include "cmux_step_parts.cuh"
#include "wgmma_step.cuh"

using namespace ieache;

namespace {

// The wgmma form: the T x BN tile (blockIdx.x: coefficient block
// blockIdx.x % (N/T) of component blockIdx.x / (N/T); blockIdx.y: batch
// rows BN blockIdx.y ..), KC digit columns a chunk; W consumer
// warpgroups, then the producer warpgroup, which gives its registers to
// them (setmaxnreg).  Clusters along x share the decomposition.
template <int BN, int T, int KC>
__global__ void __launch_bounds__(wg::Tile<BN, T, KC>::kThreads,
                                  wg::Tile<BN, T, KC>::kBlocksPerSm)
    cmux_step_wgmma_kernel(const uint32_t* __restrict__ acc,
                           const int32_t* __restrict__ bara,
                           const uint32_t* __restrict__ bk,
                           uint32_t* __restrict__ out, int kp1, int batch,
                           int n, int bg_bit, int l, uint32_t offset) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  using TL = wg::Tile<BN, T, KC>;
  const uint32_t raw = wgs::smem_addr(smem_raw);
  const wgs::Item it{
      smem_raw + ((wg::kAlign - raw % wg::kAlign) % wg::kAlign), l,
      wgs::cluster_size(), wgs::cluster_rank(), kp1, batch, n};
  const int tid = threadIdx.x;
  const int njt = n / T, o = blockIdx.x / njt, jb = (blockIdx.x % njt) * T;
  const int b0 = blockIdx.y * BN;
  const int units = kp1 * (n / KC);
  wgs::setup<BN, T, KC>(it);
  if (tid >= TL::kConsumers) {
    wg::regs_dec<TL::kProducerRegs>();
    const int ptid = tid - TL::kConsumers;
    if (ptid < wgs::kDecomposers) {
      wgs::load_amounts<BN, T, KC>(it, bara, 1, b0, ptid, wgs::kDecomposers);
      wg::bar_sync(wgs::kDecompBar, wgs::kDecomposers);
      int rows_uses = 0;
      wgs::decompose_units<BN, T, KC>(it, acc, b0, bg_bit, offset, units, 0,
                                      rows_uses, ptid);
    } else {
      wgs::build_item_planes<BN, T, KC>(it, bk, o, jb, units, false,
                                        ptid - wgs::kDecomposers);
    }
  } else {
    wg::regs_inc<TL::kConsumerRegs>();
    int32_t sum[TL::C][BN / 2];
    wg::zero<TL::C, BN>(sum);
    wgs::consume_units<BN, T, KC>(it, units, 0, tid, sum);
    wg::store_tile<BN, T, KC>(sum, it.smem, o, jb, b0, tid, acc, out, batch,
                              n, false);
  }
  // no block leaves while a peer may still reach its shared memory
  wgs::cluster_sync();
}

// Devices on which the wgmma kernels may take a block's whole shared
// memory (the attribute raised once: a rotation launches them 500 times).
constexpr int kMaxDevices = 64;

template <int BN, int T, int KC>
cudaError_t allow_wgmma_smem(int dev, int smem_optin) {
  static std::atomic<bool> done[kMaxDevices];
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  const cudaError_t err =
      allow_smem(cmux_step_wgmma_kernel<BN, T, KC>, smem_optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

template <int BN, int T, int KC>
int launch_wgmma(const void* acc, const void* bara, const void* bk, void* out,
                 int kp1, int batch, int n, int bg_bit, int l, uint32_t offset,
                 int cluster, int dev, int smem_optin, cudaStream_t s) {
  const int group = (n / T) * kp1;
  const int smem = wgs::StepTile<BN, T, KC>::smem_bytes(l, cluster, n);
  if (cluster < 1 || cluster > wgs::kMaxCluster || group % cluster ||
      smem > smem_optin)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_wgmma_smem<BN, T, KC>(dev, smem_optin);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(group, (batch + BN - 1) / BN);
  config.blockDim = dim3(wg::Tile<BN, T, KC>::kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, cmux_step_wgmma_kernel<BN, T, KC>,
                           (const uint32_t*)acc, (const int32_t*)bara,
                           (const uint32_t*)bk, (uint32_t*)out, kp1, batch, n,
                           bg_bit, l, offset);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `cluster` blocks of the wgmma form's kernel the device holds
// at once.
template <int BN, int T, int KC>
int wgmma_clusters(int l, int cluster, int n, int dev, int smem_optin,
                   int* out) {
  cudaError_t err = allow_wgmma_smem<BN, T, KC>(dev, smem_optin);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(wg::Tile<BN, T, KC>::kThreads);
  config.dynamicSmemBytes = wgs::StepTile<BN, T, KC>::smem_bytes(l, cluster, n);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, cmux_step_wgmma_kernel<BN, T, KC>, &config);
}

using WgLaunch = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, uint32_t, int, int, int,
                         cudaStream_t);

using WgClusters = int (*)(int, int, int, int, int, int*);

// The wgmma form's tile (ops/kernels.py: WG_STEP_TILE): BN = 64 rows x T =
// min(N, 128) coefficients, chunks of min(N, 256) columns (a 32-row tile
// lost at every batch, PERF.md): its launch and cluster query.
void wgmma_form_for(int n, WgLaunch* launch, WgClusters* clusters) {
  static_assert(wgs::kTile == 64, "the forms below are BN = 64's");
  if (n >= 256) {
    *launch = launch_wgmma<64, 128, 256>;
    *clusters = wgmma_clusters<64, 128, 256>;
  } else if (n == 128) {
    *launch = launch_wgmma<64, 128, 128>;
    *clusters = wgmma_clusters<64, 128, 128>;
  } else {
    *launch = launch_wgmma<64, 64, 64>;
    *clusters = wgmma_clusters<64, 64, 64>;
  }
}

}  // namespace

// Blocks of the mma form's kernel an SM holds at once at (rows, N), into
// *blocks: ops/kernels.py's step_launch reads it.
extern "C" int ieache_cmux_step_per_sm(int rows, int n, int* blocks) {
  if (!mma::shape_ok(rows, n)) return (int)cudaErrorInvalidValue;
  int sms = 0, smem_optin = 0;
  const cudaError_t err = fused::device_limits(&sms, &smem_optin);
  if (err != cudaSuccess) return (int)err;
  if (n >= 256) return fused::step_parts_per_sm<8>(rows, n, smem_optin, blocks);
  if (n == 128) return fused::step_parts_per_sm<4>(rows, n, smem_optin, blocks);
  return fused::step_parts_per_sm<2>(rows, n, smem_optin, blocks);
}

// Clusters of `cluster` blocks of the wgmma form the device holds at once
// at (rows, k+1, N), into *clusters: the launch policy
// (ops/kernels.py:step_launch) takes the form where its grid fits.
extern "C" int ieache_cmux_step_clusters(int rows, int kp1, int n,
                                         int cluster, int* clusters) {
  if (!mma::shape_ok(rows, n) || rows % kp1 ||
      rows / kp1 > wgs::kMaxLevels || cluster < 1 ||
      cluster > wgs::kMaxCluster)
    return (int)cudaErrorInvalidValue;
  WgLaunch launch;
  WgClusters query;
  wgmma_form_for(n, &launch, &query);
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = fused::device_limits(&sms, &smem_optin);
  if (err != cudaSuccess) return (int)err;
  return query(rows / kp1, cluster, n, dev, smem_optin, clusters);
}

// form 0: mma.sync (16-row tiles of min(N, 256) coefficients); form 1:
// wgmma (64-row tiles of min(N, 128) coefficients), split 1, per_item 1.
extern "C" int ieache_cmux_step(const void* acc, const void* bara,
                                const void* bk, void* out, int rows, int kp1,
                                int batch, int n, int bg_bit, int l,
                                uint32_t offset, int form, int split,
                                int per_item, int cluster, void* stream) {
  if (!mma::shape_ok(rows, n) || rows != kp1 * l)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = fused::device_limits(&sms, &smem_optin);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == 1) {
    if (split != 1 || per_item != 1 || l > wgs::kMaxLevels)
      return (int)cudaErrorInvalidValue;
    WgLaunch launch;
    WgClusters query;
    wgmma_form_for(n, &launch, &query);
    return launch(acc, bara, bk, out, kp1, batch, n, bg_bit, l, offset,
                  cluster, dev, smem_optin, s);
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  if (n >= 256)
    return fused::launch_step_parts<8>(acc, bara, bk, out, rows, kp1, batch,
                                       n, bg_bit, l, offset, split, per_item,
                                       cluster, smem_optin, s);
  if (n == 128)
    return fused::launch_step_parts<4>(acc, bara, bk, out, rows, kp1, batch,
                                       n, bg_bit, l, offset, split, per_item,
                                       cluster, smem_optin, s);
  return fused::launch_step_parts<2>(acc, bara, bk, out, rows, kp1, batch, n,
                                     bg_bit, l, offset, split, per_item,
                                     cluster, smem_optin, s);
}
