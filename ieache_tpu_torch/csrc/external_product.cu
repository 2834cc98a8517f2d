// External product of one CMux step, accumulator fused.
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _ext_product_kernel behind
// external_product_pallas_t(..., acc_t=...) (the second of the two
// kernels of each CMux step in the `split` step mode).
//
//   in : d (rows, B, N) int8 digits, bk (rows, k+1, N) int32 one TRGSW
//        step, acc (k+1, B, N) int32 or null
//   out: out[o, b, :] = acc[o, b, :] + sum_p d[p, b, :] (*) bk[p, o, :]
//        negacyclic, exact mod 2^32
//
// Two forms of one function, both launched as ops/kernels.py's
// product_launch says (form, batch tile, coefficients, split; the C side
// keeps no policy and takes the launch as it is):
//
// * "wgmma" (form 1): wgmma_tile.cuh, Hopper's warpgroup MMA,
//   wgmma.mma_async m64nNk32 s8 x s8 -> s32: the four balanced int8 limbs
//   of the Toeplitz matrix of each key polynomial as the A operand from
//   registers (warp w of a warpgroup holds limb w of 16 coefficients),
//   the digits as the B operand from shared memory, staged by the
//   tensor-memory accelerator, the product asynchronous.  A block computes
//   min(N, 128) coefficients x BN = 32 or 64 batch rows (the wgmma's n) of
//   one component o.  The policy takes it from batch x rows > 512.
// * "mma" (form 0): mma_tile.cuh, mma.sync m16n8k32: the digits as the A
//   operand, the Toeplitz limb fragments as B, a block of 4 warps
//   computing 16 batch rows x min(N, 256) coefficients.  At small batches
//   a step is a chain of latencies, which this form's is shorter.
//
// Both recombine the four limb sums as sum_v S_v << 8v in uint32_t, which
// wraps.  The Toeplitz operand is built in shared memory from the 4 KB key
// polynomial; no (N x N) operand exists in device memory.  Each limb's sum
// is exact in s32 while rows * N < 2^17, and the launch refuses larger
// shapes (cudaErrorInvalidValue), as it refuses an N that is not a power
// of two of at least 64, an unknown form or tile, and a split that is not
// in 1 .. a tile's (p, chunk) pairs.
//
// Bound on the H100: operations.  At B=1024, N=1024, k=1, l=2 (4 rows) a
// step is 4 limbs * rows * (k+1) * B * N * N = 34.4 G int8 multiply-adds,
// 0.035 ms at the tensor cores' peak; its bytes (16 KB of key, 4 MB of
// digits, 8 MB of accumulator in and out) take 0.006 ms.  mma.sync feeds
// the tensor cores from registers a warp loads itself and reaches about
// half their peak at best; wgmma is the card's way to their full rate
// (wgmma_tile.cuh's note says how its tile feeds them: 0.052 ms at B =
// 1024 against mma.sync's 0.092, PERF.md).
//
// A small batch has too few tiles to fill the card, so the launch then
// splits each tile's sum over its (p, chunk) pairs into `split` parts,
// first copies the accumulator into the output (or clears it), and each
// part adds its share with atomicAdd on unsigned int, which wraps: exact
// in any order.

#include <cuda.h>

#include <atomic>

#include "wgmma_tile.cuh"

using namespace ieache;

namespace {

// The mma.sync form: part q of `split` of tile (blockIdx.x / split,
// blockIdx.y, blockIdx.z).
template <int NI>
__global__ void __launch_bounds__(mma::kThreads, 2) external_product_kernel(
    const int8_t* __restrict__ d, const uint32_t* __restrict__ bk,
    const uint32_t* acc, uint32_t* out, int rows, int kp1, int batch, int n,
    int split) {
  extern __shared__ __align__(16) uint8_t smem[];
  using S = mma::Shape<NI>;
  const int tid = threadIdx.x;
  const int q = blockIdx.x % split, b0 = (blockIdx.x / split) * mma::BM;
  const int jb = blockIdx.y * S::T, o = blockIdx.z;
  const int nchunks = rows * (n / S::T);
  int32_t sum[4][NI][4];
  mma::zero_acc<NI>(sum);
  mma::product_accumulate_mma<NI>(
      smem, mma::GlobalDigits<NI>{d, batch, n, b0}, bk, kp1, n, o, jb,
      q * nchunks / split, (q + 1) * nchunks / split, tid, BlockSync{}, sum);
  if (split > 1) {
    mma::atomic_add_tile_mma<NI>(sum, o, b0, jb, tid, out, batch, n);
  } else {
    mma::store_tile_mma<NI, false>(sum, o, b0, jb, tid, acc, out, batch, n);
  }
}

// The wgmma form: part q of `split` of the T x BN tile (blockIdx.x / split,
// blockIdx.y, blockIdx.z), KC digit columns a chunk, the digits read
// through `map`: W consumer warpgroups, then the producer warpgroup,
// which gives its registers to them (setmaxnreg).
template <int BN, int T, int KC>
__global__ void __launch_bounds__(wg::Tile<BN, T, KC>::kThreads,
                                  wg::Tile<BN, T, KC>::kBlocksPerSm)
    external_product_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                                  const uint32_t* __restrict__ bk,
                                  const uint32_t* acc, uint32_t* out, int rows,
                                  int kp1, int batch, int n, int split) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  using TL = wg::Tile<BN, T, KC>;
  // the swizzled stages want their atoms on 1024-byte boundaries
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint8_t* smem = smem_raw + ((wg::kAlign - raw % wg::kAlign) % wg::kAlign);
  const int tid = threadIdx.x;
  const int q = blockIdx.x % split, b0 = (blockIdx.x / split) * BN;
  const int jb = blockIdx.y * T, o = blockIdx.z;
  const int nchunks = rows * (n / KC);
  const int c_begin = q * nchunks / split, c_end = (q + 1) * nchunks / split;
  if (tid < wg::kStages) {
    wg::mbar_init((uint32_t)__cvta_generic_to_shared(smem) + TL::kBarOffset +
                      8 * tid,
                  1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= TL::kConsumers) {
    wg::regs_dec<TL::kProducerRegs>();
    wg::produce<BN, T, KC>(smem, &map, bk, kp1, n, o, jb, b0, c_begin, c_end,
                           tid - TL::kConsumers);
  } else {
    wg::regs_inc<TL::kConsumerRegs>();
    int32_t sum[TL::C][BN / 2];
    wg::zero<TL::C, BN>(sum);
    wg::consume<BN, T, KC>(smem, n, c_begin, c_end, tid, sum);
    wg::store_tile<BN, T, KC>(sum, smem, o, jb, b0, tid, acc, out, batch, n,
                              split > 1);
  }
}

// The mma.sync form's launch for N's tile, NI = min(N, 256) / 32.
template <int NI>
int launch_mma(const void* d, const void* bk, const void* acc, void* out,
               int rows, int kp1, int batch, int n, int split,
               cudaStream_t s) {
  using S = mma::Shape<NI>;
  const int nbt = (batch + mma::BM - 1) / mma::BM, njt = n / S::T;
  const cudaError_t err = allow_smem(external_product_kernel<NI>,
                                     S::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  external_product_kernel<NI>
      <<<dim3(nbt * split, njt, kp1), mma::kThreads, S::kSmemBytes, s>>>(
          (const int8_t*)d, (const uint32_t*)bk, (const uint32_t*)acc,
          (uint32_t*)out, rows, kp1, batch, n, split);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the build
// links no -lcuda); null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The digits' tensor map: d (rows, batch, N) int8 as dimensions (N, batch,
// rows), boxes of SW bytes x BN rows x 1, swizzled in SW-byte spans, rows
// past the batch read as zeros.
template <int BN, int SW>
cudaError_t digit_map(CUtensorMap* map, const void* d, int rows, int batch,
                      int n) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)batch,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)n, (cuuint64_t)batch * n};
  const cuuint32_t box[3] = {SW, BN, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(d), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Devices whose shared-memory limit launch_wgmma remembers having raised.
constexpr int kMaxDevices = 64;

// The wgmma form's launch: T x BN tiles, KC columns a chunk.
template <int BN, int T, int KC>
int launch_wgmma(const void* d, const void* bk, const void* acc, void* out,
                 int rows, int kp1, int batch, int n, int split,
                 cudaStream_t s) {
  using TL = wg::Tile<BN, T, KC>;
  const int nbt = (batch + BN - 1) / BN, njt = n / T;
  // the last map this host thread encoded, kept while the digits' address
  // and shape repeat (a rotation's steps reuse one allocation)
  thread_local CUtensorMap map;
  thread_local const void* map_d = nullptr;
  thread_local int map_shape[3] = {0, 0, 0};
  cudaError_t err = cudaSuccess;
  if (map_d != d || map_shape[0] != rows || map_shape[1] != batch ||
      map_shape[2] != n) {
    map_d = nullptr;
    err = digit_map<BN, TL::SW>(&map, d, rows, batch, n);
    if (err != cudaSuccess) return (int)err;
    map_d = d;
    map_shape[0] = rows;
    map_shape[1] = batch;
    map_shape[2] = n;
  }
  // the shared-memory limit, raised once a device: the split step mode
  // launches this kernel a thousand times a rotation
  static std::atomic<bool> smem_allowed[kMaxDevices];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !smem_allowed[dev].load()) {
    err = allow_smem(external_product_wgmma_kernel<BN, T, KC>,
                     TL::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_allowed[dev].store(true);
  }
  external_product_wgmma_kernel<BN, T, KC>
      <<<dim3(nbt * split, njt, kp1), TL::kThreads, TL::kSmemBytes, s>>>(
          map, (const uint32_t*)bk, (const uint32_t*)acc, (uint32_t*)out, rows,
          kp1, batch, n, split);
  return (int)cudaGetLastError();
}

// The wgmma tiles the form has (ops/kernels.py: wgmma_tiles): BN = 32 or
// 64 batch rows x T = min(N, 128) coefficients, chunks of min(N, 256)
// digit columns.
using WgLaunch = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, cudaStream_t);

WgLaunch wgmma_launch_for(int n, int bn, int cols) {
  if (cols != (n < 128 ? n : 128) || (bn != 32 && bn != 64)) return nullptr;
  if (n >= 256)
    return bn == 32 ? launch_wgmma<32, 128, 256> : launch_wgmma<64, 128, 256>;
  if (n == 128)
    return bn == 32 ? launch_wgmma<32, 128, 128> : launch_wgmma<64, 128, 128>;
  return bn == 32 ? launch_wgmma<32, 64, 64> : launch_wgmma<64, 64, 64>;
}

}  // namespace

// form 0: mma.sync, tile 16, cols min(N, 256); form 1: wgmma, tile 32 or
// 64, cols min(N, 128).
extern "C" int ieache_external_product(const void* d, const void* bk,
                                       const void* acc, void* out, int rows,
                                       int kp1, int batch, int n, int form,
                                       int tile, int cols, int split,
                                       void* stream) {
  if (!mma::shape_ok(rows, n)) return (int)cudaErrorInvalidValue;
  const int kc = n < 256 ? n : 256;
  if (split < 1 || split > rows * (n / kc)) return (int)cudaErrorInvalidValue;
  WgLaunch wgmma = nullptr;
  if (form == 0) {
    if (tile != mma::BM || cols != (n < 256 ? n : 256))
      return (int)cudaErrorInvalidValue;
  } else if (form != 1 ||
             (wgmma = wgmma_launch_for(n, tile, cols)) == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (split > 1) {
    const size_t bytes = (size_t)kp1 * batch * n * sizeof(uint32_t);
    const cudaError_t err =
        acc != nullptr
            ? cudaMemcpyAsync(out, acc, bytes, cudaMemcpyDeviceToDevice, s)
            : cudaMemsetAsync(out, 0, bytes, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (form == 1)
    return wgmma(d, bk, acc, out, rows, kp1, batch, n, split, s);
  if (n >= 256)
    return launch_mma<8>(d, bk, acc, out, rows, kp1, batch, n, split, s);
  if (n == 128)
    return launch_mma<4>(d, bk, acc, out, rows, kp1, batch, n, split, s);
  return launch_mma<2>(d, bk, acc, out, rows, kp1, batch, n, split, s);
}
