// The whole blind rotation, all n CMux steps, as one cooperative launch.
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _blind_rotate_scan_kernel
// (with its helper _rotate_decompose_into) behind
// blind_rotate_scan_pallas (the `scan` step mode).
//
//   in : acc (k+1, B, N) int32, bara (B, n) int32 in [0, 2N),
//        bk (n, rows, k+1, N) int32 the bootstrapping key
//   out: the accumulator after the n CMux steps, exact mod 2^32; equal
//        to n steps of rot_diff_decompose.cu + external_product.cu
//
// Bound on the H100: operations at large B, as external_product.cu (the
// int8 tensor cores; its product runs the same tile, mma_tile.cuh).  At
// small B the product is a few microseconds of a step, and what bounds
// the kernel is latency: two grid-wide barriers a step (1,000 a
// rotation), phase A's round trip through L2, and the build of the key's
// byte planes in each block.  This kernel is for that small-batch case:
// per-step launches pay a launch and a drain of the card for every step.
//
// Design: the TPU kernel runs its grid as a loop on one core, with the
// accumulator resident in VMEM.  Here blocks run in parallel, so each
// step is two phases of the whole grid, separated by grid-wide barriers
// (cooperative_groups::this_grid().sync(), which needs a cooperative
// launch with every block resident at once):
//   A. rotate, diff and decompose the whole accumulator into a digit
//      buffer in device memory (rows, B, N) int8, one coefficient per
//      thread, grid-stride;
//   B. the external product tiles of external_product.cu, grid-stride,
//      writing the next accumulator.
// The accumulator ping-pongs between the output and a scratch buffer
// (64 KB at B=8, 8 MB at B=1024: both stay in the 50 MB L2).  To fill
// the SMs when B is small, phase B splits each tile's sum over the
// (p, chunk) pairs into S parts, S the smallest divisor of their count
// that gives at least one part per SM (mma::split_for); each part adds
// its partial sum into the next accumulator with atomicAdd on unsigned
// int, which wraps, so the sum is exact in any order.  Phase A then also
// copies the accumulator into the next buffer, which the parts add to.
// At B=8 and N=1024, 4 rows: 8 tiles x S=16 = 128 parts, each one chunk
// of 256 digit columns of one row p.  Data written in the launch is read
// through L2 (ld.global.cg; the digits by cp.async.cg).  The launch
// refuses what the tile refuses: rows * N >= 2^17, or an N that is not a
// power of two of at least 64 (cudaErrorInvalidValue).

#include <cooperative_groups.h>

#include "mma_tile.cuh"

using namespace ieache;
namespace cg = cooperative_groups;

namespace {

struct ScanArgs {
  const uint32_t* acc_in;
  const int32_t* bara;   // (B, nsteps)
  const uint32_t* bk;    // (nsteps, rows, kp1, N)
  uint32_t* out;
  uint32_t* scratch;
  int8_t* digits;        // (rows, B, N)
  int rows, kp1, batch, n, nsteps, bg_bit, l, split;
  uint32_t offset;
};

template <int NI>
__global__ void __launch_bounds__(kTileThreads)
    blind_rotate_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  using S = mma::Shape<NI>;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int nbt = (a.batch + TB - 1) / TB, njt = a.n / S::T;
  const int nparts = nbt * njt * a.kp1 * a.split;
  const int nchunks = a.rows * (a.n / S::T);
  const int64_t ncoef = (int64_t)a.kp1 * a.batch * a.n;
  const int64_t gtid = (int64_t)blockIdx.x * kTileThreads + tid;
  const int64_t gstride = (int64_t)gridDim.x * kTileThreads;

  for (int s = 0; s < a.nsteps; ++s) {
    // the last step writes out; earlier steps alternate with scratch
    uint32_t* dst = ((a.nsteps - 1 - s) & 1) ? a.scratch : a.out;
    const uint32_t* cur =
        s == 0 ? a.acc_in : (dst == a.out ? a.scratch : a.out);

    // phase A: digits of X^bara * cur - cur
    for (int64_t idx = gtid; idx < ncoef; idx += gstride) {
      const int j = (int)(idx % a.n);
      const int64_t ub = idx / a.n;
      const int b = (int)(ub % a.batch);
      const int u = (int)(ub / a.batch);
      const uint32_t v = rot_diff<true>(
          cur + ub * a.n, (uint32_t)a.bara[(int64_t)b * a.nsteps + s], j,
          a.n, a.offset);
      for (int jl = 0; jl < a.l; ++jl) {
        a.digits[((int64_t)(u * a.l + jl) * a.batch + b) * a.n + j] =
            gadget_digit(v, jl, a.bg_bit);
      }
      if (a.split > 1) dst[idx] = load_u32<true>(cur + idx);
    }
    grid.sync();

    // phase B: dst = cur + sum_p digits_p (*) bk[s, p, o]
    const uint32_t* bk_s = a.bk + (int64_t)s * a.rows * a.kp1 * a.n;
    for (int part = blockIdx.x; part < nparts; part += gridDim.x) {
      const int q = part % a.split;
      const int tile = part / a.split;
      const int b0 = (tile % nbt) * TB, jb = ((tile / nbt) % njt) * S::T;
      const int o = tile / (nbt * njt);
      int32_t sum[4][NI][4];
      mma::zero_acc<NI>(sum);
      mma::product_accumulate_mma<NI>(
          smem, mma::GlobalDigits<NI>{a.digits, a.batch, a.n, b0}, bk_s, a.kp1,
          a.n, o, jb, q * nchunks / a.split, (q + 1) * nchunks / a.split, tid,
          BlockSync{}, sum);
      if (a.split > 1) {
        mma::atomic_add_tile_mma<NI>(sum, o, b0, jb, tid, dst, a.batch, a.n);
      } else {
        mma::store_tile_mma<NI, true>(sum, o, b0, jb, tid, cur, dst, a.batch,
                                      a.n);
      }
    }
    grid.sync();
  }
}

// The launch for N's tile, NI = min(N, 256) / 32.
template <int NI>
int launch(ScanArgs args, int sms, cudaStream_t stream) {
  using S = mma::Shape<NI>;
  const size_t smem = S::kSmemBytes;
  cudaError_t err = allow_smem(blind_rotate_scan_kernel<NI>, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, blind_rotate_scan_kernel<NI>, kTileThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;

  // split each tile's (p, chunk) sum until there is a part per SM
  const int ntiles =
      ((args.batch + TB - 1) / TB) * (args.n / S::T) * args.kp1;
  args.split = mma::split_for(ntiles, args.rows * (args.n / S::T), sms);
  // every block must be resident at once; more blocks than parts only
  // help phase A
  const int parts = ntiles * args.split;
  const int grid = parts > sms ? (parts < sms * per_sm ? parts : sms * per_sm)
                               : sms;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(
      (const void*)blind_rotate_scan_kernel<NI>, dim3(grid),
      dim3(kTileThreads), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ieache_blind_rotate_scan(
    const void* acc, const void* bara, const void* bk, void* out,
    void* scratch, void* digits, int rows, int kp1, int batch, int n,
    int nsteps, int bg_bit, int l, uint32_t offset, void* stream) {
  if (!mma::shape_ok(rows, n)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  const ScanArgs args{(const uint32_t*)acc, (const int32_t*)bara,
                      (const uint32_t*)bk,  (uint32_t*)out,
                      (uint32_t*)scratch,   (int8_t*)digits,
                      rows, kp1, batch, n, nsteps, bg_bit, l, 1, offset};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n >= 256) return launch<8>(args, sms, s);
  if (n == 128) return launch<4>(args, sms, s);
  return launch<2>(args, sms, s);
}
