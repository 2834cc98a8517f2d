// External product of one CMux step in the transposed (k+1, N, B) layout,
// batch innermost, accumulator fused (step mode `tr`).
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _ext_product_tr_kernel and
// its host-side operand builder _bk_rev_tiles, behind
// external_product_pallas_tr (the second of the two kernels of each CMux
// step in the `tr` step mode).
//
//   in : d (rows, N, B) int8 digits, bk (rows, k+1, N) int32 one TRGSW
//        step, acc (k+1, N, B) int32 or null
//   out: out[o, :, b] = acc[o, :, b] + sum_p d[p, :, b] (*) bk[p, o, :]
//        negacyclic, exact mod 2^32
//
// Form: the TPU kernel's, on this card's int8 tensor cores: the product
//   out[o, j, b] = sum_p sum_m T_p[m, j] * d[p, m, b],  T_p[m, j] = e_p[N + j - m]
// with T split into four balanced int8 limbs, mma.sync m16n8k32 s8 x s8 ->
// s32 (wrapping), the four sums recombined as sum_v S_v << 8v in uint32_t
// (mma_tile.cuh's note has the arithmetic).  The launch refuses N not a
// power of two of at least 64 and rows * N >= 2^17 (cudaErrorInvalidValue).
//
// Bound on the H100: operations.  At B=1024, N=1024, k=1, l=2 (4 rows) a
// step is 4 limbs * rows * (k+1) * B * N * N = 34.4 G int8 multiply-adds
// (68.7 GOP), 0.0347 ms at the tensor cores' peak; its bytes (4 MB of
// digits, 8 MB of accumulator in and out, 16 KB of key) take 0.0063 ms.
//
// Design: the tile of mma_tile.cuh with the operands' roles swapped, so
// that the result lies along the batch as this layout wants it.
// * The Toeplitz limb tile is the MMA's A operand (rows: 16 coefficients
//   j, columns: 32 digit columns m).  Register a0 is four consecutive m of
//   one j, which is what a B register of the split layout's tile holds, so
//   build_planes, its four byte-shifted copies and the window over
//   diagonals carry over unchanged; a1 lies one diagonal (8) below a0, a2
//   two above, a3 one above (ops/kernels.py: mma_a_window_index).
// * The digits are the B operand (32 digit columns x 8 batch lanes).  They
//   lie (m, b) in device memory, b contiguous, so each chunk of T digit
//   columns x 16 lanes is copied as it lies (cp.async, 16 bytes a column
//   when B % 16 == 0, 4 bytes when B % 4 == 0, else byte by byte) into a
//   ring of raw stages, and each thread then turns two 4 x 4 byte blocks
//   (four words, one per column) into four words of one lane each with
//   byte permutes, into a (16, T + 16) buffer that ldmatrix.x4 reads as the
//   B fragments of both 8-lane n-tiles.  The raw stage has 16 bytes of
//   padding after every 8 columns, so the transpose's reads fall on 32
//   banks; the buffer's rows are padded so ldmatrix's 8 rows fall on 8
//   bank groups.  Two buffers: chunk c + 1 is transposed while chunk c's
//   MMAs run, one barrier a chunk.  (ldmatrix.trans cannot do the
//   transpose: on sm_90 it moves 16-bit elements, so it swaps byte pairs.)
// * The result lies along b: c0 and c1 are lanes 2 t4 and 2 t4 + 1 of one
//   coefficient, so a group of four threads writes 32 contiguous bytes of
//   out[o, j, :], and reads the accumulator the same way.
// * Tile: a block of 4 warps computes 256 coefficients (T = min(N, 256))
//   x 16 lanes of one component; a warp T/4 x 16 as NI/2 m-tiles x 2
//   n-tiles x 4 limbs (128 accumulator registers at T = 256), 32 MMAs per
//   ldmatrix of digits and k-step.  Shared memory: 21 KB of planes, 4 raw
//   stages of 4.5 KB, two buffers of 4.25 KB: 47 KB at N >= 256.
// * A small batch has too few tiles to fill the card (8 at B <= 16), so
//   the launch then splits each tile's sum over its (p, chunk) pairs
//   (mma::split_for), copies the accumulator into the output first (or
//   clears it), and each part adds with atomicAdd on unsigned int, which
//   wraps: exact in any order.  Stores are 8 bytes where B is even, else
//   one word at a time; the batch edge is masked.

#include "mma_tile.cuh"

using namespace ieache;

namespace {

constexpr int kLanes = 16;  // batch lanes of a tile: two n-tiles of 8

// Byte offset of digit column m's 16 lanes in a raw stage.
__host__ __device__ constexpr int raw_offset(int m) {
  return 16 * m + 16 * (m >> 3);
}

template <int NI>
struct TrShape {
  using S = mma::Shape<NI>;
  static constexpr int kRawBytes = raw_offset(S::T);
  static constexpr int kBufBytes = kLanes * S::kPitch;
  static constexpr int kSmemBytes =
      S::kPlanesBytes + mma::kStages * kRawBytes + 2 * kBufBytes;
};

// 4 bytes global -> shared through L1; `bytes` of them are read (4 or 0),
// the rest is written as zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Start the copy of chunk c (digit row p, columns m0c .. m0c + T - 1, lanes
// b0 .. b0 + 15 of the (rows, N, batch) tensor d) into the raw stage at
// `dst` (shared address; `dst_gen` the same as a pointer), lanes past the
// batch zero, and commit the group (empty when c is past the range).
// `vec` is 16 when batch % 16 == 0, 4 when batch % 4 == 0, else 1.
template <int NI>
__device__ __forceinline__ void stage_raw(uint32_t dst, int8_t* dst_gen,
                                          const int8_t* d, int c, int c_end,
                                          int n, int batch, int b0, int vec,
                                          int tid) {
  constexpr int T = mma::Shape<NI>::T;
  if (c < c_end) {
    const int nchunk = n / T, p = c / nchunk;
    const int8_t* src = d + ((int64_t)p * n + (c - p * nchunk) * T) * batch +
                        b0;
    if (vec == 16) {
      for (int m = tid; m < T; m += mma::kThreads)
        mma::cp_async16(dst + raw_offset(m), src + (int64_t)m * batch, 16);
    } else if (vec == 4) {
      for (int x = tid; x < 4 * T; x += mma::kThreads) {
        const int m = x >> 2, b = 4 * (x & 3);
        const bool valid = b0 + b < batch;
        cp_async4(dst + raw_offset(m) + b,
                  valid ? src + (int64_t)m * batch + b : d, valid ? 4 : 0);
      }
    } else {
      for (int x = tid; x < kLanes * T; x += mma::kThreads) {
        const int m = x >> 4, b = x & 15;
        dst_gen[raw_offset(m) + b] =
            b0 + b < batch ? src[(int64_t)m * batch + b] : (int8_t)0;
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Raw stage -> the (16, kPitch) buffer ldmatrix reads: item x takes lanes
// 4 (x % 4) .. + 3 of columns 4 (x / 4) .. + 3, a word of each column, and
// writes a word of each lane.
template <int NI>
__device__ __forceinline__ void transpose_chunk(const uint8_t* raw,
                                                uint8_t* buf, int tid) {
  using S = mma::Shape<NI>;
  for (int x = tid; x < S::T; x += mma::kThreads) {
    const int q = x & 3, m0 = 4 * (x >> 2);
    uint32_t w[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      w[mi] = *reinterpret_cast<const uint32_t*>(raw + raw_offset(m0 + mi) +
                                                 4 * q);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // byte r of the four column words, column m0 in the lowest byte
      const uint32_t pick = (uint32_t)r | ((uint32_t)(4 + r) << 4);
      *reinterpret_cast<uint32_t*>(buf + (4 * q + r) * S::kPitch + m0) =
          __byte_perm(__byte_perm(w[0], w[1], pick),
                      __byte_perm(w[2], w[3], pick), 0x5410);
    }
  }
}

// acc[v][2 mt + nt] += the tile's share of sum_p T_{p,v} x d[p] over the
// (p, chunk) pairs c_begin .. c_end - 1 (pair c = p * (N / T) + chunk), for
// coefficients jb .. jb + T - 1 of component o and lanes b0 .. b0 + 15.
// Thread (warp, lane) ends with limb v's sums for m-tile mt (coefficients
// jb + warp * T / 4 + 16 mt + lane / 4, and + 8 in registers 2, 3) and
// n-tile nt (lanes b0 + 8 nt + 2 (lane % 4) and the next).
template <int NI>
__device__ __forceinline__ void product_tr(
    uint8_t* smem, const int8_t* d, const uint32_t* bk, int kp1, int n,
    int batch, int o, int jb, int b0, int c_begin, int c_end, int vec,
    int tid, int32_t (&acc)[4][NI][4]) {
  using S = mma::Shape<NI>;
  using TS = TrShape<NI>;
  constexpr int MI = NI / 2;
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + S::kPlanesBytes);
  uint8_t* buf = smem + S::kPlanesBytes + mma::kStages * TS::kRawBytes;
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(raw);
  const uint32_t buf_s = (uint32_t)__cvta_generic_to_shared(buf);
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, t4 = lane & 3;
  const int nchunk = n / S::T;

  // this thread's word of diagonal 0 in limb 0's copy 3 - grp % 4
  const uint32_t* wp = planes + (3 - (grp & 3)) * S::kPlaneStride +
                       (S::T - warp * 8 * NI) / 4 + t4 - 1 - (grp >> 2);
  // where this lane points ldmatrix.x4 in a buffer: lanes 0-7 lanes 0-7
  // bytes 0-15 (n-tile 0's b0), 8-15 the same lanes' bytes 16-31 (its
  // b1), 16-31 lanes 8-15 (n-tile 1)
  const uint32_t lm =
      ((lane & 7) + (lane >> 4) * 8) * S::kPitch + ((lane >> 3) & 1) * 16;

  auto stage = [&](int c) {
    const int slot = (c - c_begin) % mma::kStages;
    stage_raw<NI>(raw_s + slot * TS::kRawBytes, raw + slot * TS::kRawBytes, d,
                  c, c_end, n, batch, b0, vec, tid);
  };
  auto transpose = [&](int c) {
    transpose_chunk<NI>(
        reinterpret_cast<const uint8_t*>(raw) +
            ((c - c_begin) % mma::kStages) * TS::kRawBytes,
        buf + ((c - c_begin) & 1) * TS::kBufBytes, tid);
  };

  for (int s = 0; s < mma::kStages - 1; ++s) stage(c_begin + s);
  asm volatile("cp.async.wait_group %0;" ::"n"(mma::kStages - 2) : "memory");
  __syncthreads();  // chunk c_begin has landed
  stage(c_begin + mma::kStages - 1);
  transpose(c_begin);

  uint32_t win[4][NI + 2];  // win[v][i]: diagonal 4 kseg - NI + 1 + i
  int c = c_begin;
  while (c < c_end) {
    const int p = c / nchunk, ch0 = c - p * nchunk;
    int nseg = c_end - c < nchunk - ch0 ? c_end - c : nchunk - ch0;
    if (nseg > mma::kSegChunks) nseg = mma::kSegChunks;
    __syncthreads();  // the previous planes' readers are done
    mma::build_planes<NI>(planes, bk + ((int64_t)p * kp1 + o) * n, n, jb,
                          ch0 * S::T, nseg * S::T, tid);
    for (int i = 0; i < nseg; ++i, ++c) {
      // chunk c + 1 has landed, the planes are built, chunk c is
      // transposed, and every warp is past chunk c - 1, whose buffer takes
      // chunk c + 1 and whose raw stage's successor, chunk c's, is free
      asm volatile("cp.async.wait_group %0;" ::"n"(mma::kStages - 2)
                   : "memory");
      __syncthreads();
      stage(c + mma::kStages);
      if (c + 1 < c_end) transpose(c + 1);
      const uint32_t chunk = buf_s + ((c - c_begin) & 1) * TS::kBufBytes + lm;
      if (i == 0) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int w = 0; w < NI - 2; ++w)
            win[v][w + 4] = wp[v * 4 * S::kPlaneStride + 2 * (w - NI + 1)];
      }
      const uint32_t* wk = wp + 8 * NI * i;  // diagonal 4 kseg, kseg = NI i
#pragma unroll
      for (int ks = 0; ks < NI; ++ks) {
        uint32_t bf[4];  // n-tile 0's b0, b1, n-tile 1's b0, b1
        mma::ldmatrix_x4(bf, chunk + 32 * ks);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
#pragma unroll
          for (int w = 0; w < NI - 2; ++w) win[v][w] = win[v][w + 4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            win[v][NI - 2 + q] =
                wk[v * 4 * S::kPlaneStride + 2 * (4 * ks - 1 + q)];
#pragma unroll
          for (int mt = 0; mt < MI; ++mt) {
            const uint32_t a[4] = {win[v][NI - 1 - 2 * mt],
                                   win[v][NI - 2 - 2 * mt],
                                   win[v][NI + 1 - 2 * mt],
                                   win[v][NI - 2 * mt]};
            mma::mma_s8(acc[v][2 * mt], a, bf[0], bf[1]);
            mma::mma_s8(acc[v][2 * mt + 1], a, bf[2], bf[3]);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// out[o, j, b] = add[o, j, b] (when add is not null) + the folded tile, or
// out += the folded tile atomically (wrapping, so exact in any order).
template <int NI>
__device__ __forceinline__ void store_tr(const int32_t (&acc)[4][NI][4],
                                         int o, int jb, int b0, int tid,
                                         const uint32_t* add, uint32_t* out,
                                         int batch, int n, bool atomic) {
  constexpr int T = mma::Shape<NI>::T;
  const int lane = tid & 31, warp = tid >> 5;
  const bool pairs = batch % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < NI / 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = jb + warp * (T / 4) + 16 * mt + 8 * half + (lane >> 2);
        const int b = b0 + 8 * nt + 2 * (lane & 3);
        if (b >= batch) continue;
        const int64_t at = ((int64_t)o * n + j) * batch + b;
        const uint32_t v0 = mma::fold<NI>(acc, 2 * mt + nt, 2 * half);
        const uint32_t v1 = mma::fold<NI>(acc, 2 * mt + nt, 2 * half + 1);
        const bool second = b + 1 < batch;
        if (atomic) {
          atomicAdd(reinterpret_cast<unsigned int*>(out + at), v0);
          if (second)
            atomicAdd(reinterpret_cast<unsigned int*>(out + at + 1), v1);
        } else if (pairs) {
          uint2 v = make_uint2(v0, v1);
          if (add != nullptr) {
            const uint2 a = *reinterpret_cast<const uint2*>(add + at);
            v.x += a.x;
            v.y += a.y;
          }
          *reinterpret_cast<uint2*>(out + at) = v;
        } else {
          out[at] = v0 + (add != nullptr ? add[at] : 0u);
          if (second) out[at + 1] = v1 + (add != nullptr ? add[at + 1] : 0u);
        }
      }
}

// Part q of `split` of tile (blockIdx.x / split, blockIdx.y, blockIdx.z):
// lanes 16 (blockIdx.x / split) .., coefficients T blockIdx.y ..,
// component blockIdx.z.
template <int NI>
__global__ void __launch_bounds__(mma::kThreads, 2) external_product_tr_kernel(
    const int8_t* __restrict__ d, const uint32_t* __restrict__ bk,
    const uint32_t* acc, uint32_t* out, int rows, int kp1, int batch, int n,
    int split, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  using S = mma::Shape<NI>;
  const int tid = threadIdx.x;
  const int q = blockIdx.x % split, b0 = (blockIdx.x / split) * kLanes;
  const int jb = blockIdx.y * S::T, o = blockIdx.z;
  const int nchunks = rows * (n / S::T);
  int32_t sum[4][NI][4];
  mma::zero_acc<NI>(sum);
  product_tr<NI>(smem, d, bk, kp1, n, batch, o, jb, b0, q * nchunks / split,
                 (q + 1) * nchunks / split, vec, tid, sum);
  store_tr<NI>(sum, o, jb, b0, tid, acc, out, batch, n, split > 1);
}

// The launch for N's tile, NI = min(N, 256) / 32.
template <int NI>
int launch(const void* d, const void* bk, const void* acc, void* out,
           int rows, int kp1, int batch, int n, int sms, cudaStream_t s) {
  using S = mma::Shape<NI>;
  constexpr int smem = TrShape<NI>::kSmemBytes;
  const int nbt = (batch + kLanes - 1) / kLanes, njt = n / S::T;
  const int split = mma::split_for(nbt * njt * kp1, rows * njt, sms);
  const int vec = batch % 16 == 0 ? 16 : (batch % 4 == 0 ? 4 : 1);
  cudaError_t err = cudaSuccess;
  if (split > 1) {
    const size_t bytes = (size_t)kp1 * batch * n * sizeof(uint32_t);
    err = acc != nullptr
              ? cudaMemcpyAsync(out, acc, bytes, cudaMemcpyDeviceToDevice, s)
              : cudaMemsetAsync(out, 0, bytes, s);
    if (err != cudaSuccess) return (int)err;
  }
  err = allow_smem(external_product_tr_kernel<NI>, smem);
  if (err != cudaSuccess) return (int)err;
  external_product_tr_kernel<NI>
      <<<dim3(nbt * split, njt, kp1), mma::kThreads, smem, s>>>(
          (const int8_t*)d, (const uint32_t*)bk, (const uint32_t*)acc,
          (uint32_t*)out, rows, kp1, batch, n, split, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ieache_external_product_tr(const void* d, const void* bk,
                                          const void* acc, void* out,
                                          int rows, int kp1, int batch, int n,
                                          void* stream) {
  if (!mma::shape_ok(rows, n) || ((uintptr_t)d & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n >= 256)
    return launch<8>(d, bk, acc, out, rows, kp1, batch, n, sms, s);
  if (n == 128)
    return launch<4>(d, bk, acc, out, rows, kp1, batch, n, sms, s);
  return launch<2>(d, bk, acc, out, rows, kp1, batch, n, sms, s);
}
