// Rotate, subtract and gadget-decompose one CMux step's accumulator.
//
// Replaces: ieache_tpu/ops/pallas_kernels.py, _rot_diff_decompose_kernel
// behind rot_diff_decompose_pallas (the first of the two kernels of each
// CMux step in the `split` step mode).
//
//   in : acc  (k+1, B, N) int32, bara (B,) int32
//   out: (rows, B, N) int8, rows = (k+1)*l, row u*l + jl holds
//        ((v_u >> (32 - (jl+1)*bg_bit)) & (Bg-1)) - Bg/2,
//        v = X^bara * acc - acc + offset      (all mod 2^32)
//   With bg_bit > 8 (two int8 limbs a digit: the compat gadget Bg = 2^10)
//   the out is (2 * rows, B, N): row 2 * (u*l + jl) holds the digit's
//   signed low byte d_lo and row 2 * (u*l + jl) + 1 its high limb
//   d_hi = (d - d_lo) / 2^8, so d = d_lo + 2^8 d_hi.  The external
//   product then runs unchanged at twice the rows, against a key whose
//   row 2p + 1 is (2^8 * b_p) mod 2^32 (ops/kernels.py:limb_key).
//
// Bound on the H100: memory.  Each output coefficient reads two int32
// words of the accumulator and writes l bytes; at B=1024, N=1024, k=1,
// l=2 a step reads 8 MB and writes 4 MB (0.0038 ms at 3.35 TB/s), and
// does a handful of integer operations per byte moved.
//
// Design: the TPU kernel builds X^bara as eleven conditional static
// rolls (a barrel shifter), because per-lane gathers are slow there.
// Here a thread takes a run of R = 4 or 8 consecutive coefficients of
// one (u, b) polynomial (rot_diff_run, cmux_common.cuh): its plain words
// as R / 4 aligned 16-byte loads, its rotated words as R / 4 + 1 aligned
// 16-byte loads shifted by an amount that is the same for the whole
// polynomial, every load in flight before any arithmetic; then, for each
// digit row, the run's R digit bytes packed by byte permutes
// (digit_word) into one R-byte store.  Consecutive threads take
// consecutive runs, so every load and store is coalesced.  The run
// length comes from the caller (ops/kernels.py:rot_launch, the one place
// the policy lives): runs of 8 at the throughput batches, where runs of
// 4 would need more threads than the SMs hold at once, runs of 4 below.
// Runs of 16 (one 16-byte store a digit row) were slower than runs of 8
// at every batch on the H100, with more registers and fewer threads, and
// blocks of 32, 64 or 256 threads lost to or tied with blocks of 128
// (PERF.md §6), so a block has kThreads.  The grid covers
// (B * N / R runs, k+1): N / R is a power of two, so a thread finds
// its lane and run by a shift and a mask, with no division before its
// first load (the small batches are latency-bound); any B launches.  An
// accumulator that is not 16-byte aligned takes four 4-byte loads a quad.
// All wrapping arithmetic is uint32_t (signed overflow is undefined in
// C++).

#include <climits>

#include "cmux_common.cuh"

using namespace ieache;

namespace {

constexpr int kThreads = 128;

// R digit bytes (R / 4 words) to dst, one R-byte store.
template <int R>
__device__ __forceinline__ void store_run(int8_t* dst, const uint32_t* w) {
  if constexpr (R == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = w[0];
}

// Digit jl of four coefficients v[0..3] as two int8 limbs, packed as
// digit_word packs one digit: byte s of lo is d_lo of coefficient s, the
// sign-extended low byte of d, and byte s of hi is d_hi = (d - d_lo) / 2^8
// (in [-2, 2] at Bg = 2^10).
__device__ __forceinline__ void digit_limb_words(const uint32_t* v, int jl,
                                                 int bg_bit, uint32_t& lo,
                                                 uint32_t& hi) {
  const int shift = 32 - (jl + 1) * bg_bit;
  const uint32_t mask = (1u << bg_bit) - 1u;
  lo = hi = 0u;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int d = (int)((v[s] >> shift) & mask) - (1 << (bg_bit - 1));
    const int d_lo = ((d & 0xFF) ^ 0x80) - 0x80;
    lo |= (uint32_t)(d_lo & 0xFF) << (8 * s);
    hi |= (uint32_t)(((d - d_lo) / 256) & 0xFF) << (8 * s);
  }
}

// Thread t of grid row u takes run t of component u: lane t >> log_per
// (N / R = 2^log_per runs a polynomial), coefficients R * (t mod N / R)
// onwards.  kTwo: two int8 limbs a digit, in rows 2p and 2p + 1.
template <int R, bool kVec, bool kTwo>
__global__ void __launch_bounds__(kThreads) rot_diff_decompose_kernel(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ bara,
    int8_t* __restrict__ out, int batch, int n, int bg_bit, int l,
    uint32_t offset, int runs, int log_per) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= runs) return;
  const int u = blockIdx.y, b = t >> log_per;
  const int j0 = (t & ((1 << log_per) - 1)) * R;
  uint32_t v[R];
  rot_diff_run<R, kVec, false>(acc + ((int64_t)u * batch + b) * n,
                               (uint32_t)bara[b], j0, n, offset, v);
  for (int jl = 0; jl < l; ++jl) {
    if constexpr (kTwo) {
      uint32_t lo[R / 4], hi[R / 4];
#pragma unroll
      for (int g = 0; g < R / 4; ++g)
        digit_limb_words(v + 4 * g, jl, bg_bit, lo[g], hi[g]);
      int8_t* row = out + ((int64_t)(2 * (u * l + jl)) * batch + b) * n + j0;
      store_run<R>(row, lo);
      store_run<R>(row + (int64_t)batch * n, hi);
    } else {
      uint32_t w[R / 4];
#pragma unroll
      for (int g = 0; g < R / 4; ++g) w[g] = digit_word(v + 4 * g, jl, bg_bit);
      store_run<R>(out + ((int64_t)(u * l + jl) * batch + b) * n + j0, w);
    }
  }
}

template <int R, bool kTwo>
cudaError_t launch(const void* acc, const void* bara, void* out, int kp1,
                   int batch, int n, int bg_bit, int l, uint32_t offset,
                   cudaStream_t stream) {
  const int runs = batch * (n / R), log_per = __builtin_ctz(n / R);
  const dim3 grid((runs + kThreads - 1) / kThreads, kp1);
  if (((uintptr_t)acc & 15) == 0)
    rot_diff_decompose_kernel<R, true, kTwo><<<grid, kThreads, 0, stream>>>(
        (const uint32_t*)acc, (const int32_t*)bara, (int8_t*)out, batch, n,
        bg_bit, l, offset, runs, log_per);
  else
    rot_diff_decompose_kernel<R, false, kTwo><<<grid, kThreads, 0, stream>>>(
        (const uint32_t*)acc, (const int32_t*)bara, (int8_t*)out, batch, n,
        bg_bit, l, offset, runs, log_per);
  return cudaGetLastError();
}

template <bool kTwo>
cudaError_t launch_run(const void* acc, const void* bara, void* out, int kp1,
                       int batch, int n, int bg_bit, int l, uint32_t offset,
                       int run, cudaStream_t stream) {
  return run == 4 ? launch<4, kTwo>(acc, bara, out, kp1, batch, n, bg_bit, l,
                                    offset, stream)
                  : launch<8, kTwo>(acc, bara, out, kp1, batch, n, bg_bit, l,
                                    offset, stream);
}

}  // namespace

// `run`: coefficients a thread (4 or 8).  N a power of two of at least 8.
// bg_bit in 1..16; above 8 each digit is written as two int8 limbs.
extern "C" int ieache_rot_diff_decompose(
    const void* acc, const void* bara, void* out, int kp1, int batch, int n,
    int bg_bit, int l, uint32_t offset, int run, void* stream) {
  if (n < 8 || (n & (n - 1)) != 0 || (run != 4 && run != 8) ||
      bg_bit < 1 || bg_bit > 16 || kp1 > 65535 ||
      (int64_t)batch * (n / run) > INT_MAX - kThreads)
    return (int)cudaErrorInvalidValue;
  if (kp1 == 0 || batch == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bg_bit > 8 ? launch_run<true>(acc, bara, out, kp1, batch, n,
                                             bg_bit, l, offset, run, s)
                          : launch_run<false>(acc, bara, out, kp1, batch, n,
                                              bg_bit, l, offset, run, s));
}

extern "C" const char* ieache_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
