// Timing probes for Hopper (sm_90a): one thread per column, the column's
// values in registers.
//
// Replace the two TPU probe kernels of tools/ and compute exactly what they
// compute (the plain PyTorch versions in probes/pack_probe.py and
// probes/dtype_probe.py are the spec, held against the Pallas kernels under
// the interpreter):
//
//   pack_probe_kernel<kNative>  <- tools/pack_probe.py native_kernel (:59)
//   pack_probe_kernel<kSwar>    <- tools/pack_probe.py swar_kernel (:80)
//   pack_probe_kernel<kVmax2>   the card's own answer to that probe's question:
//                               the SWAR words through the 16x2 SIMD max
//   dtype_probe_kernel<T, U>    <- tools/dtype_probe.py kernel (:33), at
//                               int32, int16 and int8
//   dtype_probe_packed<LANES>   the same at int16 / int8 with 2 / 4 columns in
//                               each 32-bit register (SIMD video intrinsics)
//
// pack probe: ROWS = 100 outer steps (a runtime loop, so nothing folds the
//   chain), each of REPS = 30 unrolled repetitions of v = op(v, roll_up(v)) on
//   a column of 13 rows, roll_up(v)[r] = v[(r + 1) % 13].  The rotate is a
//   register renaming: rows update in place in ascending order, each reading
//   its successor before that is overwritten, and the last row takes the saved
//   first.  op is max (native); the guard-bit emulation swar_max of two 15-bit
//   fields a word, bit for bit, with the subtraction in unsigned arithmetic
//   because XLA's int32 wraps where signed overflow in C++ is undefined
//   (SWAR); or __vmaxs2, the signed 16x2 max (vmax2), which on the probe's
//   inputs (fields below 2^14, guard bits zero) gives the same words as SWAR.
// dtype probe: ITERS steps of xs = x shifted down one row (row 0 takes 0),
//   m = max(x + 1, max(xs, y)), y2 = (m == x) ? y + 1 : m, x2 = max(m - 1, y2);
//   output x + y.  Every add wraps in two's complement as XLA's does: done in
//   the unsigned type of the same width and narrowed explicitly.  Rows update
//   in descending order so each reads its predecessor's old x.  The packed
//   forms hold 2 (int16) or 4 (int8) neighbouring columns in one register and
//   use __vadd2/__vsub2/__vmaxs2/__vcmpeq2 (the ...4 byte forms), selects as
//   (m & a) | (~m & b): the only way this card gives narrow types more
//   throughput, which is what the TPU probe asked of the TPU.
//
// What bounds them on this card: integer instruction throughput.  Each
// column reads and writes a few dozen bytes and does tens of thousands of
// ALU operations on registers, so the bytes are negligible.  At the TPU probes' P = 1024
// columns only 8 of 132 SMs get a block, so that size measures latency; the
// probes' timing also runs a size that fills the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPackRows = 13;   // COLS of tools/pack_probe.py
constexpr int kPackReps = 30;   // REPS
constexpr int kDtypeRows = 14;  // ROWS of tools/dtype_probe.py

enum { kNative = 0, kSwar = 1, kVmax2 = 2 };

__device__ __forceinline__ uint32_t swar_max(uint32_t a, uint32_t b) {
  const uint32_t guard = (1u << 15) | 0x80000000u;
  const uint32_t diff = (a | guard) - b;  // wraps like XLA's int32 subtract
  const uint32_t f0 = (diff >> 15) & 1u;
  const uint32_t f1 = (diff >> 31) & 1u;  // the JAX arithmetic shift, & 1
  const uint32_t mask = (f0 * 0x7FFFu) | ((f1 * 0x7FFFu) << 16);
  return b ^ ((a ^ b) & mask);
}

template <int MODE>
__device__ __forceinline__ uint32_t pack_step(uint32_t a, uint32_t b) {
  if (MODE == kNative) return (uint32_t)max((int32_t)a, (int32_t)b);
  if (MODE == kSwar) return swar_max(a, b);
  return __vmaxs2(a, b);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
pack_probe_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int P,
                  int rows) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= P) return;
  uint32_t v[kPackRows];
#pragma unroll
  for (int r = 0; r < kPackRows; ++r) v[r] = x[(size_t)r * P + c];
  for (int i = 0; i < rows; ++i) {
#pragma unroll
    for (int k = 0; k < kPackReps; ++k) {
      const uint32_t v0 = v[0];
#pragma unroll
      for (int r = 0; r < kPackRows - 1; ++r) v[r] = pack_step<MODE>(v[r], v[r + 1]);
      v[kPackRows - 1] = pack_step<MODE>(v[kPackRows - 1], v0);
    }
  }
#pragma unroll
  for (int r = 0; r < kPackRows; ++r) out[(size_t)r * P + c] = v[r];
}

// a + b in T with two's-complement wrap: added in U (the unsigned type of
// T's width), narrowed explicitly
template <typename T, typename U>
__device__ __forceinline__ T wrap_add(T a, T b) {
  return (T)(U)((U)a + (U)b);
}

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return a > b ? a : b;
}

template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
dtype_probe_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
                   int P, int iters) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= P) return;
  const T one = 1, minus_one = (T)(U)~(U)0;
  T xv[kDtypeRows], yv[kDtypeRows];
#pragma unroll
  for (int r = 0; r < kDtypeRows; ++r) {
    xv[r] = x[(size_t)r * P + c];
    yv[r] = y[(size_t)r * P + c];
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = kDtypeRows - 1; r >= 0; --r) {
      const T xs = r ? xv[r - 1] : (T)0;
      const T m = tmax(wrap_add<T, U>(xv[r], one), tmax(xs, yv[r]));
      const T y2 = (m == xv[r]) ? wrap_add<T, U>(yv[r], one) : m;
      xv[r] = tmax(wrap_add<T, U>(m, minus_one), y2);
      yv[r] = y2;
    }
  }
#pragma unroll
  for (int r = 0; r < kDtypeRows; ++r) out[(size_t)r * P + c] = wrap_add<T, U>(xv[r], yv[r]);
}

template <int LANES>
__device__ __forceinline__ uint32_t vadd(uint32_t a, uint32_t b) {
  return LANES == 2 ? __vadd2(a, b) : __vadd4(a, b);
}
template <int LANES>
__device__ __forceinline__ uint32_t vsub(uint32_t a, uint32_t b) {
  return LANES == 2 ? __vsub2(a, b) : __vsub4(a, b);
}
template <int LANES>
__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
  return LANES == 2 ? __vmaxs2(a, b) : __vmaxs4(a, b);
}
template <int LANES>
__device__ __forceinline__ uint32_t vcmpeq(uint32_t a, uint32_t b) {
  return LANES == 2 ? __vcmpeq2(a, b) : __vcmpeq4(a, b);  // all-ones lanes where equal
}

// W 32-bit words a row, each holding LANES neighbouring columns
template <int LANES>
__global__ void __launch_bounds__(kThreads)
dtype_probe_packed(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                   uint32_t* __restrict__ out, int W, int iters) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= W) return;
  const uint32_t one = LANES == 2 ? 0x00010001u : 0x01010101u;
  uint32_t xv[kDtypeRows], yv[kDtypeRows];
#pragma unroll
  for (int r = 0; r < kDtypeRows; ++r) {
    xv[r] = x[(size_t)r * W + c];
    yv[r] = y[(size_t)r * W + c];
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = kDtypeRows - 1; r >= 0; --r) {
      const uint32_t xs = r ? xv[r - 1] : 0u;
      const uint32_t m = vmax<LANES>(vadd<LANES>(xv[r], one), vmax<LANES>(xs, yv[r]));
      const uint32_t eq = vcmpeq<LANES>(m, xv[r]);
      const uint32_t y2 = (eq & vadd<LANES>(yv[r], one)) | (~eq & m);
      xv[r] = vmax<LANES>(vsub<LANES>(m, one), y2);
      yv[r] = y2;
    }
  }
#pragma unroll
  for (int r = 0; r < kDtypeRows; ++r) out[(size_t)r * W + c] = vadd<LANES>(xv[r], yv[r]);
}

dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

}  // namespace

// x, out: [13, P] 32-bit words.  mode 0 native, 1 SWAR, 2 vmax2.
// Returns cudaGetLastError().
extern "C" int pack_probe_launch(int mode, const void* x, void* out, int P, int rows,
                                 void* stream) {
  if (P <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xi = (const uint32_t*)x;
  auto* o = (uint32_t*)out;
  switch (mode) {
    case kNative: pack_probe_kernel<kNative><<<grid_for(P), kThreads, 0, s>>>(xi, o, P, rows); break;
    case kSwar: pack_probe_kernel<kSwar><<<grid_for(P), kThreads, 0, s>>>(xi, o, P, rows); break;
    case kVmax2: pack_probe_kernel<kVmax2><<<grid_for(P), kThreads, 0, s>>>(xi, o, P, rows); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, y, out: [14, P] of a bits-wide signed type (32, 16 or 8).
extern "C" int dtype_probe_launch(int bits, const void* x, const void* y, void* out, int P,
                                  int iters, void* stream) {
  if (P <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 32:
      dtype_probe_kernel<int32_t, uint32_t><<<grid_for(P), kThreads, 0, s>>>(
          (const int32_t*)x, (const int32_t*)y, (int32_t*)out, P, iters);
      break;
    case 16:
      dtype_probe_kernel<int16_t, uint16_t><<<grid_for(P), kThreads, 0, s>>>(
          (const int16_t*)x, (const int16_t*)y, (int16_t*)out, P, iters);
      break;
    case 8:
      dtype_probe_kernel<int8_t, uint8_t><<<grid_for(P), kThreads, 0, s>>>(
          (const int8_t*)x, (const int8_t*)y, (int8_t*)out, P, iters);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, y, out: [14, W] 32-bit words of `lanes` (2: int16, 4: int8) columns each.
extern "C" int dtype_probe_packed_launch(int lanes, const void* x, const void* y, void* out,
                                         int W, int iters, void* stream) {
  if (W <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xi = (const uint32_t*)x;
  const auto* yi = (const uint32_t*)y;
  auto* o = (uint32_t*)out;
  switch (lanes) {
    case 2: dtype_probe_packed<2><<<grid_for(W), kThreads, 0, s>>>(xi, yi, o, W, iters); break;
    case 4: dtype_probe_packed<4><<<grid_for(W), kThreads, 0, s>>>(xi, yi, o, W, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
