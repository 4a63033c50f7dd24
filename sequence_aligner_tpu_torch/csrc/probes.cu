// Timing probes for Hopper (sm_90a): one thread per column (or per two
// columns in 16-bit lanes), the column's values in registers.
//
// Replace the two TPU probe kernels of tools/ and compute exactly what they
// compute (the plain PyTorch versions in probes/pack_probe.py and
// probes/dtype_probe.py are the spec, held against the Pallas kernels under
// the interpreter):
//
//   pack_probe_kernel<kNative>  <- tools/pack_probe.py native_kernel (:59)
//   pack_probe_kernel<kSwar>    <- tools/pack_probe.py swar_kernel (:80)
//   pack_probe_kernel<kVmax2>   the card's own answer to that probe's question:
//                               the SWAR words through the signed 16x2 max
//   dtype_probe_kernel<Lane32>        <- tools/dtype_probe.py kernel (:33), int32
//   dtype_probe_kernel<Lane16x2<0>>   the same at int16, two columns a register
//   dtype_probe_kernel<Lane16x2<8>>   the same at int8, two columns a register,
//                                     each value in its 16-bit lane's high byte
//
// What bounds them on this card: the integer instruction rate.  Each column
// reads and writes a few dozen bytes and does tens of thousands of
// operations on registers.  So the design is the fewest instructions a step,
// from Hopper's DPX instructions: the 3-input max (VIMNMX3: __vimax3_s32,
// __vimax3_s16x2, __vimax3_u16x2) and the add-max max(a + b, c) (VIADDMNMX:
// __viaddmax_s32, __viaddmax_s16x2), beside the two-input max, which sm_90
// compiles to one VIMNMX at 32 bits and at 16x2 (__vmaxs2; the CUDA 12.8
// Math API has no __vimax_s16x2).
//
// pack probe: ROWS = 100 outer steps (a runtime loop, so nothing folds the
//   chain), each of REPS = 30 repetitions of v = op(v, roll_up(v)) on a column
//   of 13 rows, roll_up(v)[r] = v[(r + 1) % 13], rows updated in place in
//   ascending order.  op is associative and idempotent, so two repetitions are
//   one v[r] = op(v[r], v[r + 1], v[r + 2]) (indices mod 13, the old v[0] and
//   v[1] saved for the wrap): 15 fused steps of one VIMNMX3 a row.  native:
//   int32 max.  vmax2: the signed 16x2 max.  SWAR: the guard-bit emulation
//   swar_max of two 15-bit fields a word (bits 0-14, 16-30; guards 15, 31) is
//   bit-exact on any word, and on two words with clear guard bits it is the
//   per-field unsigned max, whose result has clear guard bits again.  One
//   check a column at load (the OR of its 13 words against the guard bits)
//   sends a guard-clear column through __vimax3_u16x2; a column with a guard
//   bit set runs the emulation, unfused, with the subtraction in unsigned
//   arithmetic because XLA's int32 wraps where signed overflow in C++ is
//   undefined.
// dtype probe: ITERS steps of xs = x shifted down one row (row 0 takes 0),
//   m = max(x + 1, max(xs, y)), y2 = (m == x) ? y + 1 : m, x2 = max(m - 1, y2);
//   output x + y, every add wrapping in two's complement as XLA's does.  Rows
//   update in descending order so each reads its predecessor's old x.  The
//   general step is m = addmax(x, 1, max(xs, y)); y + 1; the select;
//   x2 = addmax(m, -1, y2).  Where x + 1 does not wrap, m > x, so
//   m == x needs x == MAX.  Hence the fast step: while every x and y of the
//   thread (and the zero row) is at most M, k more steps keep them at most
//   M + k, so for MAX - M steps no x reaches MAX, y2 = m and no add wraps:
//   m = addmax(x, 1, max(xs, y)); x2 = addmax(m, -1, m); y2 = m, three
//   instructions.  The thread checks that headroom (a VIMNMX3 reduction of its
//   28 registers) and runs that many fast steps, or else a run of general
//   steps; the path follows the values, both are exact.  16x2 lanes compute
//   the select's mask without the emulated __vcmpeq2: the unsigned 16x2 min
//   of m ^ x and the lane's one is 0 where m == x and one elsewhere, and one
//   IMAD (on the FMA pipe, beside the ALU pipe's max and add-max) spreads it
//   to a mask.  int8 values sit in the high byte of a 16-bit lane (low byte
//   0): the lane's 16-bit wrap is then exactly int8's, and its signed order
//   int8's, so int8 runs the int16 arithmetic with no fix-up (there is no 8x4
//   DPX form); its y + 1 is a plain 32-bit add, whose carry can only reach
//   the high lane's low byte, which the mask (high bytes only) drops.
//
// At the TPU probes' P = 1024 columns only 8 of 132 SMs get a block, so that
// size measures latency; the probes' timing also runs a size that fills the
// card.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPackRows = 13;   // COLS of tools/pack_probe.py
constexpr int kPackReps = 30;   // REPS
constexpr int kDtypeRows = 14;  // ROWS of tools/dtype_probe.py
constexpr int kGeneralRun = 32;  // general steps between two headroom checks
constexpr uint32_t kGuard = (1u << 15) | 0x80000000u;

static_assert(kPackReps % 2 == 0, "two repetitions fuse into one 3-input max");

enum { kNative = 0, kSwar = 1, kVmax2 = 2 };

__device__ __forceinline__ uint32_t swar_max(uint32_t a, uint32_t b) {
  const uint32_t diff = (a | kGuard) - b;  // wraps like XLA's int32 subtract
  const uint32_t f0 = (diff >> 15) & 1u;
  const uint32_t f1 = (diff >> 31) & 1u;  // the JAX arithmetic shift, & 1
  const uint32_t mask = (f0 * 0x7FFFu) | ((f1 * 0x7FFFu) << 16);
  return b ^ ((a ^ b) & mask);
}

// max(a, b, c) in the variant's order: one VIMNMX3
template <int MODE>
__device__ __forceinline__ uint32_t max3(uint32_t a, uint32_t b, uint32_t c) {
  if (MODE == kNative) return (uint32_t)__vimax3_s32((int)a, (int)b, (int)c);
  if (MODE == kVmax2) return __vimax3_s16x2(a, b, c);
  return __vimax3_u16x2(a, b, c);  // SWAR on guard-clear words
}

// two in-place ascending repetitions of v[r] = max(v[r], v[(r + 1) % 13])
template <int MODE>
__device__ __forceinline__ void fused_reps(uint32_t (&v)[kPackRows]) {
  const uint32_t v0 = v[0], v1 = v[1];
#pragma unroll
  for (int r = 0; r < kPackRows - 2; ++r) v[r] = max3<MODE>(v[r], v[r + 1], v[r + 2]);
  v[kPackRows - 2] = max3<MODE>(v[kPackRows - 2], v[kPackRows - 1], v0);
  v[kPackRows - 1] = max3<MODE>(v[kPackRows - 1], v0, v1);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
pack_probe_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int P,
                  int rows) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= P) return;
  uint32_t v[kPackRows];
  uint32_t any = 0;
#pragma unroll
  for (int r = 0; r < kPackRows; ++r) {
    v[r] = x[(size_t)r * P + c];
    any |= v[r];
  }
  if (MODE != kSwar || !(any & kGuard)) {
    for (int i = 0; i < rows; ++i) {
#pragma unroll
      for (int k = 0; k < kPackReps / 2; ++k) fused_reps<MODE>(v);
    }
  } else {  // a guard bit set: the emulation, one repetition at a time
    for (int i = 0; i < rows; ++i) {
#pragma unroll
      for (int k = 0; k < kPackReps; ++k) {
        const uint32_t v0 = v[0];
#pragma unroll
        for (int r = 0; r < kPackRows - 1; ++r) v[r] = swar_max(v[r], v[r + 1]);
        v[kPackRows - 1] = swar_max(v[kPackRows - 1], v0);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPackRows; ++r) out[(size_t)r * P + c] = v[r];
}

// One int32 column a register.
struct Lane32 {
  using T = int32_t;
  static constexpr int kColumns = 1;
  static constexpr int kMax = INT32_MAX;
  static constexpr uint32_t kOne = 1u, kMinusOne = ~0u, kMin = 0x80000000u;
  static __device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
    return (uint32_t)max((int32_t)a, (int32_t)b);
  }
  static __device__ __forceinline__ uint32_t vmax3(uint32_t a, uint32_t b, uint32_t c) {
    return (uint32_t)__vimax3_s32((int32_t)a, (int32_t)b, (int32_t)c);
  }
  static __device__ __forceinline__ uint32_t addmax(uint32_t a, uint32_t b, uint32_t c) {
    return (uint32_t)__viaddmax_s32((int32_t)a, (int32_t)b, (int32_t)c);
  }
  static __device__ __forceinline__ uint32_t inc(uint32_t y) { return y + 1u; }
  // (m == x) ? a : b
  static __device__ __forceinline__ uint32_t select_eq(uint32_t m, uint32_t x, uint32_t a,
                                                       uint32_t b) {
    return m == x ? a : b;
  }
  static __device__ __forceinline__ int top(uint32_t w) { return (int32_t)w; }
  static __device__ __forceinline__ uint32_t load(const T* p, bool) { return (uint32_t)*p; }
  static __device__ __forceinline__ void store(T* p, uint32_t w, bool) { *p = (T)w; }
};

// Two columns a register in signed 16-bit lanes; SHIFT 0 holds int16 values,
// SHIFT 8 int8 values in the lanes' high bytes.
template <int SHIFT>
struct Lane16x2 {
  using T = typename std::conditional<SHIFT == 0, int16_t, int8_t>::type;
  static constexpr int kColumns = 2;
  static constexpr int kMax = 0x7FFF >> SHIFT;
  static constexpr uint32_t kOne = 0x00010001u << SHIFT;
  static constexpr uint32_t kMinusOne = ((0x10000u - (1u << SHIFT)) & 0xFFFFu) * 0x10001u;
  static constexpr uint32_t kMin = 0x80008000u;
  // kLaneMask: every lane's value bits (the whole lane, or its high byte at
  // SHIFT 8).  A lane's one times kSpread is minus that lane's value bits,
  // so ne * kSpread + kLaneMask clears them in each lane where ne is one.
  static constexpr uint32_t kLaneMask = ((0xFFFFu << SHIFT) & 0xFFFFu) * 0x10001u;
  static constexpr uint32_t kSpread = 0u - (0xFFFFu >> SHIFT);
  static __device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
    return __vmaxs2(a, b);
  }
  static __device__ __forceinline__ uint32_t vmax3(uint32_t a, uint32_t b, uint32_t c) {
    return __vimax3_s16x2(a, b, c);
  }
  static __device__ __forceinline__ uint32_t addmax(uint32_t a, uint32_t b, uint32_t c) {
    return __viaddmax_s16x2(a, b, c);
  }
  // y + 1 in each lane; at SHIFT 8 the low bytes may be left nonzero, for
  // select_eq to drop
  static __device__ __forceinline__ uint32_t inc(uint32_t y) {
    return SHIFT ? y + kOne : __viaddmax_s16x2(y, kOne, kMin);
  }
  // (m == x) ? a : b lane by lane, bytes 0 and 2 from b at SHIFT 8
  static __device__ __forceinline__ uint32_t select_eq(uint32_t m, uint32_t x, uint32_t a,
                                                       uint32_t b) {
    const uint32_t ne = __vminu2(m ^ x, kOne);  // a lane's one where m != x, else 0
    const uint32_t eq = ne * kSpread + kLaneMask;
    return (a & eq) | (b & ~eq);
  }
  static __device__ __forceinline__ int top(uint32_t w) {
    return max((int)(int16_t)w, (int)(int16_t)(w >> 16)) >> SHIFT;
  }
  // columns p[0] and, where `two`, p[1] (an odd P's last thread has one)
  static __device__ __forceinline__ uint32_t load(const T* p, bool two) {
    using U = typename std::make_unsigned<T>::type;
    const uint32_t lo = (U)p[0], hi = two ? (U)p[1] : 0u;
    return (lo | hi << 16) << SHIFT;
  }
  static __device__ __forceinline__ void store(T* p, uint32_t w, bool two) {
    p[0] = (T)(w >> SHIFT);
    if (two) p[1] = (T)(w >> (16 + SHIFT));
  }
};

// Steps the thread can take with no x reaching the type's maximum: the
// largest value of its registers and the zero row is M, and k steps keep
// every value at most M + k.
template <class L>
__device__ __forceinline__ int headroom(const uint32_t (&xv)[kDtypeRows],
                                        const uint32_t (&yv)[kDtypeRows]) {
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < kDtypeRows; ++r) acc = L::vmax3(acc, xv[r], yv[r]);
  return L::kMax - L::top(acc);
}

template <class L>
__global__ void __launch_bounds__(kThreads)
dtype_probe_kernel(const typename L::T* __restrict__ x, const typename L::T* __restrict__ y,
                   typename L::T* __restrict__ out, int P, int iters) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) * L::kColumns;
  if (col >= P) return;
  const bool two = col + 1 < P;
  uint32_t xv[kDtypeRows], yv[kDtypeRows];
#pragma unroll
  for (int r = 0; r < kDtypeRows; ++r) {
    xv[r] = L::load(x + (size_t)r * P + col, two);
    yv[r] = L::load(y + (size_t)r * P + col, two);
  }
  for (int it = 0; it < iters;) {
    const int rem = iters - it;
    const int h = headroom<L>(xv, yv);
    if (h > 0) {
      const int n = min(h, rem);
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
#pragma unroll
        for (int r = kDtypeRows - 1; r >= 0; --r) {
          const uint32_t xs = r ? xv[r - 1] : 0u;
          const uint32_t m = L::addmax(xv[r], L::kOne, L::vmax(xs, yv[r]));
          xv[r] = L::addmax(m, L::kMinusOne, m);
          yv[r] = m;
        }
      }
      it += n;
    } else {
      const int n = min(kGeneralRun, rem);
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
#pragma unroll
        for (int r = kDtypeRows - 1; r >= 0; --r) {
          const uint32_t xs = r ? xv[r - 1] : 0u;
          const uint32_t m = L::addmax(xv[r], L::kOne, L::vmax(xs, yv[r]));
          const uint32_t y2 = L::select_eq(m, xv[r], L::inc(yv[r]), m);
          xv[r] = L::addmax(m, L::kMinusOne, y2);
          yv[r] = y2;
        }
      }
      it += n;
    }
  }
#pragma unroll
  for (int r = 0; r < kDtypeRows; ++r)  // x + y: an add-max against the minimum
    L::store(out + (size_t)r * P + col, L::addmax(xv[r], yv[r], L::kMin), two);
}

dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

template <class L>
void launch_dtype(const void* x, const void* y, void* out, int P, int iters, cudaStream_t s) {
  using T = typename L::T;
  const int threads = (P + L::kColumns - 1) / L::kColumns;
  dtype_probe_kernel<L><<<grid_for(threads), kThreads, 0, s>>>((const T*)x, (const T*)y,
                                                                  (T*)out, P, iters);
}

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

// x, y, out: contiguous [14, P] of a bits-wide signed type (32, 16 or 8);
// 2-byte (int16) or 1-byte (int8) alignment is enough: elements are read one
// by one.
extern "C" int dtype_probe_launch(int bits, const void* x, const void* y, void* out, int P,
                                  int iters, void* stream) {
  if (P <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 32: launch_dtype<Lane32>(x, y, out, P, iters, s); break;
    case 16: launch_dtype<Lane16x2<0>>(x, y, out, P, iters, s); break;
    case 8: launch_dtype<Lane16x2<8>>(x, y, out, P, iters, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
