// Banded dovetail alignment kernels for Hopper (sm_90a), one thread per pair.
//
// Replaces the two TPU Pallas kernels of sequence_aligner_tpu/ops/align_fused.py:
//   phase1_kernel  <- _phase1_packed_kernel (:463, launched by phase1_fused_packed)
//   phase2_kernel  <- _phase2_packed_kernel (:821, launched by phase2_fused_packed)
// and computes exactly what they compute (the plain PyTorch versions beside the
// wrappers in ops/align_fused.py are the spec, held against the JAX package):
//
//   phase 1: affine-gap local DP of A (rows i = 1..|A|) against B's first w
//            codes (band columns k = 1..w), with the backtrack stop
//            (row << 16 | col) propagated through the fill (M before X before
//            Y) and the running best kept as the first maximum in row-major
//            order (strict >).  Outputs best, bi, bj, fi, fj.
//   phase 2: A shifted by the dove start ds, then the rotated-band affine DP
//            (band columns k = 0..w, B column j = k - zero_row + u) with the
//            in-band masks 1 <= j <= |B| and the aux state (stop_u, stop_k,
//            correct, error) carried through the fill.  Outputs best, bu, bk,
//            uf, kf, corr, err.
//
// What bounds it on this card: int32 ALU issue.  Per pair a kernel reads
// wpr + wpr_b packed words (16 two-bit codes each) and two or three length
// words and writes 5 or 7 words, while it does ~30 int32 operations for each
// of rows x (w + 1) band cells (about 1,300 cells a pair at 100 bp), so the
// bytes are three orders of magnitude below what the operations cost.  The
// design therefore spends nothing on data movement: every band column of M, X,
// Y and the stop / count words lives in registers (the kernels are templated
// on a band capacity of 16, 32 or 64 columns; a general instance keeps the
// band in device scratch laid out [column][pair], so any width the engine
// passes is handled), the in-row X recurrence is a plain left-to-right step
// x[k] = gE + max(c[k-1], x[k-1]) instead of the TPU's log-doubling gated
// chain, each row is ONE fused left-to-right pass over the band, rows stop at
// the lane's own length (phase 1) or dove length (phase 2) since later rows
// cannot change any output, and the operands are read from the word-major
// [words, pairs] layout so neighbouring threads read neighbouring words.  The
// TPU's bit packing (_extract_bits, _p2_pack, the fast / legacy split) existed
// to save vector ops and is not carried over: the running best is a plain
// strict-> compare in row-major order, the stop word is (row << 16 | col) with
// the liveness flag (max > 0) in its sign bit, and the counts are
// (correct << 16 | error).  Rows and counts therefore stay below 2^15 (the
// wrappers check la_max < 32768).  wgmma does not apply to this max-plus
// recurrence.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLive = INT32_MIN;  // sign bit of a stop word: cell max > 0

struct CostMatrix {
  int v[16];  // cm[a * 4 + b], base codes A=0 C=1 T=2 G=3
};

// Band storage: registers for the templated capacities, device scratch for
// the general instance (column k of lane p at base[k * stride]).
template <int CAP>
struct RegBand {
  int v[CAP];
  __device__ __forceinline__ int& operator[](int k) { return v[k]; }
};

struct ScratchBand {
  int* base;
  int stride;
  __device__ __forceinline__ int& operator[](int k) { return base[(size_t)k * stride]; }
};

__device__ __forceinline__ int max3(int a, int b, int c) { return max(a, max(b, c)); }

// Code r of lane p in a little-endian packed-word plane [nw, P] (0 past it).
__device__ __forceinline__ int code_at(const int32_t* __restrict__ words, int nw, int P,
                                       int p, int r) {
  if (r < 0 || r >= 16 * nw) return 0;
  const uint32_t word = (uint32_t)__ldg(words + (size_t)(r >> 4) * P + p);
  return (int)((word >> (2 * (r & 15))) & 3u);
}

// cm[a, b] from the four scores of the row's A code (a per-row constant)
__device__ __forceinline__ int score(int s0, int s1, int s2, int s3, int b) {
  return b == 0 ? s0 : (b == 1 ? s1 : (b == 2 ? s2 : s3));
}

// ---------------------------------------------------------------------------
// Phase 1.  Band arrays hold columns k = 1..w at index k - 1; column 0 is the
// DP boundary (M = X = Y = 0, never live).
// ---------------------------------------------------------------------------
template <int CAP, class Band>
__device__ __forceinline__ void phase1_pair(
    Band& M, Band& X, Band& Y, Band& S, Band& Bc, const int* s_cm,
    const int32_t* __restrict__ aw, const int32_t* __restrict__ bw, int P, int p,
    int wpr, int wpr_b, int n_rows, int w, int gO, int gE, int32_t* out) {
  // register instances unroll over the capacity; the scratch instance loops w
  const int NK = CAP > 0 ? CAP : w;
#pragma unroll
  for (int k = 1; k <= NK; ++k) {
    if (k > w) break;
    M[k - 1] = 0; X[k - 1] = 0; Y[k - 1] = 0; S[k - 1] = 0;
    Bc[k - 1] = code_at(bw, wpr_b, P, p, k - 1);
  }
  int best = 0, bi = 0, bj = 0, bs = 0;
  uint32_t aword = 0;
  const int c0 = max(gO, 0);  // c at column 0: max(max(M, Y) + gO, 0), M = Y = 0
  for (int i = 1; i <= n_rows; ++i) {
    const int r = i - 1;
    if ((r & 15) == 0)
      aword = (r >> 4) < wpr ? (uint32_t)__ldg(aw + (size_t)(r >> 4) * P + p) : 0u;
    const int* sa = s_cm + 4 * (int)((aword >> (2 * (r & 15))) & 3u);
    const int sa0 = sa[0], sa1 = sa[1], sa2 = sa[2], sa3 = sa[3];
    // previous row at column k - 1 (boundary column 0 to start)
    int pm = 0, px = 0, py = 0, ps = 0;
    // current row at column k - 1
    int cm1 = c0, xm1 = 0, mxm1 = 0, sm1 = 0;
#pragma unroll
    for (int k = 1; k <= NK; ++k) {
      if (k > w) break;
      const int om = M[k - 1], ox = X[k - 1], oy = Y[k - 1], os = S[k - 1];
      const int m = score(sa0, sa1, sa2, sa3, Bc[k - 1]) + max3(pm, py, max(px, 0));
      const int y = gE + max3(om + gO, oy, max(ox + gO, 0));
      const int x = gE + max(cm1, xm1);
      const int mx = max3(m, x, y);
      int s;
      if (m == mx)  // M: pred (i-1, k-1)
        s = ps < 0 ? (ps & INT32_MAX) : (((i - 1) << 16) | (k - 1));
      else if (x == mx)  // X: pred (i, k-1), in-row
        s = mxm1 > 0 ? sm1 : ((i << 16) | (k - 1));
      else  // Y: pred (i-1, k)
        s = os < 0 ? (os & INT32_MAX) : (((i - 1) << 16) | k);
      if (mx > best) { best = mx; bi = i; bj = k; bs = s; }
      pm = om; px = ox; py = oy; ps = os;
      cm1 = max(max(m, y) + gO, 0); xm1 = x; mxm1 = mx; sm1 = s;
      M[k - 1] = m; X[k - 1] = x; Y[k - 1] = y; S[k - 1] = mx > 0 ? (s | kLive) : s;
    }
  }
  const size_t st = (size_t)P;
  out[0 * st + p] = best;
  out[1 * st + p] = bi;
  out[2 * st + p] = bj;
  out[3 * st + p] = bs >> 16;
  out[4 * st + p] = bs & 0xFFFF;
}

template <int CAP>
__global__ void __launch_bounds__(kThreads) phase1_kernel(
    const int32_t* __restrict__ aw, const int32_t* __restrict__ bw,
    const int32_t* __restrict__ alen, int32_t* __restrict__ out, int32_t* scratch,
    int P, int wpr, int wpr_b, int la_max, int w, int gO, int gE, CostMatrix cm,
    int ulen) {
  __shared__ int s_cm[16];
  if (threadIdx.x < 16) s_cm[threadIdx.x] = cm.v[threadIdx.x];
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  // rows past the lane's length cannot change any output
  const int n_rows = min(la_max, ulen > 0 ? ulen : __ldg(alen + p));
  if constexpr (CAP > 0) {
    RegBand<CAP> M, X, Y, S, Bc;
    phase1_pair<CAP>(M, X, Y, S, Bc, s_cm, aw, bw, P, p, wpr, wpr_b, n_rows, w, gO, gE,
                     out);
  } else {
    const size_t plane = (size_t)w * P;
    ScratchBand M{scratch + p, P}, X{scratch + plane + p, P}, Y{scratch + 2 * plane + p, P},
        S{scratch + 3 * plane + p, P}, Bc{scratch + 4 * plane + p, P};
    phase1_pair<0>(M, X, Y, S, Bc, s_cm, aw, bw, P, p, wpr, wpr_b, n_rows, w, gO, gE, out);
  }
}

// ---------------------------------------------------------------------------
// Phase 2.  Band arrays hold columns k = 0..w; row u's column k is B column
// j = k - zero_row + u, and W[k] holds its code B[j - 1].
// ---------------------------------------------------------------------------
template <int CAP, class Band>
__device__ __forceinline__ void phase2_pair(
    Band& M, Band& X, Band& Y, Band& S, Band& C, Band& W, const int* s_cm,
    const int32_t* __restrict__ aw, const int32_t* __restrict__ bw, int P, int p,
    int wpr, int wpr_b, int ds, int n_rows, int blen, int w, int zero_row, int gO, int gE,
    int32_t* out) {
  const int NK = CAP > 0 ? CAP - 1 : w;
#pragma unroll
  for (int k = 0; k <= NK; ++k) {
    if (k > w) break;
    M[k] = 0; X[k] = 0; Y[k] = 0; S[k] = 0; C[k] = 0;
    W[k] = code_at(bw, wpr_b, P, p, k - zero_row);
  }
  int best = 0, bu = 0, bk = 0, bs = 0, bc = 0;
  uint32_t aword = 0;
  for (int u = 1; u <= n_rows; ++u) {
    const int r = u - 1 + ds;  // dove-shifted A row
    if (u == 1 || (r & 15) == 0)
      aword = (r >= 0 && (r >> 4) < wpr) ? (uint32_t)__ldg(aw + (size_t)(r >> 4) * P + p)
                                         : 0u;
    const int a = (r >= 0) ? (int)((aword >> (2 * (r & 15))) & 3u) : 0;
    const int sa0 = s_cm[4 * a], sa1 = s_cm[4 * a + 1], sa2 = s_cm[4 * a + 2],
              sa3 = s_cm[4 * a + 3];
    // in-band columns: 1 <= j <= blen  <=>  klo <= k <= khi
    const int klo = zero_row + 1 - u, khi = blen + zero_row - u;
    const int b_next = code_at(bw, wpr_b, P, p, w - zero_row + u);
    int cm1 = 0, xm1 = 0, mxm1 = 0, sm1 = 0, ccm1 = 0;  // current row, column k - 1
#pragma unroll
    for (int k = 0; k <= NK; ++k) {
      if (k > w) break;
      // previous row at columns k and k + 1 (column w + 1 is outside the band;
      // k1 stays inside the register array where k + 1 cannot be a column)
      const int om = M[k], ox = X[k], oy = Y[k], os = S[k], oc = C[k];
      const bool edge = k == w;
      const int k1 = (CAP > 0 && k + 1 >= CAP) ? k : k + 1;
      const int om1 = edge ? 0 : M[k1], ox1 = edge ? 0 : X[k1];
      const int oy1 = edge ? 0 : Y[k1], os1 = edge ? 0 : S[k1];
      const int oc1 = edge ? 0 : C[k1];
      const int b = W[k];
      int m = 0, x = 0, y = 0;
      if (k >= klo && k <= khi) {
        m = score(sa0, sa1, sa2, sa3, b) + max3(om, oy, max(ox, 0));
        if (!edge) y = gE + max3(om1 + gO, oy1, max(ox1 + gO, 0));
        if (k != 0) x = gE + max(cm1, xm1);
      }
      const int mx = max3(m, x, y);
      int s, c;
      if (m == mx) {  // M: pred (u-1, k)
        if (os < 0) { s = os & INT32_MAX; c = oc; } else { s = ((u - 1) << 16) | k; c = 0; }
        c += (a == b) ? 0x10000 : 1;  // match or error
      } else if (k != 0 && x == mx) {  // X: pred (u, k-1), in-row
        if (mxm1 > 0) { s = sm1; c = ccm1; } else { s = (u << 16) | (k - 1); c = 0; }
        c += 1;
      } else {  // Y: pred (u-1, k+1)
        if (os1 < 0) { s = os1 & INT32_MAX; c = oc1; } else { s = ((u - 1) << 16) | (k + 1); c = 0; }
        c += 1;
      }
      if (mx > best) { best = mx; bu = u; bk = k; bs = s; bc = c; }
      cm1 = max(max(m, y) + gO, 0); xm1 = x; mxm1 = mx; sm1 = s; ccm1 = c;
      M[k] = m; X[k] = x; Y[k] = y; S[k] = mx > 0 ? (s | kLive) : s; C[k] = c;
      W[k] = edge ? b_next : W[k1];  // slide the B window for row u + 1
    }
  }
  const size_t st = (size_t)P;
  out[0 * st + p] = best;
  out[1 * st + p] = bu;
  out[2 * st + p] = bk;
  out[3 * st + p] = bs >> 16;
  out[4 * st + p] = bs & 0xFFFF;
  out[5 * st + p] = bc >> 16;
  out[6 * st + p] = bc & 0xFFFF;
}

template <int CAP>
__global__ void __launch_bounds__(kThreads) phase2_kernel(
    const int32_t* __restrict__ aw, const int32_t* __restrict__ bw,
    const int32_t* __restrict__ ds, const int32_t* __restrict__ dlen,
    const int32_t* __restrict__ blen, int32_t* __restrict__ out, int32_t* scratch, int P,
    int wpr, int wpr_b, int rows, int w, int zero_row, int gO, int gE, CostMatrix cm,
    int ulen) {
  __shared__ int s_cm[16];
  if (threadIdx.x < 16) s_cm[threadIdx.x] = cm.v[threadIdx.x];
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  // rows past the lane's dove length are masked: they cannot change any output
  const int n_rows = min(rows, __ldg(dlen + p));
  const int bl = ulen > 0 ? ulen : __ldg(blen + p);
  const int d = __ldg(ds + p);
  if constexpr (CAP > 0) {
    RegBand<CAP> M, X, Y, S, C, W;
    phase2_pair<CAP>(M, X, Y, S, C, W, s_cm, aw, bw, P, p, wpr, wpr_b, d, n_rows, bl, w,
                     zero_row, gO, gE, out);
  } else {
    const size_t plane = (size_t)(w + 1) * P;
    ScratchBand M{scratch + p, P}, X{scratch + plane + p, P}, Y{scratch + 2 * plane + p, P},
        S{scratch + 3 * plane + p, P}, C{scratch + 4 * plane + p, P},
        W{scratch + 5 * plane + p, P};
    phase2_pair<0>(M, X, Y, S, C, W, s_cm, aw, bw, P, p, wpr, wpr_b, d, n_rows, bl, w,
                   zero_row, gO, gE, out);
  }
}

CostMatrix load_cm(const int32_t* cm) {
  CostMatrix c;
  for (int i = 0; i < 16; ++i) c.v[i] = cm[i];
  return c;
}

}  // namespace

// Scratch (int32) the general instance needs: 0 for the register instances.
extern "C" long long phase1_scratch_words(int P, int w) {
  return w + 1 <= 64 ? 0 : 5LL * w * P;
}

extern "C" long long phase2_scratch_words(int P, int w) {
  return w + 1 <= 64 ? 0 : 6LL * (w + 1) * P;
}

// out: [5, P] int32 (best, bi, bj, fi, fj).  Returns cudaGetLastError().
extern "C" int phase1_launch(const int32_t* aw, const int32_t* bw, const int32_t* alen,
                             int32_t* out, int32_t* scratch, int P, int wpr, int wpr_b,
                             int la_max, int w, int gO, int gE, const int32_t* cm, int ulen,
                             void* stream) {
  if (P <= 0 || w < 1 || wpr < 1 || wpr_b < 1 || la_max < 0 || la_max >= 32768)
    return (int)cudaErrorInvalidValue;
  if (w + 1 > 64 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const CostMatrix c = load_cm(cm);
  if (w + 1 <= 16)
    phase1_kernel<16><<<grid, block, 0, s>>>(aw, bw, alen, out, scratch, P, wpr, wpr_b,
                                             la_max, w, gO, gE, c, ulen);
  else if (w + 1 <= 32)
    phase1_kernel<32><<<grid, block, 0, s>>>(aw, bw, alen, out, scratch, P, wpr, wpr_b,
                                             la_max, w, gO, gE, c, ulen);
  else if (w + 1 <= 64)
    phase1_kernel<64><<<grid, block, 0, s>>>(aw, bw, alen, out, scratch, P, wpr, wpr_b,
                                             la_max, w, gO, gE, c, ulen);
  else
    phase1_kernel<0><<<grid, block, 0, s>>>(aw, bw, alen, out, scratch, P, wpr, wpr_b,
                                            la_max, w, gO, gE, c, ulen);
  return (int)cudaGetLastError();
}

// out: [7, P] int32 (best, bu, bk, uf, kf, corr, err).  Returns cudaGetLastError().
extern "C" int phase2_launch(const int32_t* aw, const int32_t* bw, const int32_t* ds,
                             const int32_t* dlen, const int32_t* blen, int32_t* out,
                             int32_t* scratch, int P, int wpr, int wpr_b, int rows, int w,
                             int zero_row, int gO, int gE, const int32_t* cm, int ulen,
                             void* stream) {
  if (P <= 0 || w < 1 || wpr < 1 || wpr_b < 1 || rows < 0 || rows >= 32768)
    return (int)cudaErrorInvalidValue;
  if (w + 1 > 64 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const CostMatrix c = load_cm(cm);
  if (w + 1 <= 16)
    phase2_kernel<16><<<grid, block, 0, s>>>(aw, bw, ds, dlen, blen, out, scratch, P, wpr,
                                             wpr_b, rows, w, zero_row, gO, gE, c, ulen);
  else if (w + 1 <= 32)
    phase2_kernel<32><<<grid, block, 0, s>>>(aw, bw, ds, dlen, blen, out, scratch, P, wpr,
                                             wpr_b, rows, w, zero_row, gO, gE, c, ulen);
  else if (w + 1 <= 64)
    phase2_kernel<64><<<grid, block, 0, s>>>(aw, bw, ds, dlen, blen, out, scratch, P, wpr,
                                             wpr_b, rows, w, zero_row, gO, gE, c, ulen);
  else
    phase2_kernel<0><<<grid, block, 0, s>>>(aw, bw, ds, dlen, blen, out, scratch, P, wpr,
                                            wpr_b, rows, w, zero_row, gO, gE, c, ulen);
  return (int)cudaGetLastError();
}
