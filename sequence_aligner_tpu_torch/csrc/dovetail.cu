// Banded dovetail alignment kernels for Hopper (sm_90a), one thread per pair.
//
// Replaces the two TPU Pallas kernels of sequence_aligner_tpu/ops/align_fused.py:
//   phase1_kernel  <- _phase1_packed_kernel (:463, launched by phase1_fused_packed)
//   phase2_kernel  <- _phase2_packed_kernel (:821, launched by phase2_fused_packed)
// and computes exactly what they compute (the plain PyTorch versions beside the
// wrappers in ops/align_fused.py are the spec, held against the JAX package):
//
//   phase 1: affine-gap local DP of A (rows i = 1..|A|) against B's first w
//            codes (band columns k = 1..w), with the backtrack stop (row, col)
//            propagated through the fill (M before X before Y) and the running
//            best kept as the first maximum in row-major order (strict >).
//            Outputs best, bi, bj, fi, fj.
//   phase 2: A shifted by the dove start ds, then the rotated-band affine DP
//            (band columns k = 0..w, B column j = k - zero_row + u) with the
//            in-band mask 1 <= j <= |B| and the aux state (stop, correct,
//            error) carried through the fill.  Outputs best, bu, bk, uf, kf,
//            corr, err.
//
// Both kernels take the engine's packed read table as it is: `packed` is the
// [n_reads, wpr] row-major table of little-endian 2-bit codes (16 a word) and
// a thread reads its own pair's A and B rows through a_idx / b_idx, and the
// lengths through the same indices.  No operand is gathered or transposed
// before a launch; the words a thread reads (a few dozen) come from L2.
//
// What bounds them on this card: int32 issue.  A pair reads ~2 wpr words and
// writes 5 or 7, while it does 20-40 integer instructions for each of
// rows x (w + 1) band cells, so bytes are three orders below operations.  The
// design therefore spends every instruction it can on the DP itself:
//
//   * One thread per pair, the band in registers.  Register instances are
//     templated on the number of band columns: exactly w = 12 and w = 16 for
//     phase 1 (13 and 17 columns for phase 2) -- the widths of the
//     AlignSettings() defaults and of amos_parity(kmer_size=16) -- with no
//     width test in the unrolled column loop, and capacity instances of 24,
//     32, 48 and 64 columns for the widths of reads up to 3,199 bp.  A
//     capacity instance runs all its columns and masks those past w (they
//     feed no column <= w; phase 1 keeps them out of the best, phase 2 out
//     of the band), so its row loop has no branch a column.  Both ping-pong
//     bands stay in registers (about 7 words a column in phase 1, 9 in
//     phase 2), so the 32- to 64-column instances spill; they still beat
//     the scratch band.  Any wider band, any score that does not fit 16
//     bits, and every launch of more than MAX_ROWS rows takes the general
//     instance, whose band lives in device scratch laid out [column][pair].
//   * No register moves for the band.  Rows are unrolled by two and
//     ping-pong between two register bands (P -> Q, then Q -> P), so "the
//     previous row" is a renaming: nothing is carried forward cell by cell.
//     The carried state is reduced to what the next row reads: D = max(mx, 0)
//     (the next M's diagonal term), T = gE + max(max(M, X) + gO, Y, 0) (the
//     next Y) and E, the stop a successor inherits (the cell's stop if it is
//     live, else its own position), plus F, the counts it inherits (phase 2).
//   * Scores by one PRMT.  The row's four scores cm[a][0..3] sit as 16-bit
//     halves of two words; a per-column byte selector (0x9910 + 0x2222 * b)
//     picks B's score with sign replication.  Phase 1's selectors are fixed
//     per column; phase 2 keeps B's packed words in a funnel-shifted window,
//     shifted once a row, and extracts column k with a constant shift.
//   * No branches in the cell.  M / X / Y predecessors, the band mask
//     (one unsigned compare, (j - 1) < |B|) and the running best are selects.
//   * __launch_bounds__(kThreads, 1): without the block minimum ptxas caps
//     the w = 12 instances at 80 and 128 registers and spills a word; with
//     it they take 79 and 141 registers and nothing spills.
//
// Stop and count words: the narrow instances carry (row << 16 | col) and
// (correct << 16 | error) in 32 bits and take at most MAX_ROWS rows; the wide
// general instance carries the same fields 32 bits apart in 64-bit words and
// takes up to kMaxRowsWide rows, for reads of 32,768 bp or more.  The in-row
// X recurrence is the plain step x[k] = gE + max(c[k-1], x[k-1]); rows stop at
// the lane's own length (phase 1) or dove length (phase 2), since later rows
// cannot change any output.  wgmma does not apply to this max-plus recurrence.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 32767;        // narrow words: 16-bit row and count fields
constexpr int kMaxRowsWide = 1 << 30;  // wide words: 32-bit fields, int loop bounds

struct CostMatrix {
  int v[16];  // cm[a * 4 + b], base codes A=0 C=1 T=2 G=3
};

// Stop / count words: fields SH bits apart.
template <class W>
struct Word {
  static constexpr int SH = 4 * (int)sizeof(W);
  static constexpr W ONE_HI = (W)1 << SH;  // +1 correct
  __device__ __forceinline__ static W pos(int row, int col) {
    return ((W)(uint32_t)row << SH) | (W)(uint32_t)col;
  }
  __device__ __forceinline__ static int hi(W x) { return (int)(x >> SH); }
  __device__ __forceinline__ static int lo(W x) { return (int)(x & (ONE_HI - 1)); }
};

// Band storage: registers for the templated instances, device scratch for the
// general one (column k of lane p at base[k * stride]).
template <class T, int N>
struct RegBand {
  T v[N];
  __device__ __forceinline__ T& operator[](int k) { return v[k]; }
};

template <class T>
struct ScratchBand {
  T* base;
  int stride;
  __device__ __forceinline__ T& operator[](int k) { return base[(size_t)k * stride]; }
};

__device__ __forceinline__ int max3(int a, int b, int c) { return max(a, max(b, c)); }

// Code r of a packed row of nw words (0 outside it).
__device__ __forceinline__ uint32_t code_at(const int32_t* __restrict__ row, int nw, int r) {
  if (r < 0 || r >= 16 * nw) return 0u;
  return ((uint32_t)__ldg(row + (r >> 4)) >> (2 * (r & 15))) & 3u;
}

__device__ __forceinline__ uint32_t word_at(const int32_t* __restrict__ row, int nw, int q) {
  return (q >= 0 && q < nw) ? (uint32_t)__ldg(row + q) : 0u;
}

// PRMT selector that picks the sign-extended 16-bit score of B code b from the
// word pair (lo = scores 0, 1; hi = scores 2, 3).
__device__ __forceinline__ uint32_t score_sel(uint32_t b) { return 0x9910u + b * 0x2222u; }

__device__ __forceinline__ int prmt_score(uint32_t lo, uint32_t hi, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return (int)d;
}

// The row's scores: packed 16-bit halves (register instances) or the matrix
// row in shared memory (general instance).
struct RowScores {
  uint32_t lo, hi;
  const int* row;
};

template <bool REG>
__device__ __forceinline__ int score(const RowScores& rs, uint32_t key) {
  if constexpr (REG) return prmt_score(rs.lo, rs.hi, key);
  else return rs.row[key];
}

struct Shared {
  int cm[16];
  uint32_t lo[4], hi[4];
};

// One thread fills the block's score tables; constant indices keep the
// parameter struct out of local memory.
__device__ __forceinline__ void load_scores(Shared& sh, const CostMatrix& cm) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sh.cm[i] = cm.v[i];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int* r = cm.v + 4 * a;
      sh.lo[a] = ((uint32_t)r[0] & 0xFFFFu) | ((uint32_t)r[1] << 16);
      sh.hi[a] = ((uint32_t)r[2] & 0xFFFFu) | ((uint32_t)r[3] << 16);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ RowScores row_scores(const Shared& sh, uint32_t a) {
  return RowScores{sh.lo[a], sh.hi[a], sh.cm + 4 * a};
}

// ---------------------------------------------------------------------------
// Phase 1.  Band index k - 1 holds column k = 1..w; column 0 is the DP
// boundary (never live, D = 0).  NK: columns of a register instance (0: w,
// in scratch); EXACT: NK == w.
// ---------------------------------------------------------------------------
template <int NK, bool EXACT, class W, class BI, class BW, class BK>
__device__ __forceinline__ void phase1_row(BI& Dp, BI& Tp, BW& Ep, BI& Dq, BI& Tq, BW& Eq,
                                           BK& key, const RowScores& rs, int i, int w,
                                           int gO, int gE, int& best, W& bpos, W& bs) {
  constexpr bool REG = NK > 0;
  const int nk = REG ? NK : w;
  const W rb = Word<W>::pos(i, 0);
  int h = max(gO, 0);          // max(max(M, Y) + gO, X, 0) at column k - 1, this row
  W ecl = rb;                  // E at column k - 1, this row (column 0: its position)
  int dpl = 0;                 // D at column k - 1, previous row
  W epl = Word<W>::pos(i - 1, 0);  // E at column k - 1, previous row
#pragma unroll
  for (int k = 1; k <= nk; ++k) {
    const int m = score<REG>(rs, key[k - 1]) + dpl;
    const int y = Tp[k - 1];
    const int x = gE + h;
    const int mx = max3(m, x, y);
    const W ep = Ep[k - 1];
    const W s = m == mx ? epl : (x == mx ? ecl : ep);  // M: (i-1, k-1), X: (i, k-1), Y: (i-1, k)
    const W pk = rb + (W)k;
    const W e = mx > 0 ? s : pk;
    // a capacity instance's columns past w feed no column <= w: they only
    // stay out of the best
    const bool up = mx > best && (EXACT || !REG || k <= w);
    best = up ? mx : best;
    bpos = up ? pk : bpos;
    bs = up ? s : bs;
    h = max3(max(m, y) + gO, x, 0);
    Tq[k - 1] = gE + max3(max(m, x) + gO, y, 0);
    dpl = Dp[k - 1];
    epl = ep;
    Dq[k - 1] = max(mx, 0);
    Eq[k - 1] = e;
    ecl = e;
  }
}

template <int NK, bool EXACT, class W, class BI, class BW, class BK>
__device__ __forceinline__ void phase1_pair(BI& D0, BI& T0, BW& E0, BI& D1, BI& T1, BW& E1,
                                            BK& key, const Shared& sh,
                                            const int32_t* __restrict__ arow,
                                            const int32_t* __restrict__ brow, int wpr,
                                            int n_rows, int w, int gO, int gE,
                                            int32_t* out, int P, int p) {
  constexpr bool REG = NK > 0;
  const int nk = REG ? NK : w;
  const int t0 = gE + max(gO, 0);  // T of the all-zero row 0
#pragma unroll
  for (int k = 1; k <= nk; ++k) {
    D0[k - 1] = 0;
    T0[k - 1] = t0;
    E0[k - 1] = Word<W>::pos(0, k);
    const uint32_t b = code_at(brow, wpr, k - 1);  // B's first w codes (0 past B's words)
    key[k - 1] = REG ? score_sel(b) : b;
  }
  int best = 0;
  W bpos = 0, bs = 0;
  uint32_t aword = 0;
  for (int i = 1; i <= n_rows; i += 2) {
    // rows i and i + 1: P -> Q, then Q -> P; i - 1 is even, so a new A word
    // starts only on the first
    if (((i - 1) & 15) == 0) aword = word_at(arow, wpr, (i - 1) >> 4);
    phase1_row<NK, EXACT, W>(D0, T0, E0, D1, T1, E1, key, row_scores(sh, aword & 3u), i, w,
                             gO, gE, best, bpos, bs);
    if (i + 1 > n_rows) break;
    phase1_row<NK, EXACT, W>(D1, T1, E1, D0, T0, E0, key, row_scores(sh, (aword >> 2) & 3u),
                             i + 1, w, gO, gE, best, bpos, bs);
    aword >>= 4;
  }
  const size_t st = (size_t)P;
  out[0 * st + p] = best;
  out[1 * st + p] = Word<W>::hi(bpos);
  out[2 * st + p] = Word<W>::lo(bpos);
  out[3 * st + p] = Word<W>::hi(bs);
  out[4 * st + p] = Word<W>::lo(bs);
}

template <int NK, bool EXACT, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1) phase1_kernel(
    const int32_t* __restrict__ packed, const int32_t* __restrict__ a_idx,
    const int32_t* __restrict__ b_idx, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ out, void* scratch, int P, int wpr, int la_max, int w, int gO,
    int gE, CostMatrix cm, int ulen) {
  using W = typename std::conditional<WIDE, uint64_t, uint32_t>::type;
  __shared__ Shared sh;
  load_scores(sh, cm);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int ia = __ldg(a_idx + p);
  const int32_t* arow = packed + (size_t)ia * wpr;
  const int32_t* brow = packed + (size_t)__ldg(b_idx + p) * wpr;
  // rows past the lane's length cannot change any output
  const int n_rows = min(la_max, ulen > 0 ? ulen : __ldg(lengths + ia));
  if constexpr (NK > 0) {
    RegBand<int, NK> D0, T0, D1, T1;
    RegBand<W, NK> E0, E1;
    RegBand<uint32_t, NK> key;
    phase1_pair<NK, EXACT, W>(D0, T0, E0, D1, T1, E1, key, sh, arow, brow, wpr, n_rows, w,
                              gO, gE, out, P, p);
  } else {
    // W planes first (8-byte aligned), then the int planes
    const size_t plane = (size_t)w * P;
    W* wp = static_cast<W*>(scratch);
    int* ip = reinterpret_cast<int*>(wp + 2 * plane);
    ScratchBand<W> E0{wp + p, P}, E1{wp + plane + p, P};
    ScratchBand<int> D0{ip + p, P}, T0{ip + plane + p, P}, D1{ip + 2 * plane + p, P},
        T1{ip + 3 * plane + p, P};
    ScratchBand<uint32_t> key{reinterpret_cast<uint32_t*>(ip + 4 * plane) + p, P};
    phase1_pair<0, false, W>(D0, T0, E0, D1, T1, E1, key, sh, arow, brow, wpr, n_rows, w,
                             gO, gE, out, P, p);
  }
}

// ---------------------------------------------------------------------------
// Phase 2.  Band index k holds column k = 0..w; row u's column k is B column
// j = k - zero_row + u, whose code is B[j - 1].  NK: columns (w + 1) of a
// register instance (0: in scratch); EXACT: NK == w + 1.
// ---------------------------------------------------------------------------

// B's codes for a row, register instances: NA words aligned to the row's
// column 0, cut by a funnel shift from a cache of NA + 1 raw words that
// advances one word every 16 rows.
template <int NK>
struct BWindow {
  static constexpr int NA = NK > 0 ? (NK + 15) / 16 : 1;
  uint32_t raw[NA + 1];
  uint32_t al[NA];
  int q;  // word index of raw[0]
  __device__ __forceinline__ void start(const int32_t* __restrict__ brow, int nw, int t) {
    q = t >> 4;  // floor, t may be negative
#pragma unroll
    for (int c = 0; c <= NA; ++c) raw[c] = word_at(brow, nw, q + c);
  }
  // the window of row t (t = j - 1 of column 0), t one more than last row's
  __device__ __forceinline__ void advance(const int32_t* __restrict__ brow, int nw, int t) {
    if ((t & 15) == 0) {
      ++q;
#pragma unroll
      for (int c = 0; c < NA; ++c) raw[c] = raw[c + 1];
      raw[NA] = word_at(brow, nw, q + NA);
    }
  }
  __device__ __forceinline__ void align(int t) {
    const int sh = 2 * (t & 15);
#pragma unroll
    for (int c = 0; c < NA; ++c) al[c] = __funnelshift_r(raw[c], raw[c + 1], sh);
  }
  __device__ __forceinline__ uint32_t code(int k) const {
    return (al[k >> 4] >> (2 * (k & 15))) & 3u;
  }
};

template <int NK, bool EXACT, class W, class BI, class BW>
__device__ __forceinline__ void phase2_row(BI& Dp, BI& Tp, BW& Ep, BW& Fp, BI& Dq, BI& Tq,
                                           BW& Eq, BW& Fq, const BWindow<NK>& win,
                                           const int32_t* __restrict__ brow, int wpr,
                                           const RowScores& rs, uint32_t a, int u, int t,
                                           int blen, int w, int gO, int gE, int& best,
                                           W& bpos, W& bs, W& bc) {
  constexpr bool REG = NK > 0;
  const int nk = REG ? NK : w + 1;
  const W rb = Word<W>::pos(u, 0);
  const W edge = Word<W>::pos(u - 1, w + 1);  // Y's predecessor past column w
  int h = 0;         // max(max(M, Y) + gO, X, 0) at column k - 1, this row
  W ecl = 0, fcl = 0;  // E and F at column k - 1, this row
  // in band: 1 <= j <= |B|, and a capacity instance's columns past w are out
  // of it (so they feed no column <= w and stay out of the best)
  const int lim = REG && !EXACT ? max(min(blen, t + w + 1), 0) : blen;
#pragma unroll
  for (int k = 0; k < nk; ++k) {
    const bool last = EXACT ? k == NK - 1 : k == w;
    // column k + 1, kept inside the band (its value is not used where k is last)
    const int k1 = REG ? (k + 1 >= NK ? k : k + 1) : (last ? k : k + 1);
    const uint32_t b = REG ? win.code(k) : code_at(brow, wpr, t + k);
    const int sub = score<REG>(rs, REG ? score_sel(b) : b);
    const bool inb = (unsigned)(t + k) < (unsigned)lim;
    const int m = inb ? sub + Dp[k] : 0;
    const int y = (inb && !last) ? Tp[k1] : 0;
    const int x = (inb && k > 0) ? gE + h : 0;
    const int mx = max3(m, x, y);
    const bool is_m = m == mx;
    const bool is_x = k > 0 && x == mx;
    // M: (u-1, k), X: (u, k-1), Y: (u-1, k+1); +1 correct on an M match,
    // else +1 error
    const W ey = last ? edge : Ep[k1];
    const W fy = last ? (W)0 : Fp[k1];
    const W s = is_m ? Ep[k] : (is_x ? ecl : ey);
    const W c = (is_m ? Fp[k] : (is_x ? fcl : fy)) + ((is_m && a == b) ? Word<W>::ONE_HI : (W)1);
    const W pk = rb + (W)k;
    const bool live = mx > 0;
    const W e = live ? s : pk;
    const W f = live ? c : (W)0;
    const bool up = mx > best;
    best = up ? mx : best;
    bpos = up ? pk : bpos;
    bs = up ? s : bs;
    bc = up ? c : bc;
    h = max3(max(m, y) + gO, x, 0);
    Tq[k] = gE + max3(max(m, x) + gO, y, 0);
    Dq[k] = max(mx, 0);
    Eq[k] = e;
    Fq[k] = f;
    ecl = e;
    fcl = f;
  }
}

template <int NK, bool EXACT, class W, class BI, class BW>
__device__ __forceinline__ void phase2_pair(BI& D0, BI& T0, BW& E0, BW& F0, BI& D1, BI& T1,
                                            BW& E1, BW& F1, const Shared& sh,
                                            const int32_t* __restrict__ arow,
                                            const int32_t* __restrict__ brow, int wpr,
                                            int ds, int n_rows, int blen, int w,
                                            int zero_row, int gO, int gE, int32_t* out,
                                            int P, int p) {
  constexpr bool REG = NK > 0;
  const int nk = REG ? NK : w + 1;
  const int t0 = gE + max(gO, 0);  // T of the all-zero row 0
#pragma unroll
  for (int k = 0; k < nk; ++k) {
    D0[k] = 0;
    T0[k] = t0;
    E0[k] = Word<W>::pos(0, k);
    F0[k] = 0;
  }
  int best = 0;
  W bpos = 0, bs = 0, bc = 0;
  BWindow<NK> win;
  if constexpr (REG) win.start(brow, wpr, -zero_row);
  uint32_t aword = 0;
  for (int u = 1; u <= n_rows; u += 2) {
    // rows u and u + 1: P -> Q, then Q -> P
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int uu = u + half;
      if (half == 1 && uu > n_rows) break;
      const int r = ds + uu - 1;  // dove-shifted A row
      if (uu == 1 || (r & 15) == 0) aword = word_at(arow, wpr, r >> 4);
      const uint32_t a = r >= 0 ? (aword >> (2 * (r & 15))) & 3u : 0u;
      const int t = uu - 1 - zero_row;  // j - 1 of column 0
      if constexpr (REG) {
        if (uu > 1) win.advance(brow, wpr, t);
        win.align(t);
      }
      if (half == 0)
        phase2_row<NK, EXACT, W>(D0, T0, E0, F0, D1, T1, E1, F1, win, brow, wpr,
                                 row_scores(sh, a), a, uu, t, blen, w, gO, gE, best, bpos,
                                 bs, bc);
      else
        phase2_row<NK, EXACT, W>(D1, T1, E1, F1, D0, T0, E0, F0, win, brow, wpr,
                                 row_scores(sh, a), a, uu, t, blen, w, gO, gE, best, bpos,
                                 bs, bc);
    }
  }
  const size_t st = (size_t)P;
  out[0 * st + p] = best;
  out[1 * st + p] = Word<W>::hi(bpos);
  out[2 * st + p] = Word<W>::lo(bpos);
  out[3 * st + p] = Word<W>::hi(bs);
  out[4 * st + p] = Word<W>::lo(bs);
  out[5 * st + p] = Word<W>::hi(bc);
  out[6 * st + p] = Word<W>::lo(bc);
}

template <int NK, bool EXACT, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1) phase2_kernel(
    const int32_t* __restrict__ packed, const int32_t* __restrict__ a_idx,
    const int32_t* __restrict__ b_idx, const int32_t* __restrict__ ds,
    const int32_t* __restrict__ dlen, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ out, void* scratch, int P, int wpr, int rows, int w, int zero_row,
    int gO, int gE, CostMatrix cm, int ulen) {
  using W = typename std::conditional<WIDE, uint64_t, uint32_t>::type;
  __shared__ Shared sh;
  load_scores(sh, cm);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int ib = __ldg(b_idx + p);
  const int32_t* arow = packed + (size_t)__ldg(a_idx + p) * wpr;
  const int32_t* brow = packed + (size_t)ib * wpr;
  // rows past the lane's dove length are masked: they cannot change any output
  const int n_rows = min(rows, __ldg(dlen + p));
  const int bl = ulen > 0 ? ulen : __ldg(lengths + ib);
  const int d = __ldg(ds + p);
  if constexpr (NK > 0) {
    RegBand<int, NK> D0, T0, D1, T1;
    RegBand<W, NK> E0, F0, E1, F1;
    phase2_pair<NK, EXACT, W>(D0, T0, E0, F0, D1, T1, E1, F1, sh, arow, brow, wpr, d, n_rows,
                              bl, w, zero_row, gO, gE, out, P, p);
  } else {
    const size_t plane = (size_t)(w + 1) * P;
    W* wp = static_cast<W*>(scratch);
    int* ip = reinterpret_cast<int*>(wp + 4 * plane);
    ScratchBand<W> E0{wp + p, P}, F0{wp + plane + p, P}, E1{wp + 2 * plane + p, P},
        F1{wp + 3 * plane + p, P};
    ScratchBand<int> D0{ip + p, P}, T0{ip + plane + p, P}, D1{ip + 2 * plane + p, P},
        T1{ip + 3 * plane + p, P};
    phase2_pair<0, false, W>(D0, T0, E0, F0, D1, T1, E1, F1, sh, arow, brow, wpr, d, n_rows,
                             bl, w, zero_row, gO, gE, out, P, p);
  }
}

CostMatrix load_cm(const int32_t* cm) {
  CostMatrix c;
  for (int i = 0; i < 16; ++i) c.v[i] = cm[i];
  return c;
}

bool scores_fit_16_bits(const int32_t* cm) {
  for (int i = 0; i < 16; ++i)
    if (cm[i] < -32768 || cm[i] > 32767) return false;
  return true;
}

// The instance a launch takes, from its band columns (phase 1: w, phase 2:
// w + 1), its rows and its scores.
enum Instance { kExactA, kExactB, kCap24, kCap32, kCap48, kCap64, kGeneral, kWide, kRefused };

Instance pick(int cols, int rows, const int32_t* cm, int exact_a, int exact_b) {
  if (cols < 1 || rows < 0 || rows > kMaxRowsWide || cols > kMaxRowsWide) return kRefused;
  if (rows > kMaxRows || cols > kMaxRows) return kWide;
  if (!scores_fit_16_bits(cm)) return kGeneral;
  if (cols == exact_a) return kExactA;
  if (cols == exact_b) return kExactB;
  if (cols <= 24) return kCap24;
  if (cols <= 32) return kCap32;
  if (cols <= 48) return kCap48;
  return cols <= 64 ? kCap64 : kGeneral;
}

// scratch int32 words: W planes (2 a W for wide) then int planes
long long scratch_words(Instance in, int cols, int P, int w_planes, int i_planes) {
  if (in != kGeneral && in != kWide) return 0;
  const long long plane = (long long)cols * P;
  return plane * (w_planes * (in == kWide ? 2 : 1) + i_planes);
}

}  // namespace

// Scratch (int32 words) a launch needs: 0 for the register instances, -1 if
// the launch is refused (too many rows or columns).
extern "C" long long phase1_scratch_words(int P, int w, int la_max, const int32_t* cm) {
  const Instance in = pick(w, la_max, cm, 12, 16);
  return in == kRefused ? -1 : scratch_words(in, w, P, 2, 5);
}

extern "C" long long phase2_scratch_words(int P, int w, int rows, const int32_t* cm) {
  const Instance in = pick(w + 1, rows, cm, 13, 17);
  return in == kRefused ? -1 : scratch_words(in, w + 1, P, 4, 4);
}

// Which instance a launch takes: 0 / 1 the exact widths, 2-5 the capacity
// instances of 24, 32, 48 and 64 columns, 6 general, 7 wide, 8 refused.
extern "C" int phase1_instance(int w, int la_max, const int32_t* cm) {
  return (int)pick(w, la_max, cm, 12, 16);
}

extern "C" int phase2_instance(int w, int rows, const int32_t* cm) {
  return (int)pick(w + 1, rows, cm, 13, 17);
}

// out: [5, P] int32 (best, bi, bj, fi, fj).  Returns cudaGetLastError().
extern "C" int phase1_launch(const int32_t* packed, const int32_t* a_idx,
                             const int32_t* b_idx, const int32_t* lengths, int32_t* out,
                             void* scratch, int P, int wpr, int la_max, int w, int gO, int gE,
                             const int32_t* cm, int ulen, void* stream) {
  const Instance in = pick(w, la_max, cm, 12, 16);
  if (P <= 0 || wpr < 1 || in == kRefused) return (int)cudaErrorInvalidValue;
  if ((in == kGeneral || in == kWide) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const CostMatrix c = load_cm(cm);
#define P1_ARGS packed, a_idx, b_idx, lengths, out, scratch, P, wpr, la_max, w, gO, gE, c, ulen
  switch (in) {
    case kExactA: phase1_kernel<12, true, false><<<grid, block, 0, s>>>(P1_ARGS); break;
    case kExactB: phase1_kernel<16, true, false><<<grid, block, 0, s>>>(P1_ARGS); break;
    case kCap24: phase1_kernel<24, false, false><<<grid, block, 0, s>>>(P1_ARGS); break;
    case kCap32: phase1_kernel<32, false, false><<<grid, block, 0, s>>>(P1_ARGS); break;
    case kCap48: phase1_kernel<48, false, false><<<grid, block, 0, s>>>(P1_ARGS); break;
    case kCap64: phase1_kernel<64, false, false><<<grid, block, 0, s>>>(P1_ARGS); break;
    case kGeneral: phase1_kernel<0, false, false><<<grid, block, 0, s>>>(P1_ARGS); break;
    default: phase1_kernel<0, false, true><<<grid, block, 0, s>>>(P1_ARGS); break;
  }
#undef P1_ARGS
  return (int)cudaGetLastError();
}

// out: [7, P] int32 (best, bu, bk, uf, kf, corr, err).  Returns cudaGetLastError().
extern "C" int phase2_launch(const int32_t* packed, const int32_t* a_idx,
                             const int32_t* b_idx, const int32_t* ds, const int32_t* dlen,
                             const int32_t* lengths, int32_t* out, void* scratch, int P,
                             int wpr, int rows, int w, int zero_row, int gO, int gE,
                             const int32_t* cm, int ulen, void* stream) {
  const Instance in = pick(w + 1, rows, cm, 13, 17);
  if (P <= 0 || wpr < 1 || in == kRefused) return (int)cudaErrorInvalidValue;
  if ((in == kGeneral || in == kWide) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const CostMatrix c = load_cm(cm);
#define P2_ARGS \
  packed, a_idx, b_idx, ds, dlen, lengths, out, scratch, P, wpr, rows, w, zero_row, gO, gE, c, ulen
  switch (in) {
    case kExactA: phase2_kernel<13, true, false><<<grid, block, 0, s>>>(P2_ARGS); break;
    case kExactB: phase2_kernel<17, true, false><<<grid, block, 0, s>>>(P2_ARGS); break;
    case kCap24: phase2_kernel<24, false, false><<<grid, block, 0, s>>>(P2_ARGS); break;
    case kCap32: phase2_kernel<32, false, false><<<grid, block, 0, s>>>(P2_ARGS); break;
    case kCap48: phase2_kernel<48, false, false><<<grid, block, 0, s>>>(P2_ARGS); break;
    case kCap64: phase2_kernel<64, false, false><<<grid, block, 0, s>>>(P2_ARGS); break;
    case kGeneral: phase2_kernel<0, false, false><<<grid, block, 0, s>>>(P2_ARGS); break;
    default: phase2_kernel<0, false, true><<<grid, block, 0, s>>>(P2_ARGS); break;
  }
#undef P2_ARGS
  return (int)cudaGetLastError();
}
