// The B1 substep as the cost probes P3 and P4 time it, for Hopper.
//
// Replaces the Pallas TPU probe kernels scripts/wave_probe.py:make_waves
// (P3, pallas_call at :266) and scripts/skew_probe.py:make_current,
// make_skewed, make_current_ival and make_skewed_ival (P4, pallas_call
// at :639).  Contract, shared with the plain PyTorch version
// agatha_tpu_torch/probes/substep_probe.py:plain:
//   meta  (N, 2) int32  [qlen, rlen] per pair
//   out   (N, 4) int32  [ms, mr, mq, diags], folded over the waves
//   state (N, S) int32  optional: the final scratch, per wave hfa, hfb,
//                       fst, est, qwin, tb (W lanes each), then each
//                       wave's qfw and, skewed, tfw (384 lanes each)
// bit-identical to the plain version, outputs and state.  Every
// instance runs all 8 * n_diags substeps (the originals never stop).
//
// Mapping: the tile kernel's (antidiag.cu), so that the probe's switches
// say something about B2.  Every lane runs every substep, so a pair's
// lanes x substeps form a grid.  In the coordinates (lane l, q = d - l),
// d the substep, every array a cell reads comes from (l, q - 1),
// (l, q - 2), (l - 1, q) or (l - 1, q - 1), in both frames, so the grid
// cut into 8x8 tiles (tile row pr: lanes 8pr..8pr+7; tile column pc: q in
// 8pc..8pc+7) is computed exactly by a wavefront over tile diagonals, as
// B2 computes the DP's.  One block per pair, one thread per tile row (W /
// 8 threads, rounded up to a whole warp; the threads past the last tile
// row compute nothing, so every shuffle takes the full mask).  Step D
// computes tile (pr, D - pr) in registers: its cells lie at substeps
// 8D + ro + co, those with ro + co <= 7 in packed diagonal D, the others
// in D + 1, whose slice bounds, masks, chunk starts and fake rows they
// take.  Steps run from D = -1, whose cells before substep 0 hold the
// initial state, to n_diags - 1, whose cells past the last substep are
// not computed.  In the skewed frame a cell's row follows from its
// substep (r = r_lo(d) + l), and the parity of ro + co says which arrays
// moved a lane, so every dependency is fixed at compile time.
// Hand-offs, once a step: a thread keeps its tile row's right column(s)
// in registers for its next tile, and a tile's bottom row (H, and qwin
// and E, or in the skewed frame by column parity qwin and E or H, F and
// tb) goes to the row below by __shfl_up_sync within a warp and through
// shared memory across warps, behind the step's one __syncthreads (none
// when a pair is one warp, W <= 256).  Lane 0's row above is the plain
// version's boundary: H, E and F MINUS_INF2, qwin and tb the feeds, read
// in closed form (the feeds are never written).  Per-diagonal maxima:
// each thread folds tile D's cells with ro + co <= 7 and its tile
// D - 1's with ro + co >= 8 into 8 packed maxima per wave, reduced by
// redux.sync per warp and across warps through a triple-buffered shared
// array, so every thread runs the 8 diagonals' bookkeeping in order with
// the same registers.  With n_waves waves a thread owns tile row pr of
// every wave: n_waves independent tiles a step.  The final state is
// stored by the cells of the last two substeps, in the last step.
//
// What bounds it on this card: not memory (a launch reads 8 bytes and
// writes 16 per pair, and the state when asked).  The contract runs every
// lane on every substep, so some 12-15 integer instructions a
// lane-substep for the recurrence and the masks, whatever the masks say
// (the operation bound counts C-true cells only).  At P3's shape (4096
// pairs of one warp, several blocks an SM) that is issue, and the design
// replaces a substep's exchanges, two reductions and barrier by one
// hand-off and 8 warp reductions per 64 cells.  At P4's (128 pairs of 4
// warps, one block an SM) it is the latency of a step: a tile's chain and
// one barrier per 8 substeps in place of 8.  On an H100 SXM at 700 W, P3's
// base variant takes ~0.51 ms a launch (a contract floor of 0.23 at 12
// operations a lane-substep), and a P4 step ~2.4 us (~4800 cycles), of
// which the floor is ~0.75 us.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "antidiag_common.cuh"

namespace {

constexpr int kLane = 128;         // the TPU lane width: the feed window
constexpr int kFeedW = 3 * kLane;  // width of the qfw / tfw scratch
constexpr int kSW = 3;
constexpr int kBW = 751;
constexpr int kGOE = 8;
constexpr int kGE = 2;
constexpr int kMatch = 1;
constexpr int kMism = 4;
constexpr int kZ = 400;
constexpr int kCBW = (kBW + 7) / 8;  // ceil(bw / 8)
constexpr int kFBW = (kBW + 7) >> 3;
constexpr int kMaxThreads = 128;     // W / 8 at W = 1024
constexpr int kMaxWarps = kMaxThreads / 32;

// x << s on int32 bits, as XLA computes it (no signed overflow)
__device__ __forceinline__ int shl(int x, int s) {
  return static_cast<int>(static_cast<uint32_t>(x) << s);
}

struct Book {
  int ms, mr, mq, term, diags;
};

// The Z-drop bookkeeping of one substep from the pair's row max.
__device__ __forceinline__ void book_step(Book& b, int dmax, int d) {
  const bool live = b.term == 0;
  const int th = dmax >> 16;
  const int tr = dmax & 0xFFFF;
  const int dq = d - tr;
  const bool upd = live && th > b.ms;
  const bool zel = live && !(th > b.ms) && tr >= b.mr && dq >= b.mq;
  const int gap = abs((tr - b.mr) - (dq - b.mq));
  if (zel && b.ms - th > kZ + gap * kGE) b.term = 1;
  if (upd) {
    b.ms = th;
    b.mr = tr;
    b.mq = dq;
  }
  b.diags += live ? 1 : 0;
}

// Slice / chunk terms of the cell-by-cell masks for row r.
struct CellTerms {
  bool xa, xb, ya, yb, csea;
};

__device__ __forceinline__ CellTerms cell_terms(int r, int D, int i1, int pql,
                                                int ss1, int se1, int ss2,
                                                int se2) {
  const int pr = r >> 3;
  const int cs = max(0, (pr << 3) - kBW) >> 3;
  const int ce = min(pql - 1, ((pr << 3) + (7 + kBW)) >> 3);
  const int pqa = D - pr;
  const int pqb = pqa - 1;
  CellTerms t;
  t.xa = pr >= ss1 && pr <= se1 && pqa >= cs && pqa <= ce;
  t.xb = pr >= ss2 && pr <= se2 && pqb >= cs && pqb <= ce;
  t.ya = t.xa && pqa > cs && pqa < ce;
  t.yb = t.xb && pqb > cs && pqb < ce;
  t.csea = pqa == max(cs, i1 - pr);
  return t;
}

// C of row r at substep k (base antidiagonal d), and the chunk-start
// test cst, from the cell-by-cell terms; ro is r & 7, which the caller
// may know at compile time.
__device__ __forceinline__ bool cell_mask(const CellTerms& t, int r, int ro,
                                          int d, int k, int qlen, bool& cst) {
  const int qq = d - r;
  const bool in_band = abs(d - 2 * r) <= kBW;
  cst = ro == k && qq >= 0 && t.csea;
  const bool z = ro > k ? t.yb || (t.xb && in_band)
                        : t.ya || (t.xa && in_band);
  return qq >= 0 && qq < qlen && z;
}

// Per-pair interval bounds of one packed diagonal (rows, not octets).
struct Ival {
  int alo, ahi, aylo, ayhi, blo, bhi, bylo, byhi, cr;
};

__device__ __forceinline__ void chunk_iv(int Dv, int ss, int se, int pql,
                                         int& lo3, int& hi3, int& ylo3,
                                         int& yhi3) {
  const int lo = max(max(Dv - pql + 1, (Dv - kFBW + 1) >> 1), ss);
  const int hi = min(min(Dv, (Dv + kCBW) >> 1), se);
  lo3 = shl(lo, 3);
  hi3 = shl(hi, 3) + 7;
  ylo3 = shl(lo + 1, 3);
  yhi3 = shl(hi - 1, 3) + 7;
}

__device__ __forceinline__ Ival ival_bounds(int D, int i1, int pql, int ss1,
                                            int se1, int ss2, int se2) {
  Ival v;
  chunk_iv(D, ss1, se1, pql, v.alo, v.ahi, v.aylo, v.ayhi);
  chunk_iv(D - 1, ss2, se2, pql, v.blo, v.bhi, v.bylo, v.byhi);
  const int la = v.alo >> 3;
  v.cr = shl(max(la, i1 - (D - la)), 3);
  return v;
}

// C and cst from the interval bounds: two range tests per row (ro as in
// cell_mask).
__device__ __forceinline__ bool ival_mask(const Ival& v, int r, int ro, int d,
                                          int k, int qlen, bool& cst) {
  const int bandlo = (d - kBW + 1) >> 1;
  const int bandhi = (d + kBW) >> 1;
  const int vlo = d - qlen + 1;
  const int lo_a = max(min(v.aylo, max(v.alo, bandlo)), vlo);
  const int hi_a = min(max(v.ayhi, min(v.ahi, bandhi)), d);
  const int lo_b = max(min(v.bylo, max(v.blo, bandlo)), vlo);
  const int hi_b = min(max(v.byhi, min(v.bhi, bandhi)), d);
  cst = ro == k && r >= v.cr && r <= v.cr + 7;
  return ro > k ? r >= lo_b && r <= hi_b : r >= lo_a && r <= hi_a;
}

// What the masks of packed diagonal Dp need (one wave): the slice start
// i1, the slice bounds at i1 and at the previous slice's start i2, and
// with interval masks the bounds (the first step's Dp = -1 serves only
// cells before substep 0, which read no mask).
struct DiagMasks {
  int i1, ss1, se1, ss2, se2;
  Ival iv;
};

template <bool kIval>
__device__ __forceinline__ DiagMasks diag_masks(int Dp, int pql, int prl) {
  DiagMasks m;
  m.i1 = Dp / kSW * kSW;
  const int i2 = Dp == m.i1 ? m.i1 - kSW : m.i1;
  slice_bounds(m.i1, pql, prl, kSW, kBW, m.ss1, m.se1);
  slice_bounds(i2, pql, prl, kSW, kBW, m.ss2, m.se2);
  if constexpr (kIval) {
    m.iv = ival_bounds(Dp, m.i1, pql, m.ss1, m.se1, m.ss2, m.se2);
  }
  return m;
}

// The arrays a cell holds: H (the cell's h_out), qwin, E, F, tb.
enum Arr { kH, kQ, kE, kF, kT, kNArr };

// Whether a tile's bottom row hands array a at column c to the row below:
// current frame H, qwin and E (qwin and E move down a column, H down a
// diagonal); skewed frame, by the parity of the cell below (that of c + 1),
// qwin and E to even cells, F and tb to odd cells, and H to the even cell
// one column on.
template <bool kSkewed>
__device__ __forceinline__ bool handed(int a, int c) {
  if (!kSkewed) return a == kH || a == kQ || a == kE;
  return (c & 1) ? (a == kH || a == kF || a == kT) : (a == kQ || a == kE);
}

// A thread's registers for one wave.
struct Wave {
  int qlen, rlen, pql, prl;
  // its last tile's right column (col -1 of the next tile) by row, and H
  // of the column before (col -2)
  int lh1[8], lh2[8], lq[8], le[8], lf[8], lt[8];
  int top[kNArr][8];  // the tile above's bottom row (row -1), by column
  int corner;         // H at row -1, column -1
  int cmax[7];        // tile D - 1's maxima on packed diagonal D
  Book bk;
};

enum Part { kFirst, kMid, kLast };

// The row above lane 0 for its tile at step D: the plain version's lane-0
// boundary.
__device__ __forceinline__ void top_boundary(Wave& v, int D, int w) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int d = (D << 3) + c;  // the substep of lane 0's cell (0, c)
    v.top[kH][c] = v.top[kE][c] = v.top[kF][c] = kMinusInf2;
    v.top[kQ][c] = (d + w) & 3;  // qfw[(k + phase) & 127]
    v.top[kT][c] = d & 3;        // tfw[(k + phase) & 127]
  }
}

// Thread pr's tile of wave w at step D (columns pc = D - pr): the cells'
// recurrence, folded into dm (by ro + co) and, at the last step, the
// final state into st (the wave's part of the state row) unless it is
// null; leaves the tile's bottom row in `bottom`.
template <bool kSkewed, bool kIval, int kPart>
__device__ __forceinline__ void tile(Wave& v, int w, int D, int pr, int W,
                                     const DiagMasks& m0,
                                     const DiagMasks& m1, int (&dm)[15],
                                     int (&bottom)[kNArr][8], int32_t* st) {
  // The cell masks' slice / chunk terms depend on a row's octet r >> 3.
  // A cell's row is r = base + o: in the current frame (r = l) o = ro, so
  // a tile's rows are one octet, pr; in the skewed frame o = ro +
  // ((ro + co + 1) >> 1), so they lie in three.  Each octet's terms for
  // packed diagonal D (the cells with ro + co <= 7) and D + 1 (the
  // others) are packed 5 bits an octet, once a tile.
  constexpr int kOctets = kSkewed ? 3 : 1;
  const int base = kSkewed ? 4 * D + 8 * pr : 8 * pr;
  int terms[2] = {0, 0};
  if constexpr (!kIval) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const DiagMasks& m = u == 0 ? m0 : m1;
#pragma unroll
      for (int i = 0; i < kOctets; ++i) {
        const CellTerms t = cell_terms(((base >> 3) + i) << 3, D + u, m.i1,
                                       v.pql, m.ss1, m.se1, m.ss2, m.se2);
        terms[u] |= (t.xa | t.xb << 1 | t.ya << 2 | t.yb << 3 | t.csea << 4)
                    << (5 * i);
      }
    }
  }

  int up[kNArr][8];  // row ro - 1, by column
  int upc = v.corner;  // H at row ro - 1, column -1
#pragma unroll
  for (int a = 0; a < kNArr; ++a) {
#pragma unroll
    for (int c = 0; c < 8; ++c) up[a][c] = v.top[a][c];
  }
#pragma unroll
  for (int ro = 0; ro < 8; ++ro) {
    const int l = (pr << 3) + ro;
    // the row's values at columns co - 1 (and H at co - 2)
    int h1 = v.lh1[ro], h2 = v.lh2[ro];
    int ql = v.lq[ro], el = v.le[ro], fl = v.lf[ro], tl = v.lt[ro];
    int nx[kNArr][8];
    const int nxc = h1;
    if (kPart == kLast && ro == 7 && st != nullptr) {
      // the second-last substep's H of lane l lies in the previous tile
      if (kSkewed) {
        if (l + 1 < W) st[W + l + 1] = h1;
      } else {
        st[W + l] = h1;
      }
    }
#pragma unroll
    for (int co = 0; co < 8; ++co) {
      const int j = ro + co;
      const bool upper = j < 8;
      int h, e, f, q, t;
      if (kPart == kFirst && upper) {
        // before substep 0: the initial state, as the cells at substeps
        // -1 (hfa) and -2 (hfb, one lane on in the skewed frame, which
        // reads it before its first roll) hold it
        h = j == 7 ? l + w : l + (kSkewed ? 2 : 1) + w;
        e = f = kMinusInf2;
        q = (l + w) & 3;
        t = ((l + w) >> 2) & 3;
      } else if (kPart == kLast && !upper) {
        h = e = f = q = t = 0;  // past the last substep: not computed
      } else {
        const int d = (D << 3) + j;
        const int k = j & 7;
        const bool odd = kSkewed && (j & 1);
        const int hdiag = co == 0 ? upc : up[kH][co - 1];
        int qwin, tb, htl, e_in, f_in;
        if (!kSkewed) {  // qwin and E from above, F from the left
          qwin = up[kQ][co];
          tb = ((l + w) >> 2) & 3;
          htl = hdiag;
          e_in = up[kE][co];
          f_in = fl;
        } else if (odd) {  // tb and F moved a lane; H is the lane's own
          qwin = ql;
          e_in = el;
          htl = h2;
          f_in = up[kF][co];
          tb = up[kT][co];
        } else {  // qwin and E moved a lane
          qwin = up[kQ][co];
          e_in = up[kE][co];
          htl = hdiag;
          f_in = fl;
          tb = tl;
        }
        const int o = kSkewed ? ro + ((j + 1) >> 1) : ro;
        const int r = base + o;
        const int rro = kSkewed ? ((base & 7) + o) & 7 : ro;  // r & 7
        bool C, cst, fake, prev_fake;
        if constexpr (kIval) {
          C = ival_mask((upper ? m0 : m1).iv, r, rro, d, k, v.qlen, cst);
        } else {
          // the terms of r's octet, (r >> 3) - (base >> 3) of the tile's
          const int f = kSkewed ? terms[upper ? 0 : 1] >>
                                      (5 * (((base & 7) + o) >> 3))
                                : terms[upper ? 0 : 1];
          const CellTerms t{(f & 1) != 0, (f & 2) != 0, (f & 4) != 0,
                            (f & 8) != 0, (f & 16) != 0};
          C = cell_mask(t, r, rro, d, k, v.qlen, cst);
        }
        if constexpr (kIval) {
          fake = prev_fake = true;
        } else {
          fake = r >= v.rlen;
          prev_fake = r > v.rlen;
        }
        if (cst && prev_fake) htl = kMinusInf2;
        if (cst && fake) f_in = kMinusInf2;
        int s = tb == kNValue ? -kNPenalty : (qwin == tb ? kMatch : -kMism);
        if (qwin == kNValue) s = -kNPenalty;
        const int temp = htl + s;
        const int h_new = __vimax3_s32(temp, f_in, e_in);
        const int tg = temp - kGOE;
        h = C ? h_new : htl;
        e = C ? __viaddmax_s32(e_in, -kGE, tg) : e_in;
        f = C ? __viaddmax_s32(f_in, -kGE, tg) : f_in;
        q = qwin;
        t = tb;
        // (h_new << 16) + r wrapped like int32
        const int packed = static_cast<int>(
            (static_cast<uint32_t>(h_new) << 16) + static_cast<uint32_t>(r));
        dm[j] = max(dm[j], C ? packed : INT_MIN);
        if (kPart == kLast && j == 7 && st != nullptr) {  // last (odd)
          st[l] = h;                     // hfa
          st[2 * W + l] = f;
          if (kSkewed) {
            st[3 * W + l] = e;
          } else {  // est holds E moved one lane, lane 0 lane W - 1's
            st[3 * W + (l + 1 == W ? 0 : l + 1)] = e;
          }
          st[4 * W + l] = q;
          st[5 * W + l] = t;
        }
        if (kPart == kLast && j == 6 && st != nullptr) {  // hfb (even)
          if (kSkewed) {  // rolled one lane at the last substep
            if (l + 1 < W) st[W + l + 1] = h;
          } else {
            st[W + l] = h;
          }
        }
      }
      nx[kH][co] = h;
      nx[kQ][co] = q;
      nx[kE][co] = e;
      nx[kF][co] = f;
      nx[kT][co] = t;
      h2 = h1;
      h1 = h;
      ql = q;
      el = e;
      fl = f;
      tl = t;
    }
    v.lh1[ro] = h1;
    v.lh2[ro] = h2;
    v.lq[ro] = ql;
    v.le[ro] = el;
    v.lf[ro] = fl;
    v.lt[ro] = tl;
    upc = nxc;
#pragma unroll
    for (int a = 0; a < kNArr; ++a) {
#pragma unroll
      for (int c = 0; c < 8; ++c) up[a][c] = nx[a][c];
    }
  }
#pragma unroll
  for (int a = 0; a < kNArr; ++a) {
#pragma unroll
    for (int c = 0; c < 8; ++c) bottom[a][c] = up[a][c];
  }
}

// Shared arrays of a block: the bottom rows that cross a warp boundary
// (by step parity) and each warp's 8 packed maxima (by step mod 3).
template <int NW>
struct Shared {
  int hand[2][NW][kMaxWarps][kNArr * 8];
  int red[3][NW][kMaxWarps][8];
};

// Step D of every wave: the tiles, the hand-off of their bottom rows,
// and (from D = 0) the 8 diagonals' maxima and bookkeeping.  A wave
// keeps ~60 registers a thread besides a tile's, so 4 waves spill some;
// a loop that took them one after another, their state in local memory,
// ran 2.3x slower on an H100, so every instance interleaves its waves.
template <int NW, bool kSkewed, bool kIval, int kPart>
__device__ __forceinline__ void step(Wave (&v)[NW], Shared<NW>& sh, int D,
                                     int W, int32_t* row) {
  const int pr = threadIdx.x;
  const int warp = pr >> 5;
  const int lane = pr & 31;
  const int nwarps = ((W >> 3) + 31) >> 5;
  const bool active = pr < (W >> 3);
  int dm[NW][15];
  int bottom[NW][kNArr][8];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
#pragma unroll
    for (int j = 0; j < 15; ++j) {
      dm[w][j] = kPart != kFirst && j < 7 ? v[w].cmax[j] : INT_MIN;
    }
    if (active) {
      const DiagMasks m0 = diag_masks<kIval>(D, v[w].pql, v[w].prl);
      const DiagMasks m1 = diag_masks<kIval>(D + 1, v[w].pql, v[w].prl);
      tile<kSkewed, kIval, kPart>(
          v[w], w, D, pr, W, m0, m1, dm[w], bottom[w],
          row == nullptr ? nullptr : row + 6 * w * W);
    } else {
#pragma unroll
      for (int a = 0; a < kNArr; ++a) {
#pragma unroll
        for (int c = 0; c < 8; ++c) bottom[w][a][c] = 0;
      }
    }
  }

  if (kPart != kLast) {  // the bottom rows to the rows below
    const int buf = (D + 1) & 1;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      v[w].corner = v[w].top[kH][7];
#pragma unroll
      for (int a = 0; a < kNArr; ++a) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (!handed<kSkewed>(a, c)) continue;
          v[w].top[a][c] = __shfl_up_sync(~0u, bottom[w][a][c], 1);
          if (nwarps > 1 && lane == 31) {
            sh.hand[buf][w][warp][a * 8 + c] = bottom[w][a][c];
          }
        }
      }
    }
  }
  int mx[NW][8];
  const int par = (D + 3) % 3;
  if (kPart != kFirst) {  // packed diagonal D's maxima, per warp
#pragma unroll
    for (int w = 0; w < NW; ++w) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        mx[w][k] = __reduce_max_sync(~0u, dm[w][k]);
        if (nwarps > 1 && lane == 0) sh.red[par][w][warp][k] = mx[w][k];
      }
    }
  }
  if (kPart != kLast) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
#pragma unroll
      for (int k = 0; k < 7; ++k) v[w].cmax[k] = dm[w][8 + k];
    }
  }
  if (nwarps > 1) __syncthreads();
  if (kPart != kLast) {
    const int buf = (D + 1) & 1;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (nwarps > 1 && lane == 0 && warp > 0) {
#pragma unroll
        for (int a = 0; a < kNArr; ++a) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if (handed<kSkewed>(a, c)) {
              v[w].top[a][c] = sh.hand[buf][w][warp - 1][a * 8 + c];
            }
          }
        }
      }
      if (pr == 0) top_boundary(v[w], D + 1, w);
    }
  }
  if (kPart != kFirst) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (nwarps > 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k) mx[w][k] = INT_MIN;
        for (int wp = 0; wp < nwarps; ++wp) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            mx[w][k] = max(mx[w][k], sh.red[par][w][wp][k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) book_step(v[w].bk, mx[w][k], (D << 3) + k);
    }
  }
}

template <int NW, bool kSkewed, bool kIval>
__global__ void __launch_bounds__(kMaxThreads)
substep_kernel(const int32_t* __restrict__ meta, int32_t* __restrict__ out,
               int32_t* __restrict__ state, int W, int n_diags) {
  static_assert(NW == 1 || (!kSkewed && !kIval),
                "waves run the current frame with cell masks");
  __shared__ Shared<NW> sh;
  const int pr = threadIdx.x;
  const int pair = blockIdx.x;
  const int width = 6 * NW * W + (NW + (kSkewed ? 1 : 0)) * kFeedW;
  int32_t* const row =
      state == nullptr ? nullptr : state + static_cast<size_t>(pair) * width;

  Wave v[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    v[w].qlen = meta[2 * pair] + w;
    v[w].rlen = meta[2 * pair + 1] + w;
    v[w].pql = (v[w].qlen + 7) >> 3;
    v[w].prl = (v[w].rlen + 7) >> 3;
#pragma unroll
    for (int ro = 0; ro < 8; ++ro) {
      v[w].lh1[ro] = v[w].lh2[ro] = v[w].lq[ro] = v[w].le[ro] = 0;
      v[w].lf[ro] = v[w].lt[ro] = 0;
    }
#pragma unroll
    for (int a = 0; a < kNArr; ++a) {
#pragma unroll
      for (int c = 0; c < 8; ++c) v[w].top[a][c] = 0;
    }
    // step 0's corner, H at substep -2 of lane 8pr - 1 (read by the
    // cell at substep 0): hfb there, or lane 8pr's hfb in the skewed
    // frame; lane 0's boundary in the current frame
    v[w].top[kH][7] =
        kSkewed ? (pr << 3) + 1 + w : (pr == 0 ? kMinusInf2 : (pr << 3) + w);
    v[w].corner = 0;
#pragma unroll
    for (int k = 0; k < 7; ++k) v[w].cmax[k] = INT_MIN;
    v[w].bk = Book{0, 0, 0, 0, 0};
  }

  if (n_diags > 0) {
    step<NW, kSkewed, kIval, kFirst>(v, sh, -1, W, row);
    for (int D = 0; D + 1 < n_diags; ++D) {
      step<NW, kSkewed, kIval, kMid>(v, sh, D, W, row);
    }
    step<NW, kSkewed, kIval, kLast>(v, sh, n_diags - 1, W, row);
  }

  if (pr == 0) {
    Book f = v[0].bk;
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      f.ms = max(f.ms, v[w].bk.ms);
      f.mr = max(f.mr, v[w].bk.mr);
      f.mq = max(f.mq, v[w].bk.mq);
      f.diags += v[w].bk.diags;
    }
    int32_t* const o = out + 4 * pair;
    o[0] = f.ms;
    o[1] = f.mr;
    o[2] = f.mq;
    o[3] = f.diags;
  }
  if (row == nullptr) return;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    int32_t* const st = row + 6 * w * W;
    if (n_diags == 0 && pr < (W >> 3)) {  // the initial state
#pragma unroll
      for (int ro = 0; ro < 8; ++ro) {
        const int l = (pr << 3) + ro;
        st[l] = l + w;
        st[W + l] = l + 1 + w;
        st[2 * W + l] = st[3 * W + l] = kMinusInf2;
        st[4 * W + l] = (l + w) & 3;
        st[5 * W + l] = ((l + w) >> 2) & 3;
      }
    }
    if (kSkewed && n_diags > 0 && pr == 0) st[W] = kMinusInf2;  // hfb
    int32_t* const fd = row + 6 * NW * W + w * kFeedW;
    for (int j = pr; j < kFeedW; j += blockDim.x) fd[j] = (j + w) & 3;
    if (kSkewed) {
      for (int j = pr; j < kFeedW; j += blockDim.x) fd[kFeedW + j] = j & 3;
    }
  }
}

using Kernel = void (*)(const int32_t*, int32_t*, int32_t*, int, int);

// The instance for these switches, or nullptr.
Kernel pick(int n_waves, int skewed, int ival) {
  if (skewed) {
    if (n_waves != 1) return nullptr;
    return ival ? substep_kernel<1, true, true>
                : substep_kernel<1, true, false>;
  }
  if (ival) return n_waves == 1 ? substep_kernel<1, false, true> : nullptr;
  switch (n_waves) {
    case 1: return substep_kernel<1, false, false>;
    case 2: return substep_kernel<2, false, false>;
    case 4: return substep_kernel<4, false, false>;
    default: return nullptr;
  }
}

// Threads of a block: one per tile row, rounded up to a whole warp.
int block_threads(int W) { return (W / 8 + 31) / 32 * 32; }

// The instance, or nullptr for switches or a width it does not take.
Kernel prepare(int W, int n_waves, int skewed, int ival, cudaError_t& err) {
  err = cudaErrorInvalidValue;
  Kernel kern = pick(n_waves, skewed, ival);
  if (kern == nullptr || W % 32 != 0 || W < 32 || W * n_waves > 1024) {
    return nullptr;
  }
  err = cudaSuccess;
  return kern;
}

}  // namespace

// Launches one instance over n pairs on `stream` (one block of W / 8
// threads, rounded up to a warp, each); a non-null `state` receives the
// final scratch.  Returns cudaGetLastError().
extern "C" int agatha_substep_probe(const void* meta, void* out, void* state,
                                    int n, int W, int n_diags, int n_waves,
                                    int skewed, int ival, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Kernel kern = prepare(W, n_waves, skewed, ival, err);
  if (kern == nullptr) return static_cast<int>(err);
  kern<<<n, block_threads(W), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(meta), static_cast<int32_t*>(out),
      static_cast<int32_t*>(state), W, n_diags);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one instance an SM holds at once (on the current device).
extern "C" int agatha_substep_probe_occupancy(int W, int n_waves, int skewed,
                                              int ival, int* blocks_per_sm) {
  cudaError_t err;
  Kernel kern = prepare(W, n_waves, skewed, ival, err);
  if (kern == nullptr) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kern, block_threads(W), 0));
}
