// Column-sweep alignment of short-read buckets, for Hopper: two kernels.
//
// `sweep` replaces the Pallas TPU kernel
// agatha_tpu/ops/colsweep.py:_make_sweep_kernel (pallas_call at
// colsweep.py:482, B4); `chain` replaces _make_chain_kernel (pallas_call
// at colsweep.py:510, B5).  Contract, shared with the plain PyTorch
// versions colsweep_sweep_torch / colsweep_chain_torch in
// ops/colsweep.py:
//   meta   (GB, 2) int32   [qlen, rlen] per pair
//   tcodes (GB, W/2) uint8  4-bit target codes, low nibble first
//   qfwd   (GB, QF/2) uint8 4-bit query codes, low nibble first
//   ring   per-diagonal max of (H << 16) + r over the cells r + j = d,
//          INT32_MIN where unreached; the kernels keep it pair-major,
//          (GB, d_pad) int32, and the wrapper hands out its (d_pad, GB)
//          transposed view, the plain version's layout
//   out    (GB, 4) int32   [score, query_end, target_end, diagonals]
// for buckets that pass colsweep_eligible (the band covers every
// diagonal and no value leaves int16 range), bit-identical to the
// antidiagonal kernel and to the oracle align_one_sweep.
//
// sweep, register instances (sweep_regs_kernel<K>, K = 4, 8, ..., 32
// rows a lane: every bucket of R <= 1024 rows).  One warp per pair; lane
// L holds rows [L*K, L*K + K) of the pair: H, F, the target code, the
// row's mismatch score and its ring multiplier and offset (below) in
// registers, the row loops fully unrolled.  Rows at or past
// R8 = 8 * ceil(rlen / 8) (at most R) never feed a lower row and write
// nothing.  The query codes are staged once in shared memory, and each
// lane loads its next column's code a step ahead.  The lanes run a
// wavefront: at step s lane L sweeps column j = s - L over its K rows
// with the serial recurrence itself,
//   temp = H(r-1, j-1) + score, H = max(temp, F, E),
//   F' = max(temp - goe, F - ge), E(r+1) = max(temp - goe, E(r) - ge),
// taking from lane L-1 by two __shfl_up_sync the E leaving that lane's
// last row at column j (produced at step s-1) and that row's H at column
// j-1 (its value before step s-1's update); lane 0 takes the top strip's
// values.  No scan: each value is the literal recurrence's, so the
// kernel equals the plain version by construction.  A pair takes
// qlen + (lanes holding a swept row) - 1 steps.  Chunk-start masks (the
// reference's fake-row reloads) apply at each lane's own columns
// j % 8 == 0, to the rows [rlen, R8) of the lanes that hold them.
//
// The ring merge.  Row r of column j max-merges (H << 16) + r into
// diagonal r + j.  A lane's rows i < K of column j reach diagonals
// r0 + j + i, so the lane keeps a window A[i] in registers, its max so
// far of diagonal r0 + j + i: each row sets A[i] = max(A[i + 1], its
// value), and after column j the lane's part of diagonal r0 + j is whole
// (later columns reach only higher diagonals).  At its next step the
// lane merges that entry into the warp's ring in shared memory, after
// its last column the K entries left: one merge a step, where a merge
// a row made the shared-memory atomics the largest cost of a row.  The
// merges are shared-memory atomicMax (a native integer atomic): lanes L
// and L' merge the same diagonal at different steps, and the max of a
// set does not depend on the order of its merges, so the ring is exact
// whatever order they land in.  In one step the lanes merge diagonals
// L*(K-1) + s - 1, on 32 distinct banks for odd K - 1, hence even K;
// K runs in steps of 4 (on the H100, K 8 and 20 beat K 6 and 18 on the
// 150 and 600 bp buckets that need only 6 and 18, and odd K was slower).  A row outside [0, R8)
// has multiplier 0 and offset INT_MIN, so its value H * 0 + INT_MIN
// changes no max: no test a row.  The mismatch score, multiplier and
// offset pass through an identity shuffle once, which keeps the compiler
// from recomputing them with a compare and a select every column.
//
// sweep, shared-memory instance (sweep_smem_kernel, the first version,
// for bands past 1024 rows).  One warp per pair with K = ceil(R8 / 32)
// rows a lane, H, F and the codes lane-interleaved in shared memory, the
// lanes column-synchronous: pass 1 gives each lane's E carry from -inf,
// a weighted prefix max over lanes (five __shfl_up_sync) gives the E
// entering each lane, E(L) = max over L' <= L of v(L') - ge*K*(L - L'),
// which in integers equals the serial recurrence; pass 2 runs the
// recurrence and max-merges into the ring (within a column no two rows
// share a diagonal; a __syncwarp per column orders the columns).  Its
// state and ring take 4 * (3 * R + d_pad) bytes a pair; the caller
// routes a bucket whose pair does not fit in a block's shared memory
// (only gap_extend = 0 with bands past ~11k rows) to the antidiagonal
// kernel.  Both instances write the ring pair-major once, coalesced.
//
// What bounds sweep on this card.  The recurrence needs ~12 int32
// operations per cell (R8 x qlen cells per pair), and the bytes are
// small (codes in, one ring out), so operations bound it.  A 512-pair
// bucket is 512 warps, about one per scheduler, so the register
// instances keep every per-row operand in registers (the first version
// paid several dependent shared-memory round trips a row) and issue 9
// instructions a row (one compare and one select for the score, two
// adds, the H, F and E maxima as Hopper's three-operand VIMNMX3 and
// VIADDMNMX, one multiply-add and one max for the ring window) plus ~35
// a step; the inter-lane dependence is two shuffles a step, not a
// five-step scan a column.
//
// chain.  One warp per pair walks its ring row 32 diagonals a round,
// one coalesced 128-byte load a round (loaded a round ahead).  The
// reference's per-diagonal loop keeps the best (score, cell) so far,
// updated where a swept diagonal's score is strictly greater, and stops
// at the first diagonal that fails the Z-drop test against the best
// before it.  In a round the best before each lane is an exclusive
// prefix max over lanes of (score, earlier diagonal first), with the
// state carried from the previous round first (ties keep the earliest,
// as the strict test does); each lane then runs the Z-drop test against
// its prefix, and the first failing lane (__ballot_sync, __ffs) ends the
// chain with diagonals = d + 1 and that lane's prefix as the result.
// Diagonals in [n_diags, i_end8) are counted but neither update nor
// test.  Bytes bound it in principle (one pass over the ring), but a
// round is a chain of ~10 shuffles, so its latency sets the time.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMinusInf2 = -16384;  // SHRT_MIN / 2, the strip sentinel
constexpr int kNValue = 14;         // 4-bit code of 'N'
constexpr int kNPenalty = 1;
constexpr int kNegBig = -(1 << 28);  // E-scan fill: loses every max
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kChainWarps = 4;

struct SweepParams {
  const int32_t* meta;
  const uint8_t* tcodes;
  const uint8_t* qfwd;
  int32_t* ring;  // (GB, d_pad) output, pair-major
  int gb, wt, qf, R, Q, d_pad, wpb;
  int match, mismatch, goe, ge, sw;
};

// Rows of one state array of the shared-memory instance: R rounded up to
// the warp.
__host__ __device__ __forceinline__ int state_rows(int R) {
  return R < 32 ? 32 : (R + 31) & ~31;
}

// Ints of one warp's shared memory in the register instances: a spare
// slot, the d_pad-int ring and the Q query codes as bytes between 32
// bytes of slack on either side, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int regs_warp_ints(int d_pad, int Q) {
  return 1 + d_pad + (((Q + 64 + 15) >> 4) << 2);
}

// int16 wraparound of an int32 (short2 strip storage).
__device__ __forceinline__ int trunc16(int x) {
  return static_cast<int>(static_cast<uint32_t>(x) << 16) >> 16;
}

// Code i of a nibble-packed row (the wire format; low nibble first).
__device__ __forceinline__ int load_code(const uint8_t* row, int i) {
  return (row[i >> 1] >> ((i & 1) << 2)) & 0xF;
}

__device__ __forceinline__ int sub_score(const SweepParams& p, int qc,
                                         int tc) {
  return (qc == kNValue || tc == kNValue) ? -kNPenalty
                                          : (qc == tc ? p.match : -p.mismatch);
}

// Chunk-start cell of row-block pr at column 8 * g8 (sweep.py
// chunk_start_mask with cs == 0, which eligibility guarantees).
__device__ __forceinline__ bool chunk_start(int pr, int g8, int sw) {
  const int i = ((pr + g8) / sw) * sw;
  return g8 == max(0, i - pr);
}

// (H << 16) + r in uint32: a left shift of a negative int is undefined
// in C++17.
__device__ __forceinline__ int pack_cell(int h, int r) {
  return static_cast<int>((static_cast<uint32_t>(h) << 16) +
                          static_cast<uint32_t>(r));
}

template <int K>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
sweep_regs_kernel(const SweepParams p) {
  static_assert(K % 4 == 0 && K <= 32, "K: 4, 8, ..., 32 rows a lane");
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int pair = blockIdx.x * p.wpb + wib;
  if (pair >= p.gb) return;  // whole warps only: no lane is left behind

  // ring[-1] takes lane 0's merge before its first column (INT_MIN, a
  // no-op); qs[-32, Q + 32) may be read, the steps outside a lane's
  // columns read the slack and use nothing
  int* const ring = smem + wib * regs_warp_ints(p.d_pad, p.Q) + 1;
  uint8_t* const qs = reinterpret_cast<uint8_t*>(ring + p.d_pad) + 32;

  const int qlen = min(p.meta[2 * pair], p.Q);
  const int rlen = p.meta[2 * pair + 1];
  const int r8p = min(((rlen + 7) >> 3) << 3, p.R);
  const int r0 = lane * K;
  const int nvalid = r8p - r0;  // rows [r0, r0 + nvalid) are swept
  const int lanes = (r8p + K - 1) / K;  // lanes holding a swept row
  const uint8_t* const trow =
      p.tcodes + static_cast<size_t>(pair) * (p.wt >> 1);
  const uint8_t* const qrow = p.qfwd + static_cast<size_t>(pair) * (p.qf >> 1);

  for (int d = lane; d < p.d_pad; d += 32) ring[d] = INT_MIN;
  for (int j = lane; j < qlen; j += 32) qs[j] = load_code(qrow, j);

  // left-strip inits (every row is inside the band by eligibility); a
  // row's ring value is H * M + RR, (H << 16) + r where the row is swept
  // and INT_MIN (no merge changes) where it is not
  int H[K], F[K], T[K], B[K], M[K], RR[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int r = r0 + i;
    const int k0 = trunc16(-(p.goe + p.ge * r));
    H[i] = k0;
    F[i] = trunc16(k0 - p.goe);
    T[i] = i < nvalid ? load_code(trow, r) : 0;
    // B, M and RR pass through an identity shuffle, which the compiler
    // cannot see through: it keeps them in registers rather than
    // recomputing them with a compare and a select every column
    B[i] = __shfl_sync(~0u, T[i] == kNValue ? -kNPenalty : -p.mismatch,
                       lane);
    M[i] = __shfl_sync(~0u, i < nvalid ? 1 << 16 : 0, lane);
    RR[i] = __shfl_sync(~0u, i < nvalid ? r : INT_MIN, lane);
  }
  __syncwarp();

  // fake rows [rlen, r8p) all lie in row-block rlen >> 3; rows i >= ffrom
  // of this lane are fake
  const int ffrom = rlen - r0;
  const bool has_fake = rlen < r8p && r0 < r8p && ffrom < K;
  const int steps = qlen > 0 && lanes > 0 ? qlen + lanes - 1 : 0;
  // columns this lane sweeps: [0, qcols) (none past the swept rows)
  const unsigned qcols = lane < lanes ? qlen : 0;
  // lane 0 takes the top strip (through a shuffle: the compiler keeps the
  // flag rather than reading the lane id every step)
  const bool top = __shfl_sync(~0u, static_cast<int>(lane == 0), lane) != 0;

  // A[i]: this lane's max so far of diagonal r0 + j + i, j the lane's
  // last swept column (rows i' >= i of columns <= j reach it); A[0] is
  // complete once column j is swept
  int A[K];
#pragma unroll
  for (int i = 0; i < K; ++i) A[i] = INT_MIN;
  int qc_next = qs[-lane];
  int e_in = 0, h_in = 0;  // from lane - 1 (lane 0: the top strip)
  for (int s = 0; s < steps; ++s) {
    const int j = s - lane;
    const int qc = qc_next;
    qc_next = qs[j + 1];
    const int h_pub = H[K - 1];  // this lane's last row at column j - 1
    // lane 0 (j == s) takes the top strip: H(-1, j - 1) and E(0, j)
    const int top_h = s == 0 ? 0 : trunc16(-(p.goe + p.ge * (s - 1)));
    const int top_e = trunc16(trunc16(-(p.goe + p.ge * s)) - p.goe);
    h_in = top ? top_h : h_in;
    e_in = top ? top_e : e_in;
    int e = e_in;
    if (static_cast<unsigned>(j) < qcols) {
      int prev = h_in;  // H(r0 - 1, j - 1)
      if (has_fake && (j & 7) == 0 && chunk_start(rlen >> 3, j >> 3, p.sw)) {
        // row r takes H(r-1, j-1) = -inf where r > rlen and F = -inf
        // where r >= rlen; H[i - 1] is read next only as row i's input
        if (ffrom < 0) prev = kMinusInf2;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (i >= ffrom) F[i] = kMinusInf2;
          if (i > 0 && i > ffrom) H[i - 1] = kMinusInf2;
        }
      }
      atomicMax(ring + r0 + j - 1, A[0]);  // INT_MIN at j == 0
      // an N query code scores -1 against every row: it takes the match
      // branch with sm = -1; B holds the row's mismatch score
      const bool qn = qc == kNValue;
      const int sm = qn ? -kNPenalty : p.match;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int temp = prev + (T[i] == qc || qn ? sm : B[i]);
        prev = H[i];
        const int tg = temp - p.goe;
        const int h = __vimax3_s32(temp, F[i], e);
        F[i] = __viaddmax_s32(F[i], -p.ge, tg);
        e = __viaddmax_s32(e, -p.ge, tg);
        H[i] = h;
        const int pk = static_cast<int>(static_cast<uint32_t>(h) * M[i] +
                                        static_cast<uint32_t>(RR[i]));
        A[i] = i + 1 < K ? max(A[i + 1], pk) : pk;
      }
    }
    e_in = __shfl_up_sync(~0u, e, 1);
    h_in = __shfl_up_sync(~0u, h_pub, 1);
  }
  // the diagonals of the last column swept (rows past r8p reach none)
  if (steps > 0 && lane < lanes) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i < nvalid) atomicMax(ring + r0 + qlen - 1 + i, A[i]);
  }
  __syncwarp();

  int32_t* const out = p.ring + static_cast<size_t>(pair) * p.d_pad;
  for (int d = lane; d < p.d_pad; d += 32) out[d] = ring[d];
}

__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
sweep_smem_kernel(const SweepParams p) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int pair = blockIdx.x * p.wpb + wib;
  if (pair >= p.gb) return;  // whole warps only: no lane is left behind

  const int rs = state_rows(p.R);
  int* const hs = smem + wib * (3 * rs + p.d_pad);
  int* const fs = hs + rs;
  int* const ts = hs + 2 * rs;
  int* const ring = hs + 3 * rs;

  const int qlen = min(p.meta[2 * pair], p.Q);
  const int rlen = p.meta[2 * pair + 1];
  const int r8p = min(((rlen + 7) >> 3) << 3, p.R);
  const int K = max(1, (r8p + 31) >> 5);  // rows per lane, K*32 <= rs
  const int r0 = lane * K;
  const uint8_t* const trow =
      p.tcodes + static_cast<size_t>(pair) * (p.wt >> 1);
  const uint8_t* const qrow = p.qfwd + static_cast<size_t>(pair) * (p.qf >> 1);

  // left-strip inits (every row is inside the band by eligibility); state
  // is lane-interleaved (row lane*K + i at [i*32 + lane]): no bank conflict
  for (int i = 0; i < K; ++i) {
    const int r = r0 + i;
    const int k0 = trunc16(-(p.goe + p.ge * r));
    hs[i * 32 + lane] = k0;
    fs[i * 32 + lane] = trunc16(k0 - p.goe);
    ts[i * 32 + lane] = r < r8p ? load_code(trow, r) : 0;
  }
  for (int d = lane; d < p.d_pad; d += 32) ring[d] = INT_MIN;
  __syncwarp();

  for (int j = 0; j < qlen; ++j) {
    const int qc = load_code(qrow, j);
    const int top_h = j == 0 ? 0 : trunc16(-(p.goe + p.ge * (j - 1)));
    const int top_e = trunc16(trunc16(-(p.goe + p.ge * j)) - p.goe);
    const bool cst_col = (j & 7) == 0;
    const int g8 = j >> 3;

    // diagonal-H input of the first row: the row above, before this
    // column's update, lives in the previous lane
    int in_h = __shfl_up_sync(~0u, hs[(K - 1) * 32 + lane], 1);
    if (lane == 0) in_h = top_h;

    // pass 1: this lane's E carry from -inf
    int carry = kNegBig;
    {
      int prev = in_h;
      for (int i = 0; i < K; ++i) {
        const int r = r0 + i;
        if (r >= r8p) break;
        const int slot = i * 32 + lane;
        int htl = prev;
        if (cst_col && r > rlen && chunk_start(r >> 3, g8, p.sw))
          htl = kMinusInf2;
        const int temp = htl + sub_score(p, qc, ts[slot]);
        carry = max(temp - p.goe, carry - p.ge);
        prev = hs[slot];
      }
    }

    // E entering each lane: weighted prefix max over lanes
    int v = __shfl_up_sync(~0u, carry, 1);
    if (lane == 0) v = top_e;
    const int wk = p.ge * K;
    int g = v + wk * lane;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(~0u, g, o);
      if (lane >= o) g = max(g, u);
    }
    int e = g - wk * lane;

    // pass 2: the serial recurrence over this lane's rows
    {
      int prev = in_h;
      for (int i = 0; i < K; ++i) {
        const int r = r0 + i;
        if (r >= r8p) break;
        const int slot = i * 32 + lane;
        int htl = prev;
        int f_in = fs[slot];
        if (cst_col && r >= rlen && chunk_start(r >> 3, g8, p.sw)) {
          if (r > rlen) htl = kMinusInf2;
          f_in = kMinusInf2;
        }
        const int temp = htl + sub_score(p, qc, ts[slot]);
        const int h_new = max(max(temp, f_in), e);
        fs[slot] = max(temp - p.goe, f_in - p.ge);
        prev = hs[slot];
        hs[slot] = h_new;
        e = max(temp - p.goe, e - p.ge);
        ring[r + j] = max(ring[r + j], pack_cell(h_new, r));
      }
    }
    __syncwarp();
  }

  int32_t* const out = p.ring + static_cast<size_t>(pair) * p.d_pad;
  for (int d = lane; d < p.d_pad; d += 32) out[d] = ring[d];
}

__global__ void __launch_bounds__(kChainWarps * 32)
chain_kernel(const int32_t* __restrict__ meta,
             const int32_t* __restrict__ ring, int32_t* __restrict__ out,
             int gb, int d_pad, int sw, int z, int ge) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kChainWarps + (threadIdx.x >> 5);
  if (pair >= gb) return;  // whole warps only
  const int qlen = meta[2 * pair];
  const int rlen = meta[2 * pair + 1];
  const int tad = ((qlen + 7) >> 3) + ((rlen + 7) >> 3) - 1;
  const int i_end8 = ((tad + sw - 1) / sw) * sw * 8;
  const int n_diags = qlen + rlen - 1;
  const int last = min(i_end8 + 8, d_pad);  // end_p
  const int32_t* const row = ring + static_cast<size_t>(pair) * d_pad;

  // the best so far (warp-uniform) and the diagonals swept
  int ms = 0, mr = 0, mq = 0, diags = last;
  int nxt = lane < last ? row[lane] : INT_MIN;
  for (int d0 = 0; d0 < last; d0 += 32) {
    const int d = d0 + lane;
    const int v = nxt;
    if (d + 32 < last) nxt = row[d + 32];
    const bool gate = d < last && ((d < i_end8 && d < n_diags) || d >= i_end8);
    const int th = v >> 16;
    const int tr = v & 0xFFFF;
    const int dq = d - tr;

    // inclusive prefix max over lanes of (score, earlier lane first)
    int key = gate ? static_cast<int>((static_cast<uint32_t>(th) << 5) |
                                      static_cast<uint32_t>(31 - lane))
                   : INT_MIN;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(~0u, key, o);
      if (lane >= o) key = max(key, u);
    }
    // the best before this lane: the carried state unless an earlier
    // lane of the round beats it strictly
    int ex = __shfl_up_sync(~0u, key, 1);
    if (lane == 0) ex = INT_MIN;
    const int wl = 31 - (ex & 31);
    const int wv = __shfl_sync(~0u, v, wl);
    int pms = ms, pmr = mr, pmq = mq;
    if ((ex >> 5) > ms) {
      pms = ex >> 5;
      pmr = wv & 0xFFFF;
      pmq = d0 + wl - pmr;
    }
    const bool stop = gate && z >= 0 && !(th > pms) && tr >= pmr &&
                      dq >= pmq &&
                      pms - th > z + abs((tr - pmr) - (dq - pmq)) * ge;
    const unsigned fail = __ballot_sync(~0u, stop);
    if (fail != 0) {
      const int l = __ffs(fail) - 1;
      ms = __shfl_sync(~0u, pms, l);
      mr = __shfl_sync(~0u, pmr, l);
      mq = __shfl_sync(~0u, pmq, l);
      diags = d0 + l + 1;
      break;
    }
    // carry the best after the round's last lane
    const int all = __shfl_sync(~0u, key, 31);
    const int al = 31 - (all & 31);
    const int av = __shfl_sync(~0u, v, al);
    if ((all >> 5) > ms) {
      ms = all >> 5;
      mr = av & 0xFFFF;
      mq = d0 + al - mr;
    }
  }
  if (lane == 0) {
    int32_t* const o = out + 4 * static_cast<size_t>(pair);
    o[0] = ms;
    o[1] = mq;
    o[2] = mr;
    o[3] = diags;
  }
}

using SweepKernel = void (*)(const SweepParams);

// The sweep instance of k_rows rows a lane (0: the shared-memory one), or
// nullptr where there is none.
SweepKernel sweep_instance(int k_rows) {
  switch (k_rows) {
    case 0: return sweep_smem_kernel;
    case 4: return sweep_regs_kernel<4>;
    case 8: return sweep_regs_kernel<8>;
    case 12: return sweep_regs_kernel<12>;
    case 16: return sweep_regs_kernel<16>;
    case 20: return sweep_regs_kernel<20>;
    case 24: return sweep_regs_kernel<24>;
    case 28: return sweep_regs_kernel<28>;
    case 32: return sweep_regs_kernel<32>;
    default: return nullptr;
  }
}

// Dynamic shared memory of a sweep block of wpb pairs on that instance.
size_t sweep_block_smem(int R, int Q, int d_pad, int wpb, int k_rows) {
  const size_t per_warp =
      k_rows == 0 ? 3 * static_cast<size_t>(state_rows(R)) + d_pad
                  : static_cast<size_t>(regs_warp_ints(d_pad, Q));
  return sizeof(int) * per_warp * wpb;
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of kern at this block
// size and dynamic shared memory, or a negative CUDA error.
template <typename Kernel>
int resident_per_sm(Kernel kern, int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        threads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// Launches the sweep of one bucket on `stream` into the pair-major ring
// (GB, d_pad): k_rows = 4, 8, ..., 32 picks that register instance (R at
// most 32 * k_rows), 0 the shared-memory instance;
// wpb pairs a block (1 to 4, as many as fit in a block's shared memory;
// the caller checks that one does).  Returns cudaGetLastError().
extern "C" int agatha_colsweep_sweep(const void* meta, const void* tcodes,
                                     const void* qfwd, void* ring, int gb,
                                     int wt, int qf, int R, int Q, int d_pad,
                                     int wpb, int k_rows, int match,
                                     int mismatch, int goe, int ge, int sw,
                                     int device, void* stream) {
  const SweepKernel kern = sweep_instance(k_rows);
  if (kern == nullptr || wpb < 1 || wpb > kMaxWarpsPerBlock ||
      (k_rows != 0 && R > 32 * k_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  SweepParams p;
  p.meta = static_cast<const int32_t*>(meta);
  p.tcodes = static_cast<const uint8_t*>(tcodes);
  p.qfwd = static_cast<const uint8_t*>(qfwd);
  p.ring = static_cast<int32_t*>(ring);
  p.gb = gb;
  p.wt = wt;
  p.qf = qf;
  p.R = R;
  p.Q = Q;
  p.d_pad = d_pad;
  p.wpb = wpb;
  p.match = match;
  p.mismatch = mismatch;
  p.goe = goe;
  p.ge = ge;
  p.sw = sw;
  const size_t smem = sweep_block_smem(R, Q, d_pad, wpb, k_rows);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(gb + wpb - 1) / wpb, wpb * 32, smem,
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches the chain of one bucket on `stream` over the pair-major ring
// (GB, d_pad); returns cudaGetLastError().
extern "C" int agatha_colsweep_chain(const void* meta, const void* ring,
                                     void* out, int gb, int d_pad, int sw,
                                     int z, int ge, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (gb + kChainWarps - 1) / kChainWarps;
  chain_kernel<<<blocks, kChainWarps * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(ring),
      static_cast<int32_t*>(out), gb, d_pad, sw, z, ge);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the launch agatha_colsweep_sweep makes with
// these (R, Q, d_pad, wpb, k_rows) (its instance, block size and dynamic
// shared memory), or with chain != 0 of agatha_colsweep_chain's launch;
// a negative CUDA error on failure.
extern "C" int agatha_colsweep_occupancy(int chain, int R, int Q, int d_pad,
                                         int wpb, int k_rows, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (chain) return resident_per_sm(chain_kernel, kChainWarps * 32, 0);
  const SweepKernel kern = sweep_instance(k_rows);
  if (kern == nullptr || wpb < 1 || wpb > kMaxWarpsPerBlock)
    return -static_cast<int>(cudaErrorInvalidValue);
  return resident_per_sm(kern, wpb * 32,
                         sweep_block_smem(R, Q, d_pad, wpb, k_rows));
}
