// Banded column sweep for long reads, for Hopper, with its cost probe.
//
// `colband_kernel` replaces the Pallas TPU kernel
// agatha_tpu/ops/colband.py:_make_colband_kernel with its fused chain
// _vchain (pallas_call at colband.py:823, B7).  `probe_kernel` replaces
// the cost probe scripts/colband_probe.py:make_kernel (pallas_call at
// colband_probe.py:278, P2).  Contract of colband_kernel, shared with the
// plain PyTorch version colband_torch in ops/colband.py:
//   scal   (8, GB) int32    rows qlen, rlen, i_end8, n_diags, end_p
//                           (ops/colband.py:chain_scalars)
//   tcodes (GB, W/2) uint8  4-bit target codes, low nibble first
//   qfwd   (GB, QF/2) uint8 4-bit query codes, low nibble first
//   out    (GB, 4) int32    [score, query_end, target_end, diagonals]
// for int16-safe buckets (colband_eligible), bit-identical to the
// antidiagonal kernel and to the oracle align_one_sweep.
//
// Layout.  The Pallas kernel puts 128 pairs on lanes and the RW window
// rows on sublanes.  Here one block owns one pair.  Thread t owns the R
// window rows Rt .. Rt+R-1 (R = 2, 4 or 8, a template parameter), inside
// one row block of the reference (pr = r >> 3), so the slice / chunk
// algebra of a group of 8 columns is a handful of scalars per thread,
// computed once per group and shared by the 8 / R threads of a row
// block; only the band test varies per row and column.  H, F, the R
// target codes (a byte, a half or a whole 32-bit word of the nibble
// wire) and their mismatch scores live in registers.  RW / R row
// threads, rounded up to whole warps, plus one chain warp, within the
// instance's launch bound (colband_max_threads): R = 2 takes RW <= 1984,
// R = 4 RW <= 1536, R = 8 every window up to 4096.
//
// Per column, two barriers:
//   A  every thread has published the H of its last row (hl[t]); thread t
//      reads hl[t-1] as the diagonal-H input of its first row (top_h at
//      window row 0, which stands for the row that slid out above);
//   pass 1: temp and gv(rw) = ge*rw + (C ? temp - goe : top_e) for the R
//      rows, and their maximum;
//   the exclusive prefix maximum of those maxima over threads: a shuffle
//      scan in each row warp, which posts its total in shared memory
//   B  then every row warp reduces the totals of the warps before it
//      (one load a lane, one warp reduction: no loop over warps), and
//      e_in(rw) = max(top_e - ge, max over rw' < rw of gv(rw'))
//      - (ge*rw - ge), the Pallas kernel's plain-weight form literally
//      (integers, so the order of the maxima does not matter);
//   pass 2: H, F committed where C, and (H << 16) + r max-merged into
//      diagonal r + j of the ring.  Within a column every row hits
//      another diagonal, so no atomics; barrier A of the next column
//      orders the columns.
// A row's updates are Hopper's DPX three-operand maxima (__vimax3_s32,
// __viaddmax_s32), one instruction each on the row's dependent chain.
// The window origin w0(g) = clip(8g - LEAD, 0, WMAX) moves 8 rows per
// group between the pinned phases; then every thread hands its rows to
// thread t - 8 / R through shared memory (one more barrier, once per
// group) and the last 8 / R row threads take fresh rows (H = F =
// MINUS_INF2).
//
// The ring holds diagonals modulo a power of two >= RW + 32, padded by
// one entry in 32 so that the 32 lanes of a warp, whose rows are R
// apart, hit (nearly) 32 banks.  Diagonals below w0(g) + 8g - 8 are
// final when group g starts, at most 16 more than a group before.  The
// chain warp replays diag_chain_banded_np over them in one round a
// group, beside pass 2 of the group's first column (chain_round: one
// diagonal a lane, a prefix maximum over lanes of (score, earlier lane
// first) after the carried best, each lane's Z-drop test against the
// best before it, the first failing lane by a ballot), and resets each
// entry it has read.  Lane 0 publishes "finished" (Z-drop, or the end
// cap end_p) once per group; the block then stops: nothing later
// changes the four outputs.  Columns at or past qlen compute nothing,
// so the sweep stops there and the chain warp runs the remaining
// diagonals alone, 32 a round.
//
// What bounds it on this card.  ~12 int32 operations per in-band cell
// and few bytes, so operations; but a 128-pair bucket is 128 blocks on
// 132 SMs, one block an SM, and each column is a chain of two barriers,
// a shuffle scan and R dependent rows: latency, not issue, sets it.
// The first layout (R = 8 and lane 0 stepping the chain two diagonals
// a column) took ~1980 cycles a column at RW 1536 with no warp busy for
// more than ~1300 of them.  The instances' clock64 split (the `kSplit`
// instances, probes/colband_bench.py:column_split; PERF.md) shows a
// fixed ~1000 cycles a column (the two barriers, the ~280-cycle warp
// scan, the group steps) plus the rows' passes, which shrink with R
// until the barriers and the scan of more warps cost more than they
// hide: the instance of 8-12 row warps was the fastest at bands
// 255-2001 and within 1% of it at 127, so the wrapper takes the fewest
// rows a thread that keep RW / R within 384 threads
// (ops/colband.py:colband_rows).  Lane 0's chain steps
// (400-840 cycles a column) outlasted pass 2 at every R, so the whole
// chain warp took them over.  A version without a block barrier per
// column (warps handing their E carry down through shared-memory slot
// rings, skewed) gained only 4.6%, since skewed warps still waited
// for the slowest one's passes, and was not kept.
//
// probe_kernel keeps this layout: the instances of R rows a thread
// (launch bounds colband_max_threads(R); the wrapper takes colband_rows'
// R), H, F and the codes in registers, the roll 8 / R threads up, the
// two barriers a column, the warp scan with one warp reduction of the
// totals, DPX maxima, the ring merge, and the chain warp's one round a
// group (the probe's own 16-diagonal segment chain, one diagonal a
// lane).  It omits the slice / chunk algebra and the boundary strips
// (placeholder interval masks and sentinels stand in), the wire loads
// (target codes rw & 3, an all-zero query), the pinned window phases
// (it rolls every group), the early exit and the chain's tail rounds.
// It switches the chain, the E scan and the ring: timing-faithful,
// semantically wrong, bit-identical to colband_probe_torch in
// probes/colband_probe.py.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMinusInf2 = -16384;  // SHRT_MIN / 2, the strip sentinel
constexpr int kNValue = 14;         // 4-bit code of 'N'
constexpr int kNPenalty = 1;
constexpr int kNegBig = -(1 << 28);  // scan fill: loses every max

// Threads a block of colband_kernel<R> may have, its launch bound: 4096 /
// R row threads and the chain warp, at most 1024; but R = 4 only the
// largest block ops/colband.py:colband_rows gives it (384 row threads and
// the chain warp), under which ptxas schedules it ~2% faster at RW 1536
// (probes/colband_bench.py:bound_ab; R = 2 measured no faster so).
__host__ __device__ constexpr int colband_max_threads(int R) {
  return R == 4 ? 384 + 32 : 4096 / R + 32 < 1024 ? 4096 / R + 32 : 1024;
}

struct Params {
  const int32_t* scal;
  const uint8_t* tcodes;
  const uint8_t* qfwd;
  int32_t* out;
  int gb, wt, qf, RW, Qpad, LEAD, WMAX;
  int R, nb, nbpad, rs;  // rows a thread; row threads, rounded to warps;
                         // ring entries
  int match, mismatch, goe, ge, sw, z, bw;
};

// Ring slot of diagonal d (rs a power of two): one pad entry after every
// 32, so d, d + R, d + 2R, ... (the rows of a warp's 32 lanes) fall in
// (nearly) 32 different banks.  The ring takes ring_ints(rs) ints.
__device__ __forceinline__ int ring_slot(int d, int rs) {
  const int x = d & (rs - 1);
  return x + (x >> 5);
}

__host__ __device__ __forceinline__ int ring_ints(int rs) {
  return rs + (rs >> 5);
}

__device__ __forceinline__ int ctr16(int t) {
  return t >= 0 ? t >> 4 : -((-t) >> 4);
}

// (H << 16) + r in uint32: a left shift of a negative int is undefined.
__device__ __forceinline__ int pack_hr(int h, int r) {
  return static_cast<int>((static_cast<uint32_t>(h) << 16) +
                          static_cast<uint32_t>(r));
}

// Exclusive prefix maximum of `a` over the block's row threads, in
// thread order (kNegBig for thread 0), in two halves: warp_excl_max scans
// the warp and posts its total in wtot (32 ints of shared memory); after
// a __syncthreads(), warps_before merges the totals of the warps before.
// wtot is free again once every thread has returned and passed another
// barrier.
__device__ __forceinline__ int warp_excl_max(int a, int* wtot) {
  const int lane = threadIdx.x & 31;
  int inc = a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc = max(inc, u);
  }
  int exc = __shfl_up_sync(~0u, inc, 1);
  if (lane == 0) exc = kNegBig;
  if (lane == 31) wtot[threadIdx.x >> 5] = inc;
  return exc;
}

// The maximum of the totals of the warps before this one: a load a lane
// and one warp reduction, whatever the number of warps (at most 32).
__device__ __forceinline__ int warps_before(const int* wtot) {
  const int lane = threadIdx.x & 31;
  const int w = static_cast<int>(threadIdx.x >> 5);
  return __reduce_max_sync(~0u, lane < w ? wtot[lane] : kNegBig);
}

// Hands every thread's R rows of H and F to thread t - 8 / R (the window
// moves down 8 rows); the last 8 / R row threads take kMinusInf2.  Call
// publish, a barrier, then take.  xs holds (2R, nbpad) ints.
template <int R>
__device__ __forceinline__ void shift_publish(const int (&H)[R],
                                              const int (&F)[R], int* xs,
                                              int nbpad, int t) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    xs[i * nbpad + t] = H[i];
    xs[(R + i) * nbpad + t] = F[i];
  }
}

template <int R>
__device__ __forceinline__ void shift_take(int (&H)[R], int (&F)[R],
                                           const int* xs, int nbpad, int nb,
                                           int t) {
  const int src = t + 8 / R;
  const bool last = src >= nb;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    H[i] = last ? kMinusInf2 : xs[i * nbpad + src];
    F[i] = last ? kMinusInf2 : xs[(R + i) * nbpad + src];
  }
}

// R 4-bit target codes, low nibble first: one load of R / 2 bytes.
template <int R> struct Codes;
template <> struct Codes<2> { using T = uint8_t; };
template <> struct Codes<4> { using T = uint16_t; };
template <> struct Codes<8> { using T = uint32_t; };

// The reference's per-diagonal best / Z-drop state of one pair.
struct Chain {
  int ms, mr, mq, diags, next;
  bool term;
};

// diag_chain_banded_np over diagonals c.next .. c.next + n - 1 (n =
// min(32, limit - c.next) > 0, all final, c not terminated) by the 32
// lanes of one warp, one diagonal a lane; c is the same in every lane
// before and after.  Each lane reads its ring entry and resets it.
// Diagonal d counts (diags) whether or not its gate lets it update the
// state.  The state before lane l is the carried best unless an earlier
// lane of the round beats it strictly (a prefix maximum of (score,
// earlier lane first)); the round stops at the first lane whose Z-drop
// test fails, which counts too, as the serial replay does.
__device__ __forceinline__ void chain_round(Chain& c, int* ring, int rs,
                                            int limit, int i_end8,
                                            int n_diags, int z, int ge) {
  const int lane = threadIdx.x & 31;
  const int n = min(32, limit - c.next);
  const int d = c.next + lane;
  int x = INT_MIN;
  if (lane < n) {
    int* const slot = ring + ring_slot(d, rs);
    x = *slot;
    *slot = INT_MIN;
  }
  const bool gate =
      lane < n && ((d < i_end8 && d < n_diags) || d >= i_end8);
  const int th = x >> 16;
  const int tr = x & 0xFFFF;
  const int dq = d - tr;
  int key = gate ? static_cast<int>((static_cast<uint32_t>(th) << 5) |
                                    static_cast<uint32_t>(31 - lane))
                 : INT_MIN;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(~0u, key, o);
    if (lane >= o) key = max(key, u);
  }
  int ex = __shfl_up_sync(~0u, key, 1);
  if (lane == 0) ex = INT_MIN;
  const int wl = 31 - (ex & 31);
  const int wv = __shfl_sync(~0u, x, wl);
  int pms = c.ms, pmr = c.mr, pmq = c.mq;
  if ((ex >> 5) > c.ms) {
    pms = ex >> 5;
    pmr = wv & 0xFFFF;
    pmq = c.next + wl - pmr;
  }
  const bool stop = gate && z >= 0 && !(th > pms) && tr >= pmr &&
                    dq >= pmq &&
                    pms - th > z + abs((tr - pmr) - (dq - pmq)) * ge;
  const unsigned fail = __ballot_sync(~0u, stop);
  const int all = __shfl_sync(~0u, key, 31);
  const int al = 31 - (all & 31);
  const int av = __shfl_sync(~0u, x, al);
  if (fail != 0) {
    const int l = __ffs(fail) - 1;
    c.ms = __shfl_sync(~0u, pms, l);
    c.mr = __shfl_sync(~0u, pmr, l);
    c.mq = __shfl_sync(~0u, pmq, l);
    c.diags += l + 1;
    c.next += l + 1;
    c.term = true;
    return;
  }
  if ((all >> 5) > c.ms) {
    c.ms = all >> 5;
    c.mr = av & 0xFFFF;
    c.mq = c.next + al - c.mr;
  }
  c.diags += n;
  c.next += n;
}

// Shared memory of colband_kernel, in ints: the ring, the rolled rows
// xs (2R, nbpad), hl (nbpad), wtot (32) and the flag.
__host__ __device__ __forceinline__ int colband_smem_ints(const Params& p) {
  return ring_ints(p.rs) + (2 * p.R + 1) * p.nbpad + 32 + 1;
}

// R rows a thread.  kSplit: lane 0 of every warp adds up clock64 cycles
// per part of a column into split[(block * warps + warp) * 8 + part]:
// 0 barrier A (the column's prologue with it), 1 pass 1, 2 the warp
// scan, 3 barrier B and the merge of the warps' totals, 4 pass 2 with
// the ring writes (the chain warp: its chain rounds), 5 the group steps
// (the roll, the slice algebra, the group's barrier), 6 the columns.
template <int R, bool kSplit>
__global__ void __launch_bounds__(colband_max_threads(R))
colband_kernel(const Params p, long long* split) {
  extern __shared__ int smem[];
  int* const ring = smem;
  int* const xs = ring + ring_ints(p.rs);
  int* const hl = xs + 2 * R * p.nbpad;
  int* const wtot = hl + p.nbpad;
  int* const flag = wtot + 32;

  const int t = threadIdx.x;
  const int pair = blockIdx.x;
  const bool active = t < p.nb;
  const bool chain_warp = t >= p.nbpad;  // the last warp
  const bool chain_lane = t == p.nbpad;  // its lane 0
  const int qlen = min(p.scal[pair], p.Qpad);
  const int rlen = p.scal[p.gb + pair];
  const int i_end8 = p.scal[2 * p.gb + pair];
  const int n_diags = p.scal[3 * p.gb + pair];
  const int end_p = p.scal[4 * p.gb + pair];
  const int pql = (p.scal[pair] + 7) >> 3;
  const int prl = (rlen + 7) >> 3;
  using CodeT = typename Codes<R>::T;
  const CodeT* const trow = reinterpret_cast<const CodeT*>(
      p.tcodes + static_cast<size_t>(pair) * (p.wt >> 1));
  const uint32_t* const qrow = reinterpret_cast<const uint32_t*>(
      p.qfwd + static_cast<size_t>(pair) * (p.qf >> 1));
  const int goe = p.goe, ge = p.ge, bw = p.bw, sw = p.sw;
  long long acc[7] = {0, 0, 0, 0, 0, 0, 0};
  long long tk = kSplit ? clock64() : 0;
  const auto lap = [&](int part) {
    if (kSplit) {
      const long long now = clock64();
      acc[part] += now - tk;
      tk = now;
    }
  };

  // the rows' E weights ge * rw, and the first window: left-strip inits
  // for rows inside the band
  int wr[R], H[R], F[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rw = R * t + i;
    wr[i] = ge * rw;
    const int k0 = -(goe + wr[i]);
    H[i] = rw <= bw ? k0 : kMinusInf2;
    F[i] = rw <= bw ? k0 - goe : kMinusInf2;
  }
  for (int d = t; d < ring_ints(p.rs); d += blockDim.x) ring[d] = INT_MIN;
  if (t == 0) *flag = 0;
  Chain c = {0, 0, 0, 0, 0, false};
  int w0_prev = 0;
  const int groups = (qlen + 7) >> 3;
  __syncthreads();

  for (int g = 0; g < groups; ++g) {
    const int w0 = min(max(8 * g - p.LEAD, 0), p.WMAX);
    const bool rolling = w0 != w0_prev;
    w0_prev = w0;
    if (rolling && active) shift_publish<R>(H, F, xs, p.nbpad, t);
    if (chain_lane) *flag = c.term || c.next >= end_p;
    __syncthreads();
    if (*flag) break;
    if (rolling && active) shift_take<R>(H, F, xs, p.nbpad, p.nb, t);

    const int rbase = w0 + R * t;  // this thread's first row
    const int pr = rbase >> 3;     // its row block
    const CodeT tword = (active && rbase < p.wt) ? trow[rbase / R] : 0;
    const uint32_t qword = 8 * g < p.qf ? qrow[g] : 0u;
    if (active) hl[t] = H[R - 1];
    // each row's code and its score against any other query code
    int tc[R], mis[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      tc[i] = (tword >> (4 * i)) & 0xF;
      mis[i] = tc[i] == kNValue ? -kNPenalty : -p.mismatch;
    }

    // slice / chunk algebra of this thread's row block for query word g
    const int cs = max(0, 8 * pr - bw) >> 3;
    const int ce = min(pql - 1, (8 * pr + 7 + bw) >> 3);
    const int i_sl = ((pr + g) / sw) * sw;
    const int ss = max(max(0, i_sl - pql + 1), ctr16((i_sl << 3) + (8 - bw)));
    const int se = min(min(prl - 1, i_sl + (sw - 1)),
                       ctr16((i_sl << 3) + (8 * (sw - 1) + 7 + bw)));
    const bool insl = pr >= ss && pr <= se;
    const bool xg = insl && g >= cs && g <= ce;
    const bool yg = insl && g > cs && g < ce;
    const bool cst = g == max(cs, i_sl - pr);
    // diagonals below this are final: the chain may take them
    const int frontier = min(w0 + 8 * g - 8, end_p);
    lap(5);

    for (int k = 0; k < 8; ++k) {
      const int j = 8 * g + k;
      if (j >= qlen) break;
      const int qc = (qword >> (4 * k)) & 0xF;
      // an N query code scores -1 against every row: it takes the match
      // branch with sm = -1
      const bool qn = qc == kNValue;
      const int sm = qn ? -kNPenalty : p.match;
      const int top_h =
          j == 0 ? 0 : (j - 1 <= bw ? -(goe + ge * (j - 1)) : kMinusInf2);
      const int top_e = j <= bw ? -(goe + ge * j) - goe : kMinusInf2;
      const bool reload = k == 0 && cst;  // chunk starts: j % 8 == 0 only
      // |r - j| <= bw as one unsigned test of i - (j - bw - rbase)
      const int band_lo = j - bw - rbase;
      const unsigned band_span = 2u * static_cast<unsigned>(bw);

      __syncthreads();  // A: hl holds every thread's last row
      lap(0);
      int temp[R], v[R];
      unsigned cmask = 0;
      int a = kNegBig;
      if (active) {
        int htl = t == 0 ? top_h : hl[t - 1];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = rbase + i;
          if (reload && r >= rlen + 1) htl = kMinusInf2;
          temp[i] = htl + (tc[i] == qc || qn ? sm : mis[i]);
          const bool comp =
              yg || (xg && static_cast<unsigned>(i - band_lo) <= band_span);
          cmask |= static_cast<unsigned>(comp) << i;
          v[i] = comp ? temp[i] - goe : top_e;
          a = __viaddmax_s32(v[i], wr[i], a);
          htl = H[i];
        }
      }
      lap(1);
      int exc = kNegBig;
      if (!chain_warp) exc = warp_excl_max(a, wtot);
      lap(2);
      __syncthreads();  // B: wtot holds every row warp's total
      if (!chain_warp) exc = max(exc, warps_before(wtot));
      lap(3);
      if (active) {
        // the R rows hit R different diagonals: read them all first, so
        // that no load waits for an earlier row's store
        int slot[R], old[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          slot[i] = ring_slot(rbase + i + j, p.rs);
          old[i] = ring[slot[i]];
        }
        int run = max(top_e - ge, exc);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = rbase + i;
          const int e_in = run - wr[i] + ge;
          int f_in = F[i];
          if (reload && r >= rlen) f_in = kMinusInf2;
          const int h_new = __vimax3_s32(temp[i], f_in, e_in);
          if ((cmask >> i) & 1) {
            F[i] = __viaddmax_s32(f_in, -ge, v[i]);
            H[i] = h_new;
            ring[slot[i]] = max(old[i], pack_hr(h_new, r));
          } else {
            F[i] = f_in;
          }
          run = __viaddmax_s32(v[i], wr[i], run);
        }
        hl[t] = H[R - 1];
      } else if (chain_warp && !c.term && c.next < frontier) {
        // one round a group: the diagonals that became final with it
        chain_round(c, ring, p.rs, frontier, i_end8, n_diags, p.z, ge);
      }
      lap(4);
      if (kSplit) acc[6] += 1;
    }
  }
  if (kSplit && (t & 31) == 0) {
    long long* const o =
        split + (static_cast<size_t>(pair) * (blockDim.x >> 5) + (t >> 5)) * 8;
    for (int i = 0; i < 7; ++i) o[i] = acc[i];
  }
  __syncthreads();  // every diagonal is final
  if (chain_warp) {
    while (!c.term && c.next < end_p)
      chain_round(c, ring, p.rs, end_p, i_end8, n_diags, p.z, ge);
  }
  if (chain_lane) {
    int32_t* const o = p.out + 4 * static_cast<size_t>(pair);
    o[0] = c.ms;
    o[1] = c.mq;
    o[2] = c.mr;
    o[3] = c.diags;
  }
}

// --- the cost probe --------------------------------------------------------

// The probe's own parameters (scripts/colband_probe.py).
constexpr int kPBw = 751, kPGoe = 8, kPGe = 2, kPMatch = 1, kPMism = 4;
constexpr int kPZ = 400;

struct ProbeParams {
  const int32_t* meta;  // (2, N): ncols twice
  const int32_t* prev;  // (4, N)
  int32_t* out;         // (4, N)
  int32_t* state;       // null, or (3 RW + 16, N): final H, F and ring
  int n, RW, ncols;
  int R, nb, nbpad, rs;  // as Params
  int npre;  // log2 of the E window when the scan is off
};

// The carry of the probe's segment chain (colband_probe.py:_vchain), the
// same in every lane of the chain warp.
struct ProbeCarry {
  int ms, mr, mq, term, diags;
};

// One 16-diagonal segment of the probe's chain by the chain warp: lane
// l < 16 holds the ring entry x of diagonal d0 + l.  The running
// first-wins argmax seeded with the carry is a prefix maximum over lanes
// of (th, earlier lane first), the carry winning ties; each row's
// Z-drop candidate is tested against the state before it (the scan's
// exclusive value); tpre, the prefix OR of the candidates, is a ballot;
// and the probe's own (wrong on purpose) end-of-segment selection takes
// each field's maximum over the rows before the first candidate and the
// candidates, as warp reductions.
__device__ __forceinline__ void probe_segment(ProbeCarry& c, int x, int d0) {
  const int lane = threadIdx.x & 31;
  const bool row = lane < 16;
  const int th = x >> 16;
  const int tr = x & 0xFFFF;
  const int d = d0 + lane;
  int key = row ? static_cast<int>((static_cast<uint32_t>(th) << 5) |
                                   static_cast<uint32_t>(31 - lane))
                : INT_MIN;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(~0u, key, o);
    if (lane >= o) key = max(key, u);
  }
  int ex = __shfl_up_sync(~0u, key, 1);
  if (lane == 0) ex = INT_MIN;
  // the running state after this row (inclusive) and before it
  const int wl = 31 - (key & 31);
  const int wtr = __shfl_sync(~0u, tr, wl);
  const int pl = 31 - (ex & 31);
  const int ptr = __shfl_sync(~0u, tr, pl);
  int run_th = c.ms, run_tr = c.mr, run_d = c.mq + c.mr;
  if ((key >> 5) > c.ms) {
    run_th = key >> 5;
    run_tr = wtr;
    run_d = d0 + wl;
  }
  int pre_th = c.ms, pre_tr = c.mr, pre_d = c.mq + c.mr;
  if ((ex >> 5) > c.ms) {
    pre_th = ex >> 5;
    pre_tr = ptr;
    pre_d = d0 + pl;
  }
  const int dq = d - tr;
  const int pre_q = pre_d - pre_tr;
  const bool zel = !(th > pre_th) && tr >= pre_tr && dq >= pre_q;
  const int gap = abs((tr - pre_tr) - (dq - pre_q));
  const bool tcand =
      row && ((zel && pre_th - th > kPZ + gap * kPGe) || c.term > 0);
  const unsigned cand = __ballot_sync(~0u, tcand);
  const bool tpre = (cand & (~0u >> (31 - lane))) != 0;
  const bool sel = row && (!tpre || tcand);
  c.ms = __reduce_max_sync(~0u, sel ? run_th : kNegBig);
  c.mr = __reduce_max_sync(~0u, sel ? run_tr : kNegBig);
  c.mq = __reduce_max_sync(~0u, sel ? run_d - run_tr : kNegBig);
  c.term = cand != 0;
  // the probe's sum of ~tpre over int32 0 / 1: -16 less the rows from
  // the first candidate on
  c.diags += -16 - (cand != 0 ? 17 - __ffs(cand) : 0);
}

// Shared memory of probe_kernel, in ints: the ring, the rolled rows xs
// (2R, nbpad), hl (nbpad), wtot (32) and gvs (R, nbpad).
__host__ __device__ __forceinline__ int probe_smem_ints(const ProbeParams& p) {
  return ring_ints(p.rs) + (3 * p.R + 1) * p.nbpad + 32;
}

// colband_kernel's layout with the probe's placeholder masks and inputs:
// R rows a thread in registers, the window rolled 8 rows every group,
// the E scan (warp scans, one warp reduction of the totals), the ring
// merge, and the chain warp's round over the group's 16 final diagonals
// at its first column.  kChain, kRing and kScan switch the chain, the
// ring and the scan (without it, E over the last 2^npre rows: the gv of
// the 8 / R threads above through shared memory).
template <int R, bool kChain, bool kRing, bool kScan>
__global__ void __launch_bounds__(colband_max_threads(R))
probe_kernel(const ProbeParams p) {
  extern __shared__ int smem[];
  int* const ring = smem;
  int* const xs = ring + ring_ints(p.rs);
  int* const hl = xs + 2 * R * p.nbpad;
  int* const wtot = hl + p.nbpad;
  int* const gvs = wtot + 32;  // (R, nbpad), the windowed E form only

  const int t = threadIdx.x;
  const int pair = blockIdx.x;
  const bool active = t < p.nb;
  const bool chain_warp = t >= p.nbpad;
  const int qlen = p.meta[pair];
  // a zero the compiler cannot see: the probe's query is all zeros
  const uint32_t qword = static_cast<uint32_t>(p.meta[p.n + pair] - p.ncols);
  const int width = 1 << p.npre;

  // each row's E weight ge * rw and target code (rw + w0) & 3 = rw & 3
  int wr[R], tc[R], H[R], F[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    wr[i] = kPGe * (R * t + i);
    tc[i] = (R * t + i) & 3;
    H[i] = F[i] = kMinusInf2;
  }
  for (int d = t; d < ring_ints(p.rs); d += blockDim.x) ring[d] = INT_MIN;
  ProbeCarry c = {0, 0, 0, 0, 0};
  __syncthreads();

  for (int g = 0; g < p.ncols / 8; ++g) {
    const int w0 = 8 * g;
    // the window advances every group
    if (active) shift_publish<R>(H, F, xs, p.nbpad, t);
    __syncthreads();
    if (active) {
      shift_take<R>(H, F, xs, p.nbpad, p.nb, t);
      hl[t] = H[R - 1];
    }

    for (int k = 0; k < 8; ++k) {
      const int j = 8 * g + k;
      const int qc = (qword >> (4 * k)) & 0xF;
      const int lo = j - kPBw - w0 + (j & 7);
      const int hi = j + kPBw - w0 - (j & 3);
      const bool colm = qlen > j;
      // lo <= rw <= hi as one unsigned test of i - (lo - R t)
      const int band_lo = lo - R * t;
      const unsigned band_span = static_cast<unsigned>(hi - lo);

      __syncthreads();  // A
      // v + wr is the row's gv: kNegBig outside the mask
      int temp[R], v[R];
      unsigned cmask = 0;
      int a = kNegBig;
      if (active) {
        int htl = t == 0 ? kMinusInf2 : hl[t - 1];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int s = (qc == kNValue || tc[i] == kNValue)
                            ? -kNPenalty
                            : (qc == tc[i] ? kPMatch : -kPMism);
          temp[i] = htl + s;
          const bool comp =
              colm && static_cast<unsigned>(i - band_lo) <= band_span;
          cmask |= static_cast<unsigned>(comp) << i;
          v[i] = comp ? temp[i] - kPGoe : kNegBig - wr[i];
          a = __viaddmax_s32(v[i], wr[i], a);
          htl = H[i];
        }
      }
      int run = kNegBig;
      if (kScan) {
        if (!chain_warp) run = warp_excl_max(a, wtot);
        __syncthreads();  // B
        if (!chain_warp) run = max(run, warps_before(wtot));
      } else {
        // E over the last 2^npre rows only: the gv of the threads above
        // through shared memory in place of the scan
        if (active) {
#pragma unroll
          for (int i = 0; i < R; ++i) gvs[i * p.nbpad + t] = v[i] + wr[i];
        }
        __syncthreads();  // B
      }
      if (active) {
        int slot[R], old[R];
        if (kRing) {
#pragma unroll
          for (int i = 0; i < R; ++i) {
            slot[i] = ring_slot(16 * g + 8 + R * t + i + k, p.rs);
            old[i] = ring[slot[i]];
          }
        }
        // up[m - 1]: gv of row R t - m, the m-th row above this thread's
        // first (row R (t - q) + R q - m of thread t - q)
        int up[8];
        if (!kScan) {
#pragma unroll
          for (int m = 1; m <= 8; ++m) {
            if (m > width) break;
            const int q = (m + R - 1) / R;
            up[m - 1] = t >= q ? gvs[(R * q - m) * p.nbpad + t - q] : kNegBig;
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          int pmax = run;
          if (!kScan) {
            // max of gv over rows rw - width .. rw - 1
            pmax = kNegBig;
#pragma unroll
            for (int m = 1; m <= 8; ++m) {
              if (m > width) break;
              const int src = i - m;
              pmax = max(pmax, src >= 0 ? v[src] + wr[src] : up[-src - 1]);
            }
          }
          const int e_in = pmax - wr[i] + kPGe;
          const int f_in = F[i];
          const int h_new = __vimax3_s32(temp[i], f_in, e_in);
          if ((cmask >> i) & 1) {
            F[i] = __viaddmax_s32(f_in, -kPGe, v[i]);
            H[i] = h_new;
            if (kRing)
              ring[slot[i]] = max(old[i], pack_hr(h_new, R * t + i + w0));
          }
          if (kScan) run = __viaddmax_s32(v[i], wr[i], run);
        }
        hl[t] = H[R - 1];
      } else if ((kChain || kRing) && chain_warp && k == 0) {
        // one round a group: the 16 entries below 16 g were final when
        // the group began; they leave the ring whether or not the chain
        // reads them
        const int lane = t & 31;
        const int sd = 16 * g - 16 + lane;
        int x = INT_MIN;
        if (kRing && lane < 16 && sd >= 0) {
          int* const slot = ring + ring_slot(sd, p.rs);
          x = *slot;
          *slot = INT_MIN;
        }
        if (kChain) probe_segment(c, x, 16 * g - 8);
      }
    }
  }
  if (t == p.nbpad) {
    // XOR with the previous repetition's output, as the probe chains
    // its repetitions through a data dependency
    p.out[pair] = c.ms ^ p.prev[pair];
    p.out[p.n + pair] = c.mr ^ p.prev[p.n + pair];
    p.out[2 * p.n + pair] = c.mq ^ p.prev[2 * p.n + pair];
    p.out[3 * p.n + pair] = c.diags ^ p.prev[3 * p.n + pair];
  }
  if (p.state != nullptr) {
    // the final window and the unconsumed ring, for the comparison with
    // the plain version (the four outputs alone barely depend on them)
    __syncthreads();
    const size_t n = p.n;
    if (active) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        p.state[(R * t + i) * n + pair] = H[i];
        p.state[(p.RW + R * t + i) * n + pair] = F[i];
      }
    }
    const int a0 = 16 * (p.ncols / 8 - 1);
    for (int r = t; r < p.RW + 16; r += blockDim.x)
      p.state[(2 * p.RW + r) * n + pair] = ring[ring_slot(a0 + r, p.rs)];
  }
}

int ring_entries(int RW) {
  int rs = 64;
  while (rs < RW + 32) rs <<= 1;
  return rs;
}

// Fills the launch parameters of one bucket at `rows` rows a thread;
// false if the shapes are out of the kernel's range.
bool colband_params(Params& p, const void* scal, const void* tcodes,
                    const void* qfwd, void* out, int gb, int wt, int qf,
                    int RW, int Qpad, int LEAD, int WMAX, int match,
                    int mismatch, int goe, int ge, int sw, int z, int bw,
                    int rows) {
  if (RW < 8 || RW % 8 || RW > 4096 || wt % 8 || qf % 8 || sw < 1 ||
      (rows != 2 && rows != 4 && rows != 8))
    return false;
  p.scal = static_cast<const int32_t*>(scal);
  p.tcodes = static_cast<const uint8_t*>(tcodes);
  p.qfwd = static_cast<const uint8_t*>(qfwd);
  p.out = static_cast<int32_t*>(out);
  p.gb = gb;
  p.wt = wt;
  p.qf = qf;
  p.RW = RW;
  p.Qpad = Qpad;
  p.LEAD = LEAD;
  p.WMAX = WMAX;
  p.R = rows;
  p.nb = RW / rows;
  p.nbpad = (p.nb + 31) & ~31;
  p.rs = ring_entries(RW);
  p.match = match;
  p.mismatch = mismatch;
  p.goe = goe;
  p.ge = ge;
  p.sw = sw;
  p.z = z;
  p.bw = bw;
  return p.nbpad + 32 <= colband_max_threads(rows);
}

// Fills the launch parameters of one probe instance at `rows` rows a
// thread (n_prefix < 0: the full E scan); false if the shapes are out of
// its range.
bool probe_params(ProbeParams& p, const void* meta, const void* prev,
                  void* out, void* state, int n, int RW, int ncols,
                  int n_prefix, int rows) {
  if (RW < 8 || RW % 8 || RW > 4096 || ncols % 8 || n_prefix > 3 ||
      (rows != 2 && rows != 4 && rows != 8))
    return false;
  p.meta = static_cast<const int32_t*>(meta);
  p.prev = static_cast<const int32_t*>(prev);
  p.out = static_cast<int32_t*>(out);
  p.state = static_cast<int32_t*>(state);
  p.n = n;
  p.RW = RW;
  p.ncols = ncols;
  p.R = rows;
  p.nb = RW / rows;
  p.nbpad = (p.nb + 31) & ~31;
  p.rs = ring_entries(RW);
  p.npre = n_prefix < 0 ? 0 : n_prefix;
  return p.nbpad + 32 <= colband_max_threads(rows);
}

using ProbeKernel = void (*)(ProbeParams);

template <int R>
ProbeKernel probe_switched(bool chain, bool ring, bool scan) {
  switch ((chain ? 4 : 0) | (ring ? 2 : 0) | (scan ? 1 : 0)) {
    case 0: return probe_kernel<R, false, false, false>;
    case 1: return probe_kernel<R, false, false, true>;
    case 2: return probe_kernel<R, false, true, false>;
    case 3: return probe_kernel<R, false, true, true>;
    case 4: return probe_kernel<R, true, false, false>;
    case 5: return probe_kernel<R, true, false, true>;
    case 6: return probe_kernel<R, true, true, false>;
    default: return probe_kernel<R, true, true, true>;
  }
}

// The probe instance of `rows` rows a thread with these switches.
ProbeKernel probe_instance(int rows, bool chain, bool ring, bool scan) {
  switch (rows) {
    case 2: return probe_switched<2>(chain, ring, scan);
    case 4: return probe_switched<4>(chain, ring, scan);
    default: return probe_switched<8>(chain, ring, scan);
  }
}

template <int R>
cudaError_t launch_instance(const Params& p, long long* split,
                            cudaStream_t stream) {
  const size_t smem = sizeof(int) * colband_smem_ints(p);
  const auto kernel = split != nullptr ? colband_kernel<R, true>
                                       : colband_kernel<R, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<p.gb, p.nbpad + 32, smem, stream>>>(p, split);
  return cudaGetLastError();
}

}  // namespace

// Launches the banded column sweep of one bucket on `stream`, one block
// per pair, `rows` (2, 4 or 8) window rows a thread.  With `split`
// non-null, the clock64 instance: split holds (GB, warps, 8) int64
// (colband_kernel's kSplit), warps the launch's threads / 32.  Returns
// cudaGetLastError().
extern "C" int agatha_colband(const void* scal, const void* tcodes,
                              const void* qfwd, void* out, int gb, int wt,
                              int qf, int RW, int Qpad, int LEAD, int WMAX,
                              int match, int mismatch, int goe, int ge,
                              int sw, int z, int bw, int rows, void* split,
                              int device, void* stream) {
  Params p;
  if (!colband_params(p, scal, tcodes, qfwd, out, gb, wt, qf, RW, Qpad,
                      LEAD, WMAX, match, mismatch, goe, ge, sw, z, bw,
                      rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sp = static_cast<long long*>(split);
  switch (rows) {
    case 2: err = launch_instance<2>(p, sp, s); break;
    case 4: err = launch_instance<4>(p, sp, s); break;
    default: err = launch_instance<8>(p, sp, s); break;
  }
  return static_cast<int>(err);
}

// Launches one probe instance over n pairs (one block each) on `stream`:
// `rows` (2, 4 or 8) window rows a thread, with_chain and with_ring as the
// probe's switches, n_prefix < 0 for the full E scan, else E over the
// last 2^n_prefix rows (n_prefix <= 3).  meta (2, n), prev and out (4, n)
// int32; state null or (3 RW + 16, n) int32 for the final H, F and ring.
// Returns cudaGetLastError().
extern "C" int agatha_colband_probe(const void* meta, const void* prev,
                                    void* out, void* state, int n, int RW,
                                    int ncols, int with_chain, int n_prefix,
                                    int with_ring, int rows, int device,
                                    void* stream) {
  ProbeParams p;
  if (!probe_params(p, meta, prev, out, state, n, RW, ncols, n_prefix,
                    rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ProbeKernel kernel =
      probe_instance(rows, with_chain != 0, with_ring != 0, n_prefix < 0);
  const size_t smem = sizeof(int) * probe_smem_ints(p);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.n, p.nbpad + 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
