"""The benchmark's plain reference of the AGAThA alignment semantics.

Plain PyTorch on any device, written for the benchmark alone: it imports
nothing of the program and takes nothing the program made.  It encodes
the pairs' strings itself (4-bit code = ASCII & 0xF, padded with N to a
multiple of 8, as the reference's packer does) and sweeps them one base
antidiagonal at a time with the step of the frozen oracle
(`benchmark.oracle.align_one_sweep`): the same computed-cell predicate
(slice, chunk and band clipping), the same frozen values through cells
that are not computed, the same int16 strip round-trips, the same
first-wins (H << 16) + r maxima and the same slice-boundary Z-drop.

What makes it fast enough to check a run: many pairs at once, on a
window of rows that follows the band (rows outside it are never
computed, and the rows that enter it hold their initial state; the
window's first row is one that is no longer computed, so it carries the
frozen H the next row reads), the masks and substitution scores of 64
antidiagonals made in bulk, and the Z-drop chain replayed afterwards on
the per-antidiagonal maxima, whose values never depend on it.

``bits`` holds every DP value (H, E, F and the diagonal input) in a
narrower two's-complement integer after each step: the control of
`benchmark.check`, the reference in a lower precision than the
configuration states.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

MINUS_INF2 = -16384          # SHRT_MIN / 2, the strips' minus infinity
INT32_MIN = -(2**31)
N_VALUE = 14                 # 'N' & 0xF
N_PENALTY = 1
BLOCK = 64                   # antidiagonals whose masks are made at once
CHAIN_EVERY = 16             # blocks between two Z-drop replays


@dataclasses.dataclass(frozen=True)
class Scoring:
    """The alignment parameters of a configuration (the manual binary's
    -m -x -q -r -s -z -w, positive magnitudes)."""

    match: int
    mismatch: int
    gap_open: int
    gap_extend: int
    slice_width: int
    z_threshold: int
    band_width: int

    @property
    def gap_oe(self) -> int:
        return self.gap_open + self.gap_extend


def encode(seq: str) -> np.ndarray:
    """ASCII -> 4-bit codes, padded with N to a multiple of 8."""
    c = np.frombuffer(seq.encode("ascii"), np.uint8) & 0xF
    return np.concatenate([c, np.full(-len(c) % 8, N_VALUE, np.uint8)])


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _trunc16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _ctrunc16(a: torch.Tensor) -> torch.Tensor:
    """C-style truncation of a / 16."""
    return torch.where(a >= 0, a >> 4, -((-a) >> 4))


def _top_h(col: int, sc: Scoring) -> int:
    if col < 0:
        return 0
    if col <= sc.band_width:
        return int(_trunc16(-(sc.gap_oe + sc.gap_extend * col)))
    return MINUS_INF2


def _top_e(col: int, sc: Scoring) -> int:
    if col <= sc.band_width:
        return int(_trunc16(_trunc16(-(sc.gap_oe + sc.gap_extend * col))
                            - sc.gap_oe))
    return MINUS_INF2


def _cdiv16(a: np.ndarray) -> np.ndarray:
    """C-style truncation of a / 16 (numpy)."""
    return np.where(a >= 0, a // 16, -((-a) // 16))


def _stops(qlen: np.ndarray, rlen: np.ndarray, sc: Scoring):
    """Per pair: the first diagonal never swept (an empty slice ends the
    job before it, agatha_kernel.h:189; else 8 past the last slice), the
    last slice's end as a base diagonal, and the real diagonals."""
    sw, bw = sc.slice_width, sc.band_width
    pql = -(-qlen // 8)
    prl = -(-rlen // 8)
    i_end = -(-(prl + pql - 1) // sw) * sw
    stop = 8 * i_end + 8
    for p in range(len(qlen)):
        i = np.arange(0, int(i_end[p]), sw, dtype=np.int64)
        ss = np.maximum(np.maximum(0, i - pql[p] + 1),
                        _cdiv16(8 * i + 8 - bw))
        se = np.minimum(np.minimum(prl[p] - 1, i + sw - 1),
                        _cdiv16(8 * (i + sw - 1) + 7 + bw))
        empty = np.flatnonzero(ss > se)
        if empty.size:
            stop[p] = 8 * i[empty[0]]
    return stop, 8 * i_end, qlen + rlen - 1


class _Chain:
    """The per-pair maximum tracking and Z-drop test, replayed over the
    per-antidiagonal maxima (agatha_kernel.h:291-313, 336-356)."""

    def __init__(self, qlen, rlen, sc: Scoring):
        n = len(qlen)
        self.sc = sc
        self.stop, self.i_end8, self.n_diags = _stops(qlen, rlen, sc)
        self.ms = np.zeros(n, np.int64)
        self.mr = np.zeros(n, np.int64)
        self.mq = np.zeros(n, np.int64)
        self.updated = np.zeros(n, bool)
        self.swept = self.stop.copy()
        self.done = np.zeros(n, bool)

    def feed(self, d0: int, dmax: np.ndarray) -> bool:
        """Diagonals d0 .. d0 + len(dmax) - 1, dmax (D, P) int32; True
        once every pair has ended."""
        sc = self.sc
        D, P = dmax.shape
        d = (d0 + np.arange(D, dtype=np.int64))[:, None]
        dm = dmax.astype(np.int64)
        th = dm >> 16
        tr = dm & 0xFFFF
        dq = d - tr
        live = ~self.done[None, :] & (d < self.stop[None, :])
        gate = live & ((d < self.n_diags[None, :])
                       | (d >= self.i_end8[None, :]))
        lowest = np.iinfo(np.int64).min
        incl = np.maximum(self.ms[None, :], np.maximum.accumulate(
            np.where(gate, th, lowest), axis=0))
        ms_prev = np.concatenate([self.ms[None, :], incl[:-1]])
        upd = gate & (th > ms_prev)
        rows = np.arange(D)[:, None]
        lu = np.maximum.accumulate(np.where(upd, rows, -1), axis=0)
        lu_prev = np.concatenate([np.full((1, P), -1), lu[:-1]])
        cols = np.arange(P)[None, :]
        safe = np.maximum(lu_prev, 0)
        mr_prev = np.where(lu_prev >= 0, tr[safe, cols], self.mr[None, :])
        mq_prev = np.where(lu_prev >= 0, dq[safe, cols], self.mq[None, :])
        term = np.zeros_like(gate)
        if sc.z_threshold >= 0:
            gap = np.abs((tr - mr_prev) - (dq - mq_prev))
            term = (gate & ~upd & (tr >= mr_prev) & (dq >= mq_prev)
                    & (ms_prev - th > sc.z_threshold + gap * sc.gap_extend))
        hit = term.any(axis=0)
        first = np.where(hit, term.argmax(axis=0), D)
        # the state as of each pair's last diagonal handled here
        last = np.clip(first - 1, -1, D - 1)
        after = np.where(last >= 0, lu[np.maximum(last, 0), cols[0]], -1)
        got = after >= 0
        self.ms = np.where(got, th[np.maximum(after, 0), cols[0]], self.ms)
        self.mr = np.where(got, tr[np.maximum(after, 0), cols[0]], self.mr)
        self.mq = np.where(got, dq[np.maximum(after, 0), cols[0]], self.mq)
        self.updated |= got
        newly = hit & ~self.done
        self.swept = np.where(newly, d0 + first + 1, self.swept)
        self.done |= hit | (d0 + D >= self.stop)
        return bool(self.done.all())


def align(queries: list[str], targets: list[str], sc: Scoring, *,
          device="cpu", bits: int | None = None) -> dict:
    """Align each query against its target.

    Returns numpy arrays keyed "score", "query_end", "target_end",
    "diags" (antidiagonals swept) and "updated" (False where the
    maximum was never updated: the never-updated initial state).
    """
    dev = torch.device(device)
    i32 = torch.int32
    P = len(queries)
    qc = [encode(s) for s in queries]
    tc = [encode(s) for s in targets]
    qlen = np.array([len(s) for s in queries], np.int64)
    rlen = np.array([len(s) for s in targets], np.int64)
    if P == 0 or (qlen < 1).any() or (rlen < 1).any():
        raise ValueError("every pair needs at least one base a side")
    sw, bw, z = sc.slice_width, sc.band_width, sc.z_threshold
    goe, ge = sc.gap_oe, sc.gap_extend
    chain = _Chain(qlen, rlen, sc)
    end = int(chain.stop.max())

    # rows that a diagonal d may compute lie within |d - 2r| <= bw + 15
    # (the chunk interior reaches 7 columns past the band on each side);
    # the window keeps 8 more on each side and its first row above them
    margin = 8
    Wr = -(-((BLOCK + 2 * bw + 32) // 2 + 2 * margin + 24) // 8) * 8
    Lq = max(len(c) for c in qc)
    Lt = max(len(c) for c in tc)
    qpad = np.full((P, Lq), N_VALUE, np.uint8)
    tpad = np.full((P, Lt + Wr + 8), N_VALUE, np.uint8)
    for p in range(P):
        qpad[p, :len(qc[p])] = qc[p]
        tpad[p, :len(tc[p])] = tc[p]
    qpad = torch.from_numpy(qpad).to(dev, i32)
    tpad = torch.from_numpy(tpad).to(dev, i32)

    def col(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(
            dev, i32).view(1, P, 1)

    qlen_t, rlen_t = col(qlen), col(rlen)
    pql_t, prl_t = col(-(-qlen // 8)), col(-(-rlen // 8))
    lane = torch.arange(Wr, dtype=i32, device=dev)

    def init_rows(r):
        k = _trunc16(-(goe + ge * r))
        h = torch.where(r <= bw, k, MINUS_INF2)
        f = torch.where(r <= bw, _trunc16(k - goe), MINUS_INF2)
        return h.expand(P, -1), f.expand(P, -1)

    ws = 0
    h0, f0 = init_rows(lane)
    hf1 = h0.clone()
    # a step's inputs a row, [diagonal H, E, F], double-buffered: the
    # step of antidiagonal d reads g and writes d + 1's into gn
    G = torch.empty((3, P, Wr), dtype=i32, device=dev)
    G[0, :, 1:] = h0[:, :-1]
    G[0, :, 0] = _top_h(-1, sc)
    G[1] = MINUS_INF2
    G[1, :, 0] = _top_e(0, sc)
    G[2] = f0
    Gn = torch.empty_like(G)
    # a block's masks, scores and H, at fixed addresses (a CUDA graph
    # replays the block's steps on them)
    Cb = torch.empty((BLOCK, P, Wr), dtype=torch.bool, device=dev)
    Sb = torch.empty((BLOCK, P, Wr), dtype=i32, device=dev)
    Mb = torch.empty((BLOCK, 3, 1, Wr), dtype=torch.bool, device=dev)
    Rb = torch.zeros((BLOCK, 3, P, Wr), dtype=torch.bool, device=dev)
    Hb = torch.empty((BLOCK, P, Wr), dtype=i32, device=dev)

    def narrow(x):
        return x if bits is None else _wrap(x, bits)

    def step(k, g, gn, top_next):
        """Antidiagonal d0 + k (the oracle's `step`)."""
        # the int16 strip round-trips (diagonal H at block-first rows and
        # chunk starts, E at block-first rows, F at chunk starts), then
        # the fake rows' reloads
        torch.where(Mb[k], _trunc16(g), g, out=g)
        g.masked_fill_(Rb[k], MINUS_INF2)
        temp = narrow(g[0] + Sb[k])
        torch.maximum(torch.maximum(temp, g[2]), g[1], out=Hb[k])
        ef = narrow(torch.maximum(g[1:3] - ge, temp - goe))
        ck = Cb[k]
        # E flows one row down, F along its row; both freeze where the
        # cell is not computed
        torch.where(ck[:, :-1], ef[0, :, :-1], g[1, :, :-1],
                    out=gn[1, :, 1:])
        torch.where(ck, ef[1], g[2], out=gn[2])
        gn[0, :, 1:] = hf1[:, :-1]
        gn[0, :, 0] = top_next[0]
        gn[1, :, 0] = top_next[1]
        torch.where(ck, Hb[k], hf1, out=hf1)

    def sweep_block(K, top):
        for k in range(K):
            d = d0 + k
            nxt = ((_top_h(d, sc), _top_e(d + 1, sc)) if top
                   else (MINUS_INF2, MINUS_INF2))
            g, gn = (G, Gn) if k % 2 == 0 else (Gn, G)
            step(k, g, gn, nxt)
        if K % 2:
            G.copy_(Gn)

    graph = None
    pending: list[torch.Tensor] = []
    pending_d0 = 0
    d0 = 0
    while d0 < end:
        # -- slide the window: top row = one above the lowest computable
        want = max(0, ((d0 - bw - 16) >> 1) - margin) // 8 * 8
        if want > ws:
            k = want - ws
            new_h, new_f = init_rows(want + lane[Wr - k:])
            new_hd, _ = init_rows(want + lane[Wr - k:] - 1)
            hf1.copy_(torch.cat([hf1[:, k:], new_h], 1))
            G.copy_(torch.cat([G[:, :, k:], torch.stack([
                new_hd, torch.full_like(new_hd, MINUS_INF2), new_f])], 2))
            ws = want
        K = min(BLOCK, end - d0)
        if ((d0 + K - 1 + bw + 16) >> 1) + margin >= ws + Wr:
            raise AssertionError("the row window is too narrow")

        # -- the block's masks and substitution scores, in bulk
        r = (ws + lane).view(1, 1, Wr)
        pr = r >> 3
        d = (d0 + torch.arange(K, dtype=i32, device=dev)).view(K, 1, 1)
        qq = d - r                                   # (K, 1, Wr)
        pq = qq >> 3
        i = torch.div(pr + pq, sw, rounding_mode="floor") * sw
        ss = torch.maximum(torch.clamp(i - pql_t + 1, min=0),
                           _ctrunc16(8 * i + 8 - bw))
        se = torch.minimum(torch.minimum(prl_t - 1, i + sw - 1),
                           _ctrunc16(8 * (i + sw - 1) + 7 + bw))
        cs = torch.clamp(8 * pr - bw, min=0) >> 3
        ce = torch.minimum(pql_t - 1, (8 * pr + 7 + bw) >> 3)
        C = ((qq >= 0) & (qq < qlen_t) & (pr >= ss) & (pr <= se)
             & (pq >= cs) & (pq <= ce)
             & (((pq > cs) & (pq < ce)) | ((qq - r).abs() <= bw)))
        if (ws > 0 and C[:, :, 0].any()) or C[:, :, -1].any():
            raise AssertionError("a computed cell on the window's edge")
        Cb[:K] = C
        cst = (qq >= 0) & ((qq & 7) == 0) & (pq == torch.maximum(cs, i - pr))
        blk_first = ((r & 7) == 0).expand(K, 1, Wr)
        Mb[:K, 0] = blk_first | cst
        Mb[:K, 1] = blk_first
        Mb[:K, 2] = cst
        Rb[:K, 0] = cst & (r > rlen_t)               # fake-row reloads
        Rb[:K, 2] = cst & (r >= rlen_t)
        qb = qpad.gather(1, qq.clamp(0, Lq - 1).view(1, -1).expand(P, -1))
        qb = qb.view(P, K, Wr).transpose(0, 1)
        tb = tpad[:, ws:ws + Wr].unsqueeze(0)
        sub = torch.where(qb == tb, sc.match, -sc.mismatch)
        Sb[:K] = torch.where((qb == N_VALUE) | (tb == N_VALUE), -N_PENALTY,
                             sub)

        # -- the sweep, one antidiagonal a step
        if dev.type == "cuda" and ws > 0 and K == BLOCK:
            if graph is None:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    sweep_block(K, False)
            graph.replay()
        else:
            sweep_block(K, ws == 0)

        # -- the block's first-wins (H << 16) + r maxima, wrapped to int32
        packed = (Hb[:K].to(torch.int64) << 16) + r.to(torch.int64)
        packed = ((packed + 2**31) & 0xFFFFFFFF) - 2**31
        packed = torch.where(C, packed, INT32_MIN)
        pending.append(packed.amax(dim=2).to(i32))
        d0 += K
        if len(pending) == CHAIN_EVERY or d0 >= end:
            dm = torch.cat(pending).cpu().numpy()
            pending = []
            all_done = chain.feed(pending_d0, dm)
            pending_d0 = d0
            if all_done:
                break
    if not chain.done.all():
        raise AssertionError("the sweep ended before every pair")
    return {
        "score": chain.ms.astype(np.int64),
        "query_end": chain.mq.astype(np.int64),
        "target_end": chain.mr.astype(np.int64),
        "diags": chain.swept.astype(np.int64),
        "updated": chain.updated.copy(),
    }


_CIGAR_RUN = re.compile(r"(\d+)([MID])")


def rescore(cigar: str, query: str, target: str, sc: Scoring):
    """(affine score, query bases, target bases) of a CIGAR's path from
    the origin (M both, I query only, D target only), or None when the
    string is not a sequence of such runs or leaves either sequence."""
    runs = _CIGAR_RUN.findall(cigar)
    if "".join(n + op for n, op in runs) != cigar:
        return None
    q = encode(query)[:len(query)].astype(np.int64)
    t = encode(target)[:len(target)].astype(np.int64)
    qi = ti = score = 0
    for n, op in runs:
        n = int(n)
        if n == 0:
            return None
        if op == "M":
            if qi + n > len(q) or ti + n > len(t):
                return None
            a, b = q[qi:qi + n], t[ti:ti + n]
            s = np.where(a == b, sc.match, -sc.mismatch)
            s = np.where((a == N_VALUE) | (b == N_VALUE), -N_PENALTY, s)
            score += int(s.sum())
            qi += n
            ti += n
        else:
            score -= sc.gap_open + sc.gap_extend * n
            if op == "I":
                qi += n
            else:
                ti += n
            if qi > len(q) or ti > len(t):
                return None
    return score, qi, ti
