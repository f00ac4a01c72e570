"""Native (C++) host helpers, loaded through ctypes.

The port's copy of agatha_tpu/native/__init__.py, and one source of its
own.  The batch encoder (`packer.cpp`, the JAX package's source with a
note of its own at the top), the adaptive re-DP CIGAR engine of host
traceback and the decoder of the device walk's move words
(`traceback.cpp`, byte-identical to the JAX package's) are built
together with g++ at first use into one library.  The one-pass list
encoder (`encoder.cpp`, port only) calls the CPython API, so it is
built into a library of its own, against Python's headers, and loaded
through `ctypes.PyDLL`: where it cannot be built, only its entry falls
back.  Both libraries go to agatha_tpu_torch/_build/, keyed by a hash of
their sources and the host's CPU features, never next to the sources.
Every entry point falls back (or returns None, for its caller to fall
back) when its library cannot be built or loaded, with identical
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sysconfig

import numpy as np

from agatha_tpu_torch import trace

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "packer.cpp"),
         os.path.join(_DIR, "traceback.cpp")]
_ENC_SRCS = [os.path.join(_DIR, "encoder.cpp")]
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_ENC_FLAGS = [*_FLAGS, "-I", sysconfig.get_paths()["include"]]

_lib = None
_tried = False
_enc = None
_enc_tried = False


def _arch_tag() -> str:
    """Machine and CPU feature-flag fingerprint for the cached .so name.

    The library is built -march=native; a build directory shared with
    another host could otherwise load a binary with unsupported
    instructions and die with SIGILL mid-call.
    """
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    h = hashlib.sha256(feats.encode()).hexdigest()[:10]
    return f"{platform.machine()}-{h}"


def _so_path(srcs=_SRCS, flags=_FLAGS, stem="native") -> str:
    key = hashlib.sha256(" ".join(flags).encode())
    for src in srcs:
        with open(src, "rb") as f:
            key.update(f.read())
    return os.path.join(_BUILD_DIR,
                        f"{stem}-{key.hexdigest()[:16]}.{_arch_tag()}.so")


def _build(srcs, flags, stem) -> str:
    """Path of the built library, built first if it is not there."""
    so = _so_path(srcs, flags, stem)
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # build to a private temp file and rename atomically so
        # concurrent processes never load a half-written .so
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *flags, "-o", tmp, *srcs],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(_build(_SRCS, _FLAGS, "native"))
    except (OSError, subprocess.CalledProcessError):
        return None
    i64 = ctypes.c_int64
    p8 = ctypes.POINTER(ctypes.c_uint8)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.agatha_encode_batch.argtypes = [p8, p64, p8, i64, p8, i64,
                                        p32, ctypes.c_int32]
    lib.agatha_encode_batch.restype = ctypes.c_int
    i32 = ctypes.c_int32
    lib.agatha_traceback.argtypes = [
        p8, p8, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_char_p, i64, p64,
    ]
    lib.agatha_traceback.restype = ctypes.c_int
    lib.agatha_traceback_adaptive.argtypes = [
        p8, p8, i32, i32, i32, i32, i32, i32, i32, i64,
        ctypes.c_char_p, i64, p64,
    ]
    lib.agatha_traceback_adaptive.restype = ctypes.c_int
    lib.agatha_traceback_batch.argtypes = [
        p8, p64, p8, p64, p32, p32, p64, i64,
        i32, i32, i32, i32, i32,
        ctypes.c_char_p, i64, p64, p32, i32,
    ]
    lib.agatha_traceback_batch.restype = ctypes.c_int
    lib.agatha_moves_to_cigars.argtypes = [
        p32, i64, i64, ctypes.c_char_p, i64, p64, i32,
    ]
    lib.agatha_moves_to_cigars.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _load_encoder():
    """The list encoder (encoder.cpp), or None where it does not build
    or load; the rest of the native code does not depend on it."""
    global _enc, _enc_tried
    if _enc_tried:
        return _enc
    _enc_tried = True
    try:
        lib = ctypes.PyDLL(_build(_ENC_SRCS, _ENC_FLAGS, "encoder"))
    except (OSError, subprocess.CalledProcessError):
        return None
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.agatha_encode_list.argtypes = [
        ctypes.py_object, ctypes.py_object, ctypes.c_void_p,
        ctypes.c_int64, p64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.agatha_encode_list.restype = ctypes.c_int64
    _enc = lib
    return _enc


def encoder_available() -> bool:
    return _load_encoder() is not None


def encode_list(seqs: list, ops: list | None, slab_for):
    """Encode a list of str / bytes into one flat slab of padded codes.

    The codes of `encode_batch` (and of `ops.packing.encode_padded`),
    read from each item's own bytes: a str's UTF-8, as ``.encode()``
    gives it.  Sequence i's codes are ``slab[offsets[i]:offsets[i+1]]``,
    its length in bytes ``lens[i]``.  ``slab_for(size)`` returns a 1-D
    contiguous uint8 array of at least ``size`` bytes to write into.
    Returns (slab, offsets int64 (n+1,), lens int32 (n,)), or None when
    the encoder is unavailable or an item cannot be read (neither str
    nor bytes, or a str with no UTF-8 form), for the caller to fall
    back.
    """
    lib = _load_encoder()
    if lib is None:
        return None
    n = len(seqs)
    offsets = np.empty(n + 1, np.int64)
    lens = np.empty(n, np.int32)
    p64 = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    p32 = lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    with trace.span("encode.native"):
        total = lib.agatha_encode_list(seqs, ops, None, 0, p64, p32)
        if total < 0:
            return None
        slab = slab_for(total)
        rc = lib.agatha_encode_list(seqs, ops, slab.ctypes.data,
                                    slab.size, p64, p32)
    return (slab, offsets, lens) if rc == total else None


def _p8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode_batch(
    seqs: list[bytes],
    ops: np.ndarray | None,
    stride: int,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Encode a batch of ASCII sequences to (n, stride) padded codes.

    Falls back to ops.packing.encode_padded when the native library is
    unavailable.  Returns (codes uint8 (n, stride), lens int32 (n,)).
    """
    n = len(seqs)
    out = np.zeros((n, stride), np.uint8)
    lens = np.zeros(n, np.int32)
    lib = _load()
    if lib is not None:
        blob = b"".join(seqs)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=offsets[1:])
        opsa = (
            np.zeros(n, np.uint8) if ops is None
            else np.ascontiguousarray(ops, np.uint8)
        )
        blob_a = np.frombuffer(blob, np.uint8)
        if blob_a.size == 0:
            blob_a = np.zeros(1, np.uint8)
        with trace.span("encode.native"):
            rc = lib.agatha_encode_batch(
                _p8(blob_a),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                _p8(opsa),
                n,
                _p8(out),
                stride,
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_int32(n_threads),
            )
        if rc == 0:
            return out, lens
    # fallback
    from agatha_tpu_torch.ops.packing import encode_padded

    for i, s in enumerate(seqs):
        op = 0 if ops is None else int(ops[i])
        c = encode_padded(s, op)
        out[i, : len(c)] = c
        lens[i] = len(s)
    return out, lens


def traceback(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    q_end: int,
    t_end: int,
    cfg,
    bw_region: int | None = None,
) -> tuple[str, int] | None:
    """Native CIGAR traceback; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if bw_region is None:
        bw_region = max(cfg.band_width, abs(q_end - t_end)) + 16
    qc = np.ascontiguousarray(q_codes, np.uint8)
    tc = np.ascontiguousarray(t_codes, np.uint8)
    cap = 16 * (q_end + t_end + 8) + 64
    score = np.zeros(1, np.int64)
    # rc contract: 0 ok, -1 cigar buffer too small (retry larger),
    # -2 walk escaped the band (a real failure — raise, don't fall
    # back to the slow NumPy path only to re-derive the same escape).
    for _ in range(3):
        buf = ctypes.create_string_buffer(cap)
        rc = lib.agatha_traceback(
            _p8(qc), _p8(tc),
            ctypes.c_int32(q_end), ctypes.c_int32(t_end),
            ctypes.c_int32(cfg.match), ctypes.c_int32(cfg.mismatch),
            ctypes.c_int32(cfg.gap_oe), ctypes.c_int32(cfg.gap_extend),
            ctypes.c_int32(cfg.band_width), ctypes.c_int32(bw_region),
            buf, ctypes.c_int64(cap),
            score.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc == 0:
            return buf.value.decode("ascii"), int(score[0])
        if rc == -1:
            cap *= 4
            continue
        break
    if rc == -2:
        raise RuntimeError(
            f"traceback escaped the band (q_end={q_end}, t_end={t_end}, "
            f"bw_region={bw_region}): the kernel-reported end position "
            "is not reachable inside the walk-back region"
        )
    raise RuntimeError(f"native traceback failed with rc={rc}")


def _path_band_excursion(cigar: str) -> int:
    """Max |r - q| along a query-centric CIGAR path from (0, 0).

    Only D/I runs change the r - q offset (M consumes both), and the
    offset is monotone within a run, so checking after each run is
    exact.  Used to attribute traceback-vs-kernel score mismatches:
    a path that exits the scoring band was invisible to the kernel's
    boundary-block band mask by construction.
    """
    off = 0
    mx = 0
    num = 0
    for ch in cigar:
        if "0" <= ch <= "9":
            num = num * 10 + ord(ch) - 48
            continue
        if ch == "D":
            off += num
        elif ch == "I":
            off -= num
        mx = max(mx, abs(off))
        num = 0
    return mx


def traceback_adaptive(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    q_end: int,
    t_end: int,
    cfg,
    expected_score: int,
) -> tuple[str, int] | None:
    """Adaptive-band CIGAR traceback; None when the library is missing."""
    lib = _load()
    if lib is None:
        return None
    qc = np.ascontiguousarray(q_codes, np.uint8)
    tc = np.ascontiguousarray(t_codes, np.uint8)
    cap = 4 * (q_end + t_end + 8) + 64
    buf = ctypes.create_string_buffer(cap)
    score = np.zeros(1, np.int64)
    rc = lib.agatha_traceback_adaptive(
        _p8(qc), _p8(tc),
        ctypes.c_int32(q_end), ctypes.c_int32(t_end),
        ctypes.c_int32(cfg.match), ctypes.c_int32(cfg.mismatch),
        ctypes.c_int32(cfg.gap_oe), ctypes.c_int32(cfg.gap_extend),
        ctypes.c_int32(cfg.band_width),
        ctypes.c_int64(expected_score),
        buf, ctypes.c_int64(cap),
        score.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc == -2:
        raise RuntimeError(
            f"traceback escaped the walk-back window (q_end={q_end}, "
            f"t_end={t_end}): the kernel-reported end position is not "
            "reachable inside the region"
        )
    if rc == 1:
        # Accepted at the widest window with achieved != expected.
        # Two band-geometry regimes explain a mismatch and are NOT
        # engine bugs (tests/test_traceback.py
        # test_band_exempt_end_stale_carry):
        #   * band-exempt end (|q_end-t_end| > bw): the reference's
        #     boundary-block band test SKIPS out-of-band cells while
        #     retaining their stale H (agatha_kernel.h:236-239
        #     `continue` keeps the previous column's value in the
        #     register), so the kernel score can include stale-carry
        #     values no genuine affine path reproduces;
        #   * achieved > expected along a path that exits the band:
        #     the walk window is deliberately wider than the scoring
        #     band, so it can see genuine paths the kernel's band
        #     mask hid.
        # Anything else signals a scoring mismatch (legitimate only
        # under int16 wrap, outside int16_safe) — make it observable.
        cig = buf.value.decode("ascii")
        explained = abs(q_end - t_end) > cfg.band_width or (
            int(score[0]) > expected_score
            and _path_band_excursion(cig) > cfg.band_width
        )
        if not explained:
            import warnings

            warnings.warn(
                f"traceback score {int(score[0])} != kernel-reported "
                f"{expected_score} at the widest window (q_end={q_end}, "
                f"t_end={t_end}); expected only in int16-wrap regimes",
                RuntimeWarning, stacklevel=2,
            )
    elif rc != 0:
        raise RuntimeError(f"native adaptive traceback rc={rc}")
    return buf.value.decode("ascii"), int(score[0])


def traceback_batch(
    encoded: list,
    q_ends: np.ndarray,
    t_ends: np.ndarray,
    expected: np.ndarray,
    cfg,
    n_threads: int = 0,
) -> list[str] | None:
    """Batch adaptive-band CIGAR traceback; None when unavailable.

    encoded: list of (q_codes, t_codes, qlen, rlen).  The adaptive
    engine starts from a narrow window skewed along the end-point line
    and widens until the achieved score equals ``expected`` (the score
    the TPU kernel reported) — see native/traceback.cpp engine 2.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(encoded)
    if n == 0:
        return []
    qoff = np.zeros(n + 1, np.int64)
    toff = np.zeros(n + 1, np.int64)
    np.cumsum([len(e[0]) for e in encoded], out=qoff[1:])
    np.cumsum([len(e[1]) for e in encoded], out=toff[1:])
    qblob = np.concatenate([np.asarray(e[0], np.uint8) for e in encoded])
    tblob = np.concatenate([np.asarray(e[1], np.uint8) for e in encoded])
    qe = np.ascontiguousarray(q_ends, np.int32)
    te = np.ascontiguousarray(t_ends, np.int32)
    exp = np.ascontiguousarray(expected, np.int64)
    # Worst-case CIGAR: alternating single ops, 2 bytes per op.
    per_cap = int(4 * (qe.max() + te.max() + 8) + 64)
    cigars = np.zeros((n, per_cap), np.uint8)
    scores = np.zeros(n, np.int64)
    rcs = np.zeros(n, np.int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    rc = lib.agatha_traceback_batch(
        _p8(qblob), qoff.ctypes.data_as(p64),
        _p8(tblob), toff.ctypes.data_as(p64),
        qe.ctypes.data_as(p32), te.ctypes.data_as(p32),
        exp.ctypes.data_as(p64), ctypes.c_int64(n),
        ctypes.c_int32(cfg.match), ctypes.c_int32(cfg.mismatch),
        ctypes.c_int32(cfg.gap_oe), ctypes.c_int32(cfg.gap_extend),
        ctypes.c_int32(cfg.band_width),
        cigars.ctypes.data_as(ctypes.c_char_p), ctypes.c_int64(per_cap),
        scores.ctypes.data_as(p64), rcs.ctypes.data_as(p32),
        ctypes.c_int32(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"native traceback_batch failed with rc={rc}")
    bad = np.flatnonzero(rcs == -2)
    if bad.size:
        raise RuntimeError(
            f"traceback escaped the walk-back window for pairs "
            f"{bad[:5].tolist()}: kernel-reported end positions are "
            "not reachable inside the region"
        )
    bad = np.flatnonzero((rcs != 0) & (rcs != 1))
    if bad.size:
        raise RuntimeError(
            f"native traceback_batch per-pair failure rc="
            f"{rcs[bad[0]]} for pairs {bad[:5].tolist()}"
        )
    out = []
    for i in range(n):
        row = cigars[i]
        end = int(np.argmin(row)) if row[-1] == 0 else per_cap
        out.append(row[:end].tobytes().decode("ascii"))
    mismatched = np.flatnonzero(rcs == 1)
    if mismatched.size:
        # rc 1: widest-window acceptance with achieved != expected
        # (see traceback_adaptive).  Band-geometry regimes explain a
        # mismatch and stay silent: band-exempt ends (the reference's
        # stale-carry regime) and higher-scoring genuine paths that
        # exit the band (invisible to the kernel's band mask).  Warn
        # only on the unexplained remainder.
        bw = cfg.band_width
        unexplained = [
            int(i) for i in mismatched
            if abs(int(qe[i]) - int(te[i])) <= bw
            and not (int(scores[i]) > int(exp[i])
                     and _path_band_excursion(out[i]) > bw)
        ]
        if unexplained:
            import warnings

            warnings.warn(
                f"{len(unexplained)} pair(s) {unexplained[:5]} "
                "produced a traceback score different from the kernel-"
                "reported score at the widest window; expected only in "
                "int16-wrap regimes",
                RuntimeWarning, stacklevel=2,
            )
    return out


def moves_to_cigars_batch(
    words: np.ndarray, n_threads: int = 0
) -> list[str] | None:
    """Device-walk packed move words -> CIGAR strings (one per pair).

    ``words`` is the pair-major (gb, half) int32 array of the device
    walk (ops.walk); see agatha_moves_to_cigars in traceback.cpp for the bit
    layout.  Returns None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    words = np.asarray(words, np.int32)
    gb, half = words.shape
    if gb == 0:
        return []
    # pair-major is already the layout the C++ loop streams (each
    # pair's words sequential); a fetched device array is C-contiguous
    # so this is a no-op view, not a copy
    wt = np.ascontiguousarray(words)
    # worst case: alternating ops, "1X" per move = 2 bytes + NUL
    per_cap = int(2 * 16 * half + 16)
    out = np.empty((gb, per_cap), np.uint8)
    lens = np.empty(gb, np.int64)
    rc = lib.agatha_moves_to_cigars(
        wt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(half), ctypes.c_int64(gb),
        out.ctypes.data_as(ctypes.c_char_p), ctypes.c_int64(per_cap),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"native moves_to_cigars rc={rc}")
    return [
        out[b, : lens[b]].tobytes().decode("ascii") for b in range(gb)
    ]
