"""Build, bind and launch the CUDA sources in csrc/: the port's one
call path to its kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on
its own for sm_90a into a shared library in agatha_tpu_torch/_build/,
keyed by a hash of the source, the shared headers (csrc/*.cuh) and the
flags, then loaded with ctypes.
Several sources build in parallel (one nvcc process each).  A failed
build raises with nvcc's stderr.  Nothing is built at import.

An ops module declares a source's C entries in one `Library` (entry
name -> argtypes and restype); the first use of an entry builds and
binds that source.  `Library.launch` calls an entry on the device of a
tensor and its current stream, raises on a CUDA error and counts the
launch in `launches` under the kernel instance's name.  `resident`
caches a launch's resident blocks for the fill counters
(`launch_slots`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# name -> (loaded library, nvcc's stderr of the build that made it;
# empty when the library was already in the build directory)
_loaded: dict[str, tuple[ctypes.CDLL, str]] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _so_path(src: str) -> str:
    """The library's path, keyed by the source, the shared headers in
    csrc/ (any source may include them) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    key = h.hexdigest()
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{key[:16]}.so")


def build(*names: str) -> list[tuple[ctypes.CDLL, str]]:
    """Compile (once per source) and load csrc/<name> for each name.

    Returns one (library, build log) pair per name, in order.  The
    builds that are needed run concurrently.
    """
    todo = [n for n in dict.fromkeys(names) if n not in _loaded]
    procs = []
    for name in todo:
        src = os.path.join(CSRC, name)
        so = _so_path(src)
        if os.path.exists(so):
            procs.append((name, src, so, None, None))
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        procs.append((name, src, so, tmp, proc))
    failed = []
    for name, src, so, tmp, proc in procs:
        log = ""
        if proc is not None:
            _out, log = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{log}")
                continue
            os.replace(tmp, so)
        _loaded[name] = (ctypes.CDLL(so), log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_loaded[n] for n in names]


class Library:
    """The C entries of csrc/<source>, declared by `signatures` (entry
    name -> (argtypes, restype)); every entry takes the device index and
    the stream last and returns 0 or a CUDA error code, or is a query.

    The source is built and bound on the first use of one of its
    entries, never at import; `log` then holds nvcc's report of the
    build (empty when the library was already in the build directory).
    """

    def __init__(self, source: str, signatures: dict[str, tuple]):
        self.source = source
        self.signatures = signatures
        self.log = ""
        self._fns: dict | None = None

    def load(self) -> dict:
        """Build (once per source) and bind the library; its bound C
        functions by entry name."""
        if self._fns is None:
            (cdll, self.log), = build(self.source)
            fns = {}
            for entry, (argtypes, restype) in self.signatures.items():
                fn = fns[entry] = getattr(cdll, entry)
                fn.argtypes, fn.restype = argtypes, restype
            self._fns = fns
        return self._fns

    def entry(self, name: str):
        """The bound C function `name` (building the source first)."""
        return self.load()[name]

    def launch(self, entry: str, name: str, *args, on: torch.Tensor) -> int:
        """Call `entry` with args, then the index and current stream of
        `on`'s CUDA device; count it under `name` once it succeeded.
        Returns the device index."""
        dev = device(on)
        err = (self._fns or self.load())[entry](
            *args, dev, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        launches[name] += 1
        return dev


# Launches since import (or since a caller cleared it), by kernel
# instance: antidiag.score, antidiag.flags, colsweep.sweep.regs,
# colsweep.sweep.smem, colsweep.chain, walk, colband.r<R>,
# probe.colband.r<R>, probe.colband_split.r<R>, probe.wave, probe.skew.
launches: Counter = Counter()


def launched(prefix: str) -> int:
    """Launches counted under `prefix` or a name below it (prefix.*)."""
    return sum(n for k, n in launches.items()
               if k == prefix or k.startswith(prefix + "."))


def device(t: torch.Tensor) -> int:
    """The index of the CUDA device `t` is on; ValueError elsewhere."""
    if not t.is_cuda:
        raise ValueError(f"the CUDA kernels need CUDA tensors, got "
                         f"{t.device}")
    return t.get_device()


def check(*named) -> None:
    """ValueError unless the (name, tensor) pairs are contiguous and on
    the first one's device."""
    dev = named[0][1].device
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, not {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def blocks_per_sm(n: int) -> int:
    """An occupancy query's result n: resident blocks per SM, or minus
    the CUDA error the query failed with (RuntimeError)."""
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


# Blocks resident on a card at once, by (key, device), each asked once.
_residents: dict[tuple, int] = {}


def resident(key, query, dev: int) -> int:
    """Blocks of the launch `key` resident on device `dev` at once:
    query() (its `blocks_per_sm`) times the card's SMs, asked once per
    (key, dev)."""
    if (key, dev) not in _residents:
        _residents[key, dev] = query() * torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _residents[key, dev]


def launch_slots(blocks: int, resident: int) -> int:
    """Block slots a launch holds: its waves, ceil(blocks / resident),
    times the blocks resident on the whole card at once.

    blocks / launch_slots is the launch's fill by its shape (the last
    wave's empty slots count against it), not achieved occupancy: a
    block that a Z-drop exit ends early frees its slot unseen.
    """
    if resident <= 0:
        raise ValueError(f"resident blocks must be positive, got {resident}")
    return -(-blocks // resident) * resident
