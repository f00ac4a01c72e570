"""csrc/antidiag.cu itself, compiled with g++ against a stand-in for the
CUDA built-ins it uses, against the plain version on the CPU.

The stand-in runs one block at a time, one fiber per CUDA thread (all
in one OS thread: a fiber runs until it waits at a barrier, then the
others take their turns): `__syncthreads` is a barrier over the block,
the warp built-ins (`__syncwarp`, the shuffles, `__reduce_max_sync`,
`__all_sync`, `__ballot_sync`) exchange through a table behind a
barrier over the warp, `__shared__` arrays are statics of the kernel
function and the dynamic shared memory is a buffer of the launch.
`cp.async` (`__pipeline_memcpy_async`) copies at once, so its commit
and wait are no-ops; `clock64` reads 0; a shared-memory `atomicMax` is
a plain read-max-write (fibers switch only at barriers) and the DPX
maxima (`__vimax3_s32`, `__viaddmax_s32`) are written out.  The walk
and the column sweeps use the same header
(tests/test_torch_walk_standin.py, tests/test_torch_colband_standin.py,
tests/test_torch_colsweep_standin.py).  The kernel's source is used as
it is, up to its C entry (the launch is the stand-in's); only the line
declaring the dynamic shared memory is rewritten.  It checks the CUDA
source's arithmetic, schedule and hand-offs before (and beside) the
card; it says nothing about the card's compiler, timing or memory
model.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from agatha_tpu_torch.ops import kernel, walk

from .test_torch_tiles import CASES, _bucket

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "agatha_tpu_torch", "csrc")

STANDIN_H = r"""
#pragma once
#include <climits>
#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
#include <ucontext.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(x) __attribute__((aligned(x)))
struct int4 { int x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
inline int max(int a, int b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
struct dim { int x; };
inline dim threadIdx, blockIdx, blockDim;
// A block runs as fibers of one OS thread, one per CUDA thread: a fiber
// runs until it waits at a barrier, then the block's other fibers take
// their turns (so the test's speed does not depend on free cores).  A
// fiber's first run starts from its ucontext; every switch after that
// saves and restores registers and the stack pointer alone (_setjmp /
// _longjmp: no signal mask, so no system call).
namespace standin {
constexpr size_t kStack = 1 << 16;
struct Jump { jmp_buf b; };
inline jmp_buf main_jump;
inline std::vector<Jump> jumps;
inline std::vector<char> started;
inline std::vector<ucontext_t> ctx;
inline std::vector<std::unique_ptr<char[]>> stacks;
inline std::vector<char> done;
// the barrier generation a fiber waits to see change, or null: the
// scheduler resumes only fibers whose barrier has opened
inline std::vector<const unsigned*> wait_gen;
inline std::vector<unsigned> wait_val;
inline std::function<void()> kernel_call;
inline void yield() {
  if (!_setjmp(jumps[threadIdx.x].b)) _longjmp(main_jump, 1);
}
inline void entry(int t) {
  kernel_call();
  done[t] = 1;
  _longjmp(main_jump, 1);  // a fiber never returns through uc_link
}
}  // namespace standin
struct Barrier {
  explicit Barrier(int n) : n(n) {}
  void arrive_and_wait() {
    const unsigned g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      return;
    }
    standin::wait_gen[threadIdx.x] = &gen;
    standin::wait_val[threadIdx.x] = g;
    while (gen == g) standin::yield();
    standin::wait_gen[threadIdx.x] = nullptr;
  }
  int n, count = 0;
  unsigned gen = 0;
};
inline Barrier* g_block;
inline std::vector<Barrier> g_warps;
// two tables a warp, taken in turn: a lane posts into a table again only
// after every lane has posted into the other, so after every lane has
// read this one
inline int g_lanes[32][2][32];
inline std::vector<unsigned char> g_turn;  // per thread: its next table
// Runs fn() as the `threads` CUDA threads (a multiple of 32) of block b.
inline void run_block(int b, int threads, std::function<void()> fn) {
  using namespace standin;
  blockIdx.x = b;
  blockDim.x = threads;
  Barrier block(threads);
  g_block = &block;
  g_warps.assign(threads / 32, Barrier(32));
  kernel_call = std::move(fn);
  ctx.resize(threads);
  while (static_cast<int>(stacks.size()) < threads)
    stacks.emplace_back(new char[kStack]);
  done.assign(threads, 0);
  started.assign(threads, 0);
  jumps.resize(threads);
  g_turn.assign(threads, 0);
  wait_gen.assign(threads, nullptr);
  wait_val.assign(threads, 0);
  for (int t = 0; t < threads; ++t) {
    getcontext(&ctx[t]);
    ctx[t].uc_stack.ss_sp = stacks[t].get();
    ctx[t].uc_stack.ss_size = kStack;
    ctx[t].uc_link = nullptr;
    makecontext(&ctx[t], reinterpret_cast<void (*)()>(entry), 1, t);
  }
  for (int left = threads; left > 0;) {
    for (int t = 0; t < threads; ++t) {
      if (done[t] || (wait_gen[t] && *wait_gen[t] == wait_val[t]))
        continue;
      threadIdx.x = t;
      if (!_setjmp(main_jump)) {
        if (started[t]) _longjmp(jumps[t].b, 1);
        started[t] = 1;
        setcontext(&ctx[t]);
      }
      left -= done[t];
    }
  }
}
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __syncwarp(unsigned = ~0u) {
  g_warps[threadIdx.x >> 5].arrive_and_wait();
}
// every lane of the warp posts v; returns the table row (valid until
// the lane's next post)
inline const int* __warp_post(int v) {
  const int w = threadIdx.x >> 5;
  int* const row = g_lanes[w][g_turn[threadIdx.x]];
  g_turn[threadIdx.x] ^= 1;
  row[threadIdx.x & 31] = v;
  g_warps[w].arrive_and_wait();
  return row;
}
inline int __reduce_max_sync(unsigned, int v) {
  const int* t = __warp_post(v);
  int m = INT_MIN;
  for (int i = 0; i < 32; ++i) m = m > t[i] ? m : t[i];
  return m;
}
inline int __all_sync(unsigned, int v) {
  const int* t = __warp_post(v != 0);
  int all = 1;
  for (int i = 0; i < 32; ++i) all &= t[i];
  return all;
}
inline unsigned __ballot_sync(unsigned, int v) {
  const int* t = __warp_post(v != 0);
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i) bits |= static_cast<unsigned>(t[i]) << i;
  return bits;
}
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
// fibers switch only at barriers, so a read-modify-write is atomic
inline int atomicMax(int* p, int v) {
  const int old = *p;
  *p = old > v ? old : v;
  return old;
}
// Hopper's DPX three-operand maxima
inline int __vimax3_s32(int a, int b, int c) { return max(max(a, b), c); }
inline int __viaddmax_s32(int a, int b, int c) { return max(a + b, c); }
template <class T>
inline T __shfl_from(T v, int src) {
  int x;
  std::memcpy(&x, &v, 4);
  const int* t = __warp_post(x);
  const int y = t[src];
  T r;
  std::memcpy(&r, &y, 4);
  return r;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int l = threadIdx.x & 31;
  return __shfl_from(v, (l & ~(width - 1)) | (src & (width - 1)));
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d, int width = 32) {
  const int l = threadIdx.x & 31;
  const int s = (l & (width - 1)) >= static_cast<int>(d) ? l - d : l;
  return __shfl_from(v, s);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m, int width = 32) {
  const int l = threadIdx.x & 31;
  return __shfl_from(v, (l ^ m) & 31);
}
template <class T>
inline T __ldg(const T* p) { return *p; }
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t zfill = 0) {
  std::memcpy(dst, src, n - zfill);
  std::memset(static_cast<char*>(dst) + (n - zfill), 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
inline long long clock64() { return 0; }
typedef int cudaError_t;
typedef void* cudaStream_t;
"""


def compile_standin(d, body: str, driver: str):
    """g++ the kernel body (`kernel_body.inc`) and its driver in `d`
    against STANDIN_H (as cuda_runtime.h and the pipeline header);
    returns the loaded library."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed (the port's native packer needs it too)"
    (d / "cuda_runtime.h").write_text(STANDIN_H)
    (d / "cuda_pipeline_primitives.h").write_text(
        '#pragma once\n#include "cuda_runtime.h"\n')
    (d / "kernel_body.inc").write_text(body)
    (d / "driver.cpp").write_text(driver)
    so = d / "libstandin.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-U_FORTIFY_SOURCE", "-shared", "-fPIC",
         f"-I{d}",
         "-Wno-unknown-pragmas", "-o", str(so), str(d / "driver.cpp"),
         "-lpthread"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ctypes.CDLL(str(so))


DRIVER = r"""
#include "cuda_runtime.h"
static int4* g_dyn;
#include "kernel_body.inc"
extern "C" int run(const void* meta, const void* tcodes, const void* qfwd,
                   void* out, int gb, int wt, int qf, int w_state,
                   int windowed, int safe16, int match, int mismatch,
                   int goe, int ge, int sw, int z, int bw, void* flags,
                   int planes) {
  const int threads = tile_threads(bw, wt);
  if (threads == 0) return 1;
  Params p;
  p.meta = static_cast<const int32_t*>(meta);
  p.tcodes = static_cast<const uint8_t*>(tcodes);
  p.qfwd = static_cast<const uint8_t*>(qfwd);
  p.out = static_cast<int32_t*>(out);
  p.wt = wt; p.qf = qf; p.w_state = w_state; p.windowed = windowed;
  p.match = match; p.mismatch = mismatch; p.goe = goe; p.ge = ge;
  p.sw = sw; p.z = z; p.bw = bw;
  p.flags = static_cast<int32_t*>(flags); p.planes = planes;
  p.slots = 64;
  while (p.slots < 2 * threads) p.slots *= 2;
  std::vector<int4> dyn(p.slots * 17 / 4 + 1);
  g_dyn = dyn.data();
  void (*kern)(const Params) =
      threads <= 256 ? pick<256>(safe16, flags != nullptr)
                     : pick<1024>(safe16, flags != nullptr);
  for (int b = 0; b < gb; ++b) run_block(b, threads, [&] { kern(p); });
  return 0;
}
"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    d = tmp_path_factory.mktemp("standin")
    with open(os.path.join(CSRC, "antidiag.cu")) as f:
        src = f.read()
    body = src[src.index('#include "antidiag_common.cuh"'):
               src.index("// Launches one bucket")]
    common = os.path.join(CSRC, "antidiag_common.cuh")
    body = body.replace('#include "antidiag_common.cuh"',
                        f'#include "{common}"')
    body, n = re.subn(r"extern __shared__ int4 smem4\[\];",
                      "int4* const smem4 = g_dyn;", body)
    assert n == 1
    body = body.replace("}  // namespace", "}")
    lib = compile_standin(d, body, DRIVER)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes = [vp] * 4 + [ci] * 13 + [vp, ci]
    lib.run.restype = ci
    return lib


def run_standin(lib, meta, tcodes, qfwd, cfg, *, force_strips=False,
                planes=0):
    """The kernel's (GB, 4) output (and with planes > 0 its bitmap, 0
    where it writes nothing) on the CPU."""
    wt, qf, w_state, windowed, safe16 = kernel._bucket_geometry(
        tcodes, qfwd, cfg, force_strips)
    meta = np.ascontiguousarray(meta, np.int32)
    tcodes = np.ascontiguousarray(tcodes)
    qfwd = np.ascontiguousarray(qfwd)
    out = np.zeros((meta.shape[0], 4), np.int32)
    flags = np.zeros((meta.shape[0], planes * w_state), np.int32)
    rc = lib.run(meta.ctypes.data, tcodes.ctypes.data, qfwd.ctypes.data,
                 out.ctypes.data, meta.shape[0], wt, qf, w_state,
                 int(windowed), int(safe16), cfg.match, cfg.mismatch,
                 cfg.gap_oe, cfg.gap_extend, cfg.slice_width,
                 cfg.z_threshold, cfg.band_width,
                 flags.ctypes.data if planes else None, planes)
    assert rc == 0
    return (out, flags) if planes else out


@pytest.mark.parametrize("case", list(CASES))
def test_standin_kernel_equals_plain(standin, case):
    cfg, _pairs, meta, tcodes, qfwd = _bucket(case)
    ref = kernel.align_bucket_torch(
        *(torch.from_numpy(a) for a in (meta, tcodes, qfwd)), cfg).numpy()
    assert (run_standin(standin, meta, tcodes, qfwd, cfg) == ref).all()


@pytest.mark.parametrize("case", ["z-1-wrap", "bw751-full"])
def test_standin_kernel_force_strips(standin, case):
    cfg, _pairs, meta, tcodes, qfwd = _bucket(case)
    ref = kernel.align_bucket_torch(
        *(torch.from_numpy(a) for a in (meta, tcodes, qfwd)), cfg,
        force_strips=True).numpy()
    got = run_standin(standin, meta, tcodes, qfwd, cfg, force_strips=True)
    assert (got == ref).all()


@pytest.mark.parametrize("case", ["windowed-bw60", "zdrop-inside-plane",
                                  "n-runs-and-one-code", "sw1-bw50-z-1"])
def test_standin_flags_equal_plain(standin, case):
    """B3: results equal, the bitmap equal on every computed cell of the
    swept planes, and the walked words equal."""
    cfg, _pairs, meta, tcodes, qfwd = _bucket(case)
    planes = kernel.flag_planes_needed(meta, cfg)
    out, flags = run_standin(standin, meta, tcodes, qfwd, cfg,
                             planes=planes)
    ref, ref_flags, mask = kernel.align_bucket_torch(
        *(torch.from_numpy(a) for a in (meta, tcodes, qfwd)), cfg,
        emit_flags=True, planes=planes, return_mask=True)
    assert (out == ref.numpy()).all()
    gb = out.shape[0]
    last = (np.maximum(out[:, 3], 1) - 1) >> 3
    keep = np.arange(planes)[None, :] < last[:, None]
    m = mask.numpy().reshape(gb, planes, -1)
    a = (flags.reshape(gb, planes, -1) & m)[keep]
    b = (ref_flags.numpy().reshape(gb, planes, -1) & m)[keep]
    assert (a == b).all()
    vbases = torch.from_numpy(
        walk.vbase_schedule(planes, cfg, 2 * tcodes.shape[1]))
    assert torch.equal(
        walk.walk_torch(torch.from_numpy(flags), vbases,
                        torch.from_numpy(out)),
        walk.walk_torch(ref_flags, vbases, ref))
