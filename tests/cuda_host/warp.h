// A CUDA kernel written for blocks of one warp, built for the host with
// g++ and run on the CPU, for tests (tests/test_torch_stage2_kernel.py,
// tests/test_torch_stage1_kernel.py):
// the block's 32 lanes are fibers (ucontext) in one thread, and each
// warp primitive switches to the next lane, so a primitive that every
// lane calls in the same order is a barrier. __shared__ variables become
// statics, which serve the one block running at a time. Included as
// <cuda_runtime.h> in place of the toolkit's.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
using std::max;
using std::min;

struct HostDim { unsigned x; };

struct HostWarp {
  ucontext_t lane_ctx[32];
  ucontext_t main_ctx;
  unsigned long long slot[32];
  int lane = 0;
};
inline HostWarp* host_warp;
inline HostDim blockIdx;
#define threadIdx (HostDim{(unsigned)host_warp->lane})

inline void host_switch() {     // to the next lane; back here when all did
  HostWarp* w = host_warp;
  int me = w->lane, next = (me + 1) & 31;
  w->lane = next;
  swapcontext(&w->lane_ctx[me], &w->lane_ctx[next]);
  w->lane = me;
}

inline void __syncwarp(unsigned = 0xffffffffu) { host_switch(); }

template <typename T> inline T host_xchg(T v, int src) {
  unsigned long long b = 0;
  std::memcpy(&b, &v, sizeof(T));
  host_warp->slot[host_warp->lane] = b;
  host_switch();
  unsigned long long r = host_warp->slot[src & 31];
  host_switch();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <typename T> inline T __shfl_xor_sync(unsigned, T v, int m) {
  return host_xchg(v, host_warp->lane ^ m);
}
template <typename T> inline T __shfl_sync(unsigned, T v, int src) {
  return host_xchg(v, src);
}
inline unsigned __ballot_sync(unsigned, bool p) {
  host_warp->slot[host_warp->lane] = p;
  host_switch();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (host_warp->slot[i] ? 1u : 0u) << i;
  host_switch();
  return m;
}
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline int __clz(unsigned x) { return x == 0 ? 32 : __builtin_clz(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __double2float_rn(double d) { return (float)d; }
inline float __ll2float_rn(long long v) { return (float)v; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
template <typename T> inline T __ldg(const T* p) { return *p; }

// Run fn() as the 32 lanes of each block 0..blocks-1 in turn.
template <typename F> void host_launch(int blocks, F fn) {
  static F* call;
  call = &fn;
  constexpr size_t kStack = 1 << 18;
  std::vector<char> stacks(32 * kStack);
  HostWarp w;
  host_warp = &w;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    for (int l = 0; l < 32; ++l) {
      getcontext(&w.lane_ctx[l]);
      w.lane_ctx[l].uc_stack.ss_sp = stacks.data() + l * kStack;
      w.lane_ctx[l].uc_stack.ss_size = kStack;
      // a lane that returns resumes the next one; the last, the launcher
      w.lane_ctx[l].uc_link = l == 31 ? &w.main_ctx : &w.lane_ctx[l + 1];
      makecontext(&w.lane_ctx[l], +[] { (*call)(); }, 0);
    }
    w.lane = 0;
    swapcontext(&w.main_ctx, &w.lane_ctx[0]);
  }
}
