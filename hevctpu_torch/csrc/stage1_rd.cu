// Stage 1's candidate RD for Hopper (sm_90a): the residual RD cost of
// each candidate intra mode at every aligned n x n position of a batch of
// planes -- one launch a call of pipeline/encoder.py's
// _dense_rd_candidates under rate_model="global".
//
// It replaces no TPU kernel: the JAX package's candidate RD
// (hevctpu/pipeline/encoder.py, _dense_rd_candidates) is XLA code. The
// port ran it as ~150 aten kernels a row chunk: the references of every
// position (a cummax scan), all 35 modes predicted by one float32 matmul
// and the K candidates gathered, the forward transform as float64 GEMMs,
// quantisation, an int64 SSE and ops/rate.py's estimate in ~60 ops, every
// intermediate through device memory, in 13-17 chunks at 1080p.
//
// What it computes, for a position and one of its K candidate modes
// (ops/rd.py, mode_rd_costs under "global"): the 4n+1 boundary read from
// the boundary plane with the grid's availability (encoder._grid_avail),
// substitution, the [1 2 1] or strong smoothing (luma), the candidate's
// prediction with the DC and VER/HOR edge filters (luma n < 32), the
// residual against the plane, the exact forward DCT (DST at luma 4x4), the
// hard-decision quantiser, the dequantiser, the SSE of the coefficient
// error in int64 rounded once to float32 and scaled by 4^(log2 n - 7), and
// rate.estimate_tu_bits at the QP's weights; rd = dist + (λ/256)·bits in
// float32. Only the [B, R, C, K] costs are written to device memory.
//
// What bounds it on an H100: the forward transforms, 2n^3 multiply-adds a
// candidate, at the INT32 rate (~3.8 G multiply-adds a 1080p frame,
// benchmark/cellbench/roofline.stage1_transform_macs, ~0.23 ms at 132 SMs
// x 64 lanes x 1.98 GHz); its bytes (the planes read once, the costs
// written once) are a few MB. In practice a multiply-add costs a shared-
// memory read and an L1 read beside it, and the quantiser and the rate
// estimate per coefficient add as much again.
//
// Design: a warp a position, blocks of up to 4 warps over the whole batch
// in one launch, a kernel instantiated for each n. The warp builds the
// position's references once, in shared memory (the plain version
// rebuilds them for every row chunk and predicts all 35 modes), then
// codes its K candidates one after another; at 4x4 two side by side, a
// half-warp each. The shared-memory rows of the residual and the
// transform's first pass are n + 1 words apart, so a warp's column reads
// fall on distinct banks. Each warp's arrays are sized for the launch's n
// (dynamic shared memory, 0.7-15 KB a warp). The per-TU functions are
// stage 2's (intra_tu.cuh). On an H100 the 25 launches of a 1088x1920 x 8
// decision take ~20 ms, ~10x the bound: a warp's TU is a chain of shared-
// memory round trips, shuffles and __syncwarp, hidden only as far as the
// warps an SM holds (16-32, by registers and shared memory) allow.
//
// Bit-identical to the plain version: integers exactly; the cost in
// float32 in the plain version's order and types, and built with
// --fmad=false so that the product and the sum round apart as torch's do.
// Every table (transform matrices, angular tables, filter flags, scans,
// rate weights and last-position bits, quantiser scales) comes from the
// Python functions the plain version uses (ops/stage1_rd.py, tables_np).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false -O3
//        -shared -Xcompiler -fPIC (driven by hevctpu_torch/ops/stage1_rd.py).

#include <cstdint>

#include <cuda_runtime.h>

#include "intra_tu.cuh"

// The tables of one launch's size, device pointers into one int32 buffer
// that ops/stage1_rd.py builds (tables_np) and fills in this order.
struct Stage1Tables {
  const int* mat;           // [n][n] DCT, or DST at luma 4x4 (transforms)
  const int* ang_src;       // [33][3n+2] (intra._angular_tables)
  const int* ang_idx;       // [33][3n+2]
  const int* ang_didx;      // [33][n]
  const int* ang_fact;      // [33][n]
  const int* filter;        // [35] filtered-reference flags (0 for chroma)
  const int* diag_pos;      // [n*n] y*n+x -> diagonal scan position (rate)
  const int* diag_idx;      // [n*n] the inverse of diag_pos
  const int* cg_pos;        // [(n/4)^2] group -> diagonal group position
  const int* last_bits;     // [n] rate._last_pos_bits at the QP's weights
  const int* weights;       // [10] rate.bin_weights(qp)
  const int* quant_scale;   // [6]
  const int* inv_scale;     // [6]
};

// One call: B planes of hp x wp, R = hp / n rows and C = wp / n columns of
// positions, K candidates each.
struct Stage1Args {
  const int* plane;         // [B][hp][wp] the blocks
  const int* bsrc;          // [B][hp][wp] the boundaries
  const uint8_t* avail;     // [R][C][4n+1] (encoder._grid_avail)
  const int* cand;          // [B][R][C][K] modes 0..34
  float* out;               // [B][R][C][K]
  int batch, hp, wp;
  int n, k, qp, luma;
  int warps;                // warps a block (set by the launch)
  float lam_u;              // λ / 256, the host's float64 rounded to float32
  Stage1Tables tab;
};

namespace {

constexpr int kMaxWarps = 4;

// A warp's shared-memory words at size n: four boundary arrays of 4n+1,
// then for its c TUs (2 at 4x4) the prediction / coefficients, the
// residual / levels and the first pass (rows n + 1 apart above 4x4), and
// the groups' sums.
__host__ __device__ __forceinline__ int warp_words(int n) {
  const int c = n == 4 ? 2 : 1, pitch = n == 4 ? 4 : n + 1;
  return 4 * (4 * n + 1) + c * n * n + 2 * c * n * pitch +
         c * (n / 4) * (n / 4);
}

// One warp a position, at the launch's size N: a kernel a size, so that
// the compiler unrolls the loops over a TU's rows and coefficients and
// keeps to 60-86 registers (125 with n a runtime value, which halved the
// warps an SM holds and doubled the time).
template <int N>
__global__ void __launch_bounds__(32 * kMaxWarps)
stage1_rd_kernel(const Stage1Args A) {
#if defined(__CUDACC__)
  extern __shared__ int smem[];
#else
  // the host build runs a block at a time: warp_words(32) a warp
  static int smem[kMaxWarps * (4 * 129 + 1024 + 2 * 32 * 33 + 64)];
#endif
  const Stage1Tables& T = A.tab;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int n = N, log2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  constexpr int nn = n * n, n2 = 2 * n;
  const int L = 4 * n + 1;
  const int R = A.hp / n, C = A.wp / n;
  const long long pos = (long long)blockIdx.x * A.warps + warp;
  if (pos >= (long long)A.batch * R * C) return;     // the whole warp
  constexpr int c = N == 4 ? 2 : 1, pitch = N == 4 ? 4 : N + 1;
  constexpr int tu = n * pitch;

  int* fill = smem + warp * warp_words(n);
  int* filt = fill + L;
  int* bnd = filt + L;
  int* fidx = bnd + L;
  int* pc = fidx + L;          // prediction, then coefficients [c][nn]
  int* rl = pc + c * nn;       // residual [c][n][pitch], then levels [c][nn]
  int* tm = rl + c * tu;       // the transform's first pass
  int* cg = tm + c * tu;

  const int b = (int)(pos / (R * C)), rc = (int)(pos % (R * C));
  const int y0 = rc / C * n, x0 = rc % C * n;
  const size_t plane_words = (size_t)A.hp * A.wp;
  const int* src = A.bsrc + b * plane_words;
  const uint8_t* av = A.avail + (size_t)rc * L;
  const bool luma = A.luma != 0;

  // the references, once a position: out-of-plane reads clamp to the
  // edge (never available), as intra_mm.grid_boundaries does
  reference(bnd, fidx, fill, n, [&](int i, int& v) {
    int dy = i < n2 ? n2 - 1 - i : -1;
    int dx = i < n2 ? -1 : i - n2 - 1;
    int y = min(max(y0 + dy, 0), A.hp - 1);
    int x = min(max(x0 + dx, 0), A.wp - 1);
    v = src[(size_t)y * A.wp + x];
    return av[i] != 0;
  }, lane);
  if (luma && n >= 8) smooth(fill, filt, n, lane);
  const int dc = dc_value(fill, n, log2, lane);

  const int* orig = A.plane + b * plane_words + (size_t)y0 * A.wp + x0;
  const int* cand = A.cand + pos * A.k;
  float* out = A.out + pos * A.k;
  const int qp = A.qp;
  const int qs = T.quant_scale[qp % 6];
  const int qbits = 14 + qp / 6 + (15 - 8 - log2);
  const float dscale = ldexpf(1.0f, 2 * (log2 - 7));
  constexpr int seg = c == 2 ? 16 : 32;      // lanes a TU
  const int t = c == 2 ? lane >> 4 : 0;      // this lane's TU
  const int sub = lane & (seg - 1);

  for (int k0 = 0; k0 < A.k; k0 += c) {
    // the candidate (the last one twice where K is odd at 4x4)
    const int mode = cand[min(k0 + t, A.k - 1)];
    const bool use_f = luma && T.filter[mode] != 0;
    predict_mode(pc + t * nn, use_f ? filt : fill, fill, dc, n, log2, mode,
                 luma && n < 32, T.ang_src, T.ang_idx, T.ang_didx,
                 T.ang_fact, sub, seg);
    __syncwarp();
    for (int e = lane; e < c * nn; e += 32) {
      int u = e >> (2 * log2), f = e & (nn - 1);
      int y = f >> log2, x = f & (n - 1);
      rl[u * tu + y * pitch + x] = orig[(size_t)y * A.wp + x] - pc[e];
    }
    __syncwarp();
    forward(rl, tm, pc, T.mat, n, log2, c, pitch, lane);
    // hard quantisation, dequantisation and the coefficient error
    long long sse = 0;
    for (int e = lane; e < c * nn; e += 32) {
      int cf = pc[e];
      int l = hard_level(abs(cf), qs, qbits);
      l = cf < 0 ? -l : l;
      rl[e] = l;
      long long er = cf - dequant(l, log2, qp, T.inv_scale);
      sse += er * er;
    }
    sse = seg_sum(sse, seg);
    __syncwarp();
    int bits = estimate_tu_bits(cg, rl, c, n, log2, T.weights, T.last_bits,
                                T.diag_pos, T.diag_idx, T.cg_pos, lane);
    float rd = __fadd_rn(__fmul_rn(__ll2float_rn(sse), dscale),
                         __fmul_rn(A.lam_u, (float)bits));
    if (sub == 0 && k0 + t < A.k) out[k0 + t] = rd;
  }
}

}  // namespace

#if defined(__CUDACC__)
extern "C" {

int stage1_rd_args_size() { return (int)sizeof(Stage1Args); }

// One call on `stream`: blocks of as many warps (up to 4) as fit 48 KB of
// shared memory, a warp a position.
int stage1_rd_launch(const Stage1Args* args, cudaStream_t stream) {
  Stage1Args a = *args;
  const int bytes = warp_words(a.n) * 4;
  a.warps = 48 * 1024 / bytes;
  a.warps = a.warps > kMaxWarps ? kMaxWarps : a.warps < 1 ? 1 : a.warps;
  const long long pos =
      (long long)a.batch * (a.hp / a.n) * (a.wp / a.n);
  const long long blocks = (pos + a.warps - 1) / a.warps;
  if (blocks == 0) return 0;
  const dim3 grid((unsigned)blocks), block(32 * a.warps);
  const size_t smem = (size_t)a.warps * bytes;
  switch (a.n) {
    case 4: stage1_rd_kernel<4><<<grid, block, smem, stream>>>(a); break;
    case 8: stage1_rd_kernel<8><<<grid, block, smem, stream>>>(a); break;
    case 16: stage1_rd_kernel<16><<<grid, block, smem, stream>>>(a); break;
    case 32: stage1_rd_kernel<32><<<grid, block, smem, stream>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* stage1_rd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
#endif
