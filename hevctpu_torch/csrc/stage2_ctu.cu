// Stage 2 of one wavefront diagonal for Hopper (sm_90a): every CTU and
// plane of the diagonal codes its own transform units, in z-order, in
// shared memory -- one launch a diagonal.
//
// It replaces no TPU kernel: the JAX package's stage 2
// (hevctpu/pipeline/encoder.py, _reconstruct) is XLA code, a masked
// schedule of 424 TU steps a diagonal. The port replayed that schedule
// as CUDA graphs of ~700 aten kernels a step (pipeline/encoder.py,
// _Wavefront._quad and _block), so a diagonal ran ~300k tiny kernels,
// each computing every row and discarding the rows its fire mask left
// out. This kernel runs between the diagonal's gather (_open) and
// scatter (_close), which stay CUDA graphs, and reads and writes their
// static buffers in place.
//
// What it computes, for one TU (pipeline/encoder.py, _tu_chain): the
// boundary of 4n+1 samples from the extended CTU buffer, availability
// (decoded before, from the schedule's tables, and inside the picture),
// substitution (H.265 8.4.4.2.2), the [1 2 1] or strong smoothing, the
// selected mode's prediction (8.4.4.2.4-6), the forward DCT (DST for
// luma 4x4), RDOQ or the hard-decision quantiser (ops/quant.py), the
// 4x4 transform-skip trial, sign-bit hiding, dequantisation, the
// inverse transform and the clamped recon, written into the buffer that
// the next TU reads its boundary from.
//
// What bounds it on an H100: the serial chain of TUs inside a CTU. A
// TU's boundary depends on the TUs before it in z-order, so the busiest
// CTU of a diagonal (up to 256 luma 4x4 TUs, each with the TS trial)
// sets the diagonal's time, whatever the others do; the arithmetic, 4n^3
// multiply-adds a TU and the quantiser's per-coefficient costs, is a
// few microseconds of one warp. Its bytes (the diagonal's source, recon
// and levels) are a few MB.
//
// Design: one block of one warp for each (CTU row, plane): luma for
// each of the R rows, then U and V for each chroma row; a row whose CTU
// is inactive on this diagonal returns at once. A block walks the
// static schedule (a table the wrapper builds from the Python schedule,
// the TU8 steps each followed by their four TU4 steps) and codes a step
// only where its row's leaf-TU-size and coded-slot maps say so: a
// branch, not a mask. The CTU's extended buffer, 8-bit, and the TU's
// working arrays live in shared memory (~44 KB a block); a TU's n^2
// coefficients run across the warp's lanes, and the 4x4 TS trial codes
// its two candidates side by side, one a half-warp. No block-wide
// barrier: __syncwarp between phases.
//
// Bit-identical to the plain version (the eager _Wavefront on the CPU):
// integers exactly; the float decisions of RDOQ, the TS trial and SBH in
// the plain version's order and types -- float32 products and sums
// left to right (quant.seqsum), the scan cumsums in float64 rounded
// once to float32, error sums in int64 -- and built with --fmad=false,
// so that no multiply-add fuses where torch rounds twice. Every table
// (transform matrices, scans, rate weights and last-position bits,
// angular tables, filter flags, quantiser scales, the schedule and its
// decoded-before masks) comes from the Python functions the plain
// version uses (ops/stage2_ctu.py, tables_np). The per-TU pieces it
// shares with stage 1's RD kernel (references, prediction, the forward
// transform, the rate estimate, the warp reductions) are in intra_tu.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false -O3
//        -shared -Xcompiler -fPIC (driven by hevctpu_torch/ops/stage2_ctu.py).

#include <cstdint>

#include <cuda_runtime.h>

#include "intra_tu.cuh"

namespace {

constexpr int kMaxNN = 1024;          // 32x32 coefficients
constexpr int kExtY = 97 * 130;       // luma extended buffer
constexpr int kStepWords = 8;         // words of one schedule entry

}  // namespace

// The tables, device pointers into one int32 buffer that
// ops/stage2_ctu.py builds (tables) and fills in this order. Index [i]
// of a per-size array is log2(n) - 2 (n = 4, 8, 16, 32); [p] of a
// per-plane one is 0 luma, 1 chroma.
struct Stage2Tables {
  const int* dct[4];        // [n][n] T[k][x] (transforms._mat_np)
  const int* dst4;          // [4][4]
  const int* scan_idx[4];   // [3][n*n] scan position -> y*n+x (quant)
  const int* scan_pos[4];   // [3][n*n] y*n+x -> scan position (quant)
  const int* diag_pos[4];   // [n*n] y*n+x -> diagonal scan position (rate)
  const int* diag_idx[4];   // [n*n] the inverse of diag_pos
  const int* cg_pos[4];     // [(n/4)^2] group -> diagonal group position
  const int* last_bits[2][4];  // [n] rate._last_pos_bits at the plane's QP
  const int* weights[2];    // [10] rate.bin_weights at the plane's QP
  const int* pos_in_cg;     // [3][16] (quant._pos_in_cg)
  const int* quant_scale;   // [6]
  const int* inv_scale;     // [6]
  const int* ang_src[4];    // [33][3n+2] (intra._angular_tables)
  const int* ang_idx[4];    // [33][3n+2]
  const int* ang_didx[4];   // [33][n]
  const int* ang_fact[4];   // [33][n]
  const int* filter[4];     // [35] luma filtered-reference flags
  const int* steps;         // [n_steps][8] the schedule (see walk below)
  const int* avail;         // decoded-before masks the steps point into
  int n_steps;
};

// One diagonal's buffers (_Wavefront.buf) and quantiser settings. A
// per-row pointer is null where the setting is one static value; [p] is
// 0 luma, 1 chroma. The scalar λ products are the host's float64
// products rounded to float32, as torch adds a Python float to a float32
// tensor.
struct Stage2Args {
  int* ext_y;               // [R][97][130]
  int* ext_c;               // [2R][49][66]
  const int* oyl;           // [R][64][64]
  const int* ouv;           // [2R][32][32]
  const int* tz;            // [R][8][8] leaf TU log2
  const uint8_t* c8;        // [R][8][8] coded slots
  const int* msl;           // [R][8][8] luma modes
  const int* cm8;           // [R][8][8] chroma modes
  const int* mm4;           // [R][16][16] 4x4 luma modes
  const uint8_t* mk;        // [R] active rows
  const int64_t* ctu_y;     // [R] picture origins, luma
  const int64_t* ctu_x;
  const int64_t* ctu_yc;    // [2R] chroma
  const int64_t* ctu_xc;
  int* vy;                  // [R][64][64] levels out
  int* vc;                  // [2R][32][32]
  uint8_t* cy8;             // [R][8][8] luma cbf (TU8-32)
  uint8_t* cc8;             // [2R][8][8] chroma cbf
  uint8_t* tc8;             // [2R][8][8] chroma transform skip
  uint8_t* cy4;             // [R][16][16] luma cbf (TU4)
  uint8_t* ty4;             // [R][16][16] luma transform skip (TU4)
  const int* qp_rows[2];    // [R], [2R] or null
  const float* rdoq_rows[2];
  const float* ts_rows[2];
  int qp[2];
  float rdoq_lam_u[2];      // λ / 256
  float rdoq_csbf[2];       // λ / 256 * w_csbf
  float rdoq_cbf0[2];       // λ / 256 * w_cbf0
  float ts_lam_u[2];
  int rdoq_on[2];
  int ts_on[2];
  int rows;                 // R
  int h, w;                 // luma picture size
  int sbh;
  int tu4;                  // NxN or the TU tree: the TU4 steps run
  Stage2Tables tab;
};

namespace {

// ---------------------------------------------------------------------------
// Shared memory of a block
// ---------------------------------------------------------------------------

union Work {
  float f[kMaxNN];
  int i[kMaxNN];
};

struct Smem {
  uint8_t ext[kExtY];       // the CTU's extended buffer (luma or chroma)
  int pred[kMaxNN];
  int cf[kMaxNN];           // coefficients, one or two candidates
  int lv[kMaxNN];           // levels, one or two candidates
  Work w1, w2, w3, w4;      // see code_tu for what each holds when
  int bnd[129];             // boundary samples in scan order
  int fidx[129];            // the sample each one takes
  int fill[129];            // substituted
  int filt[129];            // smoothed
  int cg[64];               // per coefficient group: sums, Rice, kill
};

struct Plane {
  int pl;                   // 0 luma, 1 chroma
  uint8_t* ext;
  int stride;               // 130 luma, 66 chroma
  const int* orig;          // [span][span] of the row
  int span;
  int* levels;              // [span][span]
  int cy, cx, h, w;         // CTU picture origin, plane size
  int qp;
  bool rdoq;
  float lam_u, lam_csbf, lam_cbf0;
  bool ts;
  float ts_lam_u;
  bool sbh_on;
  const int* weights;
};

// ---------------------------------------------------------------------------
// Prediction (ops/intra.py: fill_reference, smooth_reference,
// predict_one_mode), into s.pred.
// ---------------------------------------------------------------------------

__device__ void predict(Smem& s, const Stage2Tables& T, const Plane& P,
                        int n, int log2, int oy, int ox, int mode,
                        const int* av, bool luma, int lane) {
  const int n2 = 2 * n;
  // boundary samples from the extended buffer; available where decoded
  // before (av) and inside the picture
  reference(s.bnd, s.fidx, s.fill, n, [&](int i, int& v) {
    int dy = i < n2 ? n2 - 1 - i : -1;
    int dx = i < n2 ? -1 : i - n2 - 1;
    v = P.ext[(oy + 1 + dy) * P.stride + ox + 1 + dx];
    int fy = P.cy + oy + dy, fx = P.cx + ox + dx;
    return av[i] != 0 && fy >= 0 && fx >= 0 && fy < P.h && fx < P.w;
  }, lane);
  const bool use_f = luma && T.filter[log2 - 2][mode] != 0;
  if (use_f) smooth(s.fill, s.filt, n, lane);
  const int dc = mode == 1 ? dc_value(s.fill, n, log2, lane) : 0;
  predict_mode(s.pred, use_f ? s.filt : s.fill, s.fill, dc, n, log2, mode,
               luma && n < 32, T.ang_src[log2 - 2], T.ang_idx[log2 - 2],
               T.ang_didx[log2 - 2], T.ang_fact[log2 - 2], lane, 32);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// The inverse transform (ops/transforms.py), n x n int32 in shared memory
// ---------------------------------------------------------------------------

// out[y][x] = rs(sum_j M[j][x] clip16(rs(sum_k M[k][y] deq[k][j], 7)), 12)
__device__ void inverse(const int* deq, int* tmp, int* out, const int* m,
                        int n, int log2, int lane) {
  const int nn = n * n;
  for (int e = lane; e < nn; e += 32) {
    int i = e >> log2, j = e & (n - 1);
    int acc = 0;
    for (int k = 0; k < n; ++k) acc += __ldg(m + k * n + i) * deq[k * n + j];
    tmp[e] = min(max((acc + 64) >> 7, -32768), 32767);
  }
  __syncwarp();
  for (int e = lane; e < nn; e += 32) {
    int y = e >> log2, x = e & (n - 1);
    int acc = 0;
    for (int j = 0; j < n; ++j) acc += __ldg(m + j * n + x) * tmp[y * n + j];
    out[e] = (acc + 2048) >> 12;
  }
  __syncwarp();
}

// rate.estimate_tu_bits for `c` TUs of n x n (|levels| in arr, TU-major)
// at the plane's rate QP: every lane returns the bits of the TU of its
// segment.
__device__ __forceinline__ int tu_bits(Smem& s, const Stage2Tables& T,
                                       const Plane& P, const int* arr, int c,
                                       int n, int log2, int lane) {
  return estimate_tu_bits(s.cg, arr, c, n, log2, P.weights,
                          T.last_bits[P.pl][log2 - 2], T.diag_pos[log2 - 2],
                          T.diag_idx[log2 - 2], T.cg_pos[log2 - 2], lane);
}

// ---------------------------------------------------------------------------
// Quantisation of c candidate TUs of s.cf into signed levels in s.lv:
// quant.quantize_rdoq (RDOQ on) or quant.quantize. w1..w4 are scratch.
// ---------------------------------------------------------------------------

__device__ void quantize(Smem& s, const Stage2Tables& T, const Plane& P,
                         int c, int n, int log2, int scan, int lane) {
  const int nn = n * n, tot = c * nn, seg = nn >= 32 ? 32 : 16;
  const int qp = P.qp;
  const int qs = T.quant_scale[qp % 6];
  const int qbits = 14 + qp / 6 + (15 - 8 - log2);
  if (!P.rdoq) {
    for (int e = lane; e < tot; e += 32) {
      int l = hard_level(abs(s.cf[e]), qs, qbits);
      s.lv[e] = s.cf[e] < 0 ? -l : l;
    }
    __syncwarp();
    return;
  }
  const int* inv = T.inv_scale;
  const int* w = P.weights;
  const int nc = n >> 2, cpc = nc * nc;
  const float dscale = ldexpf(1.0f, 2 * (log2 - 7));
  const float lam = P.lam_u;
  float* csel = s.w1.f;
  float* cz = s.w2.f;                // then the zero-out distortion
  float* csum = s.w3.f;
  float* zsum = s.w4.f;
  int* hdq = s.w3.i;                 // after the last-position pass

  // per coefficient: round-half level l1 and the groups' Rice parameters
  for (int e = lane; e < tot; e += 32)
    s.lv[e] = min((abs(s.cf[e]) * qs + (1 << (qbits - 1))) >> qbits, 32767);
  __syncwarp();
  for (int g = lane; g < c * cpc; g += 32) {
    const int* base = s.lv + (g / cpc) * nn;
    int gy = (g % cpc) / nc * 4, gx = (g % cpc) % nc * 4, sum = 0;
    for (int r = 0; r < 16; ++r)
      sum += base[(gy + (r >> 2)) * n + gx + (r & 3)];
    s.cg[g] = rice_param(sum);
  }
  __syncwarp();
  // {l1, l1 - 1, 0} by distortion + λ bits
  for (int e = lane; e < tot; e += 32) {
    int f = e & (nn - 1), y = f >> log2, x = f & (n - 1);
    int k = s.cg[(e / nn) * cpc + (y >> 2) * nc + (x >> 2)];
    int a = abs(s.cf[e]);
    int l1 = s.lv[e], l0 = max(l1 - 1, 0);
    float cost[3];
    int lv3[3] = {l1, l0, 0};
    for (int j = 0; j < 3; ++j) {
      float err = (float)(a - dequant(lv3[j], log2, qp, inv));
      cost[j] = __fadd_rn(__fmul_rn(__fmul_rn(err, err), dscale),
                          __fmul_rn(lam, (float)level_bits(lv3[j], k, w)));
    }
    float c1 = cost[0], c0 = cost[1], z = cost[2];
    int best = (c0 < c1 && l0 < l1) ? l0 : l1;
    float m = l0 < l1 ? c0 : c1;
    float cb = m < c1 ? m : c1;
    s.lv[e] = z <= cb ? 0 : best;
    csel[e] = z < cb ? z : cb;
    cz[e] = z;
  }
  __syncwarp();
  // coefficient-group zeroing: the group's coded cost + its flag's bits
  // against all zero, each a float32 sum left to right
  if (n > 4) {
    for (int g = lane; g < cpc; g += 32) {
      int gy = g / nc * 4, gx = g % nc * 4;
      float coded = 0.0f, zero = 0.0f;
      for (int r = 0; r < 16; ++r) {
        int f = (gy + (r >> 2)) * n + gx + (r & 3);
        coded = r ? __fadd_rn(coded, csel[f]) : csel[f];
        zero = r ? __fadd_rn(zero, cz[f]) : cz[f];
      }
      s.cg[g] = zero < __fadd_rn(coded, P.lam_csbf);
    }
    __syncwarp();
    for (int e = lane; e < tot; e += 32) {
      int y = e >> log2, x = e & (n - 1);
      if (s.cg[(y >> 2) * nc + (x >> 2)]) {
        s.lv[e] = 0;
        csel[e] = cz[e];
      }
    }
    __syncwarp();
  }
  // last position over the TU's scan: cumulative sums in float64
  for (int e = lane; e < tot; e += 32) {
    float af = (float)abs(s.cf[e]);
    cz[e] = __fmul_rn(__fmul_rn(af, af), dscale);
  }
  __syncwarp();
  const int* sidx = T.scan_idx[log2 - 2] + scan * nn;
  const int* spos = T.scan_pos[log2 - 2] + scan * nn;
  for (int t = 0; t < c; ++t) {
    if (lane == t * seg || lane == t * seg + 1) {
      const float* in = (lane & 1) ? cz + t * nn : csel + t * nn;
      float* out = (lane & 1) ? zsum + t * nn : csum + t * nn;
      double acc = 0.0;
      for (int p = 0; p < nn; ++p) {
        acc = __dadd_rn(acc, (double)in[sidx[p]]);
        out[p] = __double2float_rn(acc);
      }
    }
  }
  __syncwarp();
  const int* lb = T.last_bits[P.pl][log2 - 2];
  const float cbf1 = (float)w[kCbf1];
  float jbest = inf();
  int qbest = 0, any = 0;
  for (int e = lane; e < tot; e += 32) {
    int t = e / nn, p = e & (nn - 1), f = sidx[p];
    if (s.lv[t * nn + f] != 0) {
      any = 1;
      float tail = __fsub_rn(zsum[t * nn + nn - 1], zsum[e]);
      float lbits = __fadd_rn((float)(lb[f >> log2] + lb[f & (n - 1)]), cbf1);
      float j = __fadd_rn(__fadd_rn(csum[e], tail), __fmul_rn(lam, lbits));
      if (j < jbest) {
        jbest = j;
        qbest = p;
      }
    }
  }
  seg_argmin(jbest, qbest, seg);
  any = seg_max(any, seg);
  const float jzero = __fadd_rn(zsum[min(lane / seg, c - 1) * nn + nn - 1],
                                P.lam_cbf0);
  const bool zero = !any || jzero < jbest;
  __syncwarp();
  for (int e = lane; e < tot; e += 32)
    if (zero || spos[e & (nn - 1)] > qbest) s.lv[e] = 0;
  // arbitration against the hard decision, with the full TU estimate
  for (int e = lane; e < tot; e += 32)
    hdq[e] = hard_level(abs(s.cf[e]), qs, qbits);
  __syncwarp();
  int br = tu_bits(s, T, P, s.lv, c, n, log2, lane);
  int bh = tu_bits(s, T, P, hdq, c, n, log2, lane);
  long long dr = 0, dh = 0;
  for (int e = lane; e < tot; e += 32) {
    int a = abs(s.cf[e]);
    long long er = a - dequant(s.lv[e], log2, qp, inv);
    long long eh = a - dequant(hdq[e], log2, qp, inv);
    dr += er * er;
    dh += eh * eh;
  }
  dr = seg_sum(dr, seg);
  dh = seg_sum(dh, seg);
  float jr = __fadd_rn(__fmul_rn(__ll2float_rn(dr), dscale),
                       __fmul_rn(lam, (float)br));
  float jh = __fadd_rn(__fmul_rn(__ll2float_rn(dh), dscale),
                       __fmul_rn(lam, (float)bh));
  bool take = jr <= jh;
  __syncwarp();
  for (int e = lane; e < tot; e += 32) {
    int l = take ? s.lv[e] : hdq[e];
    s.lv[e] = s.cf[e] < 0 ? -l : l;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Sign-bit hiding (quant.sign_bit_hide) on one TU, lv and cf at offset
// `off`: two coefficient groups a pass, one a half-warp.
// ---------------------------------------------------------------------------

__device__ void sign_bit_hide(Smem& s, const Stage2Tables& T, const Plane& P,
                              int off, int n, int log2, int scan, int lane) {
  const int nc = n >> 2, ncg = nc * nc, r = lane & 15;
  const int p = T.pos_in_cg[scan * 16 + r];
  for (int base = 0; base < ncg; base += 2) {
    int g = base + (lane >> 4);
    bool valid = g < ncg;
    int gy = valid ? g / nc * 4 : 0, gx = valid ? g % nc * 4 : 0;
    int f = (gy + (r >> 2)) * n + gx + (r & 3);
    int l = valid ? s.lv[off + f] : 0;
    int cf = valid ? s.cf[off + f] : 0;
    int a = abs(l);
    bool nz = a > 0;
    int first = seg_min(nz ? p : 16, 16);
    int last = seg_max(nz ? p : -1, 16);
    int sum = seg_sum(a, 16);
    bool at_first = nz && p == first;
    int fneg = seg_max(at_first && l < 0 ? 1 : 0, 16);
    bool bad = valid && last - first > 3 && ((sum & 1) == 1) != (fneg != 0);
    float ac = (float)abs(cf);
    float d0 = __fsub_rn(ac, (float)dequant(a, log2, P.qp, T.inv_scale));
    float du = __fsub_rn(ac, (float)dequant(a + 1, log2, P.qp, T.inv_scale));
    float dd = __fsub_rn(ac, (float)dequant(max(a - 1, 0), log2, P.qp,
                                             T.inv_scale));
    float e0 = __fmul_rn(d0, d0);
    float up = __fsub_rn(__fmul_rn(du, du), e0);
    float dn = __fsub_rn(__fmul_rn(dd, dd), e0);
    bool up_ok = nz || (p > first && p < last);
    bool dn_ok = a >= 2 || (a == 1 && !at_first && p != last);
    float vu = up_ok ? up : inf(), vd = dn_ok ? dn : inf();
    float bv = vd < vu ? vd : vu;
    int bi = vd < vu ? 16 + r : r;
    seg_argmin(bv, bi, 16);
    if (bad && (bi & 15) == r) {
      int sgn = l != 0 ? (l > 0 ? 1 : -1) : (cf < 0 ? -1 : 1);
      s.lv[off + f] = bi < 16 ? l + sgn : l - sgn;
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// One TU: encoder._tu_chain, then the recon and levels written in place.
// ---------------------------------------------------------------------------

__device__ void code_tu(Smem& s, const Stage2Tables& T, const Plane& P,
                        int n, int oy, int ox, int mode, const int* av,
                        bool luma, bool dst, bool try_ts, int lane,
                        bool& cbf_out, bool& ts_out) {
  const int log2 = 31 - __clz(n), nn = n * n;
  const int* m = dst ? T.dst4 : T.dct[log2 - 2];
  int* res = s.w1.i;                 // residual, then the inverse
  int* tmp = s.w4.i;                 // transform passes
  int* deq = s.w2.i;
  predict(s, T, P, n, log2, oy, ox, mode, av, luma, lane);
  for (int e = lane; e < nn; e += 32)
    res[e] = P.orig[(oy + (e >> log2)) * P.span + ox + (e & (n - 1))] -
             s.pred[e];
  __syncwarp();
  forward(res, tmp, s.cf, m, n, log2, 1, n, lane);
  const bool ts = try_ts && n == 4 && P.ts;
  const int c = ts ? 2 : 1;
  if (ts)                            // the scaled residual, candidate 2
    for (int e = lane; e < nn; e += 32) s.cf[nn + e] = res[e] * 32;
  __syncwarp();
  // mode-dependent scan (H.265 7.4.9.11)
  int scan = 0;
  if (log2 == 2 || (log2 == 3 && luma))
    scan = (mode >= 6 && mode <= 14) ? 2 : (mode >= 22 && mode <= 30) ? 1 : 0;
  quantize(s, T, P, c, n, log2, scan, lane);
  bool use_ts = false;
  if (ts) {
    long long d = 0;
    if (lane < 2 * nn) {
      long long er = s.cf[lane] - dequant(s.lv[lane], log2, P.qp, T.inv_scale);
      d = er * er;
    }
    d = seg_sum(d, 16);
    int bits = tu_bits(s, T, P, s.lv, 2, n, log2, lane);
    float dscale = ldexpf(1.0f, 2 * (log2 - 7));
    float j = __fadd_rn(__fmul_rn(__ll2float_rn(d), dscale),
                        __fmul_rn(P.ts_lam_u, (float)bits));
    float jt = __shfl_sync(kFull, j, 0), js = __shfl_sync(kFull, j, 16);
    use_ts = js < jt;
  }
  const int off = use_ts ? nn : 0;
  if (P.sbh_on) sign_bit_hide(s, T, P, off, n, log2, scan, lane);
  int nz = 0;
  for (int e = lane; e < nn; e += 32) {
    int l = s.lv[off + e];
    nz |= l != 0;
    deq[e] = dequant(l, log2, P.qp, T.inv_scale);
  }
  nz = seg_max(nz, 32);
  __syncwarp();
  if (use_ts) {
    for (int e = lane; e < nn; e += 32) res[e] = (deq[e] + 16) >> 5;
    __syncwarp();
  } else {
    inverse(deq, tmp, res, m, n, log2, lane);
  }
  for (int e = lane; e < nn; e += 32) {
    int y = e >> log2, x = e & (n - 1);
    int v = min(max(s.pred[e] + res[e], 0), 255);
    P.ext[(oy + 1 + y) * P.stride + ox + 1 + x] = (uint8_t)v;
    P.levels[(oy + y) * P.span + ox + x] = s.lv[off + e];
  }
  __syncwarp();
  cbf_out = nz != 0;
  ts_out = use_ts && nz != 0;
}

// ---------------------------------------------------------------------------
// The kernel: one block (one warp) a (row, plane)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
stage2_ctu_kernel(const Stage2Args A) {
  __shared__ Smem s;
  const Stage2Tables& T = A.tab;
  const int lane = threadIdx.x;
  const int R = A.rows;
  const bool luma = blockIdx.x < (unsigned)R;
  const int prow = luma ? blockIdx.x : blockIdx.x - R;   // plane row
  const int row = luma ? prow : prow % R;                // CTU row
  if (!A.mk[row]) return;
  const int pl = luma ? 0 : 1;

  Plane P;
  P.span = luma ? 64 : 32;
  P.stride = luma ? 130 : 66;
  const int ext_n = luma ? 97 * 130 : 49 * 66;
  int* gext = (luma ? A.ext_y : A.ext_c) + (size_t)prow * ext_n;
  P.ext = s.ext;
  P.orig = (luma ? A.oyl : A.ouv) + (size_t)prow * P.span * P.span;
  P.levels = (luma ? A.vy : A.vc) + (size_t)prow * P.span * P.span;
  P.cy = (int)(luma ? A.ctu_y[prow] : A.ctu_yc[prow]);
  P.cx = (int)(luma ? A.ctu_x[prow] : A.ctu_xc[prow]);
  P.h = luma ? A.h : A.h / 2;
  P.w = luma ? A.w : A.w / 2;
  P.qp = A.qp_rows[pl] ? A.qp_rows[pl][prow] : A.qp[pl];
  P.rdoq = A.rdoq_on[pl] != 0;
  if (A.rdoq_rows[pl]) {   // float32 λ tensors: every product in float32
    P.lam_u = A.rdoq_rows[pl][prow] / 256.0f;
    P.lam_csbf = __fmul_rn(P.lam_u, (float)T.weights[pl][kCsbf]);
    P.lam_cbf0 = __fmul_rn(P.lam_u, (float)T.weights[pl][kCbf0]);
  } else {
    P.lam_u = A.rdoq_lam_u[pl];
    P.lam_csbf = A.rdoq_csbf[pl];
    P.lam_cbf0 = A.rdoq_cbf0[pl];
  }
  P.ts = A.ts_on[pl] != 0;
  P.ts_lam_u = A.ts_rows[pl] ? A.ts_rows[pl][prow] / 256.0f : A.ts_lam_u[pl];
  P.pl = pl;
  P.weights = T.weights[pl];
  P.sbh_on = A.sbh != 0;

  for (int i = lane; i < ext_n; i += 32) s.ext[i] = (uint8_t)gext[i];
  __syncwarp();

  const int* tz = A.tz + row * 64;
  const uint8_t* c8 = A.c8 + row * 64;
  // The schedule, one entry a step in z-order: n, oy, ox (luma, CTU-
  // local), the leaf log2 at which luma fires, the chroma rule (0 none,
  // 1 leaf == log2 n, 2 leaf <= 3: the 4x4 chroma TU of a TU4 leaf),
  // the offsets of the luma and chroma decoded-before masks.
  for (int st = 0; st < T.n_steps; ++st) {
    const int* e = T.steps + st * kStepWords;
    const int n = e[0], oy = e[1], ox = e[2];
    const int slot = (oy >> 3) * 8 + (ox >> 3);
    const int leaf = tz[slot];
    if (!c8[slot]) continue;
    bool cbf, tsf;
    if (luma) {
      if (leaf != e[3] || (n == 4 && !A.tu4)) continue;
      if (n == 4) {
        int s4 = (oy >> 2) * 16 + (ox >> 2);
        code_tu(s, T, P, 4, oy, ox, A.mm4[row * 256 + s4], T.avail + e[5],
                true, true, true, lane, cbf, tsf);
        if (lane == 0) {
          A.cy4[row * 256 + s4] = cbf;
          A.ty4[row * 256 + s4] = tsf;
        }
      } else {
        code_tu(s, T, P, n, oy, ox, A.msl[row * 64 + slot], T.avail + e[5],
                true, false, false, lane, cbf, tsf);
        if (lane == 0) A.cy8[row * 64 + slot] = cbf;
      }
    } else {
      const int log2 = 31 - __clz(n);
      const bool fire = e[4] == 1 ? leaf == log2 : (e[4] == 2 && leaf <= 3);
      if (!fire) continue;
      code_tu(s, T, P, n / 2, oy / 2, ox / 2, A.cm8[row * 64 + slot],
              T.avail + e[6], false, false, true, lane, cbf, tsf);
      if (lane == 0) {
        A.cc8[prow * 64 + slot] = cbf;
        A.tc8[prow * 64 + slot] = tsf;
      }
    }
  }
  // the recon back into the diagonal's buffer (_close scatters it)
  __syncwarp();
  const int span = P.span;
  for (int i = lane; i < span * span; i += 32) {
    int y = i / span + 1, x = i % span + 1;
    gext[y * P.stride + x] = s.ext[y * P.stride + x];
  }
}

}  // namespace

#if defined(__CUDACC__)
extern "C" {

int stage2_ctu_args_size() { return (int)sizeof(Stage2Args); }

int stage2_ctu_launch(const Stage2Args* args, cudaStream_t stream) {
  stage2_ctu_kernel<<<3 * args->rows, 32, 0, stream>>>(*args);
  return (int)cudaGetLastError();
}

const char* stage2_ctu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
#endif
