// Native slice-data entropy coder: CABAC engine + All-Intra CTU/CU/TU
// syntax serialization.
//
// This is the TPU framework's equivalent of the reference's serial CABAC
// finalization pass (TEncBinCoderCABAC.cpp:187-447 engine + TEncSbac.cpp
// syntax binarization + TEncSlice::encodeSlice, TEncSlice.cpp:985) — the
// one inherently sequential stage of HEVC encoding (SURVEY.md hot loop 5).
// It consumes the per-frame decision arrays the TPU encoder emits
// (depth8 / mode8 / cbf planes / level planes) and produces the slice-data
// RBSP bytes. It mirrors hevctpu_torch/codec/{cabac,syntax}.py bit-for-bit; the
// Python implementation stays as the golden reference
// (tests/test_native_entropy.py asserts byte equality).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 (driven by hevctpu_torch/native/__init__.py,
// which also generates ctx_init.inc from hevctpu_torch/rom.py).

#include <cstdint>
#include <cstring>
#include <vector>

#include "ctx_init.inc"  // kCtxInit[], CTX_* offsets, kNumCtx (generated)

namespace {

// ---------------------------------------------------------------------------
// Spec constants (H.265 9.3.4.3; identical to hevctpu_torch/rom.py LPS_TABLE etc.)
// ---------------------------------------------------------------------------

const uint8_t kLpsTable[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216},
    {123, 150, 178, 205}, {116, 142, 169, 195}, {111, 135, 160, 185},
    {105, 128, 152, 175}, {100, 122, 144, 166}, {95, 116, 137, 158},
    {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},
    {66, 80, 95, 110},    {62, 76, 90, 104},    {59, 72, 86, 99},
    {56, 69, 81, 94},     {53, 65, 77, 89},     {51, 62, 73, 85},
    {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},
    {35, 43, 51, 59},     {33, 41, 48, 56},     {32, 39, 46, 53},
    {30, 37, 43, 50},     {29, 35, 41, 48},     {27, 33, 39, 45},
    {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},
    {19, 23, 27, 31},     {18, 22, 26, 30},     {17, 21, 25, 28},
    {16, 20, 23, 27},     {15, 19, 22, 25},     {14, 18, 21, 24},
    {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},
    {10, 12, 15, 17},     {10, 12, 14, 16},     {9, 11, 13, 15},
    {9, 11, 12, 14},      {8, 10, 12, 14},      {8, 9, 11, 13},
    {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},
    {2, 2, 2, 2}};

const uint8_t kTransLps[64] = {
    0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

// sig_coeff_flag ctxIdxMap for 4x4 TBs (9.3.4.2.5), indexed 4*y+x.
const uint8_t kSigCtx4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                6, 6, 8, 8, 7, 7, 8, 8};

const int SCAN_DIAG = 0, SCAN_HOR = 1, SCAN_VER = 2;
const int PLANAR_IDX = 0, DC_IDX = 1, HOR_IDX = 10, VER_IDX = 26;

// ---------------------------------------------------------------------------
// Bit writer + CABAC engine (mirrors hevctpu_torch/codec/cabac.py exactly)
// ---------------------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t> bytes;
  uint32_t acc = 0;
  int nbits = 0;

  void u(uint32_t value, int bits) {
    acc = (acc << bits) | value;
    nbits += bits;
    while (nbits >= 8) {
      nbits -= 8;
      bytes.push_back((acc >> nbits) & 0xFF);
    }
    acc &= (1u << nbits) - 1;
  }
  void align_zero() {
    if (nbits) u(0, 8 - nbits);
  }
};

struct Ctx {
  uint8_t state;
  uint8_t mps;
};

inline Ctx init_ctx(int init_value, int qp) {
  int slope = (init_value >> 4) * 5 - 45;
  int offset = ((init_value & 15) << 3) - 16;
  int q = qp < 0 ? 0 : (qp > 51 ? 51 : qp);
  int pre = ((slope * q) >> 4) + offset;
  pre = pre < 1 ? 1 : (pre > 126 ? 126 : pre);
  Ctx c;
  if (pre > 63) {
    c.mps = 1;
    c.state = static_cast<uint8_t>(pre - 64);
  } else {
    c.mps = 0;
    c.state = static_cast<uint8_t>(63 - pre);
  }
  return c;
}

struct Cabac {
  BitWriter& bw;
  uint32_t low = 0;
  uint32_t range = 510;
  uint32_t bits_outstanding = 0;
  bool first_bit = true;
  Ctx ctx[kNumCtx];

  explicit Cabac(BitWriter& w, int qp) : bw(w) {
    for (int i = 0; i < kNumCtx; i++) ctx[i] = init_ctx(kCtxInit[i], qp);
  }

  void put_bit(uint32_t b) {
    if (first_bit)
      first_bit = false;
    else
      bw.u(b, 1);
    while (bits_outstanding > 0) {
      bw.u(1 - b, 1);
      bits_outstanding--;
    }
  }

  void renorm() {
    while (range < 256) {
      if (low < 256) {
        put_bit(0);
      } else if (low >= 512) {
        low -= 512;
        put_bit(1);
      } else {
        low -= 256;
        bits_outstanding++;
      }
      low <<= 1;
      range <<= 1;
    }
  }

  void bin(int ci, uint32_t b) {
    Ctx& c = ctx[ci];
    uint32_t lps = kLpsTable[c.state][(range >> 6) & 3];
    range -= lps;
    if (b != c.mps) {
      low += range;
      range = lps;
      if (c.state == 0) c.mps ^= 1;
      c.state = kTransLps[c.state];
    } else {
      c.state = c.state < 62 ? c.state + 1 : 62;
    }
    renorm();
  }

  void bypass(uint32_t b) {
    low <<= 1;
    if (b) low += range;
    if (low >= 1024) {
      put_bit(1);
      low -= 1024;
    } else if (low < 512) {
      put_bit(0);
    } else {
      bits_outstanding++;
      low -= 512;
    }
  }

  void bypass_bins(uint32_t value, int n) {
    for (int i = n - 1; i >= 0; i--) bypass((value >> i) & 1);
  }

  void terminate(uint32_t b) {
    range -= 2;
    if (b) {
      low += range;
      // flush
      range = 2;
      renorm();
      put_bit((low >> 9) & 1);
      bw.u(((low >> 7) & 3) | 1, 2);
    } else {
      renorm();
    }
  }
};

// ---------------------------------------------------------------------------
// Scan orders (H.265 6.5.3; mirrors rom.scan_order / rom.tb_scan)
// ---------------------------------------------------------------------------

struct Scans {
  // scan[scan_idx][log2-2] : vector of (y << 8 | x) in scan order (TB scan)
  std::vector<uint16_t> tb[3][4];
  // cg scan for the group grid (size n/4): (cy << 8 | cx)
  std::vector<uint16_t> cg[3][4];

  Scans() {
    for (int si = 0; si < 3; si++) {
      for (int l = 2; l <= 5; l++) {
        int n = 1 << l;
        std::vector<uint16_t> groups = order(si, n >= 8 ? n / 4 : 1);
        std::vector<uint16_t> sub = order(si, 4);
        std::vector<uint16_t>& out = tb[si][l - 2];
        if (n == 4) {
          out = sub;
        } else {
          for (uint16_t g : groups)
            for (uint16_t s : sub)
              out.push_back(((((g >> 8) * 4) + (s >> 8)) << 8) |
                            (((g & 255) * 4) + (s & 255)));
        }
        cg[si][l - 2] = groups;
      }
    }
  }

  static std::vector<uint16_t> order(int scan_idx, int size) {
    std::vector<uint16_t> coords;
    if (scan_idx == SCAN_DIAG) {
      for (int d = 0; d < 2 * size - 1; d++)
        for (int y = d < size ? d : size - 1; y >= 0; y--) {
          int x = d - y;
          if (x < size) coords.push_back((y << 8) | x);
        }
    } else if (scan_idx == SCAN_HOR) {
      for (int y = 0; y < size; y++)
        for (int x = 0; x < size; x++) coords.push_back((y << 8) | x);
    } else {
      for (int x = 0; x < size; x++)
        for (int y = 0; y < size; y++) coords.push_back((y << 8) | x);
    }
    return coords;
  }
};

const Scans kScans;

inline int coef_scan_idx(int intra_mode, int log2, bool is_luma) {
  if (log2 == 2 || (log2 == 3 && is_luma)) {
    if (6 <= intra_mode && intra_mode <= 14) return SCAN_VER;
    if (22 <= intra_mode && intra_mode <= 30) return SCAN_HOR;
  }
  return SCAN_DIAG;
}

inline int sig_ctx(int x, int y, int log2, int scan_idx, bool is_luma,
                   int prev_csbf) {
  if (log2 == 2) return kSigCtx4x4[4 * y + x];
  if (x == 0 && y == 0) return 0;
  int xp = x & 3, yp = y & 3, s;
  if (prev_csbf == 0)
    s = xp + yp == 0 ? 2 : (xp + yp < 3 ? 1 : 0);
  else if (prev_csbf == 1)
    s = yp == 0 ? 2 : (yp == 1 ? 1 : 0);
  else if (prev_csbf == 2)
    s = xp == 0 ? 2 : (xp == 1 ? 1 : 0);
  else
    s = 2;
  if (is_luma && (x >= 4 || y >= 4)) s += 3;
  if (log2 == 3)
    s += is_luma ? (scan_idx == SCAN_DIAG ? 9 : 15) : 9;
  else
    s += is_luma ? 21 : 12;
  return s;
}

inline int last_prefix(int val) {
  if (val <= 3) return val;
  int k = 31 - __builtin_clz(static_cast<unsigned>(val));
  return 2 * k + (val >= (3 << (k - 1)) ? 1 : 0);
}

// ---------------------------------------------------------------------------
// Slice encoder (mirrors hevctpu_torch/codec/syntax.py SliceEncoder)
// ---------------------------------------------------------------------------

struct SliceEnc {
  int w, h, rc, cc, h8, w8, wl, wc;
  const int32_t* depth8;
  const int32_t* mode4;  // per-4x4 luma modes (PU granularity)
  const uint8_t* nxn8 = nullptr;   // PART_NxN flag per 8x8 CU slot
  const uint8_t* cbf4 = nullptr;   // luma cbf per 4x4 (NxN / split-4 TUs)
  const int32_t* tusz8 = nullptr;  // leaf TU log2 per 8x8 slot (2..5)
  int max_tu_depth = 0;            // sps max_transform_hierarchy_depth_intra
  const int32_t* csel8;
  const uint8_t* cbf[3];
  const int32_t* levels[3];
  // SAO per-CTU params (null = SAO off): type/eo [rc*cc*2], bp [rc*cc*3],
  // off [rc*cc*3*4], layouts as in ops/sao.py.
  const int32_t* sao_type = nullptr;
  const int32_t* sao_eo = nullptr;
  const int32_t* sao_bp = nullptr;
  const int32_t* sao_off = nullptr;
  const int32_t* sao_merge = nullptr;  // 0 new, 1 left, 2 up
  bool sbh = false;  // pps sign_data_hiding_enabled_flag
  // cu_qp_delta (7.3.8.10): per-CTU absolute QP map [rc*cc] or null.
  const int32_t* qp_ctu = nullptr;
  int slice_qp = 0, qp_pred = 0, qp_target = 0;
  bool qp_coded = false, qp_error = false;
  bool transform_skip = false;     // pps transform_skip_enabled_flag
  const uint8_t* ts4 = nullptr;    // luma 4x4 TS flags [h4 * w4]
  const uint8_t* ts8_u = nullptr;  // chroma 4x4 TS flags [h8 * w8]
  const uint8_t* ts8_v = nullptr;
  BitWriter bw;
  Cabac c;

  SliceEnc(int width, int height, int qp, const int32_t* d8, const int32_t* m8,
           const int32_t* cs8, const uint8_t* cy, const uint8_t* cu,
           const uint8_t* cv, const int32_t* ly, const int32_t* lu,
           const int32_t* lv)
      : w(width), h(height), rc((height + 63) / 64), cc((width + 63) / 64),
        h8(rc * 8), w8(cc * 8), wl(cc * 64), wc(cc * 32), depth8(d8),
        mode4(m8), csel8(cs8), cbf{cy, cu, cv}, levels{ly, lu, lv},
        c(bw, qp) { slice_qp = qp; }

  int d8(int y8, int x8) const { return depth8[y8 * w8 + x8]; }

  void encode() {
    int n_ctu = rc * cc;
    qp_pred = slice_qp;
    for (int a = 0; a < n_ctu; a++) {
      int r = a / cc, col = a % cc;
      if (sao_type != nullptr) sao_params(r, col);
      qp_coded = false;
      if (qp_ctu != nullptr) qp_target = qp_ctu[r * cc + col];
      quadtree(64 * col, 64 * r, 6);
      if (qp_ctu != nullptr) {
        if (!qp_coded && qp_target != qp_pred) {
          qp_error = true;  // map not inheritance-consistent
          return;
        }
        qp_pred = qp_target;
      }
      c.terminate(a == n_ctu - 1 ? 1 : 0);
    }
    bw.align_zero();
  }

  // cu_qp_delta_abs/sign at the first cbf-carrying transform_unit of the
  // quantization group (9.3.3.10: TR cMax 5, EG0 bypass suffix; mirrors
  // syntax.py SliceEncoder._maybe_code_delta).
  void maybe_code_delta() {
    if (qp_ctu == nullptr || qp_coded) return;
    qp_coded = true;
    int d = qp_target - qp_pred;
    int a = d < 0 ? -d : d;
    int tu = a < 5 ? a : 5;
    c.bin(CTX_CU_QP_DELTA_ABS, tu ? 1 : 0);
    if (!tu) return;
    for (int i = 0; i < tu - 1; i++) c.bin(CTX_CU_QP_DELTA_ABS + 1, 1);
    if (tu < 5) c.bin(CTX_CU_QP_DELTA_ABS + 1, 0);
    if (a >= 5) {
      int v = a - 5, k = 0;
      while (v >= (1 << k)) { c.bypass(1); v -= 1 << k; k++; }
      c.bypass(0);
      for (int i = k - 1; i >= 0; i--) c.bypass((v >> i) & 1);
    }
    c.bypass(d < 0 ? 1 : 0);
  }

  void quadtree(int x0, int y0, int log2) {
    if (x0 >= w || y0 >= h) return;
    int size = 1 << log2;
    int d = 6 - log2;
    bool inside = x0 + size <= w && y0 + size <= h;
    bool split = d8(y0 / 8, x0 / 8) > d;
    if (inside && log2 > 3) {
      int ctx = 0;
      if (x0 > 0 && d8(y0 / 8, (x0 - 1) / 8) > d) ctx++;
      if (y0 > 0 && d8((y0 - 1) / 8, x0 / 8) > d) ctx++;
      c.bin(CTX_SPLIT_CU_FLAG + ctx, split ? 1 : 0);
    } else if (!inside) {
      split = log2 > 3;
    }
    if (split) {
      int half = size / 2;
      quadtree(x0, y0, log2 - 1);
      quadtree(x0 + half, y0, log2 - 1);
      quadtree(x0, y0 + half, log2 - 1);
      quadtree(x0 + half, y0 + half, log2 - 1);
    } else {
      coding_unit(x0, y0, log2);
    }
  }

  // sao() for one CTU (7.3.8.3; mirrors syntax.py SliceEncoder._sao_params)
  void sao_params(int r, int col) {
    int m = sao_merge != nullptr ? sao_merge[r * cc + col] : 0;
    if (col > 0) c.bin(CTX_SAO_MERGE, m == 1 ? 1 : 0);
    if (m != 1 && r > 0) c.bin(CTX_SAO_MERGE, m == 2 ? 1 : 0);
    if (m) return;
    int ctu = r * cc + col;
    for (int cidx = 0; cidx < 3; cidx++) {
      int tix = cidx == 0 ? 0 : 1;
      int typ = sao_type[ctu * 2 + tix];
      if (cidx < 2) {
        c.bin(CTX_SAO_TYPE_IDX, typ ? 1 : 0);
        if (typ) c.bypass(typ - 1);
      }
      if (typ == 0) continue;
      const int32_t* offs = sao_off + (ctu * 3 + cidx) * 4;
      for (int i = 0; i < 4; i++) {
        int v = offs[i] < 0 ? -offs[i] : offs[i];
        for (int k = 0; k < v; k++) c.bypass(1);
        if (v < 7) c.bypass(0);
      }
      if (typ == 1) {  // BO
        for (int i = 0; i < 4; i++)
          if (offs[i] != 0) c.bypass(offs[i] < 0 ? 1 : 0);
        c.bypass_bins(sao_bp[ctu * 3 + cidx], 5);
      } else if (cidx < 2) {
        c.bypass_bins(sao_eo[ctu * 2 + tix], 2);
      }
    }
  }

  void derive_mpm(int x0, int y0, int mpm[3]) const {
    // mode4 is the per-4x4 luma mode map (PU granularity; NxN PUs are 4x4)
    int w4 = w8 * 2;
    int cand_a =
        x0 == 0 ? DC_IDX : mode4[(y0 / 4) * w4 + (x0 - 1) / 4];
    int cand_b = (y0 == 0 || y0 % 64 == 0)
                     ? DC_IDX
                     : mode4[((y0 - 1) / 4) * w4 + x0 / 4];
    if (cand_a == cand_b) {
      if (cand_a < 2) {
        mpm[0] = PLANAR_IDX;
        mpm[1] = DC_IDX;
        mpm[2] = VER_IDX;
      } else {
        mpm[0] = cand_a;
        mpm[1] = 2 + ((cand_a + 29) % 32);
        mpm[2] = 2 + ((cand_a - 2 + 1) % 32);
      }
    } else {
      mpm[0] = cand_a;
      mpm[1] = cand_b;
      if (cand_a != PLANAR_IDX && cand_b != PLANAR_IDX)
        mpm[2] = PLANAR_IDX;
      else if (cand_a != DC_IDX && cand_b != DC_IDX)
        mpm[2] = DC_IDX;
      else
        mpm[2] = VER_IDX;
    }
  }

  void coding_unit(int x0, int y0, int log2) {
    int w4 = w8 * 2;
    bool nxn = false;
    if (log2 == 3) {
      nxn = nxn8 != nullptr && nxn8[(y0 / 8) * w8 + x0 / 8] != 0;
      // part_mode (9.3.3.7): 1 -> PART_2Nx2N, 0 -> PART_NxN
      c.bin(CTX_PART_MODE, nxn ? 0 : 1);
    }
    int npu = nxn ? 4 : 1;
    int pux[4] = {x0, x0 + 4, x0, x0 + 4};
    int puy[4] = {y0, y0, y0 + 4, y0 + 4};
    int pmodes[4], idxs[4];
    int mpms[4][3];
    for (int p = 0; p < npu; p++) {
      pmodes[p] = mode4[(puy[p] / 4) * w4 + pux[p] / 4];
      derive_mpm(pux[p], puy[p], mpms[p]);
      int mode = pmodes[p];
      idxs[p] = mode == mpms[p][0]
                    ? 0
                    : (mode == mpms[p][1] ? 1 : (mode == mpms[p][2] ? 2 : -1));
      c.bin(CTX_PREV_INTRA_LUMA_PRED, idxs[p] >= 0 ? 1 : 0);
    }
    for (int p = 0; p < npu; p++) {
      int idx = idxs[p], mode = pmodes[p];
      if (idx >= 0) {
        c.bypass(idx > 0 ? 1 : 0);
        if (idx) c.bypass(idx - 1);
      } else {
        int rem = mode;
        for (int k = 0; k < 3; k++)
          if (mpms[p][k] < mode) rem--;
        c.bypass_bins(rem, 5);
      }
    }
    // intra_chroma_pred_mode (H.265 Table 8-3): 4 = derived, 0..3 indexes
    // {planar, ver, hor, dc} with ==luma substituted by angular 34; DM for
    // NxN resolves against PU0's mode (8.4.3).
    int csel = csel8[(y0 / 8) * w8 + x0 / 8];
    int mode0 = pmodes[0];
    int cmode;
    if (csel == 4) {
      c.bin(CTX_INTRA_CHROMA_PRED_MODE, 0);
      cmode = mode0;
    } else {
      c.bin(CTX_INTRA_CHROMA_PRED_MODE, 1);
      c.bypass_bins(csel, 2);
      static const int kList[4] = {PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX};
      cmode = kList[csel] == mode0 ? 34 : kList[csel];
    }
    if (nxn) {
      // split_transform_flag inferred 1 (IntraSplitFlag, 7.3.8.8): four
      // 4x4 DST luma TUs in z-order; chroma coded with the last one.
      bool cb = node_cbf(1, x0, y0, 3);
      bool cr = node_cbf(2, x0, y0, 3);
      c.bin(CTX_CBF_CHROMA, cb ? 1 : 0);
      c.bin(CTX_CBF_CHROMA, cr ? 1 : 0);
      for (int p = 0; p < 4; p++) {
        bool cbf_l = cbf4[(puy[p] / 4) * w4 + pux[p] / 4] != 0;
        c.bin(CTX_CBF_LUMA, cbf_l ? 1 : 0);  // trafoDepth 1 -> ctx 0
        if (cbf_l || (p == 3 && (cb || cr))) maybe_code_delta();
        if (cbf_l) residual(pux[p], puy[p], 2, 0, pmodes[p]);
      }
      if (cb) residual(x0 / 2, y0 / 2, 2, 1, cmode);
      if (cr) residual(x0 / 2, y0 / 2, 2, 2, cmode);
    } else {
      transform_tree(x0, y0, log2, 0, true, true, mode0, cmode);
    }
  }

  bool node_cbf(int comp, int x0, int y0, int log2) const {
    int s = log2 >= 3 ? 1 << (log2 - 3) : 1;
    for (int yy = 0; yy < s; yy++)
      for (int xx = 0; xx < s; xx++)
        if (cbf[comp][(y0 / 8 + yy) * w8 + x0 / 8 + xx]) return true;
    return false;
  }

  void transform_tree(int x0, int y0, int log2, int depth, bool pcb, bool pcr,
                      int mode, int cmode) {
    // 7.3.8.8 with explicit split_transform_flag down to max_tu_depth
    // (mirrors syntax.py SliceEncoder._transform_tree).
    bool infer_split = log2 > 5;
    int tz = tusz8 != nullptr ? tusz8[(y0 / 8) * w8 + x0 / 8] : log2;
    bool present = log2 > 2 && log2 <= 5 && depth < max_tu_depth;
    bool split = infer_split || (present && tz < log2);
    if (present) c.bin(CTX_SPLIT_TRANSFORM_FLAG + (5 - log2), split ? 1 : 0);
    bool code_chroma = log2 > 2;
    bool cb = node_cbf(1, x0, y0, log2);
    bool cr = node_cbf(2, x0, y0, log2);
    if (code_chroma) {
      if (pcb) c.bin(CTX_CBF_CHROMA + depth, cb ? 1 : 0);
      if (pcr) c.bin(CTX_CBF_CHROMA + depth, cr ? 1 : 0);
    }
    if (split && log2 > 3) {
      int half = 1 << (log2 - 1);
      transform_tree(x0, y0, log2 - 1, depth + 1, cb, cr, mode, cmode);
      transform_tree(x0 + half, y0, log2 - 1, depth + 1, cb, cr, mode, cmode);
      transform_tree(x0, y0 + half, log2 - 1, depth + 1, cb, cr, mode, cmode);
      transform_tree(x0 + half, y0 + half, log2 - 1, depth + 1, cb, cr, mode,
                     cmode);
      return;
    }
    if (split) {  // log2 == 3: four 4x4 luma TUs, chroma stays at this node
      int w4 = w8 * 2;
      for (int p = 0; p < 4; p++) {
        int px = x0 + (p % 2) * 4, py = y0 + (p / 2) * 4;
        bool cbf_l = cbf4[(py / 4) * w4 + px / 4] != 0;
        c.bin(CTX_CBF_LUMA, cbf_l ? 1 : 0);
        if (cbf_l || (p == 3 && (cb || cr))) maybe_code_delta();
        if (cbf_l) residual(px, py, 2, 0, mode);
      }
      if (cb) residual(x0 / 2, y0 / 2, 2, 1, cmode);
      if (cr) residual(x0 / 2, y0 / 2, 2, 2, cmode);
      return;
    }
    bool cbf_l = cbf[0][(y0 / 8) * w8 + x0 / 8] != 0;
    c.bin(CTX_CBF_LUMA + (depth == 0 ? 1 : 0), cbf_l ? 1 : 0);
    if (cbf_l || (code_chroma && (cb || cr))) maybe_code_delta();
    if (cbf_l) residual(x0, y0, log2, 0, mode);
    if (code_chroma) {
      if (cb) residual(x0 / 2, y0 / 2, log2 - 1, 1, cmode);
      if (cr) residual(x0 / 2, y0 / 2, log2 - 1, 2, cmode);
    }
  }

  void code_last(int lx, int ly, int log2, bool is_luma) {
    int offset, shift;
    if (is_luma) {
      offset = 3 * (log2 - 2) + ((log2 - 1) >> 2);
      shift = (log2 + 1) >> 2;
    } else {
      offset = 0;
      shift = log2 - 2;
    }
    int gmax = (log2 << 1) - 1;
    const int base_x = is_luma ? CTX_LAST_SIG_X_LUMA : CTX_LAST_SIG_X_CHROMA;
    const int base_y = is_luma ? CTX_LAST_SIG_Y_LUMA : CTX_LAST_SIG_Y_CHROMA;
    for (int axis = 0; axis < 2; axis++) {
      int val = axis == 0 ? lx : ly;
      int base = axis == 0 ? base_x : base_y;
      int prefix = last_prefix(val);
      int nb = prefix < gmax ? prefix : gmax;
      for (int b = 0; b < nb; b++) c.bin(base + offset + (b >> shift), 1);
      if (prefix < gmax) c.bin(base + offset + (prefix >> shift), 0);
    }
    for (int axis = 0; axis < 2; axis++) {
      int val = axis == 0 ? lx : ly;
      int prefix = last_prefix(val);
      if (prefix > 3) {
        int nbits = (prefix >> 1) - 1;
        int suffix = val - ((2 + (prefix & 1)) << nbits);
        c.bypass_bins(suffix, nbits);
      }
    }
  }

  void code_remaining(int v, int rice) {
    int q = v >> rice;
    if (q < 4) {
      c.bypass_bins((1 << (q + 1)) - 2, q + 1);
      if (rice) c.bypass_bins(v & ((1 << rice) - 1), rice);
    } else {
      int v2 = v - (4 << rice);
      int k = rice + 1;
      while (v2 >= (1 << k)) {
        v2 -= 1 << k;
        k++;
      }
      c.bypass_bins((1 << (4 + k - rice)) - 2, 4 + k - rice);
      c.bypass_bins(v2, k);
    }
  }

  void residual(int x0, int y0, int log2, int comp, int mode) {
    int n = 1 << log2;
    bool is_luma = comp == 0;
    int stride = is_luma ? wl : wc;
    if (transform_skip && log2 == 2) {
      // transform_skip_flag (7.3.8.11, first element of residual_coding)
      bool ts = false;
      if (is_luma) {
        if (ts4 != nullptr) ts = ts4[(y0 / 4) * (w8 * 2) + x0 / 4] != 0;
      } else {
        const uint8_t* m = comp == 1 ? ts8_u : ts8_v;
        if (m != nullptr) ts = m[(y0 / 4) * w8 + x0 / 4] != 0;
      }
      c.bin(CTX_TRANSFORM_SKIP + (is_luma ? 0 : 1), ts ? 1 : 0);
    }
    const int32_t* lv = levels[comp];
    int scan_idx = coef_scan_idx(mode, log2, is_luma);
    const std::vector<uint16_t>& scan = kScans.tb[scan_idx][log2 - 2];
    const std::vector<uint16_t>& cgs = kScans.cg[scan_idx][log2 - 2];

    int32_t coeffs[1024];
    int last = -1;
    for (int i = 0; i < n * n; i++) {
      int yy = scan[i] >> 8, xx = scan[i] & 255;
      coeffs[i] = lv[(y0 + yy) * stride + x0 + xx];
      if (coeffs[i]) last = i;
    }

    int lx = scan[last] & 255, ly2 = scan[last] >> 8;
    if (scan_idx == SCAN_VER) {
      int t = lx;
      lx = ly2;
      ly2 = t;
    }
    code_last(lx, ly2, log2, is_luma);

    int num_cg = 1 << (2 * (log2 - 2));
    int last_cg = last >> 4;
    int ncg_side = n >= 8 ? n / 4 : 1;
    bool csbf_raster[64] = {false};
    bool csbf[64];
    for (int cg = 0; cg < num_cg; cg++) {
      bool any = false;
      for (int j = 16 * cg; j < 16 * cg + 16 && j < n * n; j++)
        if (coeffs[j]) {
          any = true;
          break;
        }
      csbf[cg] = any;
      if (any)
        csbf_raster[(cgs[cg] >> 8) * ncg_side + (cgs[cg] & 255)] = true;
    }

    const int ctx_cs =
        is_luma ? CTX_CODED_SUB_BLOCK_LUMA : CTX_CODED_SUB_BLOCK_CHROMA;
    const int ctx_sig = is_luma ? CTX_SIG_COEFF_LUMA : CTX_SIG_COEFF_CHROMA;
    const int ctx_g1 =
        is_luma ? CTX_COEFF_ABS_GT1_LUMA : CTX_COEFF_ABS_GT1_CHROMA;
    const int ctx_g2 =
        is_luma ? CTX_COEFF_ABS_GT2_LUMA : CTX_COEFF_ABS_GT2_CHROMA;
    int gt1_carry = 1;

    for (int cg = last_cg; cg >= 0; cg--) {
      int cy = cgs[cg] >> 8, cx = cgs[cg] & 255;
      int right = cx + 1 < ncg_side && csbf_raster[cy * ncg_side + cx + 1];
      int below = cy + 1 < ncg_side && csbf_raster[(cy + 1) * ncg_side + cx];
      int prev_csbf = right + 2 * below;
      bool csbf_coded = 0 < cg && cg < last_cg;
      if (csbf_coded)
        c.bin(ctx_cs + (prev_csbf < 1 ? prev_csbf : 1), csbf[cg] ? 1 : 0);
      if (csbf_coded && !csbf[cg]) continue;

      int lo = 16 * cg;
      bool infer_dc = csbf_coded;
      bool others_nonzero = false;
      for (int j = lo + 1; j < lo + 16; j++)
        if (coeffs[j]) {
          others_nonzero = true;
          break;
        }
      int start = cg == last_cg ? last - 1 : lo + 15;
      for (int i = start; i >= lo; i--) {
        if (i == lo && infer_dc && !others_nonzero) break;  // sig inferred
        int yy = scan[i] >> 8, xx = scan[i] & 255;
        int sc = sig_ctx(xx, yy, log2, scan_idx, is_luma, prev_csbf);
        c.bin(ctx_sig + sc, coeffs[i] ? 1 : 0);
      }

      int sig_rev[16], nsig = 0;
      for (int i = lo + 15; i >= lo; i--)
        if (coeffs[i]) sig_rev[nsig++] = i;
      if (!nsig) continue;

      int ctx_set = (cg == 0 || !is_luma) ? 0 : 2;
      if (gt1_carry == 0) ctx_set += 1;
      int g1ctx = 1;
      bool gt1_flags[16] = {false};
      int n1 = nsig < 8 ? nsig : 8;
      for (int k = 0; k < n1; k++) {
        int i = sig_rev[k];
        int v = coeffs[i] < 0 ? -coeffs[i] : coeffs[i];
        bool flag = v > 1;
        c.bin(ctx_g1 + ctx_set * 4 + (g1ctx < 3 ? g1ctx : 3), flag ? 1 : 0);
        gt1_flags[k] = flag;
        if (flag)
          g1ctx = 0;
        else if (0 < g1ctx && g1ctx < 3)
          g1ctx++;
      }
      gt1_carry = g1ctx;
      int first_g1 = -1;
      for (int k = 0; k < n1; k++)
        if (gt1_flags[k]) {
          first_g1 = k;
          break;
        }
      if (first_g1 >= 0) {
        int i = sig_rev[first_g1];
        int v = coeffs[i] < 0 ? -coeffs[i] : coeffs[i];
        c.bin(ctx_g2 + ctx_set, v > 2 ? 1 : 0);
      }
      // sign-data-hiding: first-in-scan sign inferred from abs-sum parity
      // when the nonzero span exceeds 3 (7.3.8.11).
      bool hidden = sbh && (sig_rev[0] - sig_rev[nsig - 1] > 3);
      for (int k = 0; k < (hidden ? nsig - 1 : nsig); k++)
        c.bypass(coeffs[sig_rev[k]] < 0 ? 1 : 0);
      int rice = 0;
      for (int k = 0; k < nsig; k++) {
        int v = coeffs[sig_rev[k]] < 0 ? -coeffs[sig_rev[k]]
                                       : coeffs[sig_rev[k]];
        int base;
        if (k < 8) {
          if (!gt1_flags[k]) continue;  // v == 1
          if (k == first_g1 && v == 2) continue;  // gt2 == 0 closed it
          base = k == first_g1 ? 3 : 2;
        } else {
          base = 1;
        }
        code_remaining(v - base, rice);
        if (v > (3 << rice) && rice < 4) rice++;
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns bytes written to `out` (capacity out_cap), or -1 on overflow.
int encode_slice_data(int width, int height, int qp, const int32_t* depth8,
                      const int32_t* mode4, const int32_t* csel8,
                      const uint8_t* nxn8, const uint8_t* cbf4,
                      const uint8_t* cbf_y, const uint8_t* cbf_u,
                      const uint8_t* cbf_v, const int32_t* levels_y,
                      const int32_t* levels_u, const int32_t* levels_v,
                      const int32_t* sao_type, const int32_t* sao_eo,
                      const int32_t* sao_bp, const int32_t* sao_off,
                      const int32_t* sao_merge, int sbh, const int32_t* tusz8, int max_tu_depth,
                      int transform_skip, const uint8_t* ts4,
                      const uint8_t* ts8_u, const uint8_t* ts8_v,
                      const int32_t* qp_ctu,
                      uint8_t* out, int out_cap) {
  SliceEnc enc(width, height, qp, depth8, mode4, csel8, cbf_y, cbf_u, cbf_v,
               levels_y, levels_u, levels_v);
  enc.nxn8 = nxn8;
  enc.cbf4 = cbf4;
  enc.tusz8 = tusz8;
  enc.max_tu_depth = max_tu_depth;
  enc.transform_skip = transform_skip != 0;
  enc.ts4 = ts4;
  enc.ts8_u = ts8_u;
  enc.ts8_v = ts8_v;
  enc.sao_type = sao_type;
  enc.sao_eo = sao_eo;
  enc.sao_bp = sao_bp;
  enc.sao_off = sao_off;
  enc.sao_merge = sao_merge;
  enc.sbh = sbh != 0;
  enc.qp_ctu = qp_ctu;
  enc.encode();
  if (enc.qp_error) return -2;
  int n = static_cast<int>(enc.bw.bytes.size());
  if (n > out_cap) return -1;
  std::memcpy(out, enc.bw.bytes.data(), n);
  return n;
}

}  // extern "C"
