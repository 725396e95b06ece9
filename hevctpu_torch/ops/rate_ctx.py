"""Context-exact stateless rate estimation for residual coding (port of
hevctpu/ops/rate_ctx.py, the search's rate_model="ctx").

The reference prices every RD trial with a counting CABAC whose context
states persist across TUs and freezes those states for the whole of a
TU's RDOQ (TEncBinCABACCounter, estBitsSbac). This module prices the EXACT
bin stream of residual_coding (7.3.8.11, mirrored bin for bin from
codec/syntax.py SliceEncoder._residual) with each context-coded bin costed
at a frozen state: the I-slice initialization state for the slice QP,
blended with the calibrated corpus counts of ops/ctx_probs.py. Stateless,
so every TU of a frame is priced at once.

Per-position context classes, scan permutations, neighbor maps and
per-context bit costs are static per (TU size, scan, component, QP): the
host tables below are the JAX package's numpy code, float32. The gt1
context chain and the Golomb-Rice adaptation, scan-sequential in the
spec, become within-CG cumulative ops plus a 16-step recurrence.

Float sums are exact here: every context cost is a float32 in
[0.027, 5.8] bits (the CABAC state line's range), so it lies on the
2^-29 grid, and a TU's total (< 2^14 bits) fits the 53 bits of a float64.
The terms are added in float64, in any order without rounding, and the
total is rounded to float32 once: every device gives the same bits. The
JAX package adds in float32, so its bits differ in the last places.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch

from hevctpu_torch import rom
from hevctpu_torch.ops import rate

_BITS = rate.BITS_ONE  # fixed-point scale of the returned costs


# CABAC probability range: the state line's most-skewed LPS probability.
# The real engine can never price a bin outside [-log2(1-pmin), -log2(pmin)].
_P_MIN = 0.5 * ((0.01875 / 0.5) ** (63.0 / 63.0))   # p_lps at state 63

# Dirichlet prior weight on the init-state probability when blending the
# calibrated corpus counts (ops/ctx_probs.py) — small counts fall back to
# the init state, large counts dominate.
_PRIOR_K = 32.0


@functools.lru_cache(maxsize=None)
def _init_probs(name: str, qp: int) -> np.ndarray:
    """[n_ctx] P(bin=1) at the I-slice init state for qp."""
    row = rom.CTX_INIT[name][0]
    alpha = (0.01875 / 0.5) ** (1.0 / 63.0)
    out = np.zeros(len(row), np.float64)
    for i, iv in enumerate(row):
        state, mps = rom.cabac_init_state(iv, qp)
        p_lps = 0.5 * alpha ** state
        out[i] = (1.0 - p_lps) if mps == 1 else p_lps
    return out


@functools.lru_cache(maxsize=None)
def ctx_cost(name: str, qp: int, calibrated: bool = True) -> np.ndarray:
    """[n_ctx, 2] float32: bits of coding bin b in context (name, idx).

    P(bin|ctx) is the calibrated corpus frequency (ops/ctx_probs.py)
    blended with the init-state probability as a prior, clipped to the
    CABAC state line's reachable range. Without a calibration entry the
    cost degrades to the exact init-state price."""
    p1 = _init_probs(name, qp).copy()
    if not calibrated:
        p1 = np.clip(p1, _P_MIN, 1.0 - _P_MIN)
        return np.stack([-np.log2(1.0 - p1), -np.log2(p1)],
                        axis=-1).astype(np.float32)
    try:
        from hevctpu_torch.ops.ctx_probs import COUNTS
    except ImportError:
        COUNTS = {}
    qps = sorted(COUNTS) if COUNTS else []
    if qps:
        near = min(qps, key=lambda q: abs(q - qp))
        d = COUNTS[near].get(name, {})
        for i in range(len(p1)):
            c0, c1 = d.get(i, (0, 0))
            n = c0 + c1
            if n:
                p1[i] = (c1 + _PRIOR_K * p1[i]) / (n + _PRIOR_K)
    p1 = np.clip(p1, _P_MIN, 1.0 - _P_MIN)
    return np.stack([-np.log2(1.0 - p1), -np.log2(p1)],
                    axis=-1).astype(np.float32)


def _last_prefix(val: int) -> int:
    if val <= 3:
        return val
    k = val.bit_length() - 1
    return 2 * k + (1 if val >= (3 << (k - 1)) else 0)


@functools.lru_cache(maxsize=None)
def _last_cost(log2: int, is_luma: bool, qp: int,
               calibrated: bool = True) -> np.ndarray:
    """[n] float32: exact bits of coding one last-position coordinate
    value (ctx prefix per 9.3.4.2.3 + bypass suffix), at init states."""
    n = 1 << log2
    name = "last_sig_x_luma" if is_luma else "last_sig_x_chroma"
    cost = ctx_cost(name, qp, calibrated)
    if is_luma:
        offset = 3 * (log2 - 2) + ((log2 - 1) >> 2)
        shift = (log2 + 1) >> 2
    else:
        offset, shift = 0, log2 - 2
    gmax = (log2 << 1) - 1
    out = np.zeros(n, np.float32)
    for v in range(n):
        prefix = _last_prefix(v)
        b = 0.0
        for i in range(min(prefix, gmax)):
            b += cost[offset + (i >> shift), 1]
        if prefix < gmax:
            b += cost[offset + (prefix >> shift), 0]
        if prefix > 3:
            b += (prefix >> 1) - 1          # bypass suffix bits
        out[v] = b
    return out


def _sig_ctx_static(x: int, y: int, log2: int, scan_idx: int,
                    is_luma: bool, prev_csbf: int) -> int:
    """sig_coeff_flag ctxInc (9.3.4.2.5) — mirror of syntax._sig_ctx."""
    if log2 == 2:
        return int(rom.SIG_CTX_4X4[4 * y + x])
    if x == 0 and y == 0:
        return 0
    xp, yp = x & 3, y & 3
    if prev_csbf == 0:
        s = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
    elif prev_csbf == 1:
        s = 2 if yp == 0 else (1 if yp == 1 else 0)
    elif prev_csbf == 2:
        s = 2 if xp == 0 else (1 if xp == 1 else 0)
    else:
        s = 2
    if is_luma and (x >= 4 or y >= 4):
        s += 3
    if log2 == 3:
        s += (9 if scan_idx == rom.SCAN_DIAG else 15) if is_luma else 9
    else:
        s += 21 if is_luma else 12
    return s


class _Tables:
    __slots__ = ("perm", "posy", "posx", "sigctx", "right_nb", "below_nb",
                 "last_cost", "sig_cost", "csbf_cost", "g1_cost",
                 "g2_cost", "cbf_cost")


@functools.lru_cache(maxsize=None)
def _tables(log2: int, scan_idx: int, is_luma: bool, qp: int,
            calibrated: bool = True) -> _Tables:
    n = 1 << log2
    n2 = n * n
    m = max(n2 // 16, 1)
    t = _Tables()
    scan = rom.tb_scan(scan_idx, log2) if n > 4 else rom.scan_order(
        scan_idx, 4)
    t.posy = scan[:, 0].astype(np.int32)
    t.posx = scan[:, 1].astype(np.int32)
    t.perm = (t.posy * n + t.posx).astype(np.int32)

    sigctx = np.zeros((4, n2), np.int32)
    for p in range(4):
        for i in range(n2):
            sigctx[p, i] = _sig_ctx_static(
                int(t.posx[i]), int(t.posy[i]), log2, scan_idx, is_luma, p)
    t.sigctx = sigctx

    ncg = max(n // 4, 1)
    cgs = rom.scan_order(scan_idx, ncg)
    pos_of = {(int(cy), int(cx)): g for g, (cy, cx) in enumerate(cgs)}
    right = np.full(m, -1, np.int32)
    below = np.full(m, -1, np.int32)
    for g, (cy, cx) in enumerate(cgs):
        right[g] = pos_of.get((int(cy), int(cx) + 1), -1)
        below[g] = pos_of.get((int(cy) + 1, int(cx)), -1)
    t.right_nb, t.below_nb = right, below

    c = "luma" if is_luma else "chroma"
    t.last_cost = _last_cost(log2, is_luma, qp, calibrated)
    t.sig_cost = ctx_cost(f"sig_coeff_{c}", qp, calibrated)
    t.csbf_cost = ctx_cost(f"coded_sub_block_{c}", qp, calibrated)
    t.g1_cost = ctx_cost(f"coeff_abs_gt1_{c}", qp, calibrated)
    t.g2_cost = ctx_cost(f"coeff_abs_gt2_{c}", qp, calibrated)
    t.cbf_cost = ctx_cost("cbf_luma" if is_luma else "cbf_chroma", qp,
                          calibrated)
    return t


@functools.lru_cache(maxsize=None)
def mode_signal_bits(qp: int) -> tuple[float, float, float]:
    """(mpm_idx0, mpm_idx1/2, non-mpm) luma mode signaling bits at init
    states: prev_intra_luma_pred_flag ctx bin + TU bypass / 5 bypass
    (TEncSearch::xModeBitsIntra semantics)."""
    c = ctx_cost("prev_intra_luma_pred", qp)
    return (float(c[0, 1]) + 1.0, float(c[0, 1]) + 2.0,
            float(c[0, 0]) + 5.0)


@functools.lru_cache(maxsize=None)
def chroma_sel_bits(qp: int) -> tuple[float, ...]:
    """Signaling bits of the 5 intra_chroma_pred_mode symbols (4 list
    entries then DM): ctx bin + 2 bypass for a list entry, ctx bin for
    DM (9.3.3.8 binarization as coded by codec/syntax.py)."""
    c = ctx_cost("intra_chroma_pred_mode", qp)
    lst = float(c[0, 1]) + 2.0
    return (lst, lst, lst, lst, float(c[0, 0]))


@functools.lru_cache(maxsize=None)
def split_cu_bits(qp: int, ctx: int = 1) -> tuple[float, float]:
    """(split=0, split=1) bits of split_cu_flag at init state; ctx is the
    neighbor-depth context (0..2), default the middle class."""
    c = ctx_cost("split_cu_flag", qp)
    return float(c[ctx, 0]), float(c[ctx, 1])


@functools.lru_cache(maxsize=None)
def part_mode_bits(qp: int) -> tuple[float, float]:
    """(PART_NxN, PART_2Nx2N) bits of the part_mode bin coded at
    max-depth intra CUs (bin 1 = 2Nx2N)."""
    c = ctx_cost("part_mode", qp)
    return float(c[0, 0]), float(c[0, 1])


@functools.lru_cache(maxsize=None)
def split_tu_bits(qp: int, log2: int) -> tuple[float, float]:
    """(no-split, split) bits of split_transform_flag at ctx 5-log2."""
    c = ctx_cost("split_transform_flag", qp)
    return float(c[5 - log2, 0]), float(c[5 - log2, 1])


@functools.lru_cache(maxsize=None)
def _tables_t(log2: int, scan_idx: int, is_luma: bool, qp: int,
              calibrated: bool, device: torch.device):
    """_tables on `device`: indices int64, costs as float64 (exact copies
    of the float32 entries), cost tables flattened to [ctx * 2 + bin]."""
    t = _tables(log2, scan_idx, is_luma, qp, calibrated)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64).ravel(),
                               device=device)

    return types.SimpleNamespace(
        perm=i64(t.perm), posy=i64(t.posy), posx=i64(t.posx),
        sigctx=i64(t.sigctx).ravel(), right=i64(t.right_nb),
        below=i64(t.below_nb), last=f64(t.last_cost), sig=f64(t.sig_cost),
        csbf=f64(t.csbf_cost), g1=f64(t.g1_cost), g2=f64(t.g2_cost),
        cbf=f64(t.cbf_cost))


def _rem_len(val: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exact coeff_abs_level_remaining length (9.3.3.9; mirror of
    syntax._code_remaining): prefix 0..3 -> q+1+c bits; escape -> the
    growing Exp-Golomb ladder. floor(log2(w + 0.5)) of the JAX package is
    bit_length(w) - 1 here (w >= 1), in integers."""
    q = val >> c
    small = q < 4
    w = torch.clamp_min(val - (2 << c), 1)
    k = torch.maximum(rate.bit_length(w) - 1, c + 1)
    return torch.where(small, q + 1 + c, 4 + 2 * k - c)


def estimate_tu_bits_ctx(levels: torch.Tensor, log2: int, qp: int, *,
                         is_luma: bool = True,
                         scan_idx: int = rom.SCAN_DIAG,
                         sbh: bool = True, cbf_ctx: int = 0,
                         include_cbf: bool = True,
                         calibrated: bool = True) -> torch.Tensor:
    """Bits of residual_coding(levels) [..., N, N] -> [...] float32 in
    1/BITS_ONE units: the exact 7.3.8.11 bin stream priced at frozen
    context states (see the module docstring). A zero TU costs the cbf=0
    bin; include_cbf=False drops the cbf bin from both sides."""
    n = 1 << log2
    n2 = n * n
    m = max(n2 // 16, 1)
    dev = levels.device
    t = _tables_t(log2, scan_idx, is_luma, qp, calibrated, dev)
    lead = levels.shape[:-2]
    a = levels.reshape(*lead, n2).index_select(-1, t.perm).abs().to(
        torch.int32)
    nz = a > 0
    iota = torch.arange(n2, device=dev)
    last = torch.where(nz, iota, -1).amax(dim=-1)
    any_nz = last >= 0
    lastc = torch.clamp_min(last, 0)

    # --- last position ---------------------------------------------------
    ly, lx = t.posy[lastc], t.posx[lastc]
    if scan_idx == rom.SCAN_VER:
        lx, ly = ly, lx
    last_bits = t.last[lx] + t.last[ly]

    # --- CG structure (the scan in [..., m, 16] groups) ------------------
    ac = a.reshape(*lead, m, 16)
    nzc = nz.reshape(*lead, m, 16)
    cg_nz = nzc.any(dim=-1)
    last_cg = lastc >> 4
    cg_iota = torch.arange(m, device=dev)
    csbf_coded = (cg_iota > 0) & (cg_iota < last_cg[..., None])

    def nb_gather(idx):
        return cg_nz.index_select(-1, torch.clamp_min(idx, 0)) & (idx >= 0)

    p = (nb_gather(t.right).long() + 2 * nb_gather(t.below).long())
    csbf_bits = torch.where(
        csbf_coded, t.csbf[torch.clamp_max(p, 1) * 2 + cg_nz.long()],
        0.0).sum(dim=-1)

    proc = (cg_iota <= last_cg[..., None]) & (cg_nz | ~csbf_coded)

    # --- significance map ------------------------------------------------
    others_nz = nzc[..., 1:].any(dim=-1)                  # positions 1..15
    iota_g = iota.reshape(m, 16)
    w_iota = torch.arange(16, device=dev)
    before_last = iota_g < last[..., None, None]
    dc_skip = ((w_iota == 0) & csbf_coded[..., None]
               & ~others_nz[..., None])
    sig_mask = proc[..., None] & before_last & ~dc_skip
    ctx_sig = t.sigctx[p[..., None] * n2 + iota_g]        # [..., m, 16]
    sig_bits = torch.where(sig_mask, t.sig[ctx_sig * 2 + nzc.long()],
                           0.0).sum(dim=(-2, -1))

    # --- gt1 / gt2 (reverse scan within CG) ------------------------------
    ar = ac.flip(-1)
    nzr = nzc.flip(-1)
    rank = nzr.long().cumsum(dim=-1)                      # 1-based at nz
    first8 = nzr & (rank <= 8)
    f = (ar > 1) & first8                                 # gt1 flags
    f_l, first8_l = f.long(), first8.long()

    # previous processed-with-coeffs CG (descending cg order) -> ctx_set +1
    has1 = f.any(dim=-1)
    idxv = torch.where(proc & cg_nz, cg_iota, m)
    revmin = idxv.flip(-1).cummin(dim=-1).values.flip(-1)
    prev_idx = torch.cat([revmin[..., 1:], torch.full_like(revmin[..., :1],
                                                           m)], dim=-1)
    prev_has1 = (has1.gather(-1, torch.clamp_max(prev_idx, m - 1))
                 & (prev_idx < m))
    ctx_set = (torch.where(cg_iota == 0, 0, 2 if is_luma else 0)
               + prev_has1.long())                        # [..., m]

    cnt_prev = first8_l.cumsum(dim=-1) - first8_l         # coded before
    cum_f = f_l.cumsum(dim=-1)
    any1_prev = (cum_f - f_l) > 0
    g1ctx = torch.where(any1_prev, 0, torch.clamp_max(1 + cnt_prev, 3))
    gt1_bits = torch.where(
        first8, t.g1[(ctx_set[..., None] * 4 + g1ctx) * 2 + f_l],
        0.0).sum(dim=(-2, -1))

    firstg1 = f & (cum_f == 1)
    g2_bin = (firstg1 & (ar > 2)).any(dim=-1)
    g2_idx = ctx_set if is_luma else torch.clamp_max(ctx_set, 1)
    gt2_bits = torch.where(has1, t.g2[g2_idx * 2 + g2_bin.long()],
                           0.0).sum(dim=-1)

    # --- signs (with sign-bit-hiding) ------------------------------------
    wmin = torch.where(nzc, w_iota, 16).amin(dim=-1)
    wmax = torch.where(nzc, w_iota, -1).amax(dim=-1)
    nnz_cg = nzc.sum(dim=-1)
    hidden = ((wmax - wmin > 3) if sbh else torch.zeros_like(cg_nz)).long()
    sign_bits = torch.where(cg_nz, nnz_cg - hidden, 0).sum(dim=-1)

    # --- remaining levels (Golomb-Rice with within-CG adaptation) --------
    coded_rem = (first8 & f & ~(firstg1 & (ar == 2))) | (nzr & (rank > 8))
    basev = torch.where(rank > 8, 1, torch.where(firstg1, 3, 2))
    vrem = torch.clamp_min(ar - basev, 0).to(torch.int32)
    rice = torch.zeros(lead + (m,), dtype=torch.int32, device=dev)
    rem_bits = torch.zeros(lead + (m,), dtype=torch.int32, device=dev)
    for j in range(16):
        cj = coded_rem[..., j]
        rem_bits = rem_bits + torch.where(cj, _rem_len(vrem[..., j], rice),
                                          0)
        rice = torch.where(cj & (ar[..., j] > (3 << rice)),
                           torch.clamp_max(rice + 1, 4), rice)
    rem_bits = rem_bits.sum(dim=-1)

    # exact float64 total, one rounding to float32
    total = (last_bits + csbf_bits + sig_bits + gt1_bits + gt2_bits
             + sign_bits + rem_bits)
    if include_cbf:
        total = total + t.cbf[cbf_ctx * 2 + 1]
        zero = t.cbf[cbf_ctx * 2]
    else:
        zero = 0.0
    return torch.where(any_nz, total, zero).to(torch.float32) * float(_BITS)
