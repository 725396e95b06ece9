"""Sample Adaptive Offset: statistics, parameter decision and application
(port of hevctpu/ops/sao.py).

Category maps for all four EO classes and the band index are computed for
the whole frame at once, per-CTU statistics are block reductions, and the
per-CTU type/offset decision is a small vectorized argmin (HM's
TEncSampleAdaptiveOffset roles: getBlkStats, deriveOffsets,
decideBlkParams, deriveModeMergeRDO). Short float sums add left to right
(quant.seqsum), so every device decides alike and exact ties stay ties.

Planes are [B, HP, WP] int32 (CTU-padded); `h, w` bound the picture.
Parameter layout per frame: sao_type [B, rc, cc, 2] (0 off, 1 BO, 2 EO;
luma, chroma-joint), sao_eo [B, rc, cc, 2], sao_bp [B, rc, cc, 3],
sao_off [B, rc, cc, 3, 4].
"""

from __future__ import annotations

import numpy as np
import torch

from hevctpu_torch.ops import rate
from hevctpu_torch.ops.quant import seqsum

# neighbor offset (dy, dx) of each EO class (H.265 Table 7-9 order)
EO_NEIGHBORS = ((0, 1), (1, 0), (1, 1), (1, -1))


def _shift2(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Roll [B,H,W] by (-dy, -dx) (wrapped samples are masked by the
    caller)."""
    if dy:
        p = torch.roll(p, -dy, dims=1)
    if dx:
        p = torch.roll(p, -dx, dims=2)
    return p


def eo_category(p: torch.Tensor, cls: int, h: int, w: int) -> torch.Tensor:
    """Edge-offset category map [B,H,W] in 0..4 for EO class `cls`
    (8.7.3); pixels whose neighbors fall outside the picture get 0."""
    dy, dx = EO_NEIGHBORS[cls]
    a = _shift2(p, -dy, -dx)
    b = _shift2(p, dy, dx)
    e = (2 + torch.sign(p - a) + torch.sign(p - b)).to(torch.int32)
    cat = torch.where(e < 2, e + 1, torch.where(e == 2, 0, e))
    yy = torch.arange(p.shape[1], device=p.device)[:, None]
    xx = torch.arange(p.shape[2], device=p.device)[None, :]
    ok = ((yy - abs(dy) >= 0) & (yy + abs(dy) < h)
          & (xx - dx >= 0) & (xx + dx < w) & (xx + dx >= 0) & (xx - dx < w))
    return torch.where(ok[None], cat, 0)


def band_index(p: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    return p >> (bit_depth - 5)


def _block_sum(x: torch.Tensor, span: int) -> torch.Tensor:
    b, hp, wp = x.shape
    return x.reshape(b, hp // span, span, wp // span, span).sum(
        dim=(2, 4)).to(torch.int32)


def ctu_stats(org: torch.Tensor, rec: torch.Tensor, h: int, w: int,
              span: int = 64):
    """Per-CTU SAO statistics of one plane: (eo_cnt [B,rc,cc,4,4], eo_sum
    [B,rc,cc,4,4], bo_cnt [B,rc,cc,32], bo_sum [B,rc,cc,32]); the eo axes
    are (class, category-1), sums are Σ(org - rec) over member pixels."""
    b, hp, wp = rec.shape
    yy = torch.arange(hp, device=rec.device)[:, None]
    xx = torch.arange(wp, device=rec.device)[None, :]
    inside = ((yy < h) & (xx < w))[None]
    diff = torch.where(inside, org - rec, 0)

    eo_cnt, eo_sum = [], []
    for cls in range(4):
        cat = eo_category(rec, cls, h, w)
        cnts, sums = [], []
        for c in range(1, 5):
            m = cat == c
            cnts.append(_block_sum(m.to(torch.int32), span))
            sums.append(_block_sum(torch.where(m, diff, 0), span))
        eo_cnt.append(torch.stack(cnts, dim=-1))
        eo_sum.append(torch.stack(sums, dim=-1))

    band = band_index(rec)
    bo_cnt, bo_sum = [], []
    for k in range(32):
        m = (band == k) & inside
        bo_cnt.append(_block_sum(m.to(torch.int32), span))
        bo_sum.append(_block_sum(torch.where(m, diff, 0), span))
    return (torch.stack(eo_cnt, dim=-2), torch.stack(eo_sum, dim=-2),
            torch.stack(bo_cnt, dim=-1), torch.stack(bo_sum, dim=-1))


def _best_offset(cnt, sm, sign: int, lam: float):
    """Best offset per statistics cell among o in 0..7 of the given sign
    (0 = both): ΔD(o) = o²·cnt − 2·o·sum plus λ·(|o|+1 TR bins, +1 sign
    bin for BO). Returns (delta_j, signed offset)."""
    if sign == 0:
        offs = np.concatenate([np.arange(0, 8), -np.arange(1, 8)])
        bits = np.minimum(np.abs(offs) + 1, 7) + (offs != 0)
    else:
        offs = sign * np.arange(0, 8)
        bits = np.minimum(np.abs(offs) + 1, 7)
    offs_t = torch.as_tensor(offs, dtype=torch.int32, device=cnt.device)
    offs_f = offs_t.to(torch.float32)
    d = (offs_f ** 2 * cnt[..., None].to(torch.float32)
         - 2.0 * offs_f * sm[..., None].to(torch.float32))
    j = d + lam * torch.as_tensor(bits, dtype=torch.float32,
                                  device=cnt.device)
    jmin, k = torch.min(j, dim=-1)
    return jmin, offs_t[k]


def derive_component(eo_cnt, eo_sum, bo_cnt, bo_sum, lam: float,
                     dist_w: float = 1.0):
    """Per-CTU candidate ΔJ and offsets for one component: (eo_j [.., 4],
    eo_off [.., 4, 4], bo_j [..], bo_pos [..], bo_off [.., 4])."""
    lam_eff = lam / dist_w

    # EO: categories 1,2 positive, 3,4 negative (signs inferred, 7.3.8.3)
    j_pos, off_pos = _best_offset(eo_cnt[..., :2], eo_sum[..., :2], 1,
                                  lam_eff)
    j_neg, off_neg = _best_offset(eo_cnt[..., 2:], eo_sum[..., 2:], -1,
                                  lam_eff)
    eo_j = dist_w * seqsum(torch.cat([j_pos, j_neg], dim=-1), -1)
    eo_off = torch.cat([off_pos, off_neg], dim=-1)

    # BO: best offset per band (free sign), then best 4-band window
    bj, boff = _best_offset(bo_cnt, bo_sum, 0, lam_eff)     # [.., 32]
    wins = torch.stack([seqsum(bj[..., i: i + 4], -1) for i in range(29)],
                       dim=-1)                               # [.., 29]
    bo_min, bo_pos = torch.min(wins, dim=-1)
    bo_j = dist_w * bo_min
    idx = bo_pos[..., None] + torch.arange(4, device=bj.device)
    bo_off = torch.gather(boff, -1, idx)
    return eo_j, eo_off, bo_j, bo_pos.to(torch.int32), bo_off


def _eval_params(stats, typ, cls, bp, off, dist_w: float):
    """dist_w-weighted ΔD [B,rc,cc] of applying the given SAO params to one
    component's CTU stats (HM's estSaoDist per category)."""
    eo_cnt, eo_sum, bo_cnt, bo_sum = stats
    offf = off.to(torch.float32)
    cls_i = cls.long()[..., None, None].expand(cls.shape + (1, 4))
    cnt_c = torch.gather(eo_cnt, -2, cls_i)[..., 0, :]
    sum_c = torch.gather(eo_sum, -2, cls_i)[..., 0, :]
    dd_eo = seqsum(offf ** 2 * cnt_c.to(torch.float32)
                   - 2.0 * offf * sum_c.to(torch.float32), -1)
    idx = bp.long()[..., None] + torch.arange(4, device=bp.device)
    # bands past 31 are not applied by apply_sao: masked out, no wrap
    in_range = idx <= 31
    idx = torch.clamp(idx, 0, 31)
    cnt_b = torch.where(in_range, torch.gather(bo_cnt, -1, idx), 0)
    sum_b = torch.where(in_range, torch.gather(bo_sum, -1, idx), 0)
    dd_bo = seqsum(offf ** 2 * cnt_b.to(torch.float32)
                   - 2.0 * offf * sum_b.to(torch.float32), -1)
    dd = torch.where(typ == 2, dd_eo, torch.where(typ == 1, dd_bo, 0.0))
    return dist_w * dd


def decide_params(y_stats, u_stats, v_stats, qp: int, qp_c: int):
    """Full per-CTU SAO decision for a frame: luma alone, Cb/Cr sharing
    type and EO class; merge-left/up evaluated densely against each
    neighbor's new-params choice (a CTU merges only from a neighbor that
    keeps its own new params). Returns int32 (sao_type, sao_eo, sao_bp,
    sao_off, sao_merge) with the final post-merge params."""
    lam = rate.lambda_rd(qp)
    w_c = rate.chroma_dist_weight(qp, qp_c)

    ey, eoy, by, bpy, boy = derive_component(*y_stats, lam)
    eu, eou, bu, bpu, bou = derive_component(*u_stats, lam, w_c)
    ev, eov, bv, bpv, bov = derive_component(*v_stats, lam, w_c)

    # syntax bits: type TR2 = 2, eo class = 2, band position = 5 per
    # component, OFF = 1 type bin
    def pick(eo_j, bo_j, bits_eo, bits_bo, bits_off):
        cand = torch.cat(
            [torch.full(bo_j.shape + (1,), lam * bits_off,
                        dtype=torch.float32, device=bo_j.device),
             (bo_j + lam * bits_bo)[..., None],
             eo_j + lam * bits_eo], dim=-1)                  # [.., 6]
        jmin, k = torch.min(cand, dim=-1)
        typ = torch.where(k == 0, 0, torch.where(k == 1, 1, 2))
        cls = torch.clamp_min(k - 2, 0)
        return typ, cls, jmin

    typ_y, cls_y, j_y = pick(ey, by, 2 + 2, 2 + 5, 1)
    typ_c, cls_c, j_c = pick(eu + ev, bu + bv, 2 + 2, 2 + 5 + 5, 1)

    sao_type = torch.stack([typ_y, typ_c], dim=-1)
    sao_eo = torch.stack([cls_y, cls_c], dim=-1)
    sao_bp = torch.stack([bpy, bpu, bpv], dim=-1)

    def comp_off(typ, cls, eo_off, bo_off):
        eo_sel = torch.gather(
            eo_off, -2, cls.long()[..., None, None].expand(
                cls.shape + (1, 4)))[..., 0, :]
        return torch.where(typ[..., None] == 2, eo_sel,
                           torch.where(typ[..., None] == 1, bo_off, 0))

    sao_off = torch.stack([comp_off(typ_y, cls_y, eoy, boy),
                           comp_off(typ_c, cls_c, eou, bou),
                           comp_off(typ_c, cls_c, eov, bov)], dim=-2)

    # merge-left / merge-up RD
    j_new = j_y + j_c + lam * 1.2          # two merge-flag zero bins

    def shift_params(axis):
        """Neighbor's params viewed from each CTU (left: axis=2, up: 1)."""
        def sh(x):
            pad = torch.zeros_like(x.narrow(axis, 0, 1))
            return torch.cat([pad, x.narrow(axis, 0, x.shape[axis] - 1)],
                             dim=axis)
        return sh(sao_type), sh(sao_eo), sh(sao_bp), sh(sao_off)

    def j_of(params):
        t2, e2, b3, o34 = params
        j = _eval_params(y_stats, t2[..., 0], e2[..., 0], b3[..., 0],
                         o34[..., 0, :], 1.0)
        j = j + _eval_params(u_stats, t2[..., 1], e2[..., 1], b3[..., 1],
                             o34[..., 1, :], w_c)
        j = j + _eval_params(v_stats, t2[..., 1], e2[..., 1], b3[..., 2],
                             o34[..., 2, :], w_c)
        return j

    _, rc_, cc_ = typ_y.shape
    col = torch.arange(cc_, device=typ_y.device)[None, None, :]
    row = torch.arange(rc_, device=typ_y.device)[None, :, None]
    pl = shift_params(2)
    pu_ = shift_params(1)
    j_left = torch.where(col > 0, j_of(pl) + lam * 0.6, torch.inf)
    j_up = torch.where(row > 0, j_of(pu_) + lam * 1.2, torch.inf)

    prov = torch.stack([j_new, j_left, j_up], dim=-1).argmin(dim=-1)
    left_new = torch.nn.functional.pad(prov[:, :, :-1] == 0, (1, 0))
    up_new = torch.nn.functional.pad(prov[:, :-1, :] == 0, (0, 0, 1, 0))
    merge = torch.where((prov == 1) & left_new, 1,
                        torch.where((prov == 2) & up_new, 2, 0))

    def apply_merge(x, nbr_l, nbr_u):
        m = merge.reshape(merge.shape + (1,) * (x.dim() - 3))
        return torch.where(m == 1, nbr_l, torch.where(m == 2, nbr_u, x))

    i32 = torch.int32
    return (apply_merge(sao_type, pl[0], pu_[0]).to(i32),
            apply_merge(sao_eo, pl[1], pu_[1]).to(i32),
            apply_merge(sao_bp, pl[2], pu_[2]).to(i32),
            apply_merge(sao_off, pl[3], pu_[3]).to(i32),
            merge.to(i32))


def apply_sao(rec, sao_type, sao_eo, sao_bp, sao_off, comp: int, h: int,
              w: int, span: int = 64, bit_depth: int = 8):
    """Apply SAO params to one plane [B,HP,WP] -> filtered plane."""
    b, hp, wp = rec.shape
    rc, cc = hp // span, wp // span
    tix = 0 if comp == 0 else 1

    def up(x):  # [B,rc,cc] -> [B,HP,WP]
        return x[:, :, None, :, None].expand(b, rc, span, cc, span).reshape(
            b, hp, wp)

    t_pix = up(sao_type[..., tix])
    eo_pix = up(sao_eo[..., tix])
    bp_pix = up(sao_bp[..., comp])

    cat = torch.zeros_like(rec)
    for cls in range(4):
        cat = torch.where(eo_pix == cls, eo_category(rec, cls, h, w), cat)
    bidx = band_index(rec, bit_depth) - bp_pix

    eo_val = torch.zeros_like(rec)
    bo_val = torch.zeros_like(rec)
    for k in range(4):
        off_k = up(sao_off[..., comp, k])
        eo_val = eo_val + torch.where(cat == k + 1, off_k, 0)
        bo_val = bo_val + torch.where(bidx == k, off_k, 0)

    delta = torch.where(t_pix == 2, eo_val, torch.where(t_pix == 1, bo_val, 0))
    return torch.clamp(rec + delta, 0, (1 << bit_depth) - 1)
