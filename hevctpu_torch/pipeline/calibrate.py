"""The calibration path: rebuild the three fitted artifacts the encoder
reads from the port's own full-RD encodes (port of the logic of
tools/fit_rate_constants.py, tools/fit_ctx_probs.py and
tools/train_cnn_domain.py; the command lines are
tools/*_torch.py).

- the per-QP bin weights of the global rate model (ops/rate_weights.py):
  every coded luma TU of frame 0 of each corpus encode, its exact
  fresh-context CABAC bits (CabacCounter over the real residual syntax)
  against rate.tu_bit_features, a ridge fit toward the hand-set weights;
- the per-context bin counts of rate_model="ctx" (ops/ctx_probs.py): the
  golden slice coder's bin stream over corpus encodes, counted per
  (context name, index);
- the domain ConvNet2 checkpoint: full-RD labels (labels.rd_ground_truth)
  on the corpus clip families, labels.make_dataset, train.train.

Each function takes the frame size and the device; the encodes run there
(the card unless the caller names another), the counting on the host.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from hevctpu_torch.ops import rate

QPS = (22, 27, 32, 37)
H, W = 240, 416                  # the tools' corpus frame size
ALPHAS = (1e1, 1e2, 1e3, 1e4, 1e5)
PINNED = ("cbf1", "cbf0")        # weights the regression does not move


# ---------------------------------------------------------------------------
# Rate weights
# ---------------------------------------------------------------------------


def true_residual_bits(blk, log2, qp, mode=1, comp=0):
    """Counting-CABAC bits to code one TU's levels with fresh contexts."""
    from hevctpu_torch.codec import headers
    from hevctpu_torch.codec.cabac import CabacCounter, ContextSet
    from hevctpu_torch.codec.syntax import SliceEncoder

    enc = SliceEncoder.__new__(SliceEncoder)
    enc.cfg = headers.StreamConfig(width=64, height=64, qp=qp,
                                   sign_data_hiding=False,
                                   transform_skip=False)
    enc.levels = {comp: blk}
    enc.ctx = ContextSet(qp, init_type=0)
    enc.c = CabacCounter()
    enc._residual(0, 0, log2, comp, mode)
    return enc.c.bits


def frame_tus(out):
    """Every coded luma TU (levels, log2) of frame 0 of an encode dict."""
    tz = out["tusz8"][0]
    coded = out["coded8"][0]
    lv = out["levels_y"][0].astype(np.int32)
    cbf = out["cbf_y"][0]
    cbf4 = out["cbf4_y"][0]
    tus, seen = [], set()
    for sy in range(tz.shape[0]):
        for sx in range(tz.shape[1]):
            if not coded[sy, sx]:
                continue
            s = int(tz[sy, sx])
            if s == 2:
                for q in range(4):
                    qy, qx = sy * 2 + q // 2, sx * 2 + q % 2
                    if cbf4[qy, qx]:
                        tus.append((lv[qy * 4: qy * 4 + 4,
                                       qx * 4: qx * 4 + 4], 2))
                continue
            step = 1 << (s - 3)
            oy, ox = (sy // step) * step, (sx // step) * step
            if (oy, ox, s) in seen:
                continue
            seen.add((oy, ox, s))
            if cbf[oy, ox]:
                n = 1 << s
                tus.append((lv[oy * 8: oy * 8 + n, ox * 8: ox * 8 + n], s))
    return tus


def rate_samples(qp: int, clips, frames: int, h: int = H, w: int = W,
                 device=None):
    """(features [T, len(_W_FIELDS) + 1], exact bits [T]) of every coded
    luma TU of frame 0 of each clip's full-RD encode at `qp` (SBH off: the
    estimator models plain sign coding; TS off: transform TUs only)."""
    from hevctpu_torch.pipeline import clips as clip_mod
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    enc = FrameEncoder(h, w, qp, search="rd", sbh=False, ts=False,
                       device=device)
    feats, trues = [], []
    for name in clips:
        out = enc.encode(*clip_mod.make_clip(name, frames, h, w))
        for blk, log2 in frame_tus(out):
            feats.append(rate.tu_bit_features(blk, log2))
            trues.append(true_residual_bits(blk, log2, qp))
    return np.stack(feats), np.asarray(trues)


def fit_rate_weights(feats, trues, max_tus: int = 1200):
    """Ridge fit of one QP's bin weights (1/BITS_ONE units) to the exact
    bits. The cbf weights stay pinned (_residual codes last position and
    levels only); the bypass bits are exact and leave the right-hand side.
    The count columns are collinear (every nonzero coefficient adds to
    sig1 and one of gt1_*), so the solve is pulled toward the hand-set
    weights with the alpha that does best on a 1/4 holdout. Returns (the
    full weight tuple in _W_FIELDS order, the report line)."""
    fields = rate._W_FIELDS
    free = [i for i, k in enumerate(fields) if k not in PINNED]
    F = np.asarray(feats, np.float64)
    rhs = np.asarray(trues) * rate.BITS_ONE - F[:, -1] * rate.BITS_ONE
    A = F[:, free]
    if len(F) > max_tus:
        idx = np.random.default_rng(0).choice(len(F), max_tus,
                                              replace=False)
        A, rhs = A[idx], rhs[idx]
    w_old = np.array([rate._W_DEFAULT[fields[i]] for i in free])
    perm = np.random.default_rng(1).permutation(len(A))
    n_tr = len(A) * 3 // 4
    tr, va = perm[:n_tr], perm[n_tr:]

    def ridge(alpha):
        aug_a = np.vstack([A[tr], np.sqrt(alpha) * np.eye(len(free))])
        aug_b = np.concatenate([rhs[tr], np.sqrt(alpha) * w_old])
        wt, *_ = np.linalg.lstsq(aug_a, aug_b, rcond=None)
        return np.clip(wt, 0.02 * rate.BITS_ONE, 2.0 * rate.BITS_ONE)

    best = None
    for alpha in ALPHAS:
        w_try = ridge(alpha)
        err = np.abs(A[va] @ w_try - rhs[va]).mean()
        if best is None or err < best[0]:
            best = (err, w_try)
    w_free = best[1]
    w_full = np.array([rate._W_DEFAULT[k] for k in fields], np.float64)
    w_full[free] = w_free
    est_new, est_old = A @ w_free, A @ w_old
    line = (f"{len(A)} TUs; scale {est_old.sum() / rhs.sum():.3f} -> "
            f"{est_new.sum() / rhs.sum():.3f}; mean abs err "
            f"{np.abs(est_old - rhs).mean() / rate.BITS_ONE:.1f} -> "
            f"{np.abs(est_new - rhs).mean() / rate.BITS_ONE:.1f} bits")
    return tuple(int(round(x)) for x in w_full), line


def fit_rate_constants(clips, frames: int, max_tus: int = 1200, *,
                       qps=QPS, h: int = H, w: int = W, device=None,
                       log=print):
    """{qp: weights} and the report lines, one fit per QP."""
    fitted, report = {}, []
    for qp in qps:
        feats, trues = rate_samples(qp, clips, frames, h, w, device)
        fitted[qp], line = fit_rate_weights(feats, trues, max_tus)
        report.append(f"qp {qp}: {line}")
        if log:
            log(report[-1])
            log("  weights:", {k: round(v / rate.BITS_ONE, 3) for k, v in
                               zip(rate._W_FIELDS, fitted[qp])})
    return fitted, report


def rate_weights_source(fitted: dict, report, tool: str) -> str:
    """The text of a rate_weights module holding `fitted`."""
    return "\n".join([
        '"""Regression-fitted per-QP bin weights for ops/rate.py',
        f"(generated by {tool} — do not hand-edit).",
        "",
    ] + list(report) + [
        '"""',
        "",
        "# {qp: weights in 1/256-bit units, field order rate._W_FIELDS}",
        f"FITTED = {fitted!r}",
        "",
    ])


# ---------------------------------------------------------------------------
# Context bin counts
# ---------------------------------------------------------------------------


def record_counts(frame: dict, cfg, counts):
    """Run the golden SliceEncoder bin stream for every batch entry of
    `frame`, accumulating per-(name, idx) [zeros, ones] bin counts."""
    from hevctpu_torch.codec import headers
    from hevctpu_torch.codec.cabac import CabacCounter, ContextSet
    from hevctpu_torch.codec.syntax import SliceEncoder

    class Recorder(CabacCounter):
        def __init__(self, rev):
            super().__init__()
            self.rev = rev

        def encode_bin(self, ctx, b):
            counts[self.rev[id(ctx)]][1 if b else 0] += 1
            super().encode_bin(ctx, b)

    class RecordingSliceEncoder(SliceEncoder):
        def encode(self):
            headers.write_slice_header(self.cfg)
            self.ctx = ContextSet(self.cfg.qp, init_type=0)
            rev = {}
            for name, models in self.ctx._ctx.items():
                for i, m in enumerate(models):
                    rev[id(m)] = (name, i)
            self.c = Recorder(rev)
            n_ctu = self.rc * self.cc
            for a in range(n_ctu):
                r, c = divmod(a, self.cc)
                if self.sao is not None:
                    self._sao_params(r, c)
                self._quadtree(64 * c, 64 * r, 6)
                self.c.encode_terminate(1 if a == n_ctu - 1 else 0)
            return b""

    for i in range(frame["depth8"].shape[0]):
        RecordingSliceEncoder(cfg, frame, i).encode()


def ctx_count_table(qps, clips, frames: int, *, h: int = H, w: int = W,
                    device=None, log=print) -> dict:
    """{qp: {context name: {idx: (zeros, ones)}}} over the full-RD encodes
    of `clips` (the fitting encode searches the whole decision space the
    estimator prices)."""
    from hevctpu_torch.codec import headers
    from hevctpu_torch.pipeline.clips import make_clip
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    table = {}
    for qp in qps:
        counts = collections.defaultdict(lambda: [0, 0])
        enc = FrameEncoder(h, w, qp, search="rd", device=device)
        cfg = headers.StreamConfig(width=w, height=h, qp=qp)
        for name in clips:
            record_counts(enc.encode(*make_clip(name, frames, h, w)), cfg,
                          counts)
            if log:
                log(f"qp {qp} clip {name}: "
                    f"{sum(sum(v) for v in counts.values())} bins")
        per_name = {}
        for (name, idx), (c0, c1) in sorted(counts.items()):
            per_name.setdefault(name, {})[idx] = (c0, c1)
        table[qp] = per_name
    return table


def ctx_probs_source(table: dict, tool: str) -> str:
    """The text of a ctx_probs module holding `table`."""
    lines = [
        f'"""GENERATED by {tool} — per-context bin counts',
        "",
        "Empirical (ctx, bin) frequencies from golden-coder bin streams of",
        "corpus encodes (fit clips exclude the BD holdout). Consumed by",
        "ops/rate_ctx.ctx_cost as evidence over the init-state prior.",
        '"""',
        "",
        "COUNTS = {",
    ]
    for qp, per_name in table.items():
        lines.append(f"    {qp}: {{")
        for name, d in per_name.items():
            items = ", ".join(f"{i}: ({c0}, {c1})"
                              for i, (c0, c1) in sorted(d.items()))
            lines.append(f"        {name!r}: {{{items}}},")
        lines.append("    },")
    lines.append("}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Domain CNN
# ---------------------------------------------------------------------------


def domain_dataset(families, seeds: int, frames: int, qps, *, h: int = H,
                   w: int = W, device=None, log=print):
    """(x32, x64, digits) tensors on `device` from full-RD labels of every
    (family, seed) clip: seeds 100 + s (the seed-0 clips stay held out for
    evaluation), the QPs taken in turn."""
    from hevctpu_torch import get_device
    from hevctpu_torch.pipeline import clips
    from hevctpu_torch.pipeline import labels as lab_mod

    dev = get_device(device)
    xs32, xs64, ds = [], [], []
    k = 0
    for fam in families:
        for s in range(seeds):
            y, u, v = clips.make_clip(fam, frames, h, w, seed=100 + s)
            qp = qps[k % len(qps)]
            k += 1
            lab = lab_mod.rd_ground_truth(y, u, v, qp, device=dev)
            x32, x64, digits = lab_mod.make_dataset(
                y.astype(np.int32), u.astype(np.int32), v.astype(np.int32),
                lab, device=dev)
            xs32.append(x32)
            xs64.append(x64)
            ds.append(digits)
            if log:
                log(f"clip {fam} seed={100 + s} qp={qp}: "
                    f"{digits.shape[0]} samples")
    return torch.cat(xs32), torch.cat(xs64), torch.cat(ds)
