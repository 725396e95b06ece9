"""The evaluation path: the reference's RD protocol on the port's encoder
(port of the logic of tools/measure_anchor.py, measure_corpus.py,
measure_rd.py, attribute_gap.py, bit_stats.py and measure_pruned_hm.py;
the command lines are tools/*_torch.py).

The protocol (calc_BDBR/README.md:12): at least 4 QP points per
encoder, Bjontegaard deltas on (bitrate, Y-PSNR) against the HM 16.20
anchor and against the pruned HM (HM gated by ConvNet2 labels through
./pred/<frame>/ctu<i>.txt, TEncCu.cpp:496-520), plus the encode-time
saving. HM points come from a cache (CORPUS_HM.json,
CORPUS_HM_VARIANTS.json) or from an HM binary run here; the port's
points from its encoder on the caller's device (the card unless the
caller names another).
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

from hevctpu_torch import get_device
from hevctpu_torch.pipeline import clips, metrics

FPS = 30.0
H, W = 240, 416                  # the protocol's frame size
QPS = (22, 27, 32, 37)

# ---------------------------------------------------------------------------
# HM runs
# ---------------------------------------------------------------------------

CFG_TEMPLATE = """\
Profile                       : main
MaxCUWidth                    : 64
MaxCUHeight                   : 64
MaxPartitionDepth             : 4
QuadtreeTULog2MaxSize         : 5
QuadtreeTULog2MinSize         : 2
QuadtreeTUMaxDepthInter       : 3
QuadtreeTUMaxDepthIntra       : 3
IntraPeriod                   : 1
DecodingRefreshType           : 1
GOPSize                       : 1
FastSearch                    : 1
SearchRange                   : 64
HadamardME                    : 1
FEN                           : 1
FDM                           : 1
QP                            : {qp}
RDOQ                          : 1
RDOQTS                        : 1
LoopFilterOffsetInPPS         : 1
LoopFilterDisable             : 0
InternalBitDepth              : 8
SAO                           : 1
AMP                           : 1
TransformSkip                 : 1
TransformSkipFast             : 1
SliceMode                     : 0
SEIDecodedPictureHash         : 1
InputFile                     : {yuv}
InputBitDepth                 : 8
InputChromaFormat             : 420
FrameRate                     : 30
FrameSkip                     : 0
SourceWidth                   : {w}
SourceHeight                  : {h}
FramesToBeEncoded             : {n}
Level                         : 3.1
BitstreamFile                 : {bs}
ReconFile                     : {rec}
"""

# SUMMARY row: "  <frames>  a  <bitrate> <Y> <U> <V> <YUV>"
_SUMMARY = re.compile(r"SUMMARY ---.*?\n.*?\n\s+(\d+)\s+[a-z]\s+([\d.]+)\s+"
                      r"([\d.]+)\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)", re.S)
_TOTAL_TIME = re.compile(r"Total Time:\s+([\d.]+)\s+sec")


def _hm(enc_bin, cfg: str, text: str, workdir, use_pred):
    """Write cfg and run HM on it; (SUMMARY match, stdout). use_pred
    True/False sets/clears HM_USE_PRED (the pred-file gate) for the run,
    None leaves the environment as it is."""
    with open(cfg, "w") as f:
        f.write(text)
    env = dict(os.environ)
    if use_pred is not None:
        env.pop("HM_USE_PRED", None)
        if use_pred:
            env["HM_USE_PRED"] = "1"
    r = subprocess.run([enc_bin, "-c", cfg], capture_output=True, text=True,
                       timeout=3600, cwd=workdir, env=env)
    if r.returncode != 0:
        raise RuntimeError(f"HM exited {r.returncode}: {r.stdout[-2000:]}"
                           f"{r.stderr[-2000:]}")
    m = _SUMMARY.search(r.stdout)
    if not m:
        raise RuntimeError(f"no SUMMARY in HM's output: {r.stdout[-3000:]}")
    return m, r.stdout


def run_hm(enc_bin, yuv, w, h, n, qp, workdir, *, use_pred=None) -> dict:
    """One HM encode of n frames of yuv at qp in workdir: its SUMMARY
    bitrate and PSNRs, Total Time and stream size."""
    cfg = os.path.join(workdir, f"q{qp}.cfg")
    bs = os.path.join(workdir, f"q{qp}.bin")
    rec = os.path.join(workdir, f"q{qp}.yuv")
    m, out = _hm(enc_bin, cfg, CFG_TEMPLATE.format(
        qp=qp, yuv=yuv, w=w, h=h, n=n, bs=bs, rec=rec), workdir, use_pred)
    t = _TOTAL_TIME.search(out)
    if not t:
        raise RuntimeError(f"no Total Time in HM's output: {out[-2000:]}")
    return {
        "qp": qp,
        "frames": int(m.group(1)),
        "bitrate_kbps": float(m.group(2)),
        "psnr_y": float(m.group(3)),
        "psnr_u": float(m.group(4)),
        "psnr_v": float(m.group(5)),
        "time_s": float(t.group(1)),
        "fps": int(m.group(1)) / float(t.group(1)),
        "bytes": os.path.getsize(bs),
    }


def run_hm_variant(enc_bin, yuv, w, h, n, qp, workdir,
                   cfg_overrides) -> dict:
    """run_hm with HM cfg-line overrides (e.g. SAO: 0)."""
    cfg = os.path.join(workdir, f"q{qp}v.cfg")
    bs = os.path.join(workdir, f"q{qp}v.bin")
    rec = os.path.join(workdir, f"q{qp}v.yuv")
    text = CFG_TEMPLATE.format(qp=qp, yuv=yuv, w=w, h=h, n=n, bs=bs, rec=rec)
    for key, val in cfg_overrides.items():
        text = re.sub(rf"(?m)^{key}\s*:.*$", f"{key} : {val}", text)
    m, _ = _hm(enc_bin, cfg, text, workdir, None)
    return {"qp": qp, "bitrate_kbps": float(m.group(2)),
            "psnr_y": float(m.group(3)), "psnr_u": float(m.group(4)),
            "psnr_v": float(m.group(5)), "time_s": 0.0}


def write_pred_files(workdir, labels):
    """The pruned HM's input: ./pred/<frame>/ctu<i>.txt, each a CTU's 16
    depth labels joined by spaces (use_model.py:121-125)."""
    labels = np.asarray(labels)
    for k in range(labels.shape[0]):
        d = os.path.join(workdir, "pred", str(k))
        os.makedirs(d, exist_ok=True)
        for i in range(labels.shape[1]):
            with open(os.path.join(d, f"ctu{i}.txt"), "w") as f:
                f.write(" ".join(str(int(x)) for x in labels[k, i]))


def hm_points(enc_bin, yuv, w, h, n, qps, workdir, labels=None, *,
              log=print) -> list:
    """HM at each QP; labels (None or [n, nCTU, 16]) switches on the
    reference pipeline's pred-file pruning."""
    if labels is not None:
        write_pred_files(workdir, labels)
    pts = []
    for qp in qps:
        p = run_hm(enc_bin, yuv, w, h, n, qp, workdir,
                   use_pred=labels is not None)
        pts.append({k: p[k] for k in ("qp", "bitrate_kbps", "psnr_y",
                                      "psnr_u", "psnr_v", "time_s", "fps")})
        log(f"    [hm{'/pred' if labels is not None else ''}] "
            f"QP {qp}: {p['bitrate_kbps']:9.2f} kbps  Y {p['psnr_y']:7.4f}"
            f"  ({p['time_s']:.1f}s)")
    return pts


# ---------------------------------------------------------------------------
# The port's points
# ---------------------------------------------------------------------------


def load_params(path):
    """ConvNet2 params (JAX layout) from an .npz or a torch .pt checkpoint;
    init_params(0) when the .pt does not exist."""
    from hevctpu_torch.models import checkpoint, convnet2
    if path.endswith(".npz"):
        return checkpoint.load(path)
    if os.path.exists(path):
        return convnet2.load_torch_params(path)
    return convnet2.init_params(0)


def parse_mode(mode: str):
    """Mode spec -> (base, FrameEncoder kwargs). Base "cnn"|"rd" plus
    dash suffixes: -global (per-bin-type rate model), -2p (two_pass
    recon-feedback refinement)."""
    parts = mode.split("-")
    base = parts[0]
    if base not in ("cnn", "rd"):
        raise ValueError(f"unknown mode {mode!r}")
    kw = {"search": base}
    for s in parts[1:]:
        if s == "global":
            kw["rate_model"] = "global"
        elif s == "2p":
            kw["two_pass"] = True
        else:
            raise ValueError(f"unknown mode suffix {s!r} in {mode!r}")
    return base, kw


def get_encoder(encoders: dict, h, w, qp, enc_kw: dict, device):
    """The FrameEncoder of (h, w, qp, options, device) from the caller's
    memo, made on first use."""
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    dev = get_device(device)
    key = (h, w, qp, tuple(sorted(enc_kw.items())), dev)
    if key not in encoders:
        encoders[key] = FrameEncoder(h, w, qp, device=dev, **enc_kw)
    return encoders[key]


def ours_points(y, u, v, qps, mode, params, *, device="cuda", batch=8,
                encoders=None, log=print) -> list:
    """The port's sweep over qps: kbps at 30 fps, PSNR Y/U/V and the wall
    seconds from the first dispatch to the end of encode_stream. The cnn
    modes run encode_fused (ConvNet2 labels and the encode on the
    device), the rd modes encode with the full-RD search; params (JAX
    layout) are the cnn modes' ConvNet2."""
    from hevctpu_torch.codec import decoder as streamlib
    from hevctpu_torch.codec import headers
    from hevctpu_torch.models import convnet2

    h, w = y.shape[-2:]
    n = y.shape[0]
    base, enc_kw = parse_mode(mode)
    encoders = {} if encoders is None else encoders
    dev = get_device(device)
    cnn = convnet2.load_model(params, dev) if base == "cnn" else None
    pts = []
    for qp in qps:
        enc = get_encoder(encoders, h, w, qp, enc_kw, dev)
        cfg = headers.StreamConfig(width=w, height=h, qp=qp)
        t0 = time.perf_counter()
        outs = []
        for i in range(0, n, batch):
            j = min(i + batch, n)
            if base == "cnn":
                outs.append(enc.encode_fused(cnn, y[i:j], u[i:j], v[i:j]))
            else:
                outs.append(enc.encode(y[i:j], u[i:j], v[i:j]))
        stream = streamlib.encode_stream(cfg, outs)
        dt = time.perf_counter() - t0
        ry = np.concatenate([o["recon_y"] for o in outs])
        ru = np.concatenate([o["recon_u"] for o in outs])
        rv = np.concatenate([o["recon_v"] for o in outs])
        kbps = len(stream) * 8 * FPS / n / 1000.0
        pts.append(dict(qp=qp, bitrate_kbps=round(kbps, 2),
                        psnr_y=round(metrics.psnr(y, ry), 4),
                        psnr_u=round(metrics.psnr(u, ru), 4),
                        psnr_v=round(metrics.psnr(v, rv), 4),
                        time_s=round(dt, 3)))
        log(f"    [ours/{mode}] QP {qp}: {kbps:9.2f} kbps  "
            f"Y {pts[-1]['psnr_y']:7.4f}  ({dt:.1f}s)")
    return pts


# ---------------------------------------------------------------------------
# Bjontegaard deltas and the summaries
# ---------------------------------------------------------------------------


def bd(anchor, test):
    """(BD-rate %, BD-PSNR dB) of test's points against anchor's."""
    ra = [p["bitrate_kbps"] for p in anchor]
    pa = [p["psnr_y"] for p in anchor]
    rt = [p["bitrate_kbps"] for p in test]
    pt = [p["psnr_y"] for p in test]
    return (round(metrics.bd_rate(ra, pa, rt, pt), 3),
            round(metrics.bd_psnr(ra, pa, rt, pt), 4))


def time_saving(anchor, test) -> float:
    """Percent of the anchor's summed encode seconds that test saves."""
    at = sum(p["time_s"] for p in anchor)
    return round(100 * (at - sum(p["time_s"] for p in test)) / at, 2)


def hm_summary(entry: dict) -> dict:
    """A clip's HM points and the pruned HM against the anchor."""
    cdoc = {"anchor": entry["anchor"], "pruned_hm": entry["pruned"]}
    bdr, bdp = bd(entry["anchor"], entry["pruned"])
    cdoc["bd_rate_pct_pruned_hm"] = bdr
    cdoc["bd_psnr_db_pruned_hm"] = bdp
    cdoc["time_saving_pct_pruned_hm"] = time_saving(entry["anchor"],
                                                     entry["pruned"])
    return cdoc


def mode_summary(entry: dict, mode: str, pts: list) -> dict:
    """One mode's points of a clip against its anchor and pruned HM."""
    bdr, bdp = bd(entry["anchor"], pts)
    bdr2, bdp2 = bd(entry["pruned"], pts)
    return {f"ours_{mode}": pts,
            f"bd_rate_pct_{mode}": bdr,
            f"bd_psnr_db_{mode}": bdp,
            f"bd_rate_pct_{mode}_vs_pruned_hm": bdr2,
            f"bd_psnr_db_{mode}_vs_pruned_hm": bdp2,
            f"time_saving_pct_{mode}": time_saving(entry["anchor"], pts)}


def corpus_summary(per_clip: dict, names, modes) -> dict:
    """Each BD and time-saving key averaged over the clips that have it."""
    def avg(key):
        vals = [per_clip[n][key] for n in names if key in per_clip[n]]
        return round(float(np.mean(vals)), 3) if vals else None

    keys = ["bd_rate_pct_pruned_hm", "bd_psnr_db_pruned_hm",
            "time_saving_pct_pruned_hm"]
    for mode in modes:
        keys += [f"bd_rate_pct_{mode}", f"bd_psnr_db_{mode}",
                 f"bd_rate_pct_{mode}_vs_pruned_hm",
                 f"bd_psnr_db_{mode}_vs_pruned_hm",
                 f"time_saving_pct_{mode}"]
    return {k: avg(k) for k in keys}


def headline(summary: dict, modes) -> dict:
    """The single-number keys earlier readers of RD_MEASURED.json take."""
    out = {}
    if "cnn" in modes:
        out["bd_rate_pct_cnn_vs_hm_anchor"] = summary["bd_rate_pct_cnn"]
        out["bd_psnr_db_cnn_vs_hm_anchor"] = summary["bd_psnr_db_cnn"]
        out["bd_rate_pct_cnn_vs_pruned_hm"] = \
            summary["bd_rate_pct_cnn_vs_pruned_hm"]
        out["bd_psnr_db_cnn_vs_pruned_hm"] = \
            summary["bd_psnr_db_cnn_vs_pruned_hm"]
    if "rd" in modes:
        out["bd_rate_pct_rd_vs_hm_anchor"] = summary["bd_rate_pct_rd"]
        out["bd_psnr_db_rd_vs_hm_anchor"] = summary["bd_psnr_db_rd"]
    return out


def device_label(device) -> str:
    """What a measurement ran on: nvidia-smi's name and power limit of
    the card (torch's name when nvidia-smi gives none), or "cpu"."""
    dev = get_device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={dev.index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    return smi or torch.cuda.get_device_name(dev)


# ---------------------------------------------------------------------------
# The corpus protocol (tools/measure_corpus_torch.py)
# ---------------------------------------------------------------------------


def hm_cache_key(name: str, frames: int, qps) -> str:
    return f"{name}_{frames}f_{'-'.join(map(str, qps))}"


def _clip_hm(enc_bin, y, u, v, n, qps, labels=None, *, log):
    h, w = y.shape[-2:]
    with tempfile.TemporaryDirectory() as td:
        yuv = os.path.join(td, "in.yuv")
        clips.write_yuv(yuv, y, u, v)
        return hm_points(enc_bin, yuv, w, h, n, qps, td, labels, log=log)


def corpus_rd(names, modes, qps, frames, params, cache: dict, *,
              device="cuda", hm=None, skip_hm=False, ref_params=None,
              save_cache=None, log=print) -> dict:
    """The corpus protocol at 416x240: for each clip the HM anchor and
    pruned-HM points (cached in cache, HM run only for a missing entry,
    then save_cache() is called), the port's points in each mode, and
    the deltas; per clip and averaged. ref_params (JAX layout) label the
    pruned HM's input; params drive the cnn modes."""
    per_clip = {}
    encoders = {}                  # one FrameEncoder per (qp, mode)
    for name in names:
        log(f"== clip {name} ==")
        y, u, v = clips.make_clip(name, frames, H, W)
        ck = hm_cache_key(name, frames, qps)
        entry = cache.get(ck)
        if entry is None or (not skip_hm and entry.get("stale")):
            entry = {}
        ran = False
        if "anchor" not in entry:
            if skip_hm:
                raise RuntimeError(f"no cached HM for {ck}")
            entry["anchor"] = _clip_hm(hm, y, u, v, frames, qps, log=log)
            ran = True
        if "pruned" not in entry:
            if skip_hm:
                raise RuntimeError(f"no cached pruned-HM for {ck}")
            labels = clip_labels(ref_params, y, u, v, device)
            entry["pruned"] = _clip_hm(hm, y, u, v, frames, qps, labels,
                                       log=log)
            ran = True
        if ran:
            cache[ck] = entry
            if save_cache is not None:
                save_cache()

        cdoc = hm_summary(entry)
        for mode in modes:
            pts = ours_points(y, u, v, qps, mode,
                              params if mode.startswith("cnn") else None,
                              device=device, encoders=encoders, log=log)
            ms = mode_summary(entry, mode, pts)
            cdoc.update(ms)
            log(f"  [{name}/{mode}] BD-rate vs anchor "
                f"{ms[f'bd_rate_pct_{mode}']:+.2f}%  BD-PSNR "
                f"{ms[f'bd_psnr_db_{mode}']:+.3f} dB | vs pruned-HM "
                f"{ms[f'bd_rate_pct_{mode}_vs_pruned_hm']:+.2f}% "
                f"{ms[f'bd_psnr_db_{mode}_vs_pruned_hm']:+.3f} dB")
        per_clip[name] = cdoc

    summary = corpus_summary(per_clip, names, modes)
    return {"per_clip": per_clip, "average": summary,
            **headline(summary, modes)}


def clip_labels(params, y, u, v, device="cuda") -> np.ndarray:
    """ConvNet2 depth labels [n, nCTU, 16] of a clip, computed on device."""
    from hevctpu_torch.models import convnet2
    dev = get_device(device)
    model = convnet2.load_model(params, dev)
    h, w = y.shape[-2:]
    planes = [torch.as_tensor(np.asarray(p, np.int32)).to(dev)
              for p in (y, u, v)]
    return convnet2.predict_frame_labels(model, *planes, h, w).cpu().numpy()


# ---------------------------------------------------------------------------
# bench.py's clip (tools/measure_rd_torch.py)
# ---------------------------------------------------------------------------


def rd_sweep(y, u, v, modes, params, anchors: dict, *, device="cuda",
             qps=QPS, log=print) -> dict:
    """measure_rd's sweep: each search mode at each QP with the clip's
    ConvNet2 labels, kbps and PSNRs, then the deltas against each anchor
    curve of anchors ({tag: points})."""
    from hevctpu_torch.codec import decoder as streamlib
    from hevctpu_torch.codec import headers
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    n = y.shape[0]
    h, w = y.shape[-2:]
    labels = clip_labels(params, y, u, v, device)
    result = {}
    for search in modes:
        points = []
        for qp in qps:
            enc = FrameEncoder(h, w, qp, search=search, device=device)
            out = enc.encode(y, u, v, labels)
            cfg = headers.StreamConfig(width=w, height=h, qp=qp)
            t0 = time.perf_counter()
            stream = streamlib.encode_stream(cfg, [out])
            dt = time.perf_counter() - t0
            py = metrics.psnr(y, out["recon_y"])
            pu = metrics.psnr(u, out["recon_u"])
            pv = metrics.psnr(v, out["recon_v"])
            kbps = len(stream) * 8 * FPS / n / 1000.0
            points.append(dict(qp=qp, bitrate_kbps=round(kbps, 2),
                               psnr_y=round(py, 4), psnr_u=round(pu, 4),
                               psnr_v=round(pv, 4)))
            log(f"[{search}] QP {qp}: {kbps:9.2f} kbps  Y {py:7.4f}  "
                f"U {pu:7.4f} V {pv:7.4f}  (entropy {dt:.2f}s)")
        result[f"rd_test_{search}"] = points
        if search == "cnn":
            result["rd_test"] = points
        for tag, anchor in anchors.items():
            bdr, bdp = bd(anchor, points)
            result[f"bd_rate_pct_{search}_vs_{tag}"] = bdr
            result[f"bd_psnr_db_{search}_vs_{tag}"] = bdp
            log(f"[{search}] BD-rate vs {tag}: {bdr:+.2f}%   "
                f"BD-PSNR: {bdp:+.3f} dB")
    if "bd_rate_pct_cnn_vs_hm_anchor" in result:
        result["bd_rate_pct_vs_hm_anchor"] = \
            result["bd_rate_pct_cnn_vs_hm_anchor"]
        result["bd_psnr_db_vs_hm_anchor"] = \
            result["bd_psnr_db_cnn_vs_hm_anchor"]
    return result


# ---------------------------------------------------------------------------
# RD-gap attribution (tools/attribute_gap_torch.py)
# ---------------------------------------------------------------------------

# variant: (our FrameEncoder options over search="rd", HM cfg overrides)
VARIANTS = {
    "base": (dict(), dict()),
    "2pass": (dict(two_pass=True), dict()),
    "nolf": (dict(sao=False, deblock=False),
             {"SAO": 0, "LoopFilterDisable": 1}),
    "hdq": (dict(rdoq=False, sbh=False),
            {"RDOQ": 0, "RDOQTS": 0, "SignHideFlag": 0}),
}


def variant_points(y, u, v, qps, vname, *, device="cuda", label="",
                   log=print) -> list:
    """A variant's full-RD encode at each QP: kbps and PSNR-Y, its stream
    signalling the variant's switched-off tools."""
    from hevctpu_torch.codec import decoder as streamlib
    from hevctpu_torch.codec import headers
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    n = y.shape[0]
    h, w = y.shape[-2:]
    enc_kw = VARIANTS[vname][0]
    sc_kw = {}
    if not enc_kw.get("sao", True):
        sc_kw = dict(sao=False, deblock=False)
    if vname == "hdq":
        sc_kw = dict(sign_data_hiding=False)
    pts = []
    for qp in qps:
        enc = FrameEncoder(h, w, qp, search="rd", device=device, **enc_kw)
        cfg = headers.StreamConfig(width=w, height=h, qp=qp, **sc_kw)
        out = enc.encode(y, u, v)
        stream = streamlib.encode_stream(cfg, [out])
        kbps = len(stream) * 8 * FPS / n / 1000.0
        pts.append(dict(qp=qp, bitrate_kbps=round(kbps, 2),
                        psnr_y=round(metrics.psnr(y, out["recon_y"]), 4)))
        log(f"[{label}/{vname}] QP {qp}: {kbps:9.2f} kbps "
            f"Y {pts[-1]['psnr_y']:.4f}")
    return pts


def attribute_gap(names, variants, qps, frames, cache: dict, *,
                  device="cuda", hm=None, skip_hm=False, save_cache=None,
                  save=None, log=print) -> dict:
    """Each variant's BD at 416x240 against its matching HM variant
    (cache keyed "<clip>_<frames>f_<variant>", HM run only for a missing
    entry, then save_cache()); save(result) after every variant, so a
    long run that is cut keeps what it measured."""
    result = {"protocol": {"clips": ",".join(names), "frames": frames,
                           "qps": list(qps)}}
    for name in names:
        y, u, v = clips.make_clip(name, frames, H, W)
        cdoc = {}
        for vname in variants:
            hk = f"{name}_{frames}f_{vname}"
            if hk not in cache:
                if skip_hm:
                    raise RuntimeError(f"no cached HM for {hk}")
                with tempfile.TemporaryDirectory() as td:
                    yuv = os.path.join(td, "in.yuv")
                    clips.write_yuv(yuv, y, u, v)
                    cache[hk] = [run_hm_variant(hm, yuv, W, H, frames, qp,
                                                td, VARIANTS[vname][1])
                                 for qp in qps]
                if save_cache is not None:
                    save_cache()
            pts = variant_points(y, u, v, qps, vname, device=device,
                                 label=name, log=log)
            bdr, bdp = bd(cache[hk], pts)
            cdoc[vname] = {"points": pts, "bd_rate_pct": bdr,
                           "bd_psnr_db": bdp}
            log(f"[{name}/{vname}] BD-rate {bdr:+.2f}%  "
                f"BD-PSNR {bdp:+.3f} dB")
            result[name] = cdoc
            if save is not None:
                save(result)
    return result


# ---------------------------------------------------------------------------
# Per-syntax-element bits (tools/bit_stats_torch.py)
# ---------------------------------------------------------------------------


def frame_bit_stats(cfg, frame: dict, i: int = 0) -> dict:
    """{syntax-element name: estimated bits} for one frame's slice data
    (the TComCodingStatistics role): the golden slice coder over a
    counting CABAC whose per-bin fractional costs go to the bin's
    context name. Bypass bins go to the latest context's scope with an
    "(ep)" suffix (remainder and sign bins follow their residual
    contexts, the MPM index follows prev_intra_luma_pred), terminate
    bins to end_of_slice/subset."""
    from hevctpu_torch.codec import headers
    from hevctpu_torch.codec.cabac import CabacCounter, ContextSet
    from hevctpu_torch.codec.syntax import SliceEncoder

    bits = collections.defaultdict(float)

    class AttributingCounter(CabacCounter):
        def __init__(self, rev):
            super().__init__()
            self.rev = rev
            self.scope = "other"

        def encode_bin(self, ctx, b):
            before = self.bits
            super().encode_bin(ctx, b)
            self.scope = self.rev[id(ctx)]
            bits[self.scope] += self.bits - before

        def encode_bypass(self, b):
            super().encode_bypass(b)
            bits[self.scope + "(ep)"] += 1.0

        def encode_bypass_bins(self, value, n):
            super().encode_bypass_bins(value, n)
            bits[self.scope + "(ep)"] += n

        def encode_terminate(self, b):
            before = self.bits
            super().encode_terminate(b)
            bits["end_of_slice/subset"] += self.bits - before

    class CountingSliceEncoder(SliceEncoder):
        def encode(self):
            bw = headers.write_slice_header(self.cfg)
            bits["slice_header"] += len(bw.data()) * 8
            self.ctx = ContextSet(self.cfg.qp, init_type=0)
            rev = {id(m): name for name, models in self.ctx._ctx.items()
                   for m in models}
            self.c = AttributingCounter(rev)
            n_ctu = self.rc * self.cc
            self._qp_pred = self.cfg.qp
            for a in range(n_ctu):
                r, c = divmod(a, self.cc)
                self._code_ctu(r, c)
                self.c.encode_terminate(1 if a == n_ctu - 1 else 0)
            return b""

    CountingSliceEncoder(cfg, frame, i).encode()
    return dict(bits)


def clip_bit_stats(clip: str, frames: int, qp: int, h: int, w: int, *,
                   device="cuda"):
    """bit_stats' run: a full-RD encode of a corpus clip, the syntax
    elements' bits summed over its frames, and the real stream's bits."""
    from hevctpu_torch.codec import decoder as streamlib
    from hevctpu_torch.codec import headers
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    y, u, v = clips.make_clip(clip, frames, h, w)
    out = FrameEncoder(h, w, qp, search="rd", device=device).encode(y, u, v)
    cfg = headers.StreamConfig(width=w, height=h, qp=qp)
    total = collections.defaultdict(float)
    for i in range(frames):
        for k, b in frame_bit_stats(cfg, out, i).items():
            total[k] += b
    return dict(total), len(streamlib.encode_stream(cfg, [out])) * 8


def bit_stats_table(total: dict, real_bits: int) -> str:
    """bit_stats' report: elements by bits, their share, the counted
    total against the real stream."""
    est = sum(total.values())
    width = max(len(k) for k in total)
    lines = [f"{'syntax element':<{width}}  {'bits':>12}  share"]
    for k, b in sorted(total.items(), key=lambda kv: -kv[1]):
        lines.append(f"{k:<{width}}  {b:12.1f}  {100 * b / est:5.2f}%")
    lines.append(f"{'TOTAL (counted)':<{width}}  {est:12.1f}")
    lines.append(f"{'stream (real, incl. headers/SEI/EP)':<{width}}  "
                 f"{real_bits:12d}  ({100 * est / real_bits:.2f}% accounted)")
    return "\n".join(lines)
