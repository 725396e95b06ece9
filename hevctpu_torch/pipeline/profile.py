"""Per-stage wall time and roofline of the encode pipeline on one device
(port of the logic of tools/profile_stages.py; the command line is
tools/profile_stages_torch.py).

The reference's only timing is a whole-run clock() diff plus per-picture
dEncTime (encmain.cpp:103-114, TEncGOP.cpp:1942). This times each stage
of the port's encode after one warm call, as the mean of reps calls
ending in a device synchronize, and sets the analytic operation counts
of the SATD and transform work against the card's peaks.

Stages (the JAX tool's keys): cnn (ConvNet2 labels, the batch in one
forward), stage1_luma (dense luma mode decision), stage1_chroma,
tu_tree (the TU quadtree RD at each CU size), decide_all (all of stage
1), stage2_wavefront (the reconstruction), device_full (the whole
device encode), filters_derived (device_full less decide_all and
stage2_wavefront), entropy_host (host CABAC), fused_total
(encode_fused: labels, encode and the transfer to the host).
"""

from __future__ import annotations

import time

import torch

from hevctpu_torch import get_device

# NVIDIA H100 SXM5 (data sheet; dense, without sparsity, at the 700 W
# limit): BF16 tensor-core peak and HBM3 bandwidth.
PEAK_BF16_TFLOPS = 989.0
PEAK_HBM_GBS = 3350.0


def transform_flops(h, w):
    """MACs of one frame's stage-2 transforms (forward and inverse, luma
    and chroma) at the representative 8x8 TU: every pel transformed once
    each way, 2·N MACs a pel a pass of an NxN separable transform."""
    n_rep = 8  # representative TU size
    luma = h * w * 2 * n_rep * 2
    chroma = 2 * (h // 2) * (w // 2) * 2 * (n_rep // 2) * 2
    return luma + chroma  # MACs; FLOPs = 2*MACs


def satd_flops(h, w):
    """MACs of stage 1's SATD: 35 modes x all positions at n in {4, 8,
    16, 32}; each Hadamard 2·min(n, 8) MACs a pel a pass, 2 passes."""
    total = 0
    for n in (4, 8, 16, 32):
        total += 35 * h * w * 2 * min(n, 8) * 2   # 8x8 HAD blocks cap
    return total


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn, dev, reps=5) -> float:
    """Mean seconds of fn over reps calls after one warm call, the last
    call's work finished on the device."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps


def profile_stages(params, *, frames=8, qp=32, device="cuda", reps=5,
                   full_reps=3, h=240, w=416) -> dict:
    """Time every stage on frames of the pink corpus clip at qp (reps calls a
    stage; full_reps for device_full, entropy_host and fused_total);
    params (JAX layout) are ConvNet2's. The stage-1 pieces run with the
    encoder's rate model, as _decide runs them (the JAX tool calls them
    with their own default, "ctx"). Returns the report dict; the
    roofline shares are computed on a card only."""
    from hevctpu_torch.codec import decoder as streamlib
    from hevctpu_torch.codec import headers
    from hevctpu_torch.models import convnet2
    from hevctpu_torch.pipeline import clips
    from hevctpu_torch.pipeline import encoder as enc_mod
    from hevctpu_torch.pipeline.evaluate import device_label

    dev = get_device(device)
    b = frames
    y, u, v = clips.clip_pink(b, h, w)
    cnn = convnet2.load_model(params, dev)
    enc = enc_mod.FrameEncoder(h, w, qp, device=dev)
    cfg = headers.StreamConfig(width=w, height=h, qp=qp)
    g = enc.geom

    yj, uj, vj = enc._to_device(y, u, v)
    yi, ui, vi = (p.to(torch.int32) for p in (yj, uj, vj))

    def pads():
        return (enc_mod.pad_plane(yi, g.hp, g.wp),
                enc_mod.pad_plane(ui, g.hp // 2, g.wp // 2),
                enc_mod.pad_plane(vi, g.hp // 2, g.wp // 2))

    yp, up, vp = pads()
    stages = {}

    stages["cnn"] = timeit(lambda: convnet2.predict_frame_labels(
        cnn, yi, ui, vi, h, w), dev, reps)

    rm = enc.rate_model

    def luma():
        return enc_mod._dense_mode_decision(yp, g, qp, rate_model=rm)

    stages["stage1_luma"] = timeit(luma, dev, reps)
    modes = luma()[0]
    stages["stage1_chroma"] = timeit(
        lambda: enc_mod._dense_chroma_decision(up, vp, g, qp, enc.qp_c,
                                               modes, rate_model=rm),
        dev, reps)
    stages["tu_tree"] = timeit(
        lambda: [enc_mod._tu_tree_decision(yp, g, qp, cl, modes[n],
                                           rate_model=rm)[0]
                 for n, cl in ((64, 6), (32, 5), (16, 4), (8, 3))],
        dev, reps)

    lab = convnet2.predict_frame_labels(cnn, yi, ui, vi, h, w).to(
        torch.int32)

    def decide():
        return enc._decide(*pads(), lab)

    stages["decide_all"] = timeit(decide, dev, reps)
    d = decide()
    stages["stage2_wavefront"] = timeit(lambda: enc._reconstruct(
        yp, up, vp, d["mode_slot"], d["cmode_slot"],
        enc_mod.to_blocked(d["tusz_frame"], 8), d["coded8"],
        enc_mod.to_blocked(d["mode4_frame"], 16)), dev, reps)

    stages["device_full"] = timeit(
        lambda: enc._encode_impl(yj, uj, vj, lab,
                                 clock=enc_mod._StageClock(dev)),
        dev, full_reps)
    stages["filters_derived"] = max(
        0.0, stages["device_full"]
        - stages["decide_all"] - stages["stage2_wavefront"])

    out = enc.encode(y, u, v, lab.cpu().numpy())
    t0 = time.perf_counter()
    for _ in range(full_reps):
        stream = streamlib.encode_stream(cfg, [out])
    stages["entropy_host"] = (time.perf_counter() - t0) / full_reps

    stages["fused_total"] = timeit(lambda: enc.encode_fused(cnn, y, u, v),
                                   dev, full_reps)

    tf_fl = 2 * transform_flops(h, w) * b
    sa_fl = 2 * satd_flops(h, w) * b
    on_card = dev.type == "cuda"
    roof = {
        "satd_stage": {
            "flops": sa_fl,
            "achieved_tflops": (sa_fl / stages["stage1_luma"] / 1e12
                                if on_card else None),
            "mfu_pct_bf16": (
                100 * sa_fl / stages["stage1_luma"] / 1e12
                / PEAK_BF16_TFLOPS if on_card else None),
        },
        "transforms_in_stage2": {
            "flops": tf_fl,
            "achieved_tflops": (tf_fl / stages["stage2_wavefront"] / 1e12
                                if on_card else None),
        },
        "wavefront_steps": 2 * (g.rc - 1) + g.cc,
        "entropy_bytes_per_s": len(stream) / stages["entropy_host"],
        "peaks": {"bf16_tflops": PEAK_BF16_TFLOPS, "hbm_gbs": PEAK_HBM_GBS,
                  "of": "NVIDIA H100 SXM5 data sheet, dense, 700 W"},
    }
    return {
        "shape": {"h": h, "w": w, "frames": b, "qp": qp,
                  "clip": "clips.pink"},
        "backend": dev.type,
        "device": device_label(dev),
        "reps": {"stages": reps, "device_full_entropy_fused": full_reps},
        "stage_ms": {k: round(s * 1e3, 2) for k, s in stages.items()},
        # filters_derived is 0 where the nested stages' noise exceeds it
        "stage_fps": {k: round(b / s, 2) if s > 0 else None
                      for k, s in stages.items()},
        "roofline": roof,
    }


def profile_markdown(doc: dict) -> str:
    """PROFILE_TORCH.md: the stage table and the roofline lines."""
    sh = doc["shape"]
    roof = doc["roofline"]
    params = doc.get("cnn_params", "the caller's params")
    lines = [
        "# PROFILE_TORCH — per-stage timing and roofline (one device)",
        "",
        f"Shape: {sh['frames']}x{sh['h']}x{sh['w']} QP {sh['qp']} "
        f"({sh['clip']}), device {doc['device']}; mean of "
        f"{doc['reps']['stages']} calls a stage after one warm call "
        f"({doc['reps']['device_full_entropy_fused']} for device_full, "
        "entropy_host and fused_total), each run ending in a device "
        f"synchronize. ConvNet2: {params}. "
        "fps = frames / stage time; the stages nest "
        "(decide_all holds stage1_*, device_full holds decide_all and "
        "stage2), so they do not sum.",
        "",
        "| stage | ms/batch | fps |",
        "|---|---|---|",
    ]
    for k, ms in doc["stage_ms"].items():
        lines.append(f"| {k} | {ms} | {doc['stage_fps'][k]} |")
    sa = roof["satd_stage"]
    tr = roof["transforms_in_stage2"]
    pk = roof["peaks"]
    lines += ["", "## Roofline", ""]
    if sa["achieved_tflops"] is None:
        lines.append(f"* Stage-1 SATD ~{sa['flops'] / 1e9:.1f} GFLOP and "
                     f"stage-2 transforms ~{tr['flops'] / 1e9:.1f} GFLOP "
                     "per batch; shares of the card's peak: not measured "
                     f"(a {doc['backend']} run).")
    else:
        lines += [
            f"* **Stage-1 SATD** ~{sa['flops'] / 1e9:.1f} GFLOP per batch "
            f"-> {sa['achieved_tflops']:.4f} TFLOP/s over stage1_luma = "
            f"{sa['mfu_pct_bf16']:.4f}% of the BF16 dense peak "
            f"({pk['bf16_tflops']:.0f} TFLOP/s). K1 computes the SATD in "
            "INT32 on the CUDA cores; the stage is its launches and the "
            "candidate RD around them.",
            f"* **Stage-2 wavefront** runs {roof['wavefront_steps']} "
            "diagonals in order, each 424 masked TU steps (on the card "
            "replayed from CUDA graphs; on the CPU only the steps its "
            "CTUs fire): "
            f"{tr['achieved_tflops'] * 1e3:.4f} GFLOP/s on the transform "
            "math: far from any FLOP or byte bound; the time is the "
            "steps' small kernels (the device's idle share is not "
            "measured here).",
        ]
    lines += [
        f"* **Host entropy** serializes at "
        f"{roof['entropy_bytes_per_s'] / 1e6:.3f} MB/s (native C++ CABAC).",
        "",
        f"Peaks: {pk['of']}: {pk['bf16_tflops']:.0f} BF16 TFLOP/s, "
        f"{pk['hbm_gbs']:.0f} GB/s HBM3.",
    ]
    return "\n".join(lines) + "\n"
