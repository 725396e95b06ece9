"""Command-line interface: encode / decode / bdrate / genlabels / train /
bytecount (port of hevctpu/cli.py).

The reference's app shell (TAppEncoder encmain.cpp + TAppEncCfg +
gen_frames/use_model orchestration, and TAppDecoder), with the CNN depth
prediction run on the encoder's device instead of the reference's
ffmpeg-JPEG + txt-file handshake.

  python -m hevctpu_torch encode -c configs/encoder_intra_main.cfg \\
      -c configs/sequence_example.cfg --model CKPT_DOMAIN.npz
  python -m hevctpu_torch encode -i in.yuv --width 416 --height 240 -f 6 \\
      -q 32 -b out.bin [--recon rec.yuv] [--search rd] [--device cpu]
  python -m hevctpu_torch decode -b out.bin -o dec.yuv
  python -m hevctpu_torch bdrate anchor.csv test.csv
  python -m hevctpu_torch train -i in.yuv --width 416 --height 240 -f 4 \\
      --epochs 3 [--init CKPT_DOMAIN.npz] -o convnet2.npz

Encoding, label generation and training run on the card (--device cuda,
the default) and raise without CUDA; --device cpu runs the plain PyTorch
path.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without CUDA; cpu runs the plain PyTorch path)")


def _add_encode(sub):
    p = sub.add_parser("encode", help="All-Intra encode a YUV420 8-bit file")
    p.add_argument("-c", "--cfg", action="append", default=[],
                   help="HM-grammar cfg file; repeatable, later files "
                        "override earlier (codec cfg + sequence cfg, like "
                        "the reference's two-file setup); CLI flags "
                        "override last")
    p.add_argument("-i", "--input")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("-f", "--frames", type=int)
    p.add_argument("-q", "--qp", type=int)
    p.add_argument("-b", "--bitstream")
    p.add_argument("--recon", help="write reconstruction YUV")
    p.add_argument("--fps", type=float)
    p.add_argument("--model",
                   help="ConvNet2 checkpoint (.pt or .npz) for CU-depth "
                        "pruning")
    p.add_argument("--fixed-depth", type=int, choices=[0, 1, 2, 3],
                   help="bypass the CNN, use a fixed CU depth")
    p.add_argument("--batch", type=int,
                   help="frames encoded per device step")
    p.add_argument("--search", choices=["cnn", "rd"],
                   help="partition source: CNN-pruned (reference pipeline) "
                        "or full RD quadtree search (unpruned anchor)")
    p.add_argument("--no-rdoq", action="store_true")
    p.add_argument("--no-sao", action="store_true")
    p.add_argument("--no-deblock", action="store_true")
    p.add_argument("--target-kbps", type=float,
                   help="enable R-λ rate control at this bitrate "
                        "(overrides -q per picture)")
    p.add_argument("--adaptive-qp", action="store_true",
                   help="apply the preanalysis frame-level QP offset "
                        "(height and width must be multiples of 64)")
    p.add_argument("--hash", choices=["md5", "crc", "checksum", "none"],
                   help="decoded-picture-hash SEI type (default md5)")
    _add_device(p)


def _add_decode(sub):
    p = sub.add_parser("decode", help="decode an Annex-B stream to YUV")
    p.add_argument("-b", "--bitstream", required=True)
    p.add_argument("-o", "--output", required=True)


def _add_bdrate(sub):
    p = sub.add_parser("bdrate", help="BD-rate/BD-PSNR from two csv files "
                       "with lines: bitrate_kbps,psnr_db")
    p.add_argument("anchor")
    p.add_argument("test")


def _add_genlabels(sub):
    p = sub.add_parser("genlabels", help="dump CU-depth training labels from "
                       "the full-RD search (the DEBUG_CTU_DEPTH flow)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("-f", "--frames", type=int, default=0)
    p.add_argument("-q", "--qp", type=int, default=32)
    p.add_argument("-o", "--output", default="PartitionInfo.txt")
    _add_device(p)


def _add_train(sub):
    p = sub.add_parser("train", help="train ConvNet2 on RD-search labels "
                       "from a YUV clip")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("-f", "--frames", type=int, default=0)
    p.add_argument("-q", "--qp", type=int, default=32)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--init", help="checkpoint to fine-tune from "
                   "(.npz or torch .pt)")
    p.add_argument("-o", "--output", default="convnet2.npz")
    _add_device(p)


def _add_bytecount(sub):
    p = sub.add_parser("bytecount", help="audit NAL unit sizes of an "
                       "Annex-B stream (annexBbytecount)")
    p.add_argument("bitstream")


def _cnn_labels(ec, y, u, v, h: int, w: int, device):
    """ConvNet2 labels [N, nCTU, 16] of every frame, one frame per forward
    pass on `device`."""
    import torch

    from hevctpu_torch.models import checkpoint, convnet2

    if ec.model.endswith(".npz"):
        params = checkpoint.load(ec.model)
    else:
        params = convnet2.load_torch_params(ec.model)
    model = convnet2.load_model(params, device)

    def plane(p):
        return torch.as_tensor(p.astype(np.int32)).to(device)

    return np.stack([
        convnet2.predict_frame_labels(model, plane(y[i]), plane(u[i]),
                                      plane(v[i]), h, w).cpu().numpy()
        for i in range(y.shape[0])]).astype(np.int32)


def cmd_encode(args) -> int:
    from hevctpu_torch import config as cfgmod
    from hevctpu_torch import get_device
    from hevctpu_torch.codec import decoder as streamlib
    from hevctpu_torch.pipeline import extract, metrics, yuv
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    device = get_device(args.device)
    # Layered config: -c files in order, explicit CLI flags last
    # (program_options_lite precedence, program_options_lite.cpp:551).
    try:
        ec = cfgmod.load(
            args.cfg,
            input_file=args.input, source_width=args.width,
            source_height=args.height, frames_to_be_encoded=args.frames,
            frame_rate=args.fps, qp=args.qp, bitstream_file=args.bitstream,
            recon_file=args.recon, model=args.model,
            fixed_depth=args.fixed_depth, batch=args.batch,
            search=args.search, target_kbps=args.target_kbps,
            adaptive_qp=args.adaptive_qp or None,
            rdoq=False if args.no_rdoq else None,
            sao=False if args.no_sao else None,
            deblock=False if args.no_deblock else None,
            hash_type=args.hash)
    except cfgmod.ConfigError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    if not (ec.input_file and ec.source_width and ec.source_height):
        print("need -c cfg or -i/--width/--height", file=sys.stderr)
        return 2
    if not ec.bitstream_file:
        print("need -b or BitstreamFile in cfg", file=sys.stderr)
        return 2
    seq = yuv.Sequence(ec.input_file, ec.source_width, ec.source_height,
                       ec.frame_rate, ec.frames_to_be_encoded)

    y, u, v = extract.load_clip(seq.path, seq.width, seq.height, seq.frames)
    n = y.shape[0]
    print(f"hevctpu_torch encode: {seq.path} {seq.width}x{seq.height} "
          f"{n} frames QP {ec.qp} search={ec.search} device={device}")

    t0 = time.time()
    rc, cc = -(-seq.height // 64), -(-seq.width // 64)
    if ec.search == "rd":
        labels = None
        t_cnn = 0.0
    elif ec.fixed_depth is not None:
        labels = np.full((n, rc * cc, 16), ec.fixed_depth, np.int32)
        t_cnn = 0.0
    else:
        labels = _cnn_labels(ec, y, u, v, seq.height, seq.width, device)
        t_cnn = time.time() - t0

    encoders: dict[int, FrameEncoder] = {}
    stage_ms: dict[str, float] = {}

    def get_enc(qp: int) -> FrameEncoder:
        if qp not in encoders:
            encoders[qp] = ec.make_encoder(qp, device=device)
        return encoders[qp]

    ratec = None
    if ec.target_kbps:
        from hevctpu_torch.pipeline.ratectrl import RateController
        ratec = RateController(ec.target_kbps * 1000.0, seq.fps,
                               seq.width, seq.height, n, device=device)

    frames_out = []
    chunks = [] if ratec is not None else None
    # rate control / adaptive QP choose a QP per picture -> batch size 1;
    # constant-QP runs batch for throughput.
    bsz = 1 if (ratec or ec.adaptive_qp) else max(ec.batch, 1)
    for i in range(0, n, bsz):
        j = min(i + bsz, n)
        qp = ec.qp
        qp_map = None
        if ratec is not None:
            qp, _ = ratec.start_picture(ratec.complexity(y[i]))
            if ec.lcu_rc:
                # LCU-level allocation (cu_qp_delta): per-CTU QPs from the
                # picture budget's SATD shares (TEncRateCtrl.cpp:845)
                qp_map = ratec.lcu_qp_map(y[i])[None]
        elif ec.adaptive_qp:
            from hevctpu_torch.pipeline.preanalysis import frame_qp_offset
            qp = int(np.clip(ec.qp + frame_qp_offset(y[i], device=device),
                             0, 51))
        enc = get_enc(qp)
        out = enc.encode(y[i:j], u[i:j], v[i:j],
                         labels[i:j] if labels is not None else None,
                         qp_map=qp_map)
        for k, ms in enc.stage_ms().items():
            stage_ms[k] = stage_ms.get(k, 0.0) + ms
        out["qp"] = qp
        if ratec is not None:
            # entropy-encode the picture's NALs once: feed the size to the
            # rate controller and reuse the bytes for the final stream.
            chunk = streamlib.encode_frame_nals(ec.to_stream_config(qp), out)
            ratec.update(len(chunk) * 8)
            chunks.append(chunk)
        frames_out.append(out)
    t_enc = time.time() - t0

    cfg = ec.to_stream_config()
    if chunks is not None:
        stream = streamlib.parameter_set_nals(cfg) + b"".join(chunks)
    else:
        stream = streamlib.encode_stream(cfg, frames_out)
    with open(ec.bitstream_file, "wb") as f:
        f.write(stream)
    t_total = time.time() - t0

    # per-frame log + summary, reference-style (TEncGOP.cpp:2268)
    tot_bits = len(stream) * 8
    psnrs = []
    k = 0
    ry_all, ru_all, rv_all = [], [], []
    for fr in frames_out:
        for b in range(fr["recon_y"].shape[0]):
            py, pu, pv = metrics.frame_psnrs(
                y[k], u[k], v[k], fr["recon_y"][b], fr["recon_u"][b],
                fr["recon_v"][b])
            print(f"POC {k:4d} ( I-SLICE, QP {fr.get('qp', ec.qp)} ) "
                  f"[Y {py:7.4f} dB  U {pu:7.4f} dB  V {pv:7.4f} dB]")
            psnrs.append((py, pu, pv))
            ry_all.append(fr["recon_y"][b])
            ru_all.append(fr["recon_u"][b])
            rv_all.append(fr["recon_v"][b])
            k += 1
    avg = np.mean(psnrs, axis=0)
    print(metrics.summary_line(n, tot_bits, seq.fps, *avg))
    print(f"Bytes written to file: {len(stream)}")
    print(f"Total Time: {t_total:9.3f} sec. "
          f"(CNN {t_cnn:.3f}s, encode {t_enc - t_cnn:.3f}s, "
          f"entropy {t_total - t_enc:.3f}s)")
    print("Stage ms: " + " | ".join(f"{k} {ms:.3f}"
                                    for k, ms in stage_ms.items()))

    if ec.recon_file:
        yuv.write_yuv420(ec.recon_file, np.stack(ry_all), np.stack(ru_all),
                         np.stack(rv_all))
    return 0


def cmd_decode(args) -> int:
    from hevctpu_torch.codec.decoder import Decoder
    from hevctpu_torch.pipeline import yuv

    with open(args.bitstream, "rb") as f:
        stream = f.read()
    t0 = time.time()
    frames = Decoder().decode(stream)
    ys = np.stack([f[0] for f in frames])
    us = np.stack([f[1] for f in frames])
    vs = np.stack([f[2] for f in frames])
    yuv.write_yuv420(args.output, ys, us, vs)
    print(f"decoded {len(frames)} frames -> {args.output} "
          f"({time.time() - t0:.3f}s)")
    return 0


def cmd_bdrate(args) -> int:
    from hevctpu_torch.pipeline import metrics

    def load(path):
        rows = [line.split(",") for line in open(path)
                if line.strip() and not line.startswith("#")]
        return ([float(r[0]) for r in rows], [float(r[1]) for r in rows])

    ra, pa = load(args.anchor)
    rt, pt = load(args.test)
    print(f"BD-rate: {metrics.bd_rate(ra, pa, rt, pt):+.3f} %")
    print(f"BD-PSNR: {metrics.bd_psnr(ra, pa, rt, pt):+.3f} dB")
    return 0


def cmd_genlabels(args) -> int:
    from hevctpu_torch import get_device
    from hevctpu_torch.pipeline import extract, labels

    device = get_device(args.device)
    y, u, v = extract.load_clip(args.input, args.width, args.height,
                                args.frames)
    lab = labels.rd_ground_truth(y, u, v, args.qp, device=device)
    labels.write_partition_info(args.output, lab, append=False)
    print(f"wrote {lab.shape[0] * lab.shape[1]} CTU label lines "
          f"-> {args.output}")
    return 0


def cmd_train(args) -> int:
    import torch

    from hevctpu_torch import get_device
    from hevctpu_torch.models import checkpoint, convnet2, train
    from hevctpu_torch.pipeline import extract, labels

    device = get_device(args.device)
    init = None
    if args.init:
        if args.init.endswith(".pt"):
            init = convnet2.load_torch_params(args.init)
        elif args.init.endswith(".npz"):
            init = checkpoint.load(args.init)
        else:
            print(f"--init {args.init}: the port reads .npz and torch .pt "
                  f"checkpoints only", file=sys.stderr)
            return 2
    y, u, v = extract.load_clip(args.input, args.width, args.height,
                                args.frames)
    t0 = time.perf_counter()
    lab = labels.rd_ground_truth(y, u, v, args.qp, device=device)
    t1 = time.perf_counter()
    x32, x64, digits = labels.make_dataset(y, u, v, lab, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    params, hist = train.train(x32, x64, digits, params=init,
                               epochs=args.epochs, lr=args.lr, device=device)
    t3 = time.perf_counter()
    checkpoint.save(args.output, params)
    print(f"Train time: labels {t1 - t0:.3f} s | dataset "
          f"{(t2 - t1) * 1e3:.3f} ms | train {t3 - t2:.3f} s "
          f"({x32.shape[0]} samples)")
    print(f"trained {len(hist)} epochs, final acc "
          f"{hist[-1]['acc']:.3f} -> {args.output}")
    return 0


def cmd_bytecount(args) -> int:
    from hevctpu_torch import utils

    with open(args.bitstream, "rb") as f:
        stream = f.read()
    rows = utils.annexb_bytecount(stream)
    names = {19: "IDR_W_RADL", 32: "VPS", 33: "SPS", 34: "PPS",
             39: "SEI_PREFIX", 40: "SEI_SUFFIX"}
    for k, (t, payload, total) in enumerate(rows):
        print(f"NAL {k:4d}  type {t:2d} {names.get(t, '?'):10s} "
              f"payload {payload:7d}  total {total:7d}")
    print(f"{len(rows)} NAL units, {sum(r[2] for r in rows)} bytes "
          f"({len(stream)} in file)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hevctpu_torch",
        description="The PyTorch/CUDA port of hevctpu's HEVC All-Intra "
                    "encoder and its ConvNet2 trainer.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_encode(sub)
    _add_decode(sub)
    _add_bdrate(sub)
    _add_genlabels(sub)
    _add_train(sub)
    _add_bytecount(sub)
    args = ap.parse_args(argv)
    return {"encode": cmd_encode, "decode": cmd_decode,
            "bdrate": cmd_bdrate, "genlabels": cmd_genlabels,
            "train": cmd_train, "bytecount": cmd_bytecount}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
