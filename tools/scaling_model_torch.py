#!/usr/bin/env python3
"""Measured communication volume + scaling-efficiency model of the port's
(frame, tile) mesh (PyTorch port of tools/scaling_model.py: its flags
and defaults, plus --world, --device and --deadline).

Where the JAX tool compiles the sharded step and walks its HLO, this one
runs it: a gloo world of --world ranks (every rank on the one card, or
on the CPU with --device cpu) encodes batch x frame-axis frames, each
rank's Mesh tallies the bytes its collectives move, and the JAX tool's
model is fed those bytes and the H100's figures. Writes
SCALING_TORCH.md + SCALING_TORCH.json (never SCALING.*).

Usage: python tools/scaling_model_torch.py [--h 1088 --w 1920 --tile 4]
           [--world 8] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hevctpu_torch import get_device  # noqa: E402
from hevctpu_torch.parallel import scaling  # noqa: E402
from hevctpu_torch.parallel.sharded import mesh_shape  # noqa: E402
from hevctpu_torch.pipeline.encoder import Geometry  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=1088)
    ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--tile", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2,
                    help="frames a rank of the frame axis encodes")
    ap.add_argument("--out", default=os.path.join(ROOT, "SCALING_TORCH"))
    ap.add_argument("--world", type=int, default=8,
                    help="ranks of the gloo world (the JAX tool's 8 "
                         "virtual devices)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (default cuda; "
                         "raises without CUDA; cpu runs the plain PyTorch "
                         "path)")
    ap.add_argument("--deadline", type=float, default=1800.0,
                    help="seconds the world may run before its ranks are "
                         "killed and the tool fails")
    args = ap.parse_args(argv)

    dev = get_device(args.device)
    try:
        _, tile = mesh_shape(args.world, args.tile)
    except ValueError as e:
        ap.error(str(e))
    cc = Geometry(args.h, args.w).cc
    if cc % tile:
        # tools/scaling_model.py stops here too (ShardedEncoder's assert)
        ap.error(f"{cc} CTU columns do not divide into {tile} tiles: pass "
                 f"another --tile or --w")
    if dev.type == "cuda":
        from hevctpu_torch.ops import satd_fused
        satd_fused.build()            # once, before the ranks load it
    job = dict(h=args.h, w=args.w, tile=tile, batch=args.batch,
               world=args.world, device=dev.type, deadline_s=args.deadline)
    print(f"encoding on {args.world} ranks at {args.h}x{args.w} "
          f"tile={tile} batch={args.batch} a frame rank ...", flush=True)
    ranks, wall = scaling.run_world(job)
    from hevctpu_torch.pipeline.evaluate import device_label
    doc = scaling.scaling_report(job, ranks, wall, device_label(dev))
    with open(args.out + ".json", "w") as f:
        json.dump(doc, f, indent=1, default=float)
    md = scaling.scaling_markdown(doc, ROOT)
    with open(args.out + ".md", "w") as f:
        f.write(md)
    print(md, end="")
    print("wrote", args.out + ".md", args.out + ".json")
    return doc


if __name__ == "__main__":
    main()
