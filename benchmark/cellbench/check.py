"""What decides `correct`: the window's outputs against references that
share no code with the program, once the window has closed and the
program's state is freed.

Numbers compared, each against the cell's limit (limits/<cell>.json):

- cnn_gap: over every frame of the window, the widest gap by which the
  digits behind the served CU-depth labels lie below the best logit of the
  reference ConvNet2 (plainref.cnn, float64, TF32 off); 0 where the
  labels are the reference's own.
- On a sample of frames drawn from the seed (one a content family while
  the sample lasts), each picture of the served stream is decoded by
  specdec, a decoder written from the H.265 Recommendation, and:
  - stage1_mismatch: CU depths, NxN flags, luma modes, chroma mode
    choices and TU sizes that the stream codes unlike the served decision
    maps, and CU depths unlike those the served labels call for (label
    depth, or the depth at which the CU first fits in the picture);
  - stage2_mismatch: levels, coded-block flags and transform-skip flags
    the stream codes unlike the served ones;
  - levels_outside: coded levels outside the bounds of a quantiser of
    the source picture's residual (specdec.picture.QuantBound);
  - filters_mismatch: SAO merge flags and parameters unlike the served
    ones, and colour components whose decoded checksum or SSE against
    the source differs from the served one;
  - stream_mismatch: pictures that do not decode or whose decoded picture
    hash SEI disagrees with the decoded picture.
- frames_missing: frames the window sent whose output or picture never
  came.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

NUMBERS = ("cnn_gap", "stage1_mismatch", "stage2_mismatch",
           "levels_outside", "filters_mismatch", "stream_mismatch",
           "frames_missing")
_START = re.compile(b"\x00\x00\x01")
NAL_IDR_W_RADL, NAL_SEI_SUFFIX = 19, 40


def split_pictures(stream: bytes) -> tuple:
    """An Annex-B stream of IDR pictures -> (parameter-set NAL units,
    [each picture's slice and suffix-SEI NAL units]), each as Annex-B
    bytes with 4-byte start codes."""
    head, pics = b"", []
    marks = [m.end() for m in _START.finditer(stream)]
    for i, s in enumerate(marks):
        end = marks[i + 1] - 3 if i + 1 < len(marks) else len(stream)
        nal = stream[s:end].rstrip(b"\x00")
        unit = b"\x00\x00\x00\x01" + nal
        kind = (nal[0] >> 1) & 0x3F
        if kind == NAL_IDR_W_RADL:
            pics.append(unit)
        elif kind == NAL_SEI_SUFFIX and pics:
            pics[-1] += unit
        elif not pics:
            head += unit
        else:
            pics[-1] += unit
    return head, pics


def sample(families: list, check_frames: int, batch: int, seed: int) -> list:
    """(batch index, frame index) pairs to check, drawn from the seed: a
    frame of a batch of each content family present, the families in a
    seed-drawn order, then frames of any batch; no pair twice."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    present = list(dict.fromkeys(families))
    order = [present[i] for i in rng.permutation(len(present))]
    picks = []
    for i in range(check_frames):
        fam = order[i] if i < len(order) else None
        cands = [(k, j) for k, f in enumerate(families)
                 if fam is None or f == fam for j in range(batch)
                 if (k, j) not in picks]
        if cands:
            picks.append(cands[int(rng.integers(len(cands)))])
    return picks


def label_depths(labels: np.ndarray, h: int, w: int) -> np.ndarray:
    """The CU depth of each 8x8 block [h/8, w/8] that CU-depth labels
    [nCTU, 16] call for: a label per 16x16 block of a 64x64 CTU in raster
    order, 0 an unsplit CTU (read at the CTU's first block), 1 a 32x32
    CU (read at the quadrant's first block), 2 a 16x16 CU, 3 8x8 CUs;
    where that CU crosses the picture's edge, the depth at which the CU
    first lies inside it."""
    cc = -(-w // 64)
    out = np.zeros((h // 8, w // 8), np.int64)
    for sy in range(h // 8):
        for sx in range(w // 8):
            lab = labels[(sy // 8) * cc + sx // 8]
            by, bx = (sy % 8) // 2, (sx % 8) // 2
            if lab[0] == 0:
                d = 0
            elif lab[(by // 2) * 8 + (bx // 2) * 2] == 1:
                d = 1
            else:
                d = 2 if lab[by * 4 + bx] == 2 else 3
            while d < 3:
                size = 64 >> d
                y0, x0 = (sy * 8) // size * size, (sx * 8) // size * size
                if y0 + size <= h and x0 + size <= w:
                    break
                d += 1
            out[sy, sx] = d
    return out


def _count(got, want) -> int:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return want.size
    return int(np.count_nonzero(got != want))


def stage1_mismatch(pic, served: dict, labels, h: int, w: int) -> int:
    s = pic.syntax
    h8, w8, h4, w4 = h // 8, w // 8, h // 4, w // 4
    return (_count(served["depth8"][:h8, :w8], s.depth8)
            + _count(label_depths(labels, h, w), s.depth8)
            + _count(served["nxn8"][:h8, :w8], s.nxn8)
            + _count(served["mode4"][:h4, :w4], s.mode4)
            + _count(served["csel8"][:h8, :w8], s.csel8)
            + _count(served["tusz8"][:h8, :w8], s.tusz8))


def stage2_mismatch(pic, served: dict, h: int, w: int) -> int:
    s = pic.syntax
    n = 0
    for c, key in enumerate(("levels_y", "levels_u", "levels_v")):
        sh = s.levels[c].shape
        n += _count(served[key][: sh[0], : sh[1]], s.levels[c])
    for (x0, y0, log2), cbf in s.cbf_y.items():
        got = (served["cbf_y"][y0 >> 3, x0 >> 3] if log2 >= 3
               else served["cbf4_y"][y0 >> 2, x0 >> 2])
        n += bool(got) != cbf
    for (comp, x0, y0, log2), cbf in s.cbf_c.items():
        k = max(1, 1 << (log2 - 3))
        got = served["cbf_u" if comp == 1 else "cbf_v"][
            y0 >> 3: (y0 >> 3) + k, x0 >> 3: (x0 >> 3) + k].any()
        n += bool(got) != cbf
    for (comp, x0, y0), ts in s.ts.items():
        key = ("ts4_y", "ts8_u", "ts8_v")[comp]
        n += bool(served[key][y0 >> 2, x0 >> 2]) != ts
    return int(n)


def filters_mismatch(pic, served: dict, source) -> int:
    s = pic.syntax
    n = _count(served["sao_merge"], s.sao_merge)
    for r, c in zip(*np.nonzero(s.sao_coded)):
        for tix in (0, 1):
            n += int(served["sao_type"][r, c, tix]) != s.sao_type[r, c, tix]
        for comp in range(3):
            typ = s.sao_type[r, c, comp]
            if typ:
                n += _count(served["sao_off"][r, c, comp],
                            s.sao_off[r, c, comp])
            if typ == 1:
                n += int(served["sao_bp"][r, c, comp]) != s.sao_bp[r, c, comp]
            if typ == 2 and comp < 2:
                n += int(served["sao_eo"][r, c, comp]) != s.sao_eo[r, c, comp]
    n += _count(np.asarray(served["hash_checksum"], np.int64), pic.checksum)
    sse = [int(((p.astype(np.int64) - np.asarray(src, np.int64)) ** 2).sum())
           for p, src in zip(pic.planes, source)]
    n += _count(np.asarray(served["sse"], np.int64), sse)
    return int(n)


def judge(config: dict, mix, weights: str, pool: dict, batches: list,
          seed: int, device: str) -> dict:
    """The numbers compared, and the frames judged wrong or missing.

    batches: [dict(family, frames, labels [B, nCTU, 16], out (host dict,
    every frame), stream (bytes))] in window order."""
    import specdec
    from plainref import cnn

    h, w = config["height"], config["width"]
    nums = dict.fromkeys(NUMBERS, 0)
    nums["cnn_gap"] = 0.0
    wrong = set()
    pics = []
    for k, b in enumerate(batches):
        n = b["frames"]
        head, p = split_pictures(b["stream"])
        pics.append((head, p))
        got = min(len(p), len(b["labels"]), np.shape(b["out"]["depth8"])[0])
        nums["frames_missing"] += n - got
        wrong.update((k, i) for i in range(got, n))

    t0 = time.perf_counter()
    params = cnn.load_params(weights)
    logits = {}
    with cnn.tf32(False):
        for fam in dict.fromkeys(b["family"] for b in batches):
            logits[fam] = cnn.frame_logits(params, *pool[fam], device)
    for k, b in enumerate(batches):
        lab = np.asarray(b["labels"])[: len(logits[b["family"]])]
        gap, _ = cnn.served_gap(logits[b["family"]][: len(lab)], lab)
        nums["cnn_gap"] = max(nums["cnn_gap"], gap)

    t_cnn = time.perf_counter() - t0
    picks = [(k, i) for k, i in sample([b["family"] for b in batches],
                                       mix.check_frames, mix.batch, seed)
             if (k, i) not in wrong]
    errors = []
    t1 = time.perf_counter()
    for k, i in picks:
        b = batches[k]
        source = tuple(pool[b["family"]][c][i] for c in range(3))
        served = {key: np.asarray(val)[i] for key, val in b["out"].items()
                  if np.ndim(val) > 0}
        try:
            pic = specdec.decode(pics[k][0] + pics[k][1][i], source)
        except (specdec.StreamError, specdec.Unsupported) as e:
            errors.append(f"batch {k} frame {i}: {e}")
            nums["stream_mismatch"] += 1
            wrong.add((k, i))
            continue
        counts = (stage1_mismatch(pic, served, np.asarray(b["labels"])[i],
                                  h, w),
                  stage2_mismatch(pic, served, h, w),
                  pic.levels_outside,
                  filters_mismatch(pic, served, source),
                  int(pic.sei_checksum != pic.checksum))
        for key, v in zip(NUMBERS[1:6], counts):
            nums[key] += v
        if any(counts):
            wrong.add((k, i))
    return dict(numbers=nums, wrong=len(wrong), checked=len(picks),
                decode_errors=errors,
                seconds=dict(cnn=t_cnn, decode=time.perf_counter() - t1,
                             total=time.perf_counter() - t0))


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for the cell's limits."""
    rows = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(numbers[k] <= limits[k] for k in NUMBERS), rows


def free_device():
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
