"""Stage 1's candidate-RD kernel on the card (csrc/stage1_rd.cu via
ops/stage1_rd.py) against its plain version, _dense_rd_plain, run on the
same card: the float32 costs equal by torch.equal at every size, luma
and chroma, K of 1, 5, 6 and 11, QPs 22, 27, 32, 37 and 51, boundaries
from another plane and from the plane itself, at 416x240 x 2, at
1920x1080 (its bottom CTU row 56 lines) and at the 1920x256 frame of a
tile-2 mesh of parallel/sharded.py. An encode on the card launches the
kernel 25 times a stage-1 decision under rate_model="global" (13 without
the TU tree) and never under "ctx", and gives the CPU port's output dict.

Needs a card (marker gpu); it skips without one. On the card:
python -m pytest tests/test_torch_stage1_card.py -m gpu"""

import numpy as np
import pytest
import torch

from hevctpu_torch.ops import rate, stage1_rd
from hevctpu_torch.pipeline import clips
from hevctpu_torch.pipeline import encoder as tenc
from hevctpu_torch.pipeline import trace

GEOMS = {"416x240": (240, 416, 2), "1920x1080": (1080, 1920, 1),
         "tile2_1920x256": (256, 1920, 1)}
# (n, luma, K, QP): the main path's candidate counts (luma 11 at 4 and 8,
# 6 above, chroma 5; 1 in the TU tree) and a QP each
CASES = [(4, True, 11, 32), (4, True, 1, 22), (8, True, 11, 37),
         (8, True, 1, 51), (16, True, 6, 27), (16, True, 1, 32),
         (32, True, 6, 51), (32, True, 1, 22),
         (4, False, 5, 37), (8, False, 5, 22), (16, False, 5, 32),
         (32, False, 5, 27), (8, False, 1, 51)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build here")
    return torch.device("cuda", 0)


def _planes(rng, h, w, b, scale, dev):
    """A smooth random plane with noise and another for the boundaries,
    [B, hp/scale, wp/scale] int32, edge-padded as the encoder pads."""
    g = tenc.Geometry(h, w)

    def plane():
        walk = np.cumsum(rng.integers(-6, 7, (b, h // scale, w // scale)),
                         axis=-1)
        noise = rng.integers(-20, 21, walk.shape)
        p = torch.as_tensor(np.clip(128 + walk + noise, 0, 255),
                            dtype=torch.int32, device=dev)
        return tenc.pad_plane(p, g.hp // scale, g.wp // scale).contiguous()

    return g, plane(), plane()


@pytest.mark.gpu
@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "{}{}_k{}_qp{}".format(
    c[0], "y" if c[1] else "c", c[2], c[3]))
def test_kernel_equals_plain(card, geom, case):
    n, is_luma, k, qp = case
    h, w, b = GEOMS[geom]
    scale = 1 if is_luma else 2
    rng = np.random.default_rng([n, k, qp, h, w])
    g, plane, bsrc = _planes(rng, h, w, b, scale, card)
    r, c = plane.shape[1] // n, plane.shape[2] // n
    cand = torch.as_tensor(rng.integers(0, 35, (b, r, c, k)),
                           dtype=torch.int32, device=card)
    lam = rate.lambda_rd(qp)
    for src in (bsrc, None):
        before = stage1_rd.LAUNCHES
        got = tenc._dense_rd_candidates(plane, g, n, cand, qp, lam,
                                        is_luma=is_luma, scale=scale,
                                        bsrc=src, rate_model="global")
        assert stage1_rd.LAUNCHES == before + 1
        want = tenc._dense_rd_plain(plane, g, n, cand, qp, lam,
                                    is_luma=is_luma, scale=scale, bsrc=src,
                                    rate_model="global")
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got, want), (
            f"{int((got != want).sum())} of {got.numel()} differ, max "
            f"{float((got - want).abs().max())}")


def _calls_per_decision(tu_split: bool) -> int:
    """The kernel's launches in one FrameEncoder._decide under "global":
    4 luma sizes, the 64x64 CU's 32x32 TUs, 12 TU-tree sizes, 4 chroma
    sizes x 2 planes."""
    return 4 + 1 + (12 if tu_split else 0) + 8


@pytest.mark.gpu
@pytest.mark.parametrize("options", [dict(), dict(rate_model="ctx"),
                                     dict(tu_split=False),
                                     dict(two_pass=True)],
                         ids=["global", "ctx", "no_tu_split", "two_pass"])
def test_encode_launches_and_equals_cpu(card, options):
    """64x128 x 2 at QP 32 with fixed labels: the card's output dict is
    the CPU port's, and the kernel launched as many times as the
    decisions call _dense_rd_candidates under "global"."""
    h, w, frames = 64, 128, 2
    y, u, v = clips.clip_sine(frames, h, w, seed=1)
    labels = np.random.default_rng(2).integers(
        0, 4, (frames, 2, 16)).astype(np.int32)
    outs = []
    for dev in (card, "cpu"):
        enc = tenc.FrameEncoder(h, w, 32, device=dev, **options)
        before = trace.counters()["stage1.rd_kernel_launches"]
        outs.append(enc.encode(y, u, v, labels))
        got = trace.counters()["stage1.rd_kernel_launches"] - before
        decisions = 2 if options.get("two_pass") else 1
        want = (0 if options.get("rate_model") == "ctx" or dev == "cpu"
                else decisions * _calls_per_decision(
                    options.get("tu_split", True)))
        assert got == want, (dev, got, want)
    card_out, cpu_out = outs
    assert set(card_out) == set(cpu_out)
    for key in cpu_out:
        assert np.array_equal(np.asarray(card_out[key]),
                              np.asarray(cpu_out[key])), key
