"""Stage 2 on the card: the traced form (its gather and scatter replayed
from CUDA graphs, the stage-2 kernel between them) against the
host-planned form on the same card, with nothing read back to the host
(torch.cuda.set_sync_debug_mode("error")), at 64x128 x 2: CNN labels, a
random per-CTU QP map, two_pass, a tile axis of 2, RDOQ, SBH and TS each
switched off, and every slot a TU4 leaf; at 120x128 x 2, whose bottom
CTU row holds 56 lines as at 1080, with CNN labels and with every CTU
unsplit (the edge alone splits CUs, down to 8x8); and a capture that
fails raises instead of giving way to another form.

Needs a card (marker gpu); it skips without one. On the card:
python -m pytest tests/test_torch_stage2_card.py -m gpu"""

import os

import numpy as np
import pytest
import torch

from hevctpu_torch.models import checkpoint, convnet2
from hevctpu_torch.pipeline import clips
from hevctpu_torch.pipeline import encoder as tenc
from hevctpu_torch.pipeline import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, QP, FRAMES = 64, 128, 32, 2


@pytest.fixture(scope="module")
def recorded():
    """A two_pass encode with a random per-CTU QP map on the card: its
    encoder and the arguments of both reconstructions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    y, u, v = clips.clip_sine(FRAMES, H, W, seed=0)
    cnn = convnet2.load_model(
        checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz")), "cuda")
    labels = convnet2.predict_frame_labels(
        cnn, *(torch.as_tensor(p.astype(np.int32)).cuda() for p in (y, u, v)),
        H, W).cpu().numpy()
    enc = tenc.FrameEncoder(H, W, QP, device="cuda", two_pass=True)
    qp_map = np.random.default_rng(3).integers(
        22, 43, (FRAMES, enc.geom.rc, enc.geom.cc))
    calls = []
    real = enc._reconstruct

    def recording(*a):
        calls.append(a)
        return real(*a)

    enc._reconstruct = recording
    enc.encode(y, u, v, labels, qp_map)
    assert len(calls) == 2
    return enc, calls


def _traced_equal(enc, args, want, shard=None):
    """One traced reconstruction of args (without the shard) under sync
    debug "error", its 13 planes held to want."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = enc._reconstruct_traced(*args, shard=shard)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(want) == 13 and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
def test_graphs_equal_planned_without_host_sync(recorded):
    enc, calls = recorded
    enc._stage2.clear()
    before = trace.counters()
    for args in calls:
        want = enc._reconstruct_planned(*args)
        for _ in range(2):          # the call that captures, then a replay
            _traced_equal(enc, args[:9], want)
    wf, = enc._stage2.values()
    after = trace.counters()
    # a diagonal replays its gather and its scatter and launches the
    # kernel once between them
    runs = 2 * len(calls) * wf.diagonals
    assert after["stage2.replays"] - before["stage2.replays"] == 2 * runs
    assert (after["stage2.kernel_launches"]
            - before["stage2.kernel_launches"] == runs)
    # both reconstructions share one key: captured once, evicted never
    assert after["stage2.captures"] - before["stage2.captures"] == 1
    assert after["stage2.evictions"] == before["stage2.evictions"]


class _HaloShard:
    """Tile ti of a tile axis whose exchange hands over the halos that
    the planned single-device reconstruction's final planes give: every
    halo sample a CTU can see is final by then (the left and above-right
    CTUs lie on earlier diagonals), and the rest is never available."""

    def __init__(self, full: dict, tiles: int, ti: int, cl: int):
        self.tile, self.tile_index = tiles, ti
        planes = [tenc.to_blocked(full[k].to(torch.int32), n)
                  for k, n in (("recon_y", 64), ("recon_u", 32),
                               ("recon_v", 32))]
        edges = [tenc._tile_edges(*(p[:, :, t * cl: (t + 1) * cl]
                                    for p in planes)) for t in range(tiles)]
        zero = torch.zeros_like(edges[0][0])
        self.halos = (edges[ti - 1][0] if ti > 0 else zero,
                      edges[ti + 1][1] if ti + 1 < tiles else zero)

    def exchange(self, right, bottom):
        return self.halos


@pytest.mark.gpu
def test_tiles_equal_planned(recorded):
    """A tile axis of 2 (one CTU column a tile), each tile's traced
    stage 2 against the planned single-device planes' columns."""
    enc, calls = recorded
    args = calls[0][:8]
    want = enc._reconstruct_planned(*args)
    for ti in range(2):
        part = {k: t[..., ti * t.shape[-1] // 2: (ti + 1) * t.shape[-1] // 2]
                for k, t in want.items()}
        _traced_equal(enc, args, part, _HaloShard(want, 2, ti, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("switch", ["rdoq", "sbh", "ts"])
def test_switch_off_equal_planned(recorded, switch):
    """An encoder with one tool off, on the recorded decisions (pass 1,
    no QP map; the TS trial's flags are stage 2's planes either way)."""
    _, calls = recorded
    enc = tenc.FrameEncoder(H, W, QP, device="cuda", **{switch: False})
    args = calls[0][:8]
    want = enc._reconstruct_planned(*args)
    for _ in range(2):
        _traced_equal(enc, args, want)


@pytest.mark.gpu
@pytest.mark.parametrize("qp_map", [False, True], ids=["static", "qp_map"])
def test_all_tu4_leaves_equal_planned(recorded, qp_map):
    """The worst-case chain: every slot a TU4 leaf (256 luma 4x4 TUs a
    CTU, each with the TS trial, and 64 chroma 4x4 TUs a plane), random
    4x4 luma modes, random source."""
    enc, calls = recorded
    args = list(calls[1][:9] if qp_map else calls[0][:8] + (None,))
    rng = np.random.default_rng(7)
    for i in range(3):              # Y, U, V
        args[i] = torch.as_tensor(rng.integers(0, 256, args[i].shape),
                                  dtype=torch.int32, device="cuda")
    args[5] = torch.full_like(args[5], 2)
    args[7] = torch.as_tensor(rng.integers(0, 35, args[7].shape),
                              dtype=torch.int32, device="cuda")
    enc._stage2.clear()
    want = enc._reconstruct_planned(*args)
    assert want["cbf4_y"].any() and want["ts4_y"].any()
    _traced_equal(enc, args, want)


@pytest.mark.gpu
def test_capture_failure_raises(recorded, monkeypatch):
    """A host read inside a captured segment fails the capture, and the
    failure reaches the caller."""
    enc, calls = recorded
    enc._stage2.clear()
    close = tenc._Wavefront._close

    def reading_close(self):
        close(self)
        self.d.item()

    monkeypatch.setattr(tenc._Wavefront, "_close", reading_close)
    with pytest.raises(RuntimeError):
        enc._reconstruct(*calls[0])
    enc._stage2.clear()


@pytest.fixture(scope="module", params=["cnn", "unsplit"])
def recorded_56(request):
    """An encode at 120x128 x 2 on the card (2 x 2 CTUs, the bottom row 56
    lines as at 1080 = 16 * 64 + 56): its encoder, stage 2's arguments
    and the output; labels from ConvNet2, or 0 (every CTU unsplit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    h = 120
    y, u, v = clips.clip_sine(FRAMES, h, W, seed=1)
    if request.param == "cnn":
        cnn = convnet2.load_model(
            checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz")), "cuda")
        labels = convnet2.predict_frame_labels(
            cnn, *(torch.as_tensor(p.astype(np.int32)).cuda()
                   for p in (y, u, v)), h, W).cpu().numpy()
    else:
        labels = np.zeros((FRAMES, 4, 16), np.int8)
    enc = tenc.FrameEncoder(h, W, QP, device="cuda")
    calls = []
    real = enc._reconstruct

    def recording(*a):
        calls.append(a)
        return real(*a)

    enc._reconstruct = recording
    out = enc.encode(y, u, v, labels)
    assert len(calls) == 1
    return enc, calls[0], out


@pytest.mark.gpu
def test_56_line_ctu_row_equal_planned(recorded_56):
    """The kernel form against the planned form where the bottom CTU row
    is cut at 56 lines: its last 8 lines are 8x8 CUs."""
    enc, args, out = recorded_56
    assert (out["depth8"][:, 14, :] == 3).all()
    enc._stage2.clear()
    want = enc._reconstruct_planned(*args[:8])
    for _ in range(2):          # the call that captures, then a replay
        _traced_equal(enc, args[:8], want)
