"""Stage 2 on the card: the traced form replayed from CUDA graphs
against the host-planned form on the same card, with nothing read back
to the host (torch.cuda.set_sync_debug_mode("error")), at 64x128 x 2
with CNN labels, a random per-CTU QP map and two_pass; and a capture
that fails raises instead of giving way to another form.

Needs a card (marker gpu); it skips without one. On the card:
python -m pytest tests/test_torch_stage2_card.py -m gpu"""

import os

import numpy as np
import pytest
import torch

from hevctpu_torch.models import checkpoint, convnet2
from hevctpu_torch.pipeline import clips
from hevctpu_torch.pipeline import encoder as tenc

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


@pytest.mark.gpu
def test_graphs_equal_planned_without_host_sync(recorded):
    enc, calls = recorded
    enc._stage2.clear()
    for args in calls:
        want = enc._reconstruct_planned(*args)
        for _ in range(2):          # the call that captures, then a replay
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = enc._reconstruct_traced(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert set(got) == set(want)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    wf, = enc._stage2.values()
    # a diagonal replays its gather, 4 TU32, 16 16-block and its scatter
    assert wf.replays == 2 * len(calls) * wf.diagonals * 22


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
