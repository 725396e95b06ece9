"""The references against the program at a small size on the CPU: the
spec decoder reads the program's streams back to its own reconstruction
and decisions, the levels lie inside the quantiser's bounds, the labels'
depths are the program's; the decoder refuses a stream whose hash or
slice data is broken; the logit-gap reading on hand-made logits, and the
check's sampling."""

import numpy as np
import pytest
import torch

import _setup
import specdec
from cellbench import check, corpus
from plainref import cnn
from specdec import filters, tables

WEIGHTS = f"{_setup.BENCH}/weights/convnet2_domain.npz"


def clip(fam, n, h, w, seed=4):
    return tuple(a.astype(np.uint8) for a in corpus.make_clip(fam, n, h, w,
                                                              seed=seed))


@pytest.fixture(scope="module", params=["detail", "pan"])
def program_out(request):
    from hevctpu_torch.codec import decoder as streamlib
    from hevctpu_torch.codec import headers
    from hevctpu_torch.models import convnet2
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    y, u, v = clip(request.param, 2, 64, 128)
    enc = FrameEncoder(64, 128, 32, device="cpu")
    model = convnet2.load_model(cnn.load_params(WEIGHTS), "cpu")
    out = enc.encode_fused(model, y, u, v, lite=True)
    recon = enc.encode(y, u, v, out["labels"])
    cfg = headers.StreamConfig(width=128, height=64, qp=32,
                               hash_type="checksum")
    return (y, u, v), out, recon, streamlib.encode_stream(cfg, [out])


def _pictures(stream):
    head, pics = check.split_pictures(stream)
    return [head + p for p in pics]


def test_cnn_labels_are_the_programs(program_out):
    (y, u, v), out, _, _ = program_out
    lg = cnn.frame_logits(cnn.load_params(WEIGHTS), y, u, v, "cpu")
    assert np.array_equal(cnn.labels_from_logits(lg), out["labels"])
    assert cnn.served_gap(lg, out["labels"]) == (0.0, 0)


def test_decoded_pictures_are_the_programs_recon(program_out):
    src, out, recon, stream = program_out
    for i, data in enumerate(_pictures(stream)):
        pic = specdec.decode(data, tuple(p[i] for p in src))
        for got, key in zip(pic.planes, ("recon_y", "recon_u", "recon_v")):
            assert np.array_equal(got, recon[key][i]), key
        assert pic.checksum == pic.sei_checksum
        assert pic.checksum == [int(x) for x in out["hash_checksum"][i]]
        assert pic.levels_coded > 0 and pic.levels_outside == 0


def test_decoded_decisions_are_the_served_ones(program_out):
    src, out, _, stream = program_out
    for i, data in enumerate(_pictures(stream)):
        source = tuple(p[i] for p in src)
        pic = specdec.decode(data, source)
        served = {k: np.asarray(v)[i] for k, v in out.items()
                  if np.ndim(v) > 0}
        assert check.stage1_mismatch(pic, served, out["labels"][i], 64,
                                     128) == 0
        assert check.stage2_mismatch(pic, served, 64, 128) == 0
        assert check.filters_mismatch(pic, served, source) == 0
        served["mode4"] = served["mode4"].copy()
        served["mode4"][0, 0] = (served["mode4"][0, 0] + 1) % 35
        assert check.stage1_mismatch(pic, served, out["labels"][i], 64,
                                     128) > 0


def test_broken_streams_are_refused(program_out):
    _, _, _, stream = program_out
    data = _pictures(stream)[0]
    bad = bytearray(data)
    bad[-8] ^= 0x10                                # a byte of the hash SEI
    pic = specdec.decode(bytes(bad))
    assert pic.sei_checksum != pic.checksum
    head, pics = check.split_pictures(stream)
    cut = head + pics[0][: len(pics[0]) // 2]      # slice data cut short
    with pytest.raises(specdec.StreamError):
        specdec.decode(cut)


def test_label_depths_by_hand():
    lab = np.full((2, 16), 2)
    lab[0] = 0                                     # CTU 0 unsplit
    lab[1, [0, 1, 4, 5]] = 1                       # CTU 1: a 32x32 quadrant
    lab[1, 15] = 3
    d = check.label_depths(lab, 64, 128)
    assert (d[:, :8] == 0).all()
    assert (d[:4, 8:12] == 1).all() and (d[:4, 12:] == 2).all()
    assert (d[6:, 14:] == 3).all()
    # a 48-row picture: the unsplit CTU crosses the edge, 32x32 CUs fit
    # above row 32 and 16x16 CUs below
    d = check.label_depths(np.zeros((1, 16), np.int64), 48, 64)
    assert (d[:4] == 1).all() and (d[4:] == 2).all()


def test_quant_bound_by_hand():
    qb = specdec.picture.QuantBound()
    src = np.full((4, 4), 100)
    pred = np.full((4, 4), 60)           # a flat residual of 40: DC only
    lv = np.zeros((4, 4), np.int64)
    qb.check(src, pred, lv, 2, 32, False, False)
    assert qb.outside == 0
    c = ((tables.dct_matrix(4) @ (np.full((4, 4), 40)).T + 1) >> 1)
    c = (tables.dct_matrix(4) @ c.T + 128) >> 8
    m = (abs(int(c[0, 0])) * tables.QUANT_SCALE[2] + (1 << 23)) >> 24
    assert m > 3
    for level, bad in ((m, 0), (m + 1, 0), (m - 2, 0), (m + 2, 1),
                       (-m, 1)):
        lv[0, 0] = level
        qb = specdec.picture.QuantBound()
        qb.check(src, pred, lv, 2, 32, False, False)
        assert qb.outside == bad, level


def test_tables_by_hand():
    m4 = tables.dct_matrix(4)
    assert m4.tolist() == [[64, 64, 64, 64], [83, 36, -36, -83],
                           [64, -64, -64, 64], [36, -83, 83, -36]]
    m32 = tables.dct_matrix(32)
    assert m32[1, :4].tolist() == [90, 90, 88, 85]
    assert (m32 @ m32.T)[0, 0] == 32 * 64 * 64
    assert tables.scan(0, 4)[:4] == ((0, 0), (0, 1), (1, 0), (0, 2))
    assert filters.checksum(np.zeros((2, 2), np.uint8)) == 0 + 1 + 1 + 0


def _logits(best=3, runner=2, margin=0.5):
    lg = np.zeros((1, 1, 4, 16))
    lg[..., best::4] = 1.0
    lg[0, 0, 2, 4 + runner] = 1.0 - margin          # quadrant 2, group 1
    return lg


def test_gap_by_hand():
    lg = _logits()
    own = cnn.labels_from_logits(lg)
    assert (own == 3).all()
    assert cnn.served_gap(lg, own) == (0.0, 0)
    digits = np.full((1, 1, 4, 4), 3)
    digits[0, 0, 2, 1] = 2
    served = cnn.digits_to_labels(digits)
    gap, n = cnn.served_gap(lg, served)
    assert n == 1 and gap == pytest.approx(0.5)


def test_labels_no_digits_yield():
    lg = _logits()
    served = np.full((1, 1, 16), 3)
    served[0, 0, 0] = 0          # a 0 beside non-0 labels in quadrant 0
    assert cnn.served_gap(lg, served)[0] == cnn.IMPOSSIBLE


def test_gap_takes_the_cheapest_digits():
    # labels 2 everywhere come from digits 2, or from 1s upgraded beside a
    # 2: the digits closest to the logits' best give the gap
    lg = np.zeros((1, 1, 4, 16))
    lg[..., 1::4] = 1.0                      # digit 1 best everywhere
    lg[..., 2::4] = 0.9                      # digit 2 a little behind
    served = np.full((1, 1, 16), 2)
    gap, _ = cnn.served_gap(lg, served)
    assert gap == pytest.approx(0.1)


def test_float64_logits_stand_above_float32_rounding():
    y, u, v = clip("pink", 1, 64, 128)
    p = cnn.load_params(WEIGHTS)
    a = cnn.frame_logits(p, y, u, v, "cpu")
    b = cnn.frame_logits(p, y, u, v, "cpu", dtype=torch.float32)
    assert np.abs(a - b).max() < 1e-3


def test_sample_is_drawn_from_the_seed():
    fams = ["pink", "scene", "pan", "detail", "pink", "scene"]
    a = check.sample(fams, 4, 32, 2**40 + 1)
    assert a == check.sample(fams, 4, 32, 2**40 + 1)
    assert {fams[k] for k, _ in a} == set(fams[:4])
    assert len(set(a)) == 4
    assert len(check.sample(["pink"], 3, 2, 5)) == 2
