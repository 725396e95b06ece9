"""The traffic generator: the same seed gives the same pictures, sizes and
family order; another seed other pictures of the same sizes."""

import numpy as np
import pytest

import _setup  # noqa: F401
from cellbench import traffic

MIX = traffic.Mix.from_dict(dict(qp=32, batch=3, in_flight=2,
                                 families=["pink", "scene", "pan", "detail"],
                                 check_frames=2))


def test_same_seed_same_pictures():
    a = traffic.make_pool(MIX, 64, 128, 2**31 + 11)
    b = traffic.make_pool(MIX, 64, 128, 2**31 + 11)
    assert list(a) == list(MIX.families)
    for fam in a:
        for x, y in zip(a[fam], b[fam]):
            assert x.dtype == np.uint8 and np.array_equal(x, y)
    assert a["pink"][0].shape == (3, 64, 128)
    assert a["pink"][1].shape == (3, 32, 64)


def test_other_seed_other_pictures_same_sizes():
    a = traffic.make_pool(MIX, 64, 128, 5)
    b = traffic.make_pool(MIX, 64, 128, 6)
    for fam in a:
        assert a[fam][0].shape == b[fam][0].shape
        assert not np.array_equal(a[fam][0], b[fam][0])


def test_family_cycle_is_the_same_for_every_seed():
    assert [MIX.family(k) for k in range(6)] == [
        "pink", "scene", "pan", "detail", "pink", "scene"]


def test_seed_beyond_63_bits():
    assert traffic.clip_seed(2**70 + 3) == traffic.clip_seed(2**70 + 3)
    assert 0 <= traffic.clip_seed(-1) < 2**63


def test_a_mix_lacking_a_key_or_family_is_refused():
    with pytest.raises(ValueError):
        traffic.Mix.from_dict(dict(qp=32))
    with pytest.raises(ValueError):
        traffic.Mix.from_dict(dict(qp=32, batch=1, in_flight=1,
                                   families=["nope"], check_frames=1))
