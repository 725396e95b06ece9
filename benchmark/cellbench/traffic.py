"""The one generator of traffic: a mix file (traffic/<name>.json) gives the
QP, the frames a batch, the batches in flight, the content families in the
order batches cycle through them and the frames the check samples
(check_frames); the seed gives the pictures.

Every seed gets the same sizes, families and order: batch k holds `batch`
frames of family families[k % len(families)]. Each family's clip is made
once a run, in set-up, by the frozen corpus generator from the seed, and
every batch of that family sends it again (an encode caches nothing
between batches, so a repeated clip costs what a new one would).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cellbench import corpus

KEYS = ("qp", "batch", "in_flight", "families", "check_frames")


@dataclasses.dataclass(frozen=True)
class Mix:
    qp: int
    batch: int
    in_flight: int
    families: tuple
    check_frames: int

    @classmethod
    def from_dict(cls, d: dict) -> "Mix":
        missing = [k for k in KEYS if k not in d]
        if missing:
            raise ValueError(f"traffic mix lacks {missing}")
        unknown = [f for f in d["families"] if f not in corpus.CORPUS]
        if unknown:
            raise ValueError(f"unknown content families {unknown}")
        if int(d["in_flight"]) < 1 or int(d["batch"]) < 1:
            raise ValueError("batch and in_flight must be at least 1")
        return cls(int(d["qp"]), int(d["batch"]), int(d["in_flight"]),
                   tuple(d["families"]), int(d["check_frames"]))

    def family(self, k: int) -> str:
        return self.families[k % len(self.families)]


def clip_seed(seed: int) -> int:
    """The corpus generator's seed for a run's seed (any integer)."""
    return int(seed) % (1 << 63)


def make_pool(mix: Mix, h: int, w: int, seed: int) -> dict:
    """{family: (y, u, v)} uint8 planes [batch, h, w] and [batch, h/2,
    w/2], one clip a family of the mix."""
    pool = {}
    for fam in dict.fromkeys(mix.families):
        y, u, v = corpus.make_clip(fam, mix.batch, h, w, seed=clip_seed(seed))
        pool[fam] = tuple(np.ascontiguousarray(a, np.uint8) for a in (y, u, v))
    return pool
