"""Per-QP bin-weight correction for ops/rate.py (the port's copy of
hevctpu/ops/rate_weights.py; derivation in that module's docstring).

The hand-calibrated global weights over/under-price the context-coded bins
systematically with QP; every ladder/csbf/last context weight is scaled by
the inverse measured ratio per QP, with the cbf weights pinned.
"""

from hevctpu_torch.ops import rate as _rate

_SCALE = {22: 1 / 1.136, 27: 1 / 0.969, 32: 1 / 0.842, 37: 1 / 0.796}
_PIN = ("cbf1", "cbf0")

FITTED = {
    qp: tuple(
        int(round(_rate._W_DEFAULT[f] * (1.0 if f in _PIN else s)))
        for f in _rate._W_FIELDS)
    for qp, s in _SCALE.items()
}
