"""K1's share of its roofline, %: the least time of each whole K1 launch
in the traced slice (cellbench.roofline.k1_bound at the batch's M for
its size n, read from the kernel's name), over the launches' device time
in the profiler's trace."""

from cellbench import roofline


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["k1"] or rec["peaks"] is None:
        return None
    rows = roofline.k1_rows(rec["height"], rec["width"], rec["batch"])
    least = sum(roofline.k1_bound(n, rows[n], rec["peaks"])[0]
                for n, _ in tr["k1"])
    return 100.0 * least / sum(t for _, t in tr["k1"])
