"""Stage 2, ms a wavefront diagonal: the program's stage clock's "stage2"
(CUDA events) summed over the window's batches, over batches x D, where
D = 2 rc + cc - 2 diagonals of the CTU grid (d = 2r + c)."""


def read(rec):
    b = rec["batches"]
    rc, cc = -(-rec["height"] // 64), -(-rec["width"] // 64)
    d = 2 * rc + cc - 2
    return sum(x["stage_ms"]["stage2"] for x in b) / (len(b) * d)
