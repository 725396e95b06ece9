"""Deblocking and SAO, ms a frame: the program's stage clock (CUDA events
between the encode's stage marks), "filters" summed over the window's
batches, over their frames."""


def read(rec):
    b = rec["batches"]
    return (sum(x["stage_ms"]["filters"] for x in b)
            / sum(x["frames"] for x in b))
