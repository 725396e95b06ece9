"""Stage 1, ms a frame: the program's stage clock (CUDA events between
the encode's stage marks), "stage1" summed over the window's batches,
over their frames."""


def read(rec):
    b = rec["batches"]
    return (sum(x["stage_ms"]["stage1"] for x in b)
            / sum(x["frames"] for x in b))
