"""ConvNet2, ms a frame: the program's stage clock (CUDA events between
the encode's stage marks), "cnn" summed over the window's batches, over
their frames."""


def read(rec):
    b = rec["batches"]
    return (sum(x["stage_ms"]["cnn"] for x in b)
            / sum(x["frames"] for x in b))
