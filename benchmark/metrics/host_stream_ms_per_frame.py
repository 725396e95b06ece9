"""Host stream, ms a frame: the host clock around collect (lite unpack)
and encode_stream (headers, native CABAC, checksum SEI) of each window
batch, counted from the end of the batch's device work, summed over the
window, over its frames."""


def read(rec):
    b = rec["batches"]
    return sum(x["host_ms"] for x in b) / sum(x["frames"] for x in b)
