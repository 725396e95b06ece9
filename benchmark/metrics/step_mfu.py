"""The whole encode's share of the card's peaks, %: the least time of a
batch's encode (cellbench.roofline.step_bound: ConvNet2 at the FP32 rate;
K1, stage 1's transforms and stage 2 at the INT32 rate or the HBM
bandwidth, each the larger), over its device time on the program's stage
clock (ConvNet2 to the filters), both summed over the window's
batches."""

from cellbench import roofline

STAGES = ("cnn", "stage1", "stage2", "filters")


def read(rec):
    b = rec["batches"]
    if rec["peaks"] is None:
        return None
    least = sum(roofline.step_bound(rec["height"], rec["width"], x["frames"],
                                    x["tusz8"], x["coded8"], rec["peaks"])
                for x in b)
    busy = sum(x["stage_ms"][k] for x in b for k in STAGES) * 1e-3
    return 100.0 * least / busy
