"""Stage 2's share of its roofline, %: the least time of the transforms
of every TU the batch's decisions code and of its planes' bytes
(cellbench.roofline.stage2_bound), over the stage clock's "stage2" (CUDA
events), both summed over the window's batches."""

from cellbench import roofline


def read(rec):
    b = rec["batches"]
    if rec["peaks"] is None:
        return None
    least = sum(roofline.stage2_bound(x["tusz8"], x["coded8"], rec["height"],
                                      rec["width"], rec["peaks"]) for x in b)
    return 100.0 * least / (sum(x["stage_ms"]["stage2"] for x in b) * 1e-3)
