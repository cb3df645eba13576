"""The model FLOPs of the window's clouds (``flops/pcst_model.py``) over
the window's seconds and the cards' bf16 peak, in percent: what bounds any
serving claim, whichever kernel it moves."""

from h100_bench.core import peaks
from h100_bench.drivers.serve import hierarchical
from h100_bench.flops import pcst_model


def read(run):
    tr = run.cell.traffic
    per_cloud = pcst_model.serve_flops_per_cloud(
        run.cell.config, tr["steps"], hierarchical(run))
    clouds = sum(r["units"] for r in run.records)
    return 100.0 * per_cloud * clouds / (
        run.window_s * run.chips * peaks.BF16_FLOPS)
