"""The model FLOPs of the window's clouds through Point-E's transformer
denoiser (``flops/point_e.py``: its GEMMs and attention's two products)
over the window's seconds and the cards' bf16 peak, in percent."""

from h100_bench.core import peaks
from h100_bench.drivers.serve import hierarchical
from h100_bench.flops import point_e


def read(run):
    if "denoiser" not in run.cell.config or run.window_s <= 0:
        return None
    per_cloud = point_e.serve_flops_per_cloud(
        run.cell.config, run.cell.traffic["steps"], hierarchical(run))
    clouds = sum(r["units"] for r in run.records)
    return 100.0 * per_cloud * clouds / (
        run.window_s * run.chips * peaks.BF16_FLOPS)
