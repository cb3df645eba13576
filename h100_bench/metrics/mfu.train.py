"""Three times the model FLOPs of a mini-step's forward
(``flops/pcst_model.py``; recomputation not counted) times the window's
mini-steps, over the window's seconds and the card's bf16 peak, in
percent."""

from h100_bench.core import peaks
from h100_bench.drivers.serve import hierarchical
from h100_bench.flops import pcst_model


def read(run):
    per_step = 3 * pcst_model.train_forward_flops(
        run.cell.config, run.cell.traffic["batch"], hierarchical(run))
    return 100.0 * per_step * len(run.records) / (
        run.window_s * run.chips * peaks.BF16_FLOPS)
