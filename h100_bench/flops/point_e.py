"""Model FLOPs of the style-transfer network with Point-E's transformer
denoiser (``core.point_e_spec``): two FLOPs a multiply-add of every dense
layer, and of attention's two products, 4 B H T^2 c a block (T = M + 2
tokens); LayerNorm, GELU, softmax, the DDIM update and the kNN are left
out. And attention's bytes a call: q, k and v read and its output written
once, in bfloat16."""

from __future__ import annotations

from ..core import peaks, point_e_spec
from . import pcst_model

BF16_BYTES = 2


def tokens(cfg: dict, hierarchical: bool = True) -> int:
    """T: the denoised points plus the style and time tokens."""
    rows = cfg["global_points"] if hierarchical else cfg["total_points"]
    return rows + 2


def attention_flops(cfg: dict, batch: int, T: int) -> int:
    """One attention call: q k^T and p v, 2 x 2 B H T^2 c."""
    d = int(cfg["denoiser"]["width"])  # H c
    return 4 * batch * T * T * d


def attention_bytes(cfg: dict, batch: int, T: int) -> int:
    return 4 * batch * T * int(cfg["denoiser"]["width"]) * BF16_BYTES


def attention_least_seconds(cfg: dict, batch: int, T: int) -> float:
    """One call's least time on the published bf16 and HBM peaks."""
    return max(attention_flops(cfg, batch, T) / peaks.BF16_FLOPS,
               attention_bytes(cfg, batch, T) / peaks.HBM_BYTES_PER_S)


def denoiser_flops(cfg: dict, batch: int, T: int) -> int:
    """One ``predict_noise`` on ``batch`` clouds of T - 2 points."""
    macs = 0
    for name, i, o in point_e_spec.dense_layers(cfg):
        if name.endswith(("input_proj", "output_proj")):
            rows = T - 2
        elif name.endswith(("style_embed", "time_embed.c_fc",
                            "time_embed.c_proj")):
            rows = 1
        else:
            rows = T
        macs += rows * i * o
    return 2 * batch * macs + int(cfg["denoiser"]["layers"]) * \
        attention_flops(cfg, batch, T)


def serve_flops_per_cloud(cfg: dict, steps: int, hierarchical: bool) -> int:
    """One cloud through ``guided_sample_loop``: the style encoder once,
    then each step the transformer on the [cond; uncond] pair."""
    return 2 * pcst_model.encoder_macs(cfg) + steps * denoiser_flops(
        cfg, 2, tokens(cfg, hierarchical))
