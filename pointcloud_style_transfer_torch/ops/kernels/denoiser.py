"""The denoiser's residual block, ``x + fc2(relu(fc1(x)))``: CUDA kernel +
plain PyTorch version.

Replaces no TPU kernel: the JAX package's ``NoisePredictor`` leaves the block
to XLA, which fuses fc1's bias and ReLU and fc2's bias and the residual add
into its dot fusions; ``csrc/denoiser_block.cu`` is the port's hand-written
counterpart of that fusion. On the card the plain block is two cuBLAS GEMMs
and three elementwise passes over a [rows, 512] hidden layer in device
memory; the kernel keeps the hidden layer on the SM. It is bound by its
4 * rows * 256 * 512 FLOP on the bf16 tensor cores (0.127 ms for the direct
sampler's 240,000 rows at 989 TFLOP/s): a persistent grid of 128-row tiles,
one block an SM, each tile walking the hidden layer in 8 chunks of 64 (wgmma,
the first product's accumulator the register operand of the second), the
weight chunks double-buffered by TMA.

Both versions compute, for x [..., 256] and bf16 weights, the plain block's
rounding points: each product accumulated in float32 with its bias added
before one rounding to bf16, the ReLU on the rounded values, the residual add
rounded once. The kernel sums each product in its own order, so the two are
held to bf16 rounding (its error from the float32 block at most 1.1x the
plain version's), not to the same bits; on an H100 they gave the same bits at
every size tried, 1 to 240,000 rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import launch

FEATURES, HIDDEN = 256, 512


def denoiser_block_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``NoisePredictor``'s block in
    eval mode, ``F.linear -> F.relu -> F.linear -> + x``, op for op."""
    return F.linear(F.relu(F.linear(x, w1, b1)), w2, b2) + x


def _check(x, w1, b1, w2, b2) -> None:
    shapes = ((w1, (HIDDEN, FEATURES), "w1"), (b1, (HIDDEN,), "b1"),
              (w2, (FEATURES, HIDDEN), "w2"), (b2, (FEATURES,), "b2"))
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.shape[-1] != FEATURES:
        raise ValueError(f"x must be [..., {FEATURES}], got {tuple(x.shape)}")
    for t, shape, what in ((x, tuple(x.shape), "x"), *shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what} must be bfloat16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what} must be on {x.device}, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def denoiser_block_cuda(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/denoiser_block.cu`` on the current stream."""
    _check(x, w1, b1, w2, b2)
    out = torch.empty_like(x)
    rows = x.numel() // FEATURES
    if rows:
        launch("denoiser_block", x.device, x.data_ptr(), w1.data_ptr(),
               b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
               rows)
    return out


class _DenoiserBlock(torch.autograd.Function):
    """The kernel forward; the backward differentiates the plain version,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return denoiser_block_cuda(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = denoiser_block_plain(*inputs)
        grads = torch.autograd.grad(out, inputs, grad)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def takes_kernel(dtype: torch.dtype, features: int, hidden: int) -> bool:
    """Whether the kernel computes a block of these widths in ``dtype``: bf16
    at 256 -> 512 -> 256 (``Config()``'s). ``NoisePredictor`` decides from
    it, once, whether its eval-mode blocks take ``denoiser_block``."""
    return dtype == torch.bfloat16 and (features, hidden) == (FEATURES,
                                                              HIDDEN)


def denoiser_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``x + fc2(relu(fc1(x)))`` with the layers' weights already in x's
    dtype: the kernel for a CUDA tensor (which raises for one it does not
    compute, see ``takes_kernel``), the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return _DenoiserBlock.apply(x, w1, b1, w2, b2)
    return denoiser_block_plain(x, w1, b1, w2, b2)
