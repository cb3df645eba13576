"""Point-E's point-diffusion transformer as the noise predictor: the second
denoiser beside ``networks.NoisePredictor``, and the one of the two that
mixes points.

``PointETransformer`` is ``PointDiffusionTransformer`` of
https://github.com/openai/point-e (``point_e/models/transformer.py``) with
token conditioning as in its ``CLIPImagePointDiffusionTransformer``, at
the widths of ``TransformerSpec`` (Point-E's presets ``base40M``,
``base300M``, ``base1B`` from ``point_e/models/configs.py``). With width d,
H heads of d / H channels and L blocks, a call on M noisy points x:

* tokens: ``h = input_proj(x)`` (3 -> d), the style token
  ``s = style_embed(style)`` (the style width -> d), the time token
  ``tau = time_embed(temb(t, d))`` (an MLP d -> 4d -> d with exact GELU;
  ``temb = cat(cos(t f), sin(t f))``, ``f_i = exp(-ln(1e4) i / (d / 2))``);
  the sequence ``[s, tau, h]`` of M + 2 tokens, with no positional
  encoding;
* ``ln_pre``, then L pre-LayerNorm blocks
  ``h = h + attn.c_proj(attention(attn.c_qkv(ln_1(h))))`` and
  ``h = h + mlp.c_proj(gelu(mlp.c_fc(ln_2(h))))``; LayerNorm affine, eps
  1e-5;
* attention: ``c_qkv``'s output is head-major, viewed as [B, T, H, 3 c]
  and split per head into q, k and v of c channels each (not [Q | K | V]);
  softmax over all T tokens of ``q k^T / sqrt(c)`` (Point-E scales q and k
  each by c^(-1/4)), no mask;
* ``ln_post``, the first two tokens dropped, ``output_proj`` (d -> 3): the
  noise of the M points.

Departures from Point-E: 3 input channels (xyz, no colour) and 3 output
channels (the noise alone: the samplers are DDIM, so there is no learned
variance half); the port's style vector stands in for the CLIP vector and
is not rescaled by sqrt(dim) (it is not unit-normalised as CLIP's is); the
unconditional copy zeroes the style vector, as the samplers' CFG already
does; the layers are initialised as ``networks.Dense`` (Point-E's
zero-initialised ``output_proj`` would predict zero noise until trained).

Parameters are float32; every product runs in the compute dtype (bf16 when
``Config.use_amp``), LayerNorm's statistics in float32, and attention is
``torch.nn.functional.scaled_dot_product_attention`` on [B, H, T, c]: on
the card restricted to its fused backends (flash, cuDNN, memory-efficient;
a call none of them takes raises rather than build the [B, H, T, T]
scores), on the CPU its plain (math) path. There is no dropout, and no
ReLU gate or max-pool to pin: a caller that passes ``selections`` gets an
error.

Its spans (``utils.profiling``): the host span ``denoiser.transformer``
around a call, and in it the device spans ``denoiser.attention`` and
``denoiser.mlp`` around each block's two sublayers (recorded only under
``recording_spans()``). Each attention call adds one to
``LAUNCH_COUNTS["attention"]`` (``ops.kernels``): L a call.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels._common import count_launch
from ..utils.profiling import annotate, device_span
from .networks import Dense

KIND = "point_e_transformer"


@dataclasses.dataclass(frozen=True)
class TransformerSpec:
    """The widths of a ``PointETransformer``."""
    width: int
    layers: int
    heads: int
    mlp_ratio: int = 4
    style_width: int = 256

    def __post_init__(self):
        if self.width % self.heads or self.width % 2:
            raise ValueError(f"width {self.width} must be even and divide "
                             f"into {self.heads} heads")

    def to_dict(self) -> dict:
        return {"kind": KIND, **dataclasses.asdict(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "TransformerSpec":
        d = dict(d)
        kind = d.pop("kind", KIND)
        if kind != KIND:
            raise ValueError(f"not a {KIND} spec: kind {kind!r}")
        return cls(**d)


# point_e/models/configs.py: base40M, base300M, base1B
PRESETS = {
    "base40M": TransformerSpec(width=512, layers=12, heads=8),
    "base300M": TransformerSpec(width=1024, layers=24, heads=16),
    "base1B": TransformerSpec(width=2048, layers=24, heads=32),
}


def denoiser_spec(d: Optional[dict]) -> Optional[TransformerSpec]:
    """The spec a checkpoint stores (``to_dict``), or None for the residual
    MLP (a checkpoint that stores none)."""
    return None if d is None else TransformerSpec.from_dict(d)


@functools.lru_cache(maxsize=None)
def _frequencies(half: int, device: torch.device) -> torch.Tensor:
    """exp(-ln(1e4) i / half), i < half, computed on the CPU (the same bits
    on every device, as ``networks._frequencies``)."""
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32) / half)
    return freqs.to(device)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Point-E's (GLIDE's) embedding [B] -> [B, dim] float32:
    ``cat(cos(t f), sin(t f))``."""
    args = t.float()[:, None] * _frequencies(dim // 2, t.device)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class LayerNorm(nn.LayerNorm):
    """Affine LayerNorm (eps 1e-5) over the trailing axis, in float32,
    returned in ``compute_dtype``."""

    def __init__(self, width: int, compute_dtype: torch.dtype):
        super().__init__(width, eps=1e-5)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


def attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Unmasked softmax attention of a head-major ``qkv`` [B, T, 3 d]
    (per head [q | k | v], c = d / heads channels each) -> [B, T, d]."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    B, T, three_d = qkv.shape
    c = three_d // (3 * heads)
    q, k, v = (z.transpose(1, 2) for z in
               qkv.view(B, T, heads, 3 * c).split(c, dim=-1))
    # on the card the fused backends alone: never the math path's scores
    backends = ([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                 SDPBackend.EFFICIENT_ATTENTION] if qkv.is_cuda
                else [SDPBackend.MATH])
    with sdpa_kernel(backends):
        o = F.scaled_dot_product_attention(q, k, v)  # scale 1 / sqrt(c)
    count_launch("attention")
    return o.transpose(1, 2).reshape(B, T, heads * c)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int, compute_dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.c_qkv = Dense(width, 3 * width, compute_dtype)
        self.c_proj = Dense(width, width, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(attention(self.c_qkv(x), self.heads))


class MLP(nn.Module):
    """d -> ratio d -> d with exact GELU."""

    def __init__(self, width: int, hidden: int, compute_dtype: torch.dtype):
        super().__init__()
        self.c_fc = Dense(width, hidden, compute_dtype)
        self.c_proj = Dense(hidden, width, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualBlock(nn.Module):
    def __init__(self, spec: TransformerSpec, compute_dtype: torch.dtype):
        super().__init__()
        d = spec.width
        self.ln_1 = LayerNorm(d, compute_dtype)
        self.attn = Attention(d, spec.heads, compute_dtype)
        self.ln_2 = LayerNorm(d, compute_dtype)
        self.mlp = MLP(d, spec.mlp_ratio * d, compute_dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        with device_span("denoiser.attention"):
            h = h + self.attn(self.ln_1(h))
        with device_span("denoiser.mlp"):
            h = h + self.mlp(self.ln_2(h))
        return h


class Backbone(nn.Module):
    def __init__(self, spec: TransformerSpec, compute_dtype: torch.dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualBlock(spec, compute_dtype)
                                       for _ in range(spec.layers))


class PointETransformer(nn.Module):
    """The noise predictor of Point-E's transformer (module docstring),
    with ``NoisePredictor``'s call signature."""

    mixes_points = True  # a point's noise depends on the others'

    def __init__(self, spec: TransformerSpec,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        d, dt = spec.width, compute_dtype
        self.spec = spec
        self.input_proj = Dense(3, d, dt)
        self.style_embed = Dense(spec.style_width, d, dt)
        self.time_embed = MLP(d, 4 * d, dt)
        self.ln_pre = LayerNorm(d, dt)
        self.backbone = Backbone(spec, dt)
        self.ln_post = LayerNorm(d, dt)
        self.output_proj = Dense(d, 3, dt)

    def forward(self, noisy_points: torch.Tensor, t: torch.Tensor,
                style_feat: torch.Tensor, train: bool = False,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                selections: Optional[dict] = None) -> torch.Tensor:
        """Noise [B, M, 3] (compute dtype) of points [B, M, 3] at timesteps
        ``t`` [B] under style vectors [B, style_width]. ``train`` changes
        nothing (no dropout, no batch statistics); ``dropout_masks`` must
        be empty."""
        if selections is not None:
            raise ValueError("PointETransformer has no ReLU gates or "
                             "max-pools to pin: selections are not taken")
        if dropout_masks:
            raise ValueError("PointETransformer has no dropout: "
                             "dropout_masks are not taken")
        with annotate("denoiser.transformer"):
            h = self.input_proj(noisy_points)
            s = self.style_embed(style_feat)
            tau = self.time_embed(timestep_embedding(t, self.spec.width))
            h = torch.cat([s[:, None].to(h.dtype), tau[:, None].to(h.dtype),
                           h], dim=1)
            h = self.ln_pre(h)
            for block in self.backbone.resblocks:
                h = block(h)
            h = self.ln_post(h)
            return self.output_proj(h[:, 2:])

