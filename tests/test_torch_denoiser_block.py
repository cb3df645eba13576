"""The denoiser's residual block as one op (``ops.kernels.denoiser_block``),
on the CPU: its plain version is the block's layers op for op, bit for bit;
``NoisePredictor`` sends eval-mode blocks through it and keeps train mode and
pinned gates on the layers, bit-identical to the code before the op; the
op's backward is the plain version's gradient. The kernel itself is held to
the plain version on the card in ``test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.models import NoisePredictor, networks
from pointcloud_style_transfer_torch.models.networks import (Dense, dropout,
                                                             gated_relu)
from pointcloud_style_transfer_torch.ops.kernels import (LAUNCH_COUNTS,
                                                         denoiser_block,
                                                         denoiser_block_cuda,
                                                         denoiser_block_plain,
                                                         takes_kernel)
from pointcloud_style_transfer_torch.ops.kernels import _common
from pointcloud_style_transfer_torch.ops.kernels import denoiser as block_mod

DTYPES = [torch.bfloat16, torch.float32]


def layers(dtype, seed=0):
    torch.manual_seed(seed)
    fc1, fc2 = Dense(256, 512, dtype), Dense(512, 256, dtype)
    with torch.no_grad():  # biases away from Flax's zeros
        fc1.bias.normal_(0, 0.1)
        fc2.bias.normal_(0, 0.1)
    return fc1, fc2


def weights(fc1, fc2, dtype):
    return (fc1.weight.to(dtype), fc1.bias.to(dtype), fc2.weight.to(dtype),
            fc2.bias.to(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 256), (127, 256), (128, 256),
                                   (1000, 256), (2, 3000, 256)])
def test_plain_is_the_blocks_layers_bit_for_bit(rng, dtype, shape):
    """``F.linear -> F.relu -> F.linear -> + x`` through the ``Dense``
    layers, as the eval block ran before the op."""
    fc1, fc2 = layers(dtype)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(dtype)
    with torch.no_grad():
        want = dropout(fc2(gated_relu(fc1(x))), False) + x
        got = denoiser_block(x, *weights(fc1, fc2, dtype))
        plain = denoiser_block_plain(x, *weights(fc1, fc2, dtype))
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)
    assert torch.equal(plain, want)


def old_forward(net, noisy_points, t, style_feat, train=False,
                dropout_masks=None, generator=None, selections=None):
    """``NoisePredictor.forward`` as it was before the op: every block on
    its layers."""
    masks = dropout_masks or [None] * len(net.blocks)
    sel = selections
    pe0, pe1, pe2 = net.point_encoder
    x = gated_relu(pe0(noisy_points), sel, "pe0.relu")
    x = pe2(gated_relu(pe1(x), sel, "pe1.relu"))
    t_feat = net.time_proj(networks.time_embedding(t, net.time_embed_dim))
    s_feat = net.style_proj(style_feat)
    x = x + t_feat[:, None, :] + s_feat[:, None, :]
    for i, ((fc1, fc2), keep) in enumerate(zip(net.blocks, masks)):
        h = gated_relu(fc1(x), sel, f"block{i}.relu")
        x = dropout(fc2(h), train, keep, generator) + x
    o0, o1, o2 = net.output_mlp
    x = gated_relu(o0(x), sel, "out0.relu")
    return o2(gated_relu(o1(x), sel, "out1.relu"))


def predictor_inputs(rng, dtype, B=2, N=96, F=256):
    torch.manual_seed(1)
    net = NoisePredictor(F, 128, compute_dtype=dtype)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn_like(p))
    x = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32))
    t = torch.tensor([5, 500][:B])
    style = torch.from_numpy(rng.standard_normal((B, F)).astype(np.float32))
    masks = [torch.from_numpy(rng.random((B, N, F)) < 0.9)
             for _ in net.blocks]
    return net, x, t, style, masks


@pytest.mark.parametrize("dtype", DTYPES)
def test_predictor_paths_bit_identical_to_before(rng, dtype):
    """Eval mode (now the op), train mode with given dropout masks, and the
    pinned gates (recording, then replaying a record) give the old code's
    bits."""
    net, x, t, style, masks = predictor_inputs(rng, dtype)
    with torch.no_grad():
        assert torch.equal(net(x, t, style), old_forward(net, x, t, style))
        assert torch.equal(
            net(x, t, style, train=True, dropout_masks=masks),
            old_forward(net, x, t, style, train=True, dropout_masks=masks))
    sel_new, sel_old = {}, {}
    got = net(x, t, style, selections=sel_new)
    want = old_forward(net, x, t, style, selections=sel_old)
    assert torch.equal(got, want)
    assert sel_new.keys() == sel_old.keys()
    assert all(torch.equal(sel_new[k], sel_old[k]) for k in sel_new)
    # a replayed record pins the gates: the same bits and the same gradient
    y = torch.from_numpy(rng.standard_normal((2, 96, 3)).astype(np.float32))
    got = net(y, t, style, train=True, dropout_masks=masks,
              selections=sel_new)
    grads = torch.autograd.grad(got.float().sum(), list(net.parameters()),
                                allow_unused=True)
    want = old_forward(net, y, t, style, train=True, dropout_masks=masks,
                       selections=sel_old)
    want_grads = torch.autograd.grad(want.float().sum(),
                                     list(net.parameters()),
                                     allow_unused=True)
    assert torch.equal(got, want)
    for g, w in zip(grads, want_grads):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("grad_mode", [False, True])
def test_eval_blocks_go_through_the_op(rng, monkeypatch, grad_mode):
    """``train=False`` without selections calls the op once a block, with or
    without grad; train mode and pinned gates never do."""
    net, x, t, style, masks = predictor_inputs(rng, torch.bfloat16, N=32)
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return denoiser_block(*args)

    monkeypatch.setattr(networks, "denoiser_block", spy)
    with torch.set_grad_enabled(grad_mode):
        net(x, t, style)
        assert calls == [torch.Size([2, 32, 256])] * 6
        calls.clear()
        net(x, t, style, train=True, dropout_masks=masks)
        net(x, t, style, selections={})
    assert calls == []


@pytest.mark.parametrize("dtype,F", [(torch.float32, 256),
                                     (torch.bfloat16, 128)])
def test_models_the_kernel_does_not_compute_keep_the_layers(rng, monkeypatch,
                                                           dtype, F):
    """A float32 model, or one at other widths, never calls the op (the
    wrapper would raise for it on the card): its eval blocks stay the
    layers, the old code's bits."""
    assert takes_kernel(torch.bfloat16, 256, 512)
    assert not takes_kernel(dtype, F, 2 * F)
    net, x, t, style, _ = predictor_inputs(rng, dtype, N=32, F=F)
    assert not net.fused_blocks
    calls = []
    monkeypatch.setattr(networks, "denoiser_block",
                        lambda *args: calls.append(args) or args[0])
    with torch.no_grad():
        assert torch.equal(net(x, t, style), old_forward(net, x, t, style))
    assert calls == []


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_backward_is_the_plain_gradient(rng, monkeypatch, dtype):
    """The autograd op's backward (here around the plain forward, as the
    kernel is the card's) gives the plain version's gradients bit for bit,
    for the input and every weight."""
    monkeypatch.setattr(block_mod, "denoiser_block_cuda",
                        lambda x, *w: denoiser_block_plain(x, *w))
    fc1, fc2 = layers(dtype, seed=3)
    x = torch.from_numpy(rng.standard_normal((2, 50, 256)).astype(np.float32)
                         ).to(dtype)
    g = torch.from_numpy(rng.standard_normal((2, 50, 256)).astype(np.float32)
                         ).to(dtype)
    ins = [x, *weights(fc1, fc2, dtype)]
    a = [t.detach().requires_grad_(True) for t in ins]
    b = [t.detach().requires_grad_(True) for t in ins]
    out = block_mod._DenoiserBlock.apply(*a)
    ref = denoiser_block_plain(*b)
    assert torch.equal(out, ref)
    want = torch.autograd.grad(ref, b, g)
    for ga, gb in zip(torch.autograd.grad(out, a, g), want):
        assert torch.equal(ga, gb)
    # gradients only where asked
    c = [x.detach().requires_grad_(True), *weights(fc1, fc2, dtype)]
    (gx,) = torch.autograd.grad(block_mod._DenoiserBlock.apply(*c), c[:1], g)
    assert torch.equal(gx, want[0])


def test_kernel_is_registered_and_wrapper_refuses_cpu():
    assert "denoiser_block" in LAUNCH_COUNTS
    source, entry = _common.KERNELS["denoiser_block"]
    assert entry in _common.SIGNATURES[source]
    assert (_common.CSRC / f"{source}.cu").exists()
    x = torch.zeros((4, 256), dtype=torch.bfloat16)
    w = weights(*layers(torch.bfloat16), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        denoiser_block_cuda(x, *w)
