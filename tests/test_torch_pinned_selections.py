"""Pinned discrete selections of a training step (``draws["selections"]``):
the ReLU gates, the style encoder's max-pool argmaxes and the Chamfer's
argmins, recorded by one step and replayed by another.

* Recording changes nothing: a step that records gives the loss and the
  gradients of a step without ``selections`` bit for bit, and a step that
  replays its own record gives them again.
* The record holds what every gate and argmax the gradient follows was
  chosen on (pre-activations, pooled values, the Chamfer's points and
  argmins), keyed by where it sits in the network.
* A replayed selection is followed: ``pooled_max`` gathers at the pinned
  argmax, ``gated_relu`` passes the gradient where the pinned gate is set,
  ``MinSqDist``'s backward takes the pinned argmin; the forward values of
  ``MinSqDist`` stay the kernel's.
* The use the card-vs-CPU check makes of it (``chip_smoke.py``): a step
  whose weights moved by one ulp (as another device's rounding moves
  results) and that replays the first step's selections is held to the CPU
  tests' bars by part (``tests/test_torch_train_step.py``): 2e-5 of each
  tensor's largest |g| for the noise predictor, 2e-4 for the style head,
  5e-2 for the PointNet++ layers. The moved step's own selections differ
  from the first step's only at near-ties, and rarely
  (``chip_smoke.selection_flips``); a planted wrong argmin, argmax or gate
  is not a near-tie.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (DiffusionNet,
                                                    PointCloudDiffusionModel,
                                                    make_schedule)
from pointcloud_style_transfer_torch.models.networks import (gated_relu,
                                                             pooled_max)
from pointcloud_style_transfer_torch.ops import min_sq_dist
from pointcloud_style_transfer_torch.training import compute_losses

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (FLIP_SHARE, NEAR_TIE_ULPS,  # noqa: E402
                        selection_flips)

N, M, FEAT = 512, 128, 32
GRAD_RTOL = {"noise_predictor.": 2e-5, "style_encoder.fc": 2e-4,
             "style_encoder.encoder.": 5e-2}
KEYS = ({f"sa{i}.relu{j}" for i in (1, 2, 3) for j in range(3)}
        | {f"sa{i}.pool" for i in (1, 2, 3)}
        | {"fc1.relu", "fc2.relu", "pe0.relu", "pe1.relu", "out0.relu",
           "out1.relu", "chamfer_pt", "chamfer_tp"}
        | {f"block{i}.relu" for i in range(6)}
        | {f"chamfer_{d}.{p}" for d in ("pt", "tp") for p in ("query", "ref")})


def pre_bn_bias(name):
    return ".linears." in name and name.endswith(".bias")


def make_net(seed):
    """Weights of the port's own (Flax's) init from a torch seed."""
    torch.manual_seed(seed)
    return DiffusionNet(FEAT, 128)


def one_ulp_moved(net, seed):
    """A copy of ``net`` whose every float32 weight is moved by -1, 0 or +1
    ulp at random."""
    g = torch.Generator().manual_seed(seed)
    moved = DiffusionNet(FEAT, 128)
    state = {k: v * (1 + torch.randint(-1, 2, v.shape, generator=g).float()
                     * 2.0 ** -23) if v.is_floating_point() else v
             for k, v in net.state_dict().items()}
    moved.load_state_dict(state)
    return moved


def step_inputs(seed):
    """Clouds and every draw of a hierarchical float32 mini-step, from
    numpy. The condition cloud is dense so that the ball queries find
    neighbours."""
    rng = np.random.default_rng(seed)
    sim = torch.from_numpy(rng.standard_normal((1, N, 3)).astype(np.float32))
    real = torch.from_numpy(
        (rng.standard_normal((1, N, 3)) * 0.3).astype(np.float32))
    draws = dict(
        t=torch.tensor([500]),
        noise=torch.from_numpy(rng.standard_normal((1, N, 3), np.float32)),
        cond_priority=torch.from_numpy(rng.random((1, N), np.float32)),
        noisy_priority=torch.from_numpy(rng.random((1, N), np.float32)),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64),
        drop_u=torch.tensor([[0.5]]),
        style_dropout_mask=torch.from_numpy(rng.random((1, 512)) < 0.9),
        noise_dropout_masks=[torch.from_numpy(rng.random((1, M, FEAT)) < 0.9)
                             for _ in range(6)])
    return sim, real, draws


def step(net, inputs, selections=None):
    """(loss terms, gradients by parameter name) of one float32 mini-step."""
    cfg = Config(total_points=N, global_points=M, feature_dim=FEAT,
                 use_amp=False)
    sim, real, draws = inputs
    model = PointCloudDiffusionModel(cfg, "cpu", net=net)
    d = dict(draws)
    if selections is not None:
        d["selections"] = selections
    loss, terms = compute_losses(
        model, make_schedule(cfg), sim, real, train=True,
        cond_drop_prob=cfg.cond_drop_prob, chamfer_weight=cfg.lambda_chamfer,
        draws=d)
    params = dict(model.net.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return ({k: v.item() for k, v in terms.items()},
            dict(zip(params, grads)))


def test_recording_and_replaying_change_nothing():
    inputs = step_inputs(0)
    net = make_net(2)
    terms, grads = step(net, inputs)
    record = {}
    terms_r, grads_r = step(net, inputs, record)
    terms_p, grads_p = step(net, inputs, record)
    assert set(record) == KEYS
    assert terms_r == terms and terms_p == terms
    for name, g in grads.items():
        assert torch.equal(grads_r[name], g), name
        assert torch.equal(grads_p[name], g), name
    assert record["sa1.pool"].shape[:2] == (1, 512)
    assert record["sa1.pool"].shape[-1] == 128
    assert record["sa3.pool"].shape[:2] == (1, 1)
    assert record["block0.relu"].shape == (1, M, 2 * FEAT)
    assert record["chamfer_pt"].shape == (1, M)
    assert record["chamfer_pt.query"].shape == (1, M, 3)
    assert record["fc1.relu"].dtype == torch.float32


def test_pooled_max_follows_the_pinned_argmax():
    x = torch.tensor([[[1.0, 5.0], [3.0, 5.0], [2.0, 4.0]]],
                     requires_grad=True)  # [1, 3, 2], pooled over dim 1
    record = {}
    assert torch.equal(pooled_max(x, 1, record, "p"), x.max(1).values)
    assert torch.equal(record["p"], x.detach())
    pinned = {"p": torch.tensor([[[0.0, 0.0], [0.0, 1.0], [1.0, 0.0]]])}
    out = pooled_max(x, 1, pinned, "p")
    assert out.tolist() == [[2.0, 5.0]]
    out.sum().backward()
    assert x.grad.tolist() == [[[0.0, 0.0], [0.0, 1.0], [1.0, 0.0]]]


def test_gated_relu_follows_the_pinned_gate():
    x = torch.tensor([-1e-7, 2.0, 3e-8, -4.0], requires_grad=True)
    record = {}
    assert torch.equal(gated_relu(x, record, "g"), torch.relu(x))
    assert torch.equal(record["g"], x.detach())
    out = gated_relu(x, {"g": torch.tensor([1.0, 1.0, -1.0, 0.0])}, "g")
    assert out.tolist() == pytest.approx([-1e-7, 2.0, 0.0, 0.0])
    out.sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 0.0, 0.0]


def test_min_sq_dist_backward_follows_the_pinned_argmin():
    q = torch.tensor([[[0.0, 0.0, 0.0]]], requires_grad=True)
    r = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 2.0, 0.0]]], requires_grad=True)
    record = {}
    d = min_sq_dist(q, r, selections=record, key="a")
    assert d.item() == 1.0 and record["a"].tolist() == [[0]]
    assert torch.equal(record["a.query"], q.detach())
    assert torch.equal(record["a.ref"], r.detach())
    d = min_sq_dist(q, r, selections={"a": torch.tensor([[1]])}, key="a")
    assert d.item() == 1.0  # the forward value stays the kernel's minimum
    d.sum().backward()
    assert q.grad.tolist() == [[[0.0, -4.0, 0.0]]]  # 2 (q - r[1])
    assert r.grad.tolist() == [[[0.0, 0.0, 0.0], [0.0, 4.0, 0.0]]]
    with torch.no_grad():  # no gradient: the row minimum, nothing recorded
        record = {}
        min_sq_dist(q, r, selections=record, key="a")
        assert record == {}


def worst_by_part(grads, ref):
    worst = {}
    for name, g in grads.items():
        if pre_bn_bias(name):
            continue
        part = next(p for p in GRAD_RTOL if name.startswith(p))
        err = ((g - ref[name]).abs().max() / ref[name].abs().max()).item()
        worst[part] = max(worst.get(part, 0.0), err)
    return worst


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replayed_selections_leave_only_rounding(seed):
    inputs = step_inputs(seed)
    net = make_net(2)
    record = {}
    terms, grads = step(net, inputs, record)
    moved = one_ulp_moved(net, seed)
    terms_m, grads_m = step(moved, inputs, record)
    for k in terms:
        assert terms_m[k] == pytest.approx(terms[k], rel=1e-5)
    worst = worst_by_part(grads_m, grads)
    assert all(worst[p] <= GRAD_RTOL[p] for p in GRAD_RTOL), worst
    for name, g in grads_m.items():
        if pre_bn_bias(name):  # zero in exact arithmetic: rounding noise
            weight = grads_m[name[:-len("bias")] + "weight"]
            assert g.abs().max() <= 1e-3 * weight.abs().max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_own_selections_of_a_moved_step_are_near_ties(seed):
    inputs = step_inputs(seed)
    net = make_net(2)
    record, own = {}, {}
    step(net, inputs, record)
    step(one_ulp_moved(net, seed), inputs, own)
    choices = selection_flips(record, own)
    assert set(choices) == {k for k in KEYS
                            if not k.endswith((".query", ".ref"))}
    entries = sum(c[0] for c in choices.values())
    assert sum(c[1] for c in choices.values()) <= FLIP_SHARE * entries
    assert max(c[2] for c in choices.values()) <= NEAR_TIE_ULPS


def planted(record, kind):
    """A copy of ``record`` with one choice made wrong: the Chamfer argmin
    of query 0 moved to the ref farthest from it, the largest pooled value
    moved below its neighbours, or the gate with the largest pre-activation
    turned the other way."""
    bad = dict(record)
    if kind == "argmin":
        q, r = record["chamfer_pt.query"], record["chamfer_pt.ref"]
        idx = record["chamfer_pt"].clone()
        idx[0, 0] = ((r[0] - q[0, 0]) ** 2).sum(-1).argmax()
        bad["chamfer_pt"] = idx
    elif kind == "pool":
        x = record["sa2.pool"].clone()
        b, s, n, c = np.unravel_index(int(x.argmax()), tuple(x.shape))
        x[b, s, n, c] = x[b, s, :, c].min() - 1.0
        bad["sa2.pool"] = x
    else:
        x = record["block0.relu"].clone()
        i = x.abs().argmax()
        x.view(-1)[i] = -x.view(-1)[i]
        bad["block0.relu"] = x
    return bad


@pytest.mark.parametrize("kind", ["argmin", "pool", "gate"])
def test_a_planted_wrong_choice_is_no_near_tie(kind):
    inputs = step_inputs(0)
    record = {}
    step(make_net(2), inputs, record)
    choices = selection_flips(record, planted(record, kind))
    flipped = {k: c for k, c in choices.items() if c[1]}
    assert len(flipped) == 1
    (key, (_, flips, ulps)), = flipped.items()
    assert flips == 1 and ulps > NEAR_TIE_ULPS, (key, ulps)
