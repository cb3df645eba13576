"""Spawned gloo process groups for the port's multi-rank tests on the CPU,
and the functions their ranks run.

``run_group(fn, world, tmp)`` spawns ``world`` processes that join one gloo
group through a file store in ``tmp`` (no port is bound, so parallel test
workers cannot collide), run ``fn(rank, world, tmp)`` with one thread each,
and leave what ``fn`` returns (a dict of arrays) in ``tmp`` as ``.npy``
files; it returns those, one dict a rank. ``start_group`` and
``join_group`` are its two halves, so that a test's groups and its own
work overlap. The group gets a deadline: past it the processes are
terminated and the test fails, so a hung collective costs seconds, not the
suite's time limit. A collective waits at most ``TIMEOUT_S``.

This module imports no JAX: a spawned child imports the module that holds
its function, and JAX in every child would cost seconds and memory for
nothing. The tests compare what the ranks return with the JAX package in
the parent. Inputs go to the ranks as files in ``tmp`` (``inputs.npz``,
``weights.pt``), written by the parent.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import json
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 60  # a collective's wait
DEADLINE_S = 240  # a group's whole run


def _child(rank: int, world: int, fn, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(rank, world, tmp)
    finally:
        dist.destroy_process_group()
    rank_dir = Path(tmp, f"rank{rank}")
    rank_dir.mkdir()
    for name, value in out.items():
        np.save(rank_dir / f"{name}.npy", np.asarray(value))


def start_group(fn, world: int, tmp, deadline: float = DEADLINE_S):
    """Spawn ``world`` ranks running ``fn`` and return at once; the group's
    deadline counts from now. ``join_group`` collects it, so that the
    parent (or another group) works meanwhile."""
    tmp = str(tmp)
    ctx = mp.start_processes(_child, args=(world, fn, tmp), nprocs=world,
                             join=False, start_method="spawn")
    return ctx, time.monotonic() + deadline, fn.__name__, world, tmp


def join_group(group) -> list[dict]:
    """Each rank's arrays of a ``start_group`` group. Raises if a rank
    raised or the group is still running at its deadline (its processes
    are terminated either way)."""
    ctx, end, name, world, tmp = group
    try:
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            if time.monotonic() >= end:
                raise TimeoutError(f"{world}-rank group of {name} still "
                                   f"running at its deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    return [{f.stem: np.load(f) for f in sorted(Path(tmp, f"rank{r}")
                                                .glob("*.npy"))}
            for r in range(world)]


def join_groups(*groups) -> list[list[dict]]:
    """``join_group`` of every group, in order; every group is collected
    (or terminated) before the first failure is raised."""
    out, errors = [], []
    for g in groups:
        try:
            out.append(join_group(g))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)
    if errors:
        raise errors[0]
    return out


def run_group(fn, world: int, tmp, deadline: float = DEADLINE_S
              ) -> list[dict]:
    """Run ``fn`` on ``world`` spawned ranks; returns each rank's arrays.
    Raises if a rank raises or the group is still running at
    ``deadline`` seconds."""
    return join_group(start_group(fn, world, tmp, deadline))


def _inputs(tmp: str) -> dict:
    with np.load(os.path.join(tmp, "inputs.npz")) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def _flat(tensors) -> np.ndarray:
    return torch.cat([t.detach().reshape(-1).float()
                      for t in tensors]).numpy()


# -- ring (tests/test_torch_ring.py) -------------------------------------

RING_MESHES = {2: {"p2": {"points": 2}},
               4: {"p4": {"points": 4}, "d2p2": {"data": 2, "points": 2}}}


def ring_ranks(rank: int, world: int, tmp: str) -> dict:
    """Every ring case of one world: per mesh, this rank's ring minima,
    kNN (random and lattice points), both Chamfers of its shards, and the
    metrics' Chamfer with the mesh (divisible and not); the mesh checks at
    world 4; the ``Tester`` at both."""
    from pointcloud_style_transfer_torch.evaluation.metrics import \
        chamfer_distance
    from pointcloud_style_transfer_torch.parallel import make_mesh
    from pointcloud_style_transfer_torch.parallel.mesh import (
        POINTS_AXIS, axis_rank, local_slice)
    from pointcloud_style_transfer_torch.parallel.ring import (
        ring_chamfer_distance, ring_chamfer_distance_l2, ring_knn,
        ring_min_sq_dist)

    x = _inputs(tmp)
    out = {}
    for tag, shape in RING_MESHES[world].items():
        mesh = make_mesh(shape, "cpu")
        out[f"{tag}.coord"] = [axis_rank(mesh, POINTS_AXIS)]

        def loc(t):
            return local_slice(t, 1, mesh, POINTS_AXIS)
        out[f"{tag}.min"] = ring_min_sq_dist(loc(x["q"]), loc(x["r"]), mesh)
        out[f"{tag}.min_nan"] = ring_min_sq_dist(loc(x["q"]),
                                                 loc(x["r_nan"]), mesh)
        for name, q, r in (("knn", x["q"], x["r"]),
                           ("lattice", x["ql"], x["rl"])):
            d, i = ring_knn(loc(q), loc(r), 3, mesh)
            out[f"{tag}.{name}_d"], out[f"{tag}.{name}_i"] = d, i
        out[f"{tag}.chamfer"] = ring_chamfer_distance(loc(x["a"]),
                                                      loc(x["b"]), mesh)
        out[f"{tag}.chamfer_l2"] = ring_chamfer_distance_l2(
            loc(x["a"]), loc(x["b"]), mesh)
        out[f"{tag}.metric"] = chamfer_distance(x["pred"], x["tgt"],
                                                mesh=mesh)
        out[f"{tag}.metric_odd"] = chamfer_distance(x["pred"][:, :-1],
                                                    x["tgt"], mesh=mesh)
    if world == 4:
        out.update(_mesh_checks())
    out.update(_tester_run(rank, tmp))
    return out


def _mesh_checks() -> dict:
    from pointcloud_style_transfer_torch.parallel import (
        batch_sharding, make_mesh, replicated)
    from pointcloud_style_transfer_torch.parallel.mesh import (axis_rank,
                                                               check_backend)

    try:  # CUDA tensors on this gloo group
        check_backend("cuda")
        mismatch = 0
    except ValueError:
        mismatch = 1
    default = make_mesh(device_type="cpu")
    two_d = make_mesh({"data": 2, "points": 2}, "cpu")
    try:
        make_mesh({"data": 8}, "cpu")
        too_big = 0
    except ValueError:
        too_big = 1
    sub = make_mesh({"data": 2}, "cpu")  # the first two ranks
    try:
        sub_rank = axis_rank(sub, "data")
    except ValueError:
        sub_rank = -1
    return {"mesh.default": [list(default.mesh_dim_names) == ["data"],
                             default.size()],
            "mesh.two_d": list(two_d.mesh.shape) + [two_d.ndim],
            "mesh.too_big_raises": [too_big],
            "mesh.backend_mismatch_raises": [mismatch],
            "mesh.placements": [str(replicated(two_d)),
                                str(batch_sharding(two_d)),
                                str(batch_sharding(two_d, True))],
            "mesh.subset_rank": [sub_rank]}


def _tester_run(rank: int, tmp: str) -> dict:
    from pointcloud_style_transfer_torch.cli import test as port_test

    out_dir = os.path.join(tmp, f"tester_rank{rank}")
    with open(os.path.join(tmp, "tester_args.json")) as f:
        args = json.load(f)
    rc = port_test.main(args + ["--output_dir", out_dir])
    files = sorted(str(p.relative_to(out_dir))
                   for p in Path(out_dir).rglob("*")) \
        if os.path.isdir(out_dir) else []
    with open(os.path.join(tmp, f"tester_files{rank}.json"), "w") as f:
        json.dump(files, f)
    return {"tester.rc": [rc]}


# -- sharded train/eval steps (tests/test_torch_sharded_step.py) --------

STEP_CFG = dict(total_points=256, global_points=64, feature_dim=16,
                time_embed_dim=8, num_timesteps=10, use_amp=False,
                gradient_accumulation_steps=1)
STEP_LR = 1e-3
STEP_MESHES = {2: ({"data": 2}, False), 4: ({"data": 2, "points": 2}, True)}


def _step_model(tmp: str):
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.models import (
        PointCloudDiffusionModel, make_schedule)
    from pointcloud_style_transfer_torch.training import (ema_init,
                                                          make_optimizer)

    cfg = Config(**STEP_CFG)
    model = PointCloudDiffusionModel(cfg, device="cpu")
    model.net.load_state_dict(torch.load(os.path.join(tmp, "weights.pt")))
    params = dict(model.net.named_parameters())
    opt = make_optimizer(cfg, params)
    grads = []
    step = opt.step

    def recorded(p, g, lr):
        grads.append(_flat(g))
        return step(p, g, lr)
    opt.step = recorded
    return cfg, model, make_schedule(cfg), opt, ema_init(params), grads


def _step_state(prefix: str, model, terms, grads, ema) -> dict:
    return {f"{prefix}.loss": [float(terms[k]) for k in sorted(terms)],
            f"{prefix}.grads": grads[-1],
            f"{prefix}.stats": _flat(dict(model.net.named_buffers())
                                     .values()),
            f"{prefix}.ema": _flat(ema.values()),
            f"{prefix}.params": _flat(model.net.parameters())}


def step_ranks(rank: int, world: int, tmp: str) -> dict:
    """The single-device train step on the global batch (rank 0, recording
    its discrete selections), then on every rank the sharded step with the
    same draws replaying those selections, its per-rank BatchNorm negative
    control, the eval steps, and at world 2 ``DiffusionTrainer`` with
    ``mesh_shape={"data": 2}``."""
    from pointcloud_style_transfer_torch.parallel import (
        make_mesh, make_sharded_eval_step, make_sharded_train_step,
        shard_batch)
    from pointcloud_style_transfer_torch.parallel import sharded
    from pointcloud_style_transfer_torch.training import (eval_step,
                                                          train_step)
    from pointcloud_style_transfer_torch.training.trainer import step_draws

    x = _inputs(tmp)
    shape, shard_points = STEP_MESHES[world]
    mesh = make_mesh(shape, "cpu")
    B, N = x["sim"].shape[:2]
    out = {}

    def draws_of(model, train, seed):
        return step_draws(model, B, N, N, train=train,
                          generator=torch.Generator().manual_seed(seed))

    selections = [None]
    if rank == 0:  # the single-device step on the global batch
        cfg, model, schedule, opt, ema, grads = _step_model(tmp)
        draws = {**draws_of(model, True, 7), "selections": {}}
        terms, _ = train_step(model, schedule, opt, ema, x["sim"],
                              x["real"], STEP_LR, draws=draws)
        out.update(_step_state("single", model, terms, grads, ema))
        e_terms = eval_step(model, schedule, ema, x["sim"], x["real"],
                            draws=draws_of(model, False, 8))
        out["single.eval"] = [float(e_terms[k]) for k in sorted(e_terms)]
        selections = [draws["selections"]]
    dist.broadcast_object_list(selections, src=0)

    sim = shard_batch(x["sim"], mesh, shard_points)
    real = shard_batch(x["real"], mesh, shard_points)

    def sharded_step(prefix):
        cfg, model, schedule, opt, ema, grads = _step_model(tmp)
        draws = {**draws_of(model, True, 7), "selections": selections[0]}
        step = make_sharded_train_step(model, schedule, opt, cfg, mesh,
                                       shard_points)
        terms, _ = step(ema, sim, real, STEP_LR, draws=draws)
        out.update(_step_state(prefix, model, terms, grads, ema))
        return cfg, model, schedule, ema

    cfg, model, schedule, ema = sharded_step("sharded")
    eval_fn = make_sharded_eval_step(model, schedule, cfg, mesh,
                                     shard_points)
    e_terms = eval_fn(ema, sim, real, draws=draws_of(model, False, 8))
    out["sharded.eval"] = [float(e_terms[k]) for k in sorted(e_terms)]

    reduce = sharded._batch_stats_reduce
    sharded._batch_stats_reduce = lambda group: (lambda t: t)
    try:  # negative control: each rank's own BatchNorm statistics
        sharded_step("per_rank_bn")
    finally:
        sharded._batch_stats_reduce = reduce
    if world == 2:
        out.update(_trainer_run(rank, tmp))
    return out


def _trainer_run(rank: int, tmp: str) -> dict:
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.data import create_dataloaders
    from pointcloud_style_transfer_torch.training import DiffusionTrainer

    runs = os.path.join(tmp, f"trainer_rank{rank}")
    cfg = Config(**{**STEP_CFG, "gradient_accumulation_steps": 2},
                 experiment_name="mesh", processed_data_dir=os.path.join(
                     tmp, "processed"), checkpoint_dir=os.path.join(
                     runs, "ckpt"), log_dir=os.path.join(runs, "logs"),
                 result_dir=os.path.join(runs, "results"), num_epochs=1,
                 val_interval=1, warmup_epochs=1, batch_size=2,
                 num_workers=0, mesh_shape={"data": 2})
    train_loader, val_loader = create_dataloaders(cfg)
    ragged = [len(b["sim_full"]) for b in val_loader]
    trainer = DiffusionTrainer(cfg, resume=False, device="cpu")
    best = trainer.train(train_loader, val_loader)
    files = sorted(str(p.relative_to(runs)) for p in Path(runs).rglob("*")
                   if p.is_file()) if os.path.isdir(runs) else []
    with open(os.path.join(tmp, f"trainer_files{rank}.json"), "w") as f:
        json.dump(files, f)
    # resume: only rank 0's checkpoint_dir holds a checkpoint
    resumed = DiffusionTrainer(cfg, resume=True, device="cpu")
    opt = resumed.optimizer
    return {"trainer.best": [best], "trainer.val_batches": ragged,
            "trainer.params": _flat(trainer.params.values()),
            "resumed.epoch_best": [resumed.start_epoch,
                                   resumed.best_val_loss],
            "resumed.opt": np.concatenate([
                _flat([opt.mu, opt.nu, opt.acc_grads]),
                [int(c) for c in (opt.mini_step, opt.gradient_step,
                                  opt.count)]]),
            "resumed.params": _flat(resumed.params.values()),
            "trained.opt": _flat([trainer.optimizer.mu])}


# -- samplers (tests/test_torch_sharded_sampler.py) ---------------------

SAMPLER_CFG = dict(total_points=256, global_points=64, feature_dim=16,
                   time_embed_dim=8, num_timesteps=10, use_amp=False,
                   knn_backend="pallas")
SAMPLER_STEPS = 3
# a grid small enough that 64 coarse points run its slot-run path
SAMPLER_GRID = dict(grid_shape=(2, 2, 2), tq=32, slot_cap=128)


def _sampler_model(tmp: str, **kw):
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.models import (
        PointCloudDiffusionModel, make_schedule)

    with open(os.path.join(tmp, "sampler_cfg.json")) as f:
        cfg = Config(**{**json.load(f), **kw})
    model = PointCloudDiffusionModel(cfg, device="cpu")
    model.net.load_state_dict(torch.load(os.path.join(tmp, "weights.pt")))
    return model, make_schedule(cfg)


def sharded_sampler_ranks(rank: int, world: int, tmp: str) -> dict:
    """``guided_sample_loop_sharded`` over {points: world}: with the
    brute-force kNN, with the grid, with ``_TEST_SHARD_OFFSET = 1``, on the
    direct path; and on rank 0 ``guided_sample_loop`` on the same inputs
    and draws for each."""
    from pointcloud_style_transfer_torch.models import guided_sample_loop
    from pointcloud_style_transfer_torch.ops import grid_knn
    from pointcloud_style_transfer_torch.parallel import make_mesh
    from pointcloud_style_transfer_torch.parallel import sharded_sampler

    grid_knn.grid_knn_interpolate_layout = functools.partial(
        grid_knn.grid_knn_interpolate_layout, **SAMPLER_GRID)
    x = _inputs(tmp)
    mesh = make_mesh({"points": world}, "cpu")
    draws = dict(x_init=x["x_init"], cond_priority=x["cond_priority"],
                 step_priorities=x["step_priorities"],
                 fps_starts=x["fps_starts"])
    direct = dict(x_init=x["x_init"][:, :64], fps_starts=x["fps_starts"])
    cases = {"brute": ({}, x["src"], x["cond"], draws),
             "grid": ({"knn_backend": "grid"}, x["src"], x["cond"], draws),
             "direct": ({}, x["src"][:, :64], x["cond"][:, :64], direct)}
    out = {}
    for name, (kw, src, cond, d) in cases.items():
        model, schedule = _sampler_model(tmp, **kw)
        run = dict(num_inference_steps=SAMPLER_STEPS, guidance_scale=7.5,
                   **d)
        out[f"{name}.sharded"] = sharded_sampler.guided_sample_loop_sharded(
            model, schedule, src, cond, mesh, **run)
        if name == "brute":
            sharded_sampler._TEST_SHARD_OFFSET = 1
            try:
                out["offset.sharded"] = \
                    sharded_sampler.guided_sample_loop_sharded(
                        model, schedule, src, cond, mesh, **run)
            finally:
                sharded_sampler._TEST_SHARD_OFFSET = 0
        if rank == 0:
            out[f"{name}.single"] = guided_sample_loop(
                model, schedule, src, cond, **run)
    return out


def small_sampler_grid() -> None:
    """The grid's interpolation and its recording kNN at ``SAMPLER_GRID``,
    which 64 coarse points engage."""
    from pointcloud_style_transfer_torch.ops import distance, grid_knn

    grid_knn.grid_knn_interpolate_layout = functools.partial(
        grid_knn.grid_knn_interpolate_layout, **SAMPLER_GRID)
    distance.grid_knn = functools.partial(grid_knn.grid_knn, **SAMPLER_GRID)


def selections_ranks(rank: int, world: int, tmp: str) -> dict:
    """``guided_sample_loop(mesh={points: world}, selections=...)`` on the
    kd-grid, replaying the one-process run's recorded choices
    (``selections.pt``) and, as a negative control, those choices with
    each step's neighbours shifted by one query row
    (``selections_shifted.pt``), with the same draws."""
    from pointcloud_style_transfer_torch.models import guided_sample_loop
    from pointcloud_style_transfer_torch.parallel import make_mesh

    small_sampler_grid()
    x = _inputs(tmp)
    mesh = make_mesh({"points": world}, "cpu")
    model, schedule = _sampler_model(tmp)
    out = {}
    for name in ("selections", "selections_shifted"):
        recorded = torch.load(os.path.join(tmp, f"{name}.pt"))
        out[name] = guided_sample_loop(
            model, schedule, x["src"], x["cond"], SAMPLER_STEPS, 7.5,
            mesh=mesh, selections=dict(recorded), **_sampler_draws(x))
    return out


def dp_sampler_ranks(rank: int, world: int, tmp: str) -> dict:
    """``guided_sample_loop_dp`` over {data: world} with each group's draws
    and with seeded generators, each rank's group also sampled alone by
    ``guided_sample_loop``, and a batch the axis does not divide."""
    from pointcloud_style_transfer_torch.models import guided_sample_loop
    from pointcloud_style_transfer_torch.parallel import (
        guided_sample_loop_dp, make_mesh)
    from pointcloud_style_transfer_torch.parallel.sharded_sampler import \
        group_seed

    x = _inputs(tmp)
    model, schedule = _sampler_model(tmp)
    mesh = make_mesh({"data": world}, "cpu")
    B = x["src"].shape[0]
    b = B // world
    draws = [dict(x_init=x["x_init"][g * b:(g + 1) * b],
                  fps_starts=x["fps_starts"][:, g * b:(g + 1) * b])
             for g in range(world)]
    run = dict(num_inference_steps=int(x["steps"]), guidance_scale=7.5)
    out = {"dp.draws": guided_sample_loop_dp(
        model, schedule, x["src"], x["cond"], mesh, draws=draws, **run),
        "dp.seeded": guided_sample_loop_dp(
            model, schedule, x["src"], x["cond"], mesh, seed=3, **run)}
    mine = slice(rank * b, (rank + 1) * b)
    out["single.draws"] = guided_sample_loop(
        model, schedule, x["src"][mine], x["cond"][mine], **draws[rank],
        **run)
    out["single.seeded"] = guided_sample_loop(
        model, schedule, x["src"][mine], x["cond"][mine],
        generator=torch.Generator().manual_seed(group_seed(3, rank)), **run)
    try:
        guided_sample_loop_dp(model, schedule, x["src"][:B - 1],
                              x["cond"][:B - 1], mesh, **run)
        out["dp.ragged_raises"] = [0]
    except ValueError as e:
        out["dp.ragged_raises"] = ["not divisible" in str(e)]
    return out


# -- the multi-rank paths through the capture runner
#    (tests/test_torch_mesh_graph.py) -----------------------------------

class FakeGraph:
    """A stand-in for a CUDA graph on the CPU: a replay runs the body on
    the static inputs and copies its outputs (a tensor or a tree) into the
    static ones, and logs ``"replay"``."""

    def __init__(self, body, static, output, log):
        self.body, self.static, self.output, self.log = (body, static,
                                                         output, log)

    def replay(self):
        from torch.utils._pytree import tree_flatten
        self.log.append("replay")
        new = self.body(self.static)
        for o, n in zip(tree_flatten(self.output)[0],
                        tree_flatten(new)[0]):
            o.copy_(n)


class Owner:
    """An object a graph reads (the runner holds a weak reference)."""


class RunnerLog(list):
    """The branches a stand-in runner took, in order (``"eager"``,
    ``"capture"``, ``"replay"``); ``state`` holds the tensors a body
    writes in place, which a stand-in capture puts back as a CUDA capture
    leaves them; ``fail`` makes the next capture raise."""

    def __init__(self):
        super().__init__()
        self.state, self.fail = [], False


@contextlib.contextmanager
def fake_runner():
    """``models.capture`` with CPU stand-ins for its eager run and its
    capture (the body run once, the state put back), empty caches, and the
    samplers routed through it on the CPU. Yields the ``RunnerLog``."""
    from pointcloud_style_transfer_torch.models import capture, samplers
    from torch.utils._pytree import tree_map

    log = RunnerLog()

    def eager(body, inputs):
        log.append("eager")
        return body(inputs)

    def fake_capture(body, inputs):
        if log.fail:
            raise RuntimeError("the stand-in capture failed")
        log.append("capture")
        static = {n: t.clone() for n, t in inputs.items()}
        saved = [t.detach().clone() for t in log.state]
        output = tree_map(lambda t: t.detach().clone(), body(static))
        with torch.no_grad():
            for t, s in zip(log.state, saved):
                t.copy_(s)
        return capture._Graph(FakeGraph(body, static, output, log), static,
                              output, None, {})
    own = (capture._eager, capture._capture, capture._ENTRIES,
           samplers._graphed)
    capture._eager, capture._capture, capture._ENTRIES = (eager, fake_capture,
                                                          {})
    samplers._graphed = lambda device: True
    try:
        yield log
    finally:
        (capture._eager, capture._capture, capture._ENTRIES,
         samplers._graphed) = own


def routed(trainer):
    """``trainer`` with its steps through the capture runner on the CPU
    (``DiffusionTrainer._graphed``'s rule without its device check)."""
    trainer._graphed = lambda draws: not (draws and "selections" in draws)
    return trainer


def trainer_state(t) -> list:
    """Every tensor a step writes in place."""
    return [*t.params.values(), *t.model.net.buffers(),
            *t.optimizer.tensors().values(), *t.ema_params.values()]


def _sampler_draws(x) -> dict:
    return dict(x_init=x["x_init"], cond_priority=x["cond_priority"],
                step_priorities=x["step_priorities"],
                fps_starts=x["fps_starts"])


def mesh_graph_ranks(rank: int, world: int, tmp: str) -> dict:
    """The meshed sampler and the meshed trainer's steps routed through
    the capture runner (CPU stand-ins) against their eager runs, the
    runner's keys on several meshes, the meshed bodies under
    ``NoSyncGuard``, and at world 2 the ranks' agreement on branches and
    on a failed capture."""
    from pointcloud_style_transfer_torch.ops import grid_knn

    grid_knn.grid_knn_interpolate_layout = functools.partial(
        grid_knn.grid_knn_interpolate_layout, **SAMPLER_GRID)
    out = {}
    out.update(_routed_sampler(world, tmp))
    out.update(_routed_steps(world, tmp))
    out.update(_keys_apart(world, tmp))
    out.update(_guarded_bodies(world, tmp))
    if world == 2:
        out.update(_agreement(rank))
        out.update(_failed_capture(rank))
    return out


def _routed_sampler(world: int, tmp: str) -> dict:
    """``guided_sample_loop(mesh=)`` on {points: world}, brute and grid:
    the eager call, then three calls through the runner."""
    from pointcloud_style_transfer_torch.models import guided_sample_loop
    from pointcloud_style_transfer_torch.parallel import make_mesh

    x = _inputs(tmp)
    mesh = make_mesh({"points": world}, "cpu")
    out = {}
    for name, kw in (("brute", {}), ("grid", {"knn_backend": "grid"})):
        model, schedule = _sampler_model(tmp, **kw)

        def run():
            return guided_sample_loop(model, schedule, x["src"], x["cond"],
                                      SAMPLER_STEPS, 7.5, mesh=mesh,
                                      **_sampler_draws(x))
        out[f"sampler.{name}.eager"] = run()
        with fake_runner() as log:
            out[f"sampler.{name}.routed"] = torch.stack([run()
                                                         for _ in range(3)])
        out[f"sampler.{name}.branches"] = list(log)
    return out


def mesh_trainer(tmp: str, name: str, shape: dict, shard_points: bool):
    """A ``DiffusionTrainer`` over ``shape`` at ``STEP_CFG`` (accumulation
    2), its layout point-sharded with ``shard_points``."""
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.parallel.sharded import StepLayout
    from pointcloud_style_transfer_torch.training import DiffusionTrainer

    runs = os.path.join(tmp, f"{name}_rank{dist.get_rank()}")
    cfg = Config(**{**STEP_CFG, "gradient_accumulation_steps": 2},
                 experiment_name=name, mesh_shape=shape,
                 checkpoint_dir=os.path.join(runs, "ckpt"),
                 log_dir=os.path.join(runs, "logs"),
                 result_dir=os.path.join(runs, "results"))
    t = DiffusionTrainer(cfg, resume=False, device="cpu")
    if shard_points:
        t.layout = StepLayout(t.mesh, shard_points=True)
    return t


def _routed_steps(world: int, tmp: str) -> dict:
    """On ``STEP_MESHES[world]``: an eager and a routed trainer, 4
    mini-steps and 3 eval steps each; the first 2 mini-steps and the first
    eval step with the global batch's draws given, the others drawn from
    each trainer's own generator (by the routed one in ``_captured``, by
    the eager one in ``StepLayout.localize``)."""
    from pointcloud_style_transfer_torch.parallel import shard_batch
    from pointcloud_style_transfer_torch.training.trainer import step_draws

    x = _inputs(tmp)
    shape, shard_points = STEP_MESHES[world]
    B, N = x["sim"].shape[:2]
    out = {}
    for mode in ("eager", "routed"):
        t = mesh_trainer(tmp, mode, shape, shard_points)
        sim, real = (shard_batch(x[k], t.mesh, shard_points)
                     for k in ("sim", "real"))
        seeded = t.generator.get_state()

        def draws(train, seed, given):
            return step_draws(t.model, B, N, N, train=train,
                              generator=torch.Generator().manual_seed(seed)
                              ) if given else None
        run = fake_runner() if mode == "routed" else \
            contextlib.nullcontext(RunnerLog())
        with run as log:
            if mode == "routed":
                routed(t)
                log.state = trainer_state(t)
            terms, emits, evals = [], [], []
            for i in range(4):
                ld, emit = t.train_step(sim, real, STEP_LR,
                                        draws=draws(True, 100 + i, i < 2))
                terms.append(torch.stack([ld[k] for k in sorted(ld)]))
                emits.append(bool(emit))
            for i in range(3):
                ld = t.eval_step(sim, real, draws=draws(False, 200, i < 1))
                evals.append(torch.stack([ld[k] for k in sorted(ld)]))
        prefix = f"steps.{mode}"
        out.update({f"{prefix}.terms": torch.stack(terms),
                    f"{prefix}.emits": emits,
                    f"{prefix}.evals": torch.stack(evals),
                    f"{prefix}.state": _flat(trainer_state(t)),
                    f"{prefix}.generator": t.generator.get_state(),
                    f"{prefix}.seeded": seeded,
                    f"{prefix}.branches": list(log) or ["none"]})
    return out


def _keys_apart(world: int, tmp: str) -> dict:
    """The runner's keys on two meshes, with the test offset, and of two
    step layouts: the sampler through the runner on {points: world} twice
    (eager, captured), then on the other mesh and with
    ``_TEST_SHARD_OFFSET = 1`` (each a new key: eager), then on the first
    again (a replay); every rank's split and layout keys."""
    from pointcloud_style_transfer_torch.models import guided_sample_loop
    from pointcloud_style_transfer_torch.parallel import (make_mesh,
                                                          sharded_sampler)
    from pointcloud_style_transfer_torch.parallel.sharded import StepLayout

    x = _inputs(tmp)
    model, schedule = _sampler_model(tmp)
    other = {"data": 2, "points": 2} if world == 4 else {"data": 1,
                                                          "points": 2}
    meshes = [make_mesh({"points": world}, "cpu"), make_mesh(other, "cpu")]

    def run(mesh):
        return guided_sample_loop(model, schedule, x["src"], x["cond"],
                                  SAMPLER_STEPS, 7.5, mesh=mesh,
                                  **_sampler_draws(x))
    with fake_runner() as log:
        calls = []
        for mesh, offset in ((0, 0), (0, 0), (1, 0), (0, 1), (0, 0)):
            sharded_sampler._TEST_SHARD_OFFSET = offset
            try:
                run(meshes[mesh])
            finally:
                sharded_sampler._TEST_SHARD_OFFSET = 0
            calls.append("+".join(log))
            log.clear()
    keys = [repr(sharded_sampler.RowSplit(m, "points", "cpu").key())
            for m in meshes]
    sharded_sampler._TEST_SHARD_OFFSET = 1
    try:
        keys.append(repr(sharded_sampler.RowSplit(meshes[0], "points",
                                                  "cpu").key()))
    finally:
        sharded_sampler._TEST_SHARD_OFFSET = 0
    step_mesh = make_mesh(other, "cpu")
    keys += [repr(StepLayout(step_mesh, sp).key()) for sp in (False, True)]
    keys.append(repr(StepLayout(make_mesh({"data": world}, "cpu")).key()))
    every = [None] * world
    dist.all_gather_object(every, keys)
    return {"keys.calls": calls, "keys.mine": keys,
            "keys.every": [k for rank_keys in every for k in rank_keys]}


def _guarded_bodies(world: int, tmp: str) -> dict:
    """The meshed sampler body and the meshed train and eval step bodies
    under ``NoSyncGuard``, every input, draw and piece of state followed:
    what reads back to the host raises."""
    import pytest
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.models import (
        PointCloudDiffusionModel, guided_sample_loop, make_schedule)
    from pointcloud_style_transfer_torch.parallel import (make_mesh,
                                                          shard_batch)
    from pointcloud_style_transfer_torch.parallel.sharded import StepLayout
    from pointcloud_style_transfer_torch.training import (ema_init,
                                                          make_optimizer)
    from pointcloud_style_transfer_torch.training.trainer import (
        eval_step, step_draws, train_step)
    from torch_nosync import NoSyncGuard, _mark, plain_kernels

    x = _inputs(tmp)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        guard = NoSyncGuard()
        plain_kernels(mp, guard)
        for name, kw in (("brute", {}), ("grid", {"knn_backend": "grid"})):
            model, schedule = _sampler_model(tmp, **kw)
            draws = _sampler_draws(x)
            _mark([x["src"], x["cond"], draws])
            mesh = make_mesh({"points": world}, "cpu")
            with guard:
                got = guided_sample_loop(model, schedule, x["src"],
                                         x["cond"], SAMPLER_STEPS, 7.5,
                                         mesh=mesh, **draws)
            out[f"guard.sampler.{name}"] = got

        shape, shard_points = STEP_MESHES[world]
        mesh = make_mesh(shape, "cpu")
        layout = StepLayout(mesh, shard_points)
        cfg = Config(**{**STEP_CFG, "gradient_accumulation_steps": 2})
        torch.manual_seed(0)
        model = PointCloudDiffusionModel(cfg, device="cpu")
        schedule = make_schedule(cfg)
        params = dict(model.net.named_parameters())
        opt, ema = make_optimizer(cfg, params), ema_init(params)
        sim, real = (shard_batch(x[k], mesh, shard_points)
                     for k in ("sim", "real"))
        B, N = x["sim"].shape[:2]
        gen = torch.Generator().manual_seed(5)
        lr = torch.tensor(STEP_LR)
        _mark([params, dict(model.net.named_buffers()), opt.tensors(), ema,
               sim, real, lr])
        emits = []
        for _ in range(2):
            draws = step_draws(model, B, N, N, train=True, generator=gen)
            _mark(draws)
            with guard:
                terms, emit = train_step(model, schedule, opt, ema, sim,
                                         real, lr, draws=draws,
                                         layout=layout)
            emits.append(bool(emit))
        draws = step_draws(model, B, N, N, train=False, generator=gen)
        _mark(draws)
        with guard:
            e_terms = eval_step(model, schedule, ema, sim, real, draws=draws,
                                layout=layout)
        out["guard.step.terms"] = torch.stack([terms[k] for k in
                                               sorted(terms)])
        out["guard.step.evals"] = torch.stack([e_terms[k] for k in
                                               sorted(e_terms)])
        out["guard.step.emits"] = emits
    return out


def _agreement(rank: int) -> dict:
    """Runner states that disagree between the ranks: rank 1's entry
    dropped after the first call (``drop``), or its owner replaced at the
    second (``owner``); each through 4 calls on the world group, and the
    drop again with the agreement patched out (``unagreed``)."""
    from pointcloud_style_transfer_torch.models import capture

    def body(ins):
        return ins["x"] * 2

    x = {"x": torch.arange(3.0)}
    group = [dist.group.WORLD]
    out = {}
    for case in ("drop", "owner", "unagreed"):
        owners = [Owner(), Owner()]
        own_agree = capture.agree
        if case == "unagreed":
            capture.agree = lambda groups, value: value
        try:
            with fake_runner() as log:
                for call in range(4):
                    owner = owners[1 if case == "owner" and rank == 1
                                   and call > 0 else 0]
                    y = capture.run_captured((case,), body, x, owner,
                                             groups=group)
                    if not torch.equal(y, x["x"] * 2):
                        raise AssertionError(f"{case}: call {call} gave {y}")
                    if case != "owner" and rank == 1 and call == 0:
                        capture._ENTRIES["sampler"].clear()
        finally:
            capture.agree = own_agree
        out[f"agree.{case}"] = list(log)
    return out


def _failed_capture(rank: int) -> dict:
    """Rank 1's stand-in capture fails at the second call: both ranks
    raise; the third call runs eagerly on both."""
    from pointcloud_style_transfer_torch.models import capture

    x = {"x": torch.arange(3.0)}
    owner = Owner()
    errors = []
    with fake_runner() as log:
        for call in range(3):
            log.fail = rank == 1 and call == 1
            try:
                capture.run_captured(("fail",), lambda ins: ins["x"] + 1, x,
                                     owner, groups=[dist.group.WORLD])
                errors.append("none")
            except RuntimeError as e:
                errors.append(str(e))
    return {"fail.errors": errors, "fail.branches": list(log)}


# -- examples/verify_sharded_torch.py (tests/test_torch_examples_verify.py)

# 1,024 points, 256 coarse, tiny widths, 2 steps; the grid's knobs come
# from the environment the parent sets
VERIFY_ARGS = ["1024", "2", "--device", "cpu", "--config",
               "global_points=256", "feature_dim=32", "time_embed_dim=16",
               "use_amp=false"]


def verify_sharded_ranks(rank: int, world: int, tmp: str) -> dict:
    """``examples/verify_sharded_torch.py``'s ``main`` on the group's
    {points: world} mesh, then again with ``_TEST_SHARD_OFFSET = 1`` (each
    rank takes its neighbour's slice): each run's gate figures, and the
    first run's step inputs and single-device assembly."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import verify_sharded_torch
    from pointcloud_style_transfer_torch.parallel import sharded_sampler

    out = {}
    res = verify_sharded_torch.main(VERIFY_ARGS)
    shifted = None
    sharded_sampler._TEST_SHARD_OFFSET = 1
    try:
        shifted = verify_sharded_torch.main(VERIFY_ARGS)
    finally:
        sharded_sampler._TEST_SHARD_OFFSET = 0
    for name, r in (("run", res), ("offset", shifted)):
        out.update({f"{name}.ranks": r["ranks"], f"{name}.ok": r["ok"],
                    f"{name}.gate1_ok": r["gate1"]["ok"],
                    f"{name}.gate1_diff": r["gate1"]["max_diff"],
                    f"{name}.gate2_ok": r["gate2"]["ok"],
                    f"{name}.chamfer": r["gate2"]["chamfer"],
                    f"{name}.floor": r["gate2"]["floor"],
                    f"{name}.sharded": r["sharded"]})
    out.update({f"step.{k}": v for k, v in res["step_inputs"].items()})
    out["fused"] = res["fused"]
    out["backend_is_grid"] = res["default_backend"] == "grid"
    return out
