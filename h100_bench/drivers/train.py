"""Training: back-to-back ``DiffusionTrainer.train_step`` mini-steps on a
pool of scene pairs held on the card, as ``train_one_epoch`` drives them
once a batch is on the device: B clouds a mini-step, an optimizer step and
the EMA every ``gradient_accumulation_steps``, the learning rate of the
schedule's epoch as a device tensor. Nothing is read back between steps;
the window ends at the synchronisation after its last step.

The traffic file gives the pool (``pool_pairs``, normalised at set-up as
the dataset normalises them), the batch (``batch``), the schedule's
``epoch`` and how many mini-steps a traced run profiles (``trace_steps``).
Mini-step j takes B distinct pairs chosen from the seed, the first three
steps' rows all distinct, and its draws from a generator on the card
seeded for it; the benchmark hands the same draws to the reference. The
feed reads nothing back, as the trainer's own loop reads nothing back.

Set-up makes the trainer, loads the benchmark's weights into it and runs
its first ``steps`` mini-steps (``workloads/<cell>.json``: two optimizer
steps) through the window's own call: the first runs eagerly, the second
captures the step's graph, the third and every later one replay it. The
check runs the plain reference (``reference/train.py``) through the same
steps from the same weights, at the configuration's bfloat16, and compares
each step's loss terms; the first optimizer step's gradient as the
optimizer holds it, clipped, worked out from its moments after that step;
the accumulated gradient of the second optimizer step, unclipped, before
its last mini-step; and the parameters' and the EMA's change after the
two, leaf by leaf (``core.compare``).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from ..core import compare, seeds, weights
from ..core import trace as tracing
from ..core.harness import mark
from ..reference import request as ref_request
from ..reference import train as ref_train
from ..traffic import lidar_pairs
from .serve import port_config

KEEP_PROB = 0.9  # the dropout masks' keep probability (Dropout(0.1))


def lr_of(run) -> float:
    cfg = run.cell.config
    from pointcloud_style_transfer_torch.training.lr_schedule import (
        lr_for_epoch)
    return lr_for_epoch(run.cell.traffic["epoch"], cfg["learning_rate"],
                        cfg["warmup_epochs"], cfg["num_epochs"],
                        cfg["min_lr_ratio"])


def rows_of(run, j: int) -> torch.Tensor:
    """The pool pairs of mini-step j (0-based), a device tensor made without
    a host round trip: the first ``steps`` steps take distinct pairs within
    each optimizer step, from a permutation drawn at set-up for each, later
    steps B distinct ones drawn on the card from the step's generator
    (``draws_of`` seeds it first)."""
    B = run.cell.traffic["batch"]
    if j < run.cell.check["steps"]:
        return run.state["first_rows"][j * B:(j + 1) * B]
    return torch.randperm(run.cell.traffic["pool_pairs"],
                          generator=run.state["gen"],
                          device=run.device)[:B]


def draws_of(run, j: int) -> Dict[str, object]:
    """Mini-step j's draws on the device, in the trainer's shapes."""
    cfg, tr = run.cell.config, run.cell.traffic
    B, N, M = tr["batch"], cfg["total_points"], cfg["global_points"]
    dev = run.device
    gen = run.state["gen"]
    gen.manual_seed(seeds.derive(run.seed, "step draws", j))

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    d: Dict[str, object] = {
        "t": torch.randint(0, cfg["num_timesteps"], (B,), generator=gen,
                           device=dev),
        "noise": torch.randn((B, N, 3), generator=gen, device=dev)}
    d["cond_priority"] = rand(B, N)
    d["fps_starts"] = torch.stack([
        torch.randint(0, M, (B,), generator=gen, device=dev),
        torch.randint(0, cfg["set_abstractions"][0][0], (B,), generator=gen,
                      device=dev)])
    d["style_dropout_mask"] = rand(B, cfg["style_head"][0]) < KEEP_PROB
    d["drop_u"] = rand(B, 1)
    d["noisy_priority"] = rand(B, N)
    d["noise_dropout_masks"] = [rand(B, M, cfg["feature_dim"]) < KEEP_PROB
                                for _ in range(cfg["denoiser_blocks"])]
    return d


def mini_step(run, j: int) -> dict:
    trainer = run.state["trainer"]
    with record_function("step.draws"):
        draws = draws_of(run, j)
    with record_function("step.batch"):
        idx = rows_of(run, j)
        sim = run.state["pool_sim"].index_select(0, idx)
        real = run.state["pool_real"].index_select(0, idx)
    t_call = time.perf_counter()
    with record_function("step.train_step"):
        terms, _ = trainer.train_step(sim, real, run.state["lr"], draws)
    t_return = time.perf_counter()
    return {"id": j, "t_call": t_call, "t_return": t_return,
            "units": run.cell.traffic["batch"], "terms": terms}


def sync(run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def setup(run) -> None:
    from pointcloud_style_transfer_torch.data.preprocessing import (
        normalize_point_cloud)
    from pointcloud_style_transfer_torch.training import DiffusionTrainer
    cfg, tr = run.cell.config, run.cell.traffic
    work = tempfile.mkdtemp(prefix="h100_bench_train_")
    config = port_config(cfg).replace(
        seed=seeds.derive(run.seed, "trainer") % (1 << 31),
        log_dir=f"{work}/logs", checkpoint_dir=f"{work}/checkpoints",
        result_dir=f"{work}/results",
        processed_data_dir=f"{work}/processed")
    w = weights.make(cfg, run.seed, run.device)
    mark(run, "weights")
    trainer = DiffusionTrainer(config, resume=False, device=run.device)
    with torch.no_grad():
        state = trainer.model.net.state_dict()
        for name, t in w.items():
            state[name].copy_(t)
        for name, e in trainer.ema_params.items():
            e.copy_(w[name])
    mark(run, "trainer")
    sims, reals = lidar_pairs.pool(
        lambda p: seeds.derive(run.seed, "pair", p), tr["pool_pairs"],
        cfg["total_points"])
    norm = [[normalize_point_cloud(c)[0] for c in clouds]
            for clouds in (sims, reals)]
    P, B, steps = tr["pool_pairs"], tr["batch"], run.cell.check["steps"]
    k = cfg["gradient_accumulation_steps"]
    if k * B > P:
        raise ValueError(f"an optimizer step of {k} x {B} needs {k * B} "
                         f"distinct pairs; the pool has {P}")
    first_rows = np.concatenate([
        seeds.numpy_rng(run.seed, "first rows", s).permutation(P)[:k * B]
        for s in range(-(-steps // k))])
    run.state.update(
        work=work, weights=w, trainer=trainer,
        gen=torch.Generator(device=run.device),
        first_rows=torch.from_numpy(first_rows).to(run.device),
        lr=trainer.lr_tensor(lr_of(run)),
        pool_sim=torch.from_numpy(np.stack(norm[0])).to(run.device),
        pool_real=torch.from_numpy(np.stack(norm[1])).to(run.device),
        host_sim=sims, host_real=reals)
    mark(run, "pool")
    # the checked first steps: eager, captured, replayed
    opt = trainer.optimizer

    def named(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return dict(zip(opt.names, opt._unflat(flat.clone())))
    first = {"terms": []}
    for j in range(steps):
        rec = mini_step(run, j)
        sync(run)
        first["terms"].append({n: float(v) for n, v in rec["terms"].items()})
        if j == k - 1:  # the first optimizer step's gradient, clipped
            first["grad"] = named(opt.mu / (1 - opt.b1))
            first["grad_nu"] = named(torch.sqrt(opt.nu / (1 - opt.b2)))
        if j == steps - 2:
            first["acc"] = named(opt.acc_grads)
        mark(run, f"step {j + 1}")
    first["params"] = {n: p.detach().clone() for n, p in
                       trainer.model.net.named_parameters()}
    first["ema"] = {n: e.clone() for n, e in trainer.ema_params.items()}
    run.state["first"] = first
    run.state["next_id"] = run.cell.check["steps"]


def window(run) -> None:
    records = []
    t0 = time.perf_counter()
    j = run.state["next_id"]
    while True:
        records.append(mini_step(run, j))
        j += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    sync(run)
    run.window_s = time.perf_counter() - t0
    run.records = records
    run.attempted, run.failed = len(records), 0
    run.state["next_id"] = j


def trace(run) -> None:
    n = run.cell.traffic["trace_steps"]

    def stretch() -> int:
        for _ in range(n):
            mini_step(run, run.state["next_id"])
            run.state["next_id"] += 1
        return n
    run.trace_summary = tracing.profile(stretch, run.device)


def release(run) -> None:
    from pointcloud_style_transfer_torch.models import capture
    capture.release()
    for key in ("trainer", "pool_sim", "pool_real", "lr"):
        run.state.pop(key, None)
    shutil.rmtree(run.state.pop("work"), ignore_errors=True)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_steps(run, precision: str = "fp32", steps: int = None
                    ) -> dict:
    """The reference's first ``steps`` (the check's) mini-steps from the
    benchmark's weights on the same rows and draws, read as the set-up reads
    the program's: loss terms a step, the first mini-step's own gradient,
    the first optimizer step's gradient from its moments, the accumulator
    before the last mini-step, the parameters and the EMA after them."""
    cfg = run.cell.config
    steps = run.cell.check["steps"] if steps is None else steps
    k = cfg["gradient_accumulation_steps"]
    ref = ref_train.Trainer(run.state["weights"], cfg, precision)
    pools = [torch.from_numpy(np.stack([
        ref_request.normalize(c, cfg["target_range"])[0] for c in clouds]))
        for clouds in (run.state["host_sim"], run.state["host_real"])]
    out = {"terms": []}
    for j in range(steps):
        rows = rows_of(run, j).cpu()
        sim, real = (p[rows].to(run.device) for p in pools)
        terms, grads = ref.step(sim, real, draws_of(run, j), lr_of(run))
        out["terms"].append(terms)
        if j == 0:
            out["step_grad"] = grads
        if j == k - 1:
            out["grad"] = {n: m / (1 - ref_train.ADAM_B1)
                           for n, m in ref.mu.items()}
            out["grad_nu"] = {n: torch.sqrt(v / (1 - ref_train.ADAM_B2))
                              for n, v in ref.nu.items()}
        if j == steps - 2:
            out["acc"] = dict(ref.acc)
    out["params"] = {n: ref.state[n] for n in ref.names}
    out["ema"], out["acc_norms"] = ref.ema, ref.acc_norms
    return out


def check(run) -> List[dict]:
    """The program's first steps against the reference's at the
    configuration's bfloat16; the float32 reference says which leaves'
    gradients are nought to rounding (``core.compare``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = compare.train_readings(
        run.state["first"], reference_steps(run, "bf16"),
        run.state["weights"], reference_steps(run, "fp32", steps=1),
        run.cell.config["gradient_accumulation_steps"])
    return compare.numbers(readings, run.cell.check["limits"])
