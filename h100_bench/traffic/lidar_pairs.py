"""The benchmark's traffic: sim/real LiDAR scene pairs.

A frozen copy of the port's ``data/synthetic.py`` (the scene layout and its
two renderings, unchanged below ``lidar_scene_pair``), so that the traffic
stays fixed whatever the program does to its own copy, and ``pool``,
which draws a run's pairs from its seed at exactly the configured point
count.

Each pair is one scene rendered twice: ``sim``, near-uniform surface
coverage with tiny isotropic noise, and ``real``, a spinning-LiDAR sweep of
the same geometry (48 beam rings, range noise, range-dependent dropout).
A request takes one pair's ``sim`` as its source and another pair's
``real`` as its style reference; a training batch takes pairs whole.
"""

from __future__ import annotations

import concurrent.futures
import numpy as np

SENSOR_HEIGHT = 1.8  # spinning-LiDAR mount height (meters)


def _scene(rng: np.random.Generator, extent: float = 30.0):
    """Random scene layout shared by both styles of a pair."""
    slope = rng.uniform(-0.02, 0.02, 2)
    n_boxes = int(rng.integers(6, 14))
    boxes = []
    for _ in range(n_boxes):
        center = rng.uniform(-0.8 * extent, 0.8 * extent, 2)
        if np.linalg.norm(center) < 3.0:  # keep the sensor cell clear
            center *= 3.0 / (np.linalg.norm(center) + 1e-6)
        size = rng.uniform([1.5, 1.5, 1.0], [5.0, 2.5, 2.5])
        yaw = rng.uniform(0, np.pi)
        boxes.append((center, size, yaw))
    n_walls = int(rng.integers(1, 4))
    walls = []
    for _ in range(n_walls):
        x0 = rng.uniform(-extent, extent, 2)
        ang = rng.uniform(0, np.pi)
        length = rng.uniform(8.0, 25.0)
        height = rng.uniform(2.0, 4.0)
        walls.append((x0, ang, length, height))
    return {"extent": extent, "slope": slope, "boxes": boxes, "walls": walls}


def _ground_z(scene, xy: np.ndarray) -> np.ndarray:
    s = scene["slope"]
    return xy[:, 0] * s[0] + xy[:, 1] * s[1]


def _sample_surfaces(rng: np.random.Generator, scene, n: int) -> np.ndarray:
    """Dense uniform sampling of every scene surface (the 'sim' renderer)."""
    extent = scene["extent"]
    n_ground = int(n * 0.55)
    per_obj = n - n_ground
    parts = []
    xy = rng.uniform(-extent, extent, (n_ground, 2)).astype(np.float32)
    parts.append(np.concatenate(
        [xy, _ground_z(scene, xy)[:, None]], 1))

    objs = ([("box", b) for b in scene["boxes"]]
            + [("wall", w) for w in scene["walls"]])
    counts = np.full(len(objs), per_obj // len(objs))
    counts[: per_obj - counts.sum()] += 1
    for (kind, obj), m in zip(objs, counts):
        if kind == "box":
            (cx, cy), (sx, sy, sz), yaw = obj[0], obj[1], obj[2]
            # sample the 4 side faces + top, area-weighted
            u = rng.uniform(-0.5, 0.5, (m, 2)).astype(np.float32)
            face = rng.integers(0, 5, m)
            local = np.empty((m, 3), np.float32)
            # sides: fix one axis at +-1/2, top: fix z
            side_axis = face % 2  # 0: x-faces, 1: y-faces
            sign = np.where(face // 2 % 2 == 0, 0.5, -0.5)
            local[:, 0] = np.where(side_axis == 0, sign, u[:, 0])
            local[:, 1] = np.where(side_axis == 0, u[:, 0], sign)
            local[:, 2] = u[:, 1] + 0.5
            top = face == 4
            local[top, 0] = u[top, 0]
            local[top, 1] = rng.uniform(-0.5, 0.5, int(top.sum()))
            local[top, 2] = 1.0
            local *= np.array([sx, sy, sz], np.float32)
            c, s = np.cos(yaw), np.sin(yaw)
            world = np.empty_like(local)
            world[:, 0] = cx + local[:, 0] * c - local[:, 1] * s
            world[:, 1] = cy + local[:, 0] * s + local[:, 1] * c
            world[:, 2] = local[:, 2]
            world[:, 2] += _ground_z(scene, world[:, :2])
            parts.append(world)
        else:
            (x0, ang, length, height) = obj
            t = rng.uniform(0, length, m).astype(np.float32)
            z = rng.uniform(0, height, m).astype(np.float32)
            world = np.stack(
                [x0[0] + t * np.cos(ang), x0[1] + t * np.sin(ang), z],
                1).astype(np.float32)
            world[:, 2] += _ground_z(scene, world[:, :2])
            parts.append(world)
    return np.concatenate(parts, 0).astype(np.float32)


def sim_cloud(rng: np.random.Generator, scene, n: int) -> np.ndarray:
    """'sim' style: uniform surface coverage + tiny isotropic noise."""
    pts = _sample_surfaces(rng, scene, n)
    return pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)


def real_cloud(rng: np.random.Generator, scene, n: int,
               n_beams: int = 48, max_range: float = 45.0) -> np.ndarray:
    """'real' style: sweep resampling of the same geometry.

    Densely samples the scene, converts to sensor-centric spherical
    coordinates, snaps each point's elevation to its nearest beam ring
    (producing scan-line structure on every surface), applies
    range-proportional radial noise and distance-dependent dropout. The
    output count is approximate — the offline preprocessor resamples to the
    exact contract count anyway (reference: data/preprocessing.py:144-159).
    """
    dense = _sample_surfaces(rng, scene, int(n * 2.5))
    sensor = np.array([0.0, 0.0, SENSOR_HEIGHT], np.float32)
    rel = dense - sensor
    rng_d = np.linalg.norm(rel, axis=1) + 1e-9
    elev = np.arcsin(rel[:, 2] / rng_d)
    beams = np.linspace(np.radians(-28.0), np.radians(8.0), n_beams)
    bi = np.abs(elev[:, None] - beams[None, :]).argmin(1)
    snapped = beams[bi]
    # distance-dependent keep probability (beam divergence / return loss)
    keep = (rng.random(len(dense))
            < np.clip(1.1 - rng_d / max_range, 0.05, 1.0))
    keep &= rng_d < max_range
    # snap elevation: rotate each return onto its beam ring (same azimuth
    # and range — the scan-line look), then radial range noise
    az = np.arctan2(rel[:, 1], rel[:, 0])
    r_noisy = rng_d * (1.0 + rng.normal(0, 0.004, len(dense)))
    out = np.stack([r_noisy * np.cos(snapped) * np.cos(az),
                    r_noisy * np.cos(snapped) * np.sin(az),
                    r_noisy * np.sin(snapped)], 1).astype(np.float32)
    out = out[keep] + sensor
    if len(out) > n:
        out = out[rng.choice(len(out), n, replace=False)]
    return np.ascontiguousarray(out)


def lidar_scene_pair(rng: np.random.Generator, n: int,
                     extent: float = 30.0) -> tuple[np.ndarray, np.ndarray]:
    """One paired (sim, real) scene: same layout, two sampling styles."""
    scene = _scene(rng, extent)
    return sim_cloud(rng, scene, n), real_cloud(rng, scene, n)


def exact_count(rng: np.random.Generator, pts: np.ndarray, n: int
                ) -> np.ndarray:
    """``pts`` at exactly ``n`` points: a random subset when larger, every
    point plus random repeats when smaller, shuffled."""
    if len(pts) >= n:
        return pts[rng.choice(len(pts), n, replace=False)]
    extra = rng.choice(len(pts), n - len(pts), replace=True)
    both = np.concatenate([pts, pts[extra]])
    return np.ascontiguousarray(both[rng.permutation(n)])


def pool(seed_of_pair, n_pairs: int, n_points: int, threads: int = 4
         ) -> tuple[np.ndarray, np.ndarray]:
    """``n_pairs`` distinct scenes: (sim [P, n, 3], real [P, n, 3])
    float32, in metres. Pair i is drawn from
    ``np.random.default_rng(seed_of_pair(i))``, on ``threads`` threads."""
    def one(i):
        rng = np.random.default_rng(seed_of_pair(i))
        sim, real = lidar_scene_pair(rng, n_points)
        return exact_count(rng, sim, n_points), exact_count(rng, real,
                                                            n_points)
    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        pairs = list(ex.map(one, range(n_pairs)))
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))
