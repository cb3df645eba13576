"""Dataset + host-side batching for hierarchical .npz files (the port's own
copy of ``pointcloud_style_transfer_tpu/data/dataset.py``; numpy, so the
same seed gives the same batches in the same order).

Replaces the reference's torch Dataset/DataLoader (reference:
data/dataset.py:10-176) with a dependency-free numpy pipeline:

* ``HierarchicalPointCloudDataset`` globs ``*_hierarchical.npz`` and returns
  per-item dicts with the reference's key set;
* ``Batcher`` shuffles per-epoch (seeded), stacks array keys and lists
  non-array keys — the reference's ``hierarchical_collate_fn`` semantics
  (data/dataset.py:131-155);
* corrupt files RAISE by default. The reference silently substitutes
  zero-filled clouds on any load error (data/dataset.py:71-77), poisoning
  batches; pass ``on_error="zeros"`` only if that bug-compat behaviour is
  wanted (it logs loudly).
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Dict, Iterator, List

import numpy as np

log = logging.getLogger("pcst.data")

ARRAY_KEYS = ("sim_full", "real_full", "sim_global", "real_global",
              "sim_global_indices", "real_global_indices")


class HierarchicalPointCloudDataset:
    def __init__(self, processed_dir: str, use_hierarchical: bool = True,
                 on_error: str = "raise"):
        self.processed_dir = processed_dir
        self.use_hierarchical = use_hierarchical
        self.on_error = on_error
        self.file_paths = sorted(glob.glob(
            os.path.join(processed_dir, "*_hierarchical.npz")))
        if not self.file_paths:
            raise FileNotFoundError(
                f"No '*_hierarchical.npz' files found in {processed_dir}. "
                "Run the preprocess CLI first.")
        log.info("Dataset: %d hierarchical files from %s (hierarchical=%s)",
                 len(self.file_paths), processed_dir, use_hierarchical)

    def __len__(self) -> int:
        return len(self.file_paths)

    def __getitem__(self, idx: int) -> Dict:
        path = self.file_paths[idx]
        try:
            with np.load(path) as z:
                item = {
                    "sim_full": z["sim_full"].astype(np.float32),
                    "real_full": z["real_full"].astype(np.float32),
                }
                if self.use_hierarchical:
                    item.update({
                        "sim_global": z["sim_global"].astype(np.float32),
                        "real_global": z["real_global"].astype(np.float32),
                        "sim_global_indices":
                            z["sim_global_indices"].astype(np.int32),
                        "real_global_indices":
                            z["real_global_indices"].astype(np.int32),
                        "sim_norm_params": {
                            "center": z["sim_norm_center"],
                            "scale": float(z["sim_norm_scale"]),
                            "method": "isotropic"},
                        "real_norm_params": {
                            "center": z["real_norm_center"],
                            "scale": float(z["real_norm_scale"]),
                            "method": "isotropic"},
                        "total_points": int(z["total_points"]),
                        "global_points": int(z["global_points"]),
                    })
                return item
        except Exception as e:
            if self.on_error == "zeros":
                log.error("CORRUPT sample %s (%s) — substituting zeros "
                          "(bug-compat mode)", path, e)
                return self._default_item()
            raise RuntimeError(f"Failed to load {path}") from e

    def _default_item(self) -> Dict:
        tp, gp = 120000, 30000
        item = {"sim_full": np.zeros((tp, 3), np.float32),
                "real_full": np.zeros((tp, 3), np.float32)}
        if self.use_hierarchical:
            item.update({
                "sim_global": np.zeros((gp, 3), np.float32),
                "real_global": np.zeros((gp, 3), np.float32),
                "sim_global_indices": np.arange(gp, dtype=np.int32),
                "real_global_indices": np.arange(gp, dtype=np.int32),
                "sim_norm_params": {"center": np.zeros(3), "scale": 1.0,
                                    "method": "isotropic"},
                "real_norm_params": {"center": np.zeros(3), "scale": 1.0,
                                     "method": "isotropic"},
                "total_points": tp, "global_points": gp,
            })
        return item


def collate(batch: List[Dict]) -> Dict:
    """Stack array keys, list everything else (reference collate semantics,
    data/dataset.py:131-155)."""
    if not batch:
        return {}
    out: Dict = {}
    for k, v in batch[0].items():
        if isinstance(v, np.ndarray):
            out[k] = np.stack([item[k] for item in batch])
        else:
            out[k] = [item[k] for item in batch]
    return out


class Batcher:
    """Deterministic, seeded, epoch-reshuffled batch iterator.

    ``num_workers > 0`` enables threaded prefetch: item loads (npz
    decompression is the host-side cost) run in a thread pool and upcoming
    batches are assembled ahead of consumption — the host-side equivalent of
    the reference's DataLoader workers (data/dataset.py:157-165). Iteration
    order and contents are identical either way.
    """

    def __init__(self, dataset: HierarchicalPointCloudDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            yield order[s:s + self.batch_size]

    def __iter__(self) -> Iterator[Dict]:
        if self.num_workers <= 0:
            for idx in self._batch_indices():
                yield collate([self.dataset[int(i)] for i in idx])
            return

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        batches = list(self._batch_indices())
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def submit(idx):
                return [pool.submit(self.dataset.__getitem__, int(i))
                        for i in idx]

            queue = deque()
            nxt = 0
            while nxt < len(batches) and len(queue) <= self.prefetch:
                queue.append(submit(batches[nxt]))
                nxt += 1
            while queue:
                items = [f.result() for f in queue.popleft()]
                if nxt < len(batches):
                    queue.append(submit(batches[nxt]))
                    nxt += 1
                yield collate(items)


def create_dataloaders(config, on_error: str = "raise"):
    """train/val Batchers over processed_dir/{train,val}
    (reference: data/dataset.py:102-176)."""
    train_ds = HierarchicalPointCloudDataset(
        os.path.join(config.processed_data_dir, "train"),
        use_hierarchical=config.use_hierarchical, on_error=on_error)
    val_ds = HierarchicalPointCloudDataset(
        os.path.join(config.processed_data_dir, "val"),
        use_hierarchical=config.use_hierarchical, on_error=on_error)
    train = Batcher(train_ds, config.batch_size, shuffle=True, drop_last=True,
                    seed=config.seed, num_workers=config.num_workers)
    val = Batcher(val_ds, config.batch_size, shuffle=False, drop_last=False,
                  seed=config.seed, num_workers=config.num_workers)
    return train, val
