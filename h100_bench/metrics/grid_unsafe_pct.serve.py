"""The share of the kd-grid's queries that its exact patch serves: the
unsafe rows the program counts on the device at every grid pass
(``ops.grid_knn.UNSAFE_COUNTS``, the latest passes it holds, one a cloud and
step), over the N - M unknown points a pass, in percent; read after the
window in one host sync."""


def read(run):
    from h100_bench.drivers.serve import hierarchical
    if run.cell.traffic["driver"] != "serve" or not hierarchical(run):
        return None
    from pointcloud_style_transfer_torch.ops import grid_knn
    counts = grid_knn.unsafe_counts()
    if not counts:
        return None
    cfg = run.cell.config
    rows = cfg["total_points"] - cfg["global_points"]
    return 100.0 * sum(counts) / (len(counts) * rows)
