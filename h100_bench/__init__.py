"""The benchmark of ``pointcloud_style_transfer_torch`` on NVIDIA H100
cards: ``python h100_bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output."""
