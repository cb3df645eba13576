"""``device_idle_pct.serve``'s reading, for the training cells."""

from h100_bench.core.harness import reader

read = reader("device_idle_pct.serve")
