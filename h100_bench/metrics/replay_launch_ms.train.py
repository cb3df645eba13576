"""Host milliseconds a mini-step inside the capture runner's
``capture.replay`` span: ``replay_launch_ms.serve``'s reading of the
training cells."""

from h100_bench.core.harness import reader

read = reader("replay_launch_ms.serve")
