"""Host milliseconds of ``DiffusionTrainer.train_step``, from its entry to
its return (before the step's synchronisation), averaged over the window's
mini-steps: ``host_ms_per_call.serve``'s reading of the training cells."""

from h100_bench.core.harness import reader

read = reader("host_ms_per_call.serve")
