"""Found by name from the cell's files; see ``core/harness.py``."""
