"""The harness's CPU tests: the checkout's root on the import path, and a
few threads a process."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(min(4, torch.get_num_threads()))
