"""Where the port's CUDA kernels are built: the counterpart of the JAX
package's persistent compilation cache (its ``utils/cache.py``).

The kernels of ``csrc/`` are compiled by ``nvcc`` at their first launch
into a build directory and loaded from there by every later process
(``ops/kernels/_common.py``; a library's name carries the hash of its source
and flags). ``enable_compilation_cache(path)`` points that directory at
``path``, else at ``$PCST_TORCH_KERNEL_CACHE`` when it is set; without
either it leaves the directory as it is (the checkout's
``build/torch_kernels/`` unless moved before). The JAX package's
``PCST_COMPILATION_CACHE`` names its XLA cache and is not read: the port's
libraries never go there. The CLIs call it where the JAX package's CLIs
call theirs.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ..ops.kernels import _common


def enable_compilation_cache(path: Optional[str] = None) -> Path:
    """Build and load the kernels under ``path`` (or
    ``$PCST_TORCH_KERNEL_CACHE``); returns the build directory in use."""
    path = path or os.environ.get("PCST_TORCH_KERNEL_CACHE")
    if path:
        _common.BUILD_ROOT = Path(path).expanduser().resolve()
    return _common.BUILD_ROOT
