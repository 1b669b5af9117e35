"""Shared import shim: make `agatha_jax` importable from any cwd.

Every script under scripts/ starts with ``import _path  # noqa: F401``
(the scripts directory is on sys.path when a script is run directly,
so this resolves without packaging).  If `agatha_jax` is already
installed (``pip install -e .``) the shim is a no-op; otherwise the
repo root — the parent of this directory — is prepended to sys.path.

One convention for all scripts (round-4 review item 5): no per-script
sys.path hacks.
"""

import sys
from pathlib import Path

try:
    import agatha_jax  # noqa: F401
except ImportError:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
