"""Shared helpers of the benchmark's own tests (CPU, tiny films)."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a film of 32x32 and 4 samples a pixel in chunks of 2 on the CPU
TINY = {"film": 32, "spp": 4, "chunk": 2}
