"""Global configuration (counterpart of reference global_config.py:1-4).

Paths resolve relative to the process CWD by default so the CLI behaves like
the reference (writes to ./output_imgs), overridable via environment.
"""

from __future__ import annotations

import os

BASE_DIR = os.environ.get("MATERIALIST_BASE_DIR", os.getcwd())
OUT_DIR = os.environ.get("MATERIALIST_OUT_DIR", os.path.join(BASE_DIR, "output_imgs"))
ENVMAP_DIR = os.environ.get("MATERIALIST_ENVMAP_DIR", os.path.join(BASE_DIR, "envmaps"))

# Default render/optimization constants pinned by the reference
# (inverse_img_w_mi.py:37-38,179,211,625; myutils/default_cam.json).
IMAGE_SIZE = 512
FOV_DEG = 35.0
ENV_H, ENV_W = 16, 32
DEFAULT_SPP = 64
MAX_DEPTH = 4          # path length incl. primary hit (integrator max_depth)
NUM_EPOCHS = 5000      # per-phase epoch cap
