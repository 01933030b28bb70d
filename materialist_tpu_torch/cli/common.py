"""Shared CLI plumbing: output-dir resolution (counterpart of
``materialist_tpu/cli/common.py``)."""

from __future__ import annotations

import os

from materialist_tpu_torch import config as gconfig


def get_output_dir(save_name: str, save_path: str = None) -> str:
    """Output dir resolution; an absolute ``save_name`` is the dir."""
    if save_path:
        if os.path.isabs(save_path):
            return os.path.join(save_path, save_name)
        return os.path.join(gconfig.OUT_DIR, save_path, save_name)
    if os.path.isabs(save_name):
        return save_name
    return os.path.join(gconfig.OUT_DIR, save_name)
