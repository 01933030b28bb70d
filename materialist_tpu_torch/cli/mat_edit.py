"""Material-editing CLI (counterpart of ``materialist_tpu/cli/
mat_edit.py``): a masked HSV albedo shift and scalar roughness / metallic
edits, rendered by ``render_final.render_real``.

Usage: python -m materialist_tpu_torch.cli.mat_edit --save_name NAME
           [--hue_shift H S V] [--roughness R] [--metallic M]
           [--env_path path.hdr] [--n_iter 10] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from materialist_tpu_torch.cli.render_final import render_real


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="masked material editing")
    p.add_argument("--save_name", required=True, type=str)
    p.add_argument("--hue_shift", nargs=3, type=float, default=None,
                   help="HSV shift applied to albedo inside the mask")
    p.add_argument("--roughness", type=float, default=None)
    p.add_argument("--metallic", type=float, default=None)
    p.add_argument("--env_path", type=str, default=None)
    p.add_argument("--input_path", type=str, default=None)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--n_iter", type=int, default=10)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    edit = {
        "albedo": np.array([a.hue_shift]) if a.hue_shift else None,
        "roughness": a.roughness,
        "metallic": a.metallic,
    }
    render_real(a.save_name, a.env_path, edit=edit, n_iter=a.n_iter,
                input_path=a.input_path, save_path=a.save_path, spp=a.spp,
                device=a.device)


if __name__ == "__main__":
    main()
