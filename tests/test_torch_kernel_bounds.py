"""``chip_smoke.py``'s kernel bounds come from the benchmark's own
formulas, ``perfbench/roofline/<counter>.py``, at the shape each launch
counter records, and give PERF.md's kernel table its bound column at the
precision it prints (4 decimals): B, B′, R, H, D, E, ``compact_sel`` and P."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# (counter, launch shape as its wrapper records it, bound ms as printed)
ROWS = [
    # B: (rows, envmap h, w)
    ("shade_bounce_fwd", (1048576, 16, 32), "0.0326"),
    # B′: path 10's bounce 0
    ("shade_bounce_bwd", (8388608, 16, 32), "0.3406"),
    # R: rng.lattice's (8, 1048576, 2) is one launch of (n_loc · dims
    # hashed values, 8 samples a value, 4 bytes a sample, mode 2)
    ("threefry_draw", (2 * 1048576, 8, 4, 2), "0.0200"),
    # H: path 10's bounce 0, its alive flags and normals broadcast over the
    # 8 samples
    ("bounce_record", (8388608, 16, 32, 1048576, 1048576), "0.1844"),
    # D: (queries, envmap h, w)
    ("env_sample_dir", (8388608, 16, 32), "0.0601"),
    # E: path 10's sky fetch
    ("env_lookup_bilinear", (1048576, 16, 32), "0.0088"),
    # compact_sel: (flags, cap)
    ("compact_sel", (8388608, 1048576), "0.0038"),
    # P: siren512's trace chunk, 4 × 512², the position written
    ("primary_state", (1048576, 512, 512, 1), "0.0154"),
]


@pytest.mark.parametrize("counter,shape,want", ROWS,
                         ids=[r[0] for r in ROWS])
def test_bound_matches_kernel_table(counter, shape, want):
    ms, by = chip_smoke.roofline(counter, shape)
    assert f"{ms:.4f}" == want
    assert by == "bytes"


def test_import_loads_no_torch():
    """The bounds are read without a card: importing ``chip_smoke`` loads
    neither torch nor CUDA."""
    code = ("import sys, chip_smoke; chip_smoke.roofline('compact_sel', "
            "(16, 4)); print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'triton', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
