"""Flat lookup from a mip-sized single-channel table: kernel G of
``csrc/gathers.cu`` (replaces
``materialist_tpu/ops/pallas/vreg_gather.py::vreg_gather``).

Nothing in either package calls it (the march kernel reads its tables
itself); it is kept as a standalone op so that every TPU kernel has its
counterpart. Tables up to ``SMEM_TEXELS`` are served from shared memory,
larger ones through the read-only cache. The plain version is indexing.
"""

from __future__ import annotations

import torch

from materialist_tpu_torch.ops.kernels import _lib

MAX_TEXELS = 65536
SMEM_TEXELS = 232448 // 4   # one block's 227 KB of shared memory


def vreg_gather_plain(table, idx):
    return table.reshape(-1)[idx.long()]


def vreg_gather(table, idx):
    """table (H, W) f32 with H·W ≤ 65,536; idx (...,) int32 flat = v·W + u
    in [0, H·W) → f32 (...,). Not differentiable."""
    if table.dim() != 2 or table.numel() > MAX_TEXELS:
        raise ValueError(f"table: expected (H, W) with H*W <= {MAX_TEXELS}, "
                         f"got {tuple(table.shape)}")
    if table.device.type == "cpu":
        return vreg_gather_plain(table.detach(), idx)
    dev = table.device
    tf = table.detach().contiguous()
    ix = idx.reshape(-1).contiguous()
    m = ix.shape[0]
    _lib.expect(tf, "table", torch.float32, device=dev)
    _lib.expect(ix, "idx", torch.int32, (m,), dev)
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    if m:
        _lib.check(_lib.lib().vreg_gather_launch(
            tf.data_ptr(), ix.data_ptr(), out.data_ptr(), m, tf.numel(),
            _lib.stream_ptr(tf)), "vreg_gather")
        _lib.LAUNCHES["vreg_gather"] += 1
    return out.reshape(idx.shape)
