"""The roofline bound of kernel H (``perfbench/roofline/bounce_record.py``)
held to the record layouts that the program reads and writes."""

from __future__ import annotations


def test_bounce_record_bound_holds_the_record_layouts():
    """H's bound moves each row's inputs and its three records once, at the
    layouts the plain version reads and writes (aux 5 × 2, recb 13 × 2, the
    normal 3 × 2 bytes a row), the broadcast flags and normals at their own
    sizes and the pdf tables once."""
    import torch

    from materialist_tpu_torch.ops import envmap as em
    from materialist_tpu_torch.ops.kernels import envkernels as ek

    from perfbench import files
    mod = files.load("roofline", "bounce_record")
    lead = (2, 6)
    wi = torch.nn.functional.normalize(torch.randn(lead + (3,)), dim=-1)
    ins = (wi, wi.flip(-1), torch.rand(lead + (1,)),
           torch.ones(lead, dtype=torch.bool),
           torch.zeros(lead, dtype=torch.bool))
    smp = em.build_sampler(torch.rand((16, 32, 3)) + 0.1)
    outs = ek.bounce_record_plain(smp.m_pdf, smp.c_pdf, *ins,
                                  torch.ones(lead, dtype=torch.bool),
                                  torch.ones(lead + (3,)))
    row = [t.element_size() * t[0, 0].numel() for t in outs]
    assert row == [5 * 2, 13 * 2, 3 * 2]
    assert mod.WRITE_BYTES_A_ROW == sum(row)
    assert mod.READ_BYTES_A_ROW == sum(t.element_size() * t[0, 0].numel()
                                       for t in ins)
    n = 1048576
    b, f = mod.bound((8 * n, 16, 32, n, n))
    assert b == 8 * n * (30 + 42) + n + 12 * n + 4 * (16 + 16 * 32)
    assert f == 8 * n * 120
