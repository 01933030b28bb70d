"""Envmap NEE sampling, pdf and bilinear fetch for small emitters, and
the fused bounce's trace record.

Kernels D (``env_sample_dir``), D′ (``env_pdf_dir``) and E
(``env_lookup_bilinear``) of ``csrc/envkernels.cu``, which replace
``materialist_tpu/ops/pallas/envkernels.py``, and H (``bounce_record``),
which writes a fused bounce's packed record after the march in one
launch, with D′'s device code. Each wrapper takes its plain PyTorch
version for CPU tensors and launches the kernel for CUDA tensors; the
plain versions follow ``materialist_tpu/ops/envmap.py`` (``sample``,
``pdf_dir``, the small-map bilinear fetch) with plain indexing in place
of one-hot contractions, and ``bounce_record_plain`` the record that
``materialist_tpu/render/shader.py`` packs for its fused shade.
"""

from __future__ import annotations

import math

import torch

from materialist_tpu_torch.camera import norm
from materialist_tpu_torch.ops.kernels import _lib
from materialist_tpu_torch.utils import profiling as prof

PI = math.pi
ENV_AXIS_MAX = 64     # the kernels keep their tables in shared memory


# ---------------------------------------------------------------- plain

def _interp_cdf(at, prev, x):
    return torch.clamp((x - prev) / torch.clamp_min(at - prev, 1e-12),
                       0.0, 1.0)


def uv_to_dir(u, v, height: int, width: int):
    phi = 2.0 * PI * u / width
    theta = PI * v / height
    st = torch.sin(theta)
    return torch.stack([st * torch.sin(phi), torch.cos(theta),
                        -st * torch.cos(phi)], dim=-1)


def env_sample_texels_plain(m_cdf, c_cdf, u2):
    """Row and column (..., 2) int64 that ``env_sample_dir_plain`` picks
    for uniforms u2 (..., 2): the counts of CDF entries below them."""
    h, w = c_cdf.shape
    x0, x1 = u2[..., 0], u2[..., 1]
    v_idx = torch.clamp(torch.sum(m_cdf < x0[..., None], -1), 0, h - 1)
    u_idx = torch.clamp(torch.sum(c_cdf[v_idx] < x1[..., None], -1), 0,
                        w - 1)
    return torch.stack([v_idx, u_idx], -1)


def env_sample_dir_plain(m_cdf, m_pdf, c_cdf, c_pdf, u2):
    h, w = c_cdf.shape
    x0, x1 = u2[..., 0], u2[..., 1]
    v_idx = torch.clamp(torch.sum(m_cdf < x0[..., None], -1), 0, h - 1)
    m_prev = torch.cat([m_cdf.new_zeros(1), m_cdf[:-1]])
    dv = _interp_cdf(m_cdf[v_idx], m_prev[v_idx], x0)
    pdf_m = m_pdf[v_idx]
    v = v_idx.to(torch.float32) + dv
    row_cdf = c_cdf[v_idx]                                   # (..., W)
    u_idx = torch.clamp(torch.sum(row_cdf < x1[..., None], -1), 0, w - 1)
    at_c = torch.gather(row_cdf, -1, u_idx[..., None])[..., 0]
    prev_c = torch.where(
        u_idx > 0,
        torch.gather(row_cdf, -1,
                     torch.clamp_min(u_idx - 1, 0)[..., None])[..., 0], 0.0)
    du = _interp_cdf(at_c, prev_c, x1)
    pdf_c = c_pdf[v_idx, u_idx]
    u = u_idx.to(torch.float32) + du
    theta = v * PI / h
    wi = uv_to_dir(u, v, h, w)
    sin_theta = torch.clamp_min(torch.sin(theta), 1e-6)
    pdf = (h * w) * (pdf_c * pdf_m) / (2.0 * PI * PI * sin_theta)
    return wi, pdf[..., None]


def dir_to_uv(d, height: int, width: int):
    phi = torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * PI)
    u = (phi - torch.floor(phi)) * width
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    v = theta / PI * height
    return u, v


def bilinear_coords(d, h: int, w: int):
    """Direction → bilinear tap coords (u0i, v0i int32, du, dv f32)."""
    u, v = dir_to_uv(d, h, w)
    uf = u - 0.5
    vf = v - 0.5
    u0 = torch.floor(uf)
    v0 = torch.floor(vf)
    du = uf - u0
    dv = vf - v0
    u0i = torch.remainder(u0.to(torch.int32), w)
    v0i = torch.clamp(v0.to(torch.int32), 0, h - 1)
    return u0i, v0i, du, dv


def env_pdf_dir_plain(m_pdf, c_pdf, d):
    h, w = c_pdf.shape
    u, v = dir_to_uv(d, h, w)
    ui = torch.clamp(u.to(torch.int32), 0, w - 1).long()
    vi = torch.clamp(v.to(torch.int32), 0, h - 1).long()
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    sin_theta = torch.clamp_min(torch.sin(theta), 1e-6)
    pdf = (h * w) * (c_pdf[vi, ui] * m_pdf[vi]) / (2.0 * PI * PI * sin_theta)
    return pdf[..., None]


def env_lookup_bilinear_plain(env, u0i, v0i, du, dv):
    h, w = env.shape[0], env.shape[1]
    flat = env.reshape(h * w, 3)
    u0 = u0i.long()
    v0 = v0i.long()
    u1 = torch.where(u0 + 1 >= w, 0, u0 + 1)
    v1 = torch.clamp_max(v0 + 1, h - 1)
    du = du[..., None]
    dv = dv[..., None]
    acc = (1.0 - du) * (1.0 - dv) * flat[v0 * w + u0]
    acc = acc + du * (1.0 - dv) * flat[v0 * w + u1]
    acc = acc + (1.0 - du) * dv * flat[v1 * w + u0]
    return acc + du * dv * flat[v1 * w + u1]


def bounce_record_plain(m_pdf, c_pdf, wi, wi_e, pdf_e, hit, shadowed,
                        base_alive, nrm):
    """A fused bounce's record: (aux (..., 5) bf16 = normalize9(bf16(wi))
    | alive & ~shadowed | alive & ~hit; recb (..., 13) bf16 = pdf_e | D′'s
    pdf of wi | wi_e | du, dv of wi_e's taps, of wi's | u0, v0 of wi_e's
    taps, of wi's; nrm (..., 3) f16). wi, wi_e (..., 3), pdf_e (..., 1),
    hit, shadowed (...); base_alive and nrm broadcast to them."""
    h, w = c_pdf.shape
    uv_e = bilinear_coords(wi_e, h, w)
    pdf_at = env_pdf_dir(m_pdf, c_pdf, wi.contiguous())
    uv_b = bilinear_coords(wi, h, w)
    rec_uvi = torch.stack([uv_e[0], uv_e[1], uv_b[0], uv_b[1]],
                          -1).to(torch.int16)
    rec_uvf = torch.stack([uv_e[2], uv_e[3], uv_b[2], uv_b[3]],
                          -1).to(torch.bfloat16)
    win = wi.to(torch.bfloat16).to(torch.float32)
    win = win / torch.clamp_min(norm(win), 1e-9)
    tgt = win.shape[:-1]
    gate_nee = (base_alive & ~shadowed).to(torch.float32)
    gate_miss = (base_alive & ~hit).to(torch.float32)
    aux = prof.cat([win, gate_nee[..., None], gate_miss[..., None]],
                   -1).to(torch.bfloat16)
    recb = prof.cat(
        [pdf_e.to(torch.bfloat16), pdf_at.to(torch.bfloat16),
         wi_e.to(torch.bfloat16), rec_uvf, rec_uvi.to(torch.bfloat16)], -1)
    return aux, recb, nrm.expand(tgt + (3,)).to(torch.float16)


# -------------------------------------------------------------- kernels

def _launch_env_sample(m_cdf, m_pdf, c_cdf, c_pdf, u2, want_texels):
    """Check the arguments and launch kernel D: (wi (m, 3), pdf (m,),
    texels (m, 2) int32 or None) for the flattened queries."""
    h, w = c_cdf.shape
    dev = u2.device
    u2f = u2.reshape(-1, 2).contiguous()
    m = u2f.shape[0]
    for name, t, shp in (("m_cdf", m_cdf, (h,)), ("m_pdf", m_pdf, (h,)),
                         ("c_cdf", c_cdf, (h, w)), ("c_pdf", c_pdf, (h, w)),
                         ("u2", u2f, (m, 2))):
        _lib.expect(t, name, torch.float32, shp, dev)
    if h > ENV_AXIS_MAX or w > ENV_AXIS_MAX:
        raise ValueError(f"env_sample_dir: tables of {h}x{w}, at most "
                         f"{ENV_AXIS_MAX} a side")
    wi = torch.empty((m, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty((m,), dtype=torch.float32, device=dev)
    tex = (torch.empty((m, 2), dtype=torch.int32, device=dev)
           if want_texels else None)
    if m:
        _lib.check(_lib.lib().env_sample_dir_launch(
            m_cdf.data_ptr(), m_pdf.data_ptr(), c_cdf.data_ptr(),
            c_pdf.data_ptr(), u2f.data_ptr(), wi.data_ptr(), pdf.data_ptr(),
            tex.data_ptr() if want_texels else None, m, h, w,
            _lib.stream_ptr(u2f)), "env_sample_dir")
        _lib.count_launch("env_sample_dir", (m, h, w))
    return wi, pdf, tex


def env_sample_dir(m_cdf, m_pdf, c_cdf, c_pdf, u2):
    """Kernel D: NEE sample (wi (..., 3), pdf (..., 1)) from uniforms
    u2 (..., 2) under the (H, W) conditional / (H,) marginal tables, whose
    CDFs must ascend strictly (``ops.envmap.build_sampler`` floors every
    texel's weight, so its tables do)."""
    if u2.device.type == "cpu":
        return env_sample_dir_plain(m_cdf, m_pdf, c_cdf, c_pdf, u2)
    shape = u2.shape[:-1]
    wi, pdf, _ = _launch_env_sample(m_cdf, m_pdf, c_cdf, c_pdf, u2, False)
    return wi.reshape(*shape, 3), pdf.reshape(*shape, 1)


def env_sample_texels(m_cdf, m_pdf, c_cdf, c_pdf, u2):
    """Row and column (..., 2) that kernel D picks for uniforms u2: the
    same launch as ``env_sample_dir`` with the texel output switched on,
    for holding the searches against ``env_sample_texels_plain``."""
    if u2.device.type == "cpu":
        return env_sample_texels_plain(m_cdf, c_cdf, u2)
    _, _, tex = _launch_env_sample(m_cdf, m_pdf, c_cdf, c_pdf, u2, True)
    return tex.reshape(*u2.shape[:-1], 2).long()


def env_pdf_dir(m_pdf, c_pdf, d):
    """Kernel D′: solid-angle pdf (..., 1) of directions d (..., 3)."""
    if d.device.type == "cpu":
        return env_pdf_dir_plain(m_pdf, c_pdf, d)
    h, w = c_pdf.shape
    dev = d.device
    shape = d.shape[:-1]
    df = d.reshape(-1, 3).contiguous()
    m = df.shape[0]
    _lib.expect(m_pdf, "m_pdf", torch.float32, (h,), dev)
    _lib.expect(c_pdf, "c_pdf", torch.float32, (h, w), dev)
    _lib.expect(df, "d", torch.float32, (m, 3), dev)
    if h > ENV_AXIS_MAX or w > ENV_AXIS_MAX:
        raise ValueError(f"env_pdf_dir: tables of {h}x{w}, at most "
                         f"{ENV_AXIS_MAX} a side")
    pdf = torch.empty((m,), dtype=torch.float32, device=dev)
    if m:
        _lib.check(_lib.lib().env_pdf_dir_launch(
            m_pdf.data_ptr(), c_pdf.data_ptr(), df.data_ptr(),
            pdf.data_ptr(), m, h, w, _lib.stream_ptr(df)), "env_pdf_dir")
        _lib.count_launch("env_pdf_dir", (m, h, w))
    return pdf.reshape(*shape, 1)


def env_lookup_bilinear(env, u0i, v0i, du, dv):
    """Kernel E: exact-f32 bilinear fetch (..., 3) from an (H, W, 3)
    emitter at tap coords u0i, v0i (int32) and fractions du, dv."""
    if env.device.type == "cpu":
        return env_lookup_bilinear_plain(env, u0i, v0i, du, dv)
    h, w = env.shape[0], env.shape[1]
    dev = env.device
    shape = u0i.shape
    args = [x.reshape(-1).contiguous() for x in (u0i, v0i, du, dv)]
    m = args[0].shape[0]
    _lib.expect(env, "env", torch.float32, (h, w, 3), dev)
    for name, t, dt in zip(("u0i", "v0i", "du", "dv"), args,
                           (torch.int32, torch.int32, torch.float32,
                            torch.float32)):
        _lib.expect(t, name, dt, (m,), dev)
    out = torch.empty((m, 3), dtype=torch.float32, device=dev)
    if m:
        _lib.check(_lib.lib().env_lookup_bilinear_launch(
            env.data_ptr(), *[a.data_ptr() for a in args], out.data_ptr(),
            m, h, w, _lib.stream_ptr(env)), "env_lookup_bilinear")
        _lib.count_launch("env_lookup_bilinear", (m, h, w))
    return out.reshape(*shape, 3)


# PyTorch divides by a Python scalar on the card as a multiplication by its
# f32 reciprocal; the record kernel's taps take the same factors
_INV_TWO_PI = float(torch.tensor(1.0) / torch.tensor(2.0 * PI))
_INV_PI = float(torch.tensor(1.0) / torch.tensor(PI))


def _own_size(t) -> int:
    """Elements of ``t`` that its strides reach (a broadcast counts once)."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0)


def bounce_record(m_pdf, c_pdf, wi, wi_e, pdf_e, hit, shadowed, base_alive,
                  nrm):
    """Kernel H: ``bounce_record_plain``'s (aux, recb, nrm) in one launch,
    bit for bit. base_alive and nrm are read through their broadcast
    strides."""
    if wi.device.type == "cpu":
        return bounce_record_plain(m_pdf, c_pdf, wi, wi_e, pdf_e, hit,
                                   shadowed, base_alive, nrm)
    h, w = c_pdf.shape
    dev = wi.device
    tgt = wi.shape[:-1]
    if len(tgt) != 2:
        raise ValueError(f"bounce_record: wi of shape {tuple(wi.shape)}, "
                         "expected (n0, n1, 3)")
    m = math.prod(tgt)
    for name, t, dt, shp in (
            ("m_pdf", m_pdf, torch.float32, (h,)),
            ("c_pdf", c_pdf, torch.float32, (h, w)),
            ("wi", wi, torch.float32, tgt + (3,)),
            ("wi_e", wi_e, torch.float32, tgt + (3,)),
            ("pdf_e", pdf_e, torch.float32, tgt + (1,)),
            ("hit", hit, torch.bool, tgt),
            ("shadowed", shadowed, torch.bool, tgt)):
        _lib.expect(t, name, dt, shp, dev)
    if h > ENV_AXIS_MAX or w > ENV_AXIS_MAX:
        raise ValueError(f"bounce_record: tables of {h}x{w}, at most "
                         f"{ENV_AXIS_MAX} a side")
    # read through their strides: a broadcast keeps its zero stride
    alive = base_alive.expand(tgt)
    nrm2 = nrm.expand(tgt + (3,))
    for name, t, dt in (("base_alive", alive, torch.bool),
                        ("nrm", nrm2, torch.float32)):
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{dt} on {dev}")
    aux = torch.empty(tgt + (5,), dtype=torch.bfloat16, device=dev)
    recb = torch.empty(tgt + (13,), dtype=torch.bfloat16, device=dev)
    nrm16 = torch.empty(tgt + (3,), dtype=torch.float16, device=dev)
    if m:
        _lib.check(_lib.lib().bounce_record_launch(
            m_pdf.data_ptr(), c_pdf.data_ptr(), wi.data_ptr(),
            wi_e.data_ptr(), pdf_e.data_ptr(), hit.data_ptr(),
            shadowed.data_ptr(), alive.data_ptr(), *alive.stride(),
            nrm2.data_ptr(), *nrm2.stride(), aux.data_ptr(),
            recb.data_ptr(), nrm16.data_ptr(), m, tgt[1], h, w,
            _INV_TWO_PI, _INV_PI, _lib.stream_ptr(wi)), "bounce_record")
        _lib.count_launch("bounce_record", (m, h, w, _own_size(alive),
                                            _own_size(nrm2) // 3))
    return aux, recb, nrm16
