"""Inverse-optimization driver: alternate envmap and material recovery
(counterpart of ``materialist_tpu/opt/loop.py``).

Up to ``max_loops`` outer loops: loop N runs an envmap phase then the
material phases of ``opt_order``, the final loop the envmap only; each
phase is early-stopped, and SaveBest persists the argmin-MSE state to
``best_results/`` after every phase. Each epoch is one step of
``opt/step.py`` (trace records, shade, adjoint, update).

Differences from the JAX package: the networks are initialised from
torch generators seeded 1 (envmap) and 2 (material) instead of Flax's
init keys. With ``compact`` (the default) ``optimize`` probes the scene's
compaction caps once at start-up on a CUDA device; on the CPU it compacts
only with caps passed in, as the JAX package does off its accelerator.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from materialist_tpu_torch import config as gconfig
from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera, norm
from materialist_tpu_torch.io import image as image_io
from materialist_tpu_torch.io import video as video_io
from materialist_tpu_torch.models import posmlp
from materialist_tpu_torch.ops.color import linear_to_srgb
from materialist_tpu_torch.opt import schedules
from materialist_tpu_torch.opt.callbacks import EarlyStopping, SaveBest
from materialist_tpu_torch.opt.step import make_phase_step
from materialist_tpu_torch.render.scene import GBuffer, Materials
from materialist_tpu_torch.render.shader import (RenderConfig,
                                                 compact_cap_utilization,
                                                 probe_compact_caps)
from materialist_tpu_torch.utils.profiling import JsonlLogger, PhaseTimer


@dataclasses.dataclass
class InverseOptions:
    """CLI-level knobs; the fields and defaults of the JAX package."""
    opt_src: str = "a"
    opt_order: Sequence[str] = ("rm", "a")
    model_name: str = "pos_mlp"        # pos_mlp | none
    use_mask: bool = False
    opt_env_from: int = 0
    output_type: str = "arm"           # arm | armn
    use_mesh_normal: bool = True
    spp: int = gconfig.DEFAULT_SPP
    num_epochs: int = gconfig.NUM_EPOCHS
    env_hw: tuple = (gconfig.ENV_H, gconfig.ENV_W)
    scale_delta: float = 0.1
    frame_every: int = 10              # 0 disables frame/video output
    max_loops: int = 3
    seed: int = 0
    chunk: int = 4
    march_steps: int = 24
    shadow_steps: int = 16
    march_impl: str = "fused"
    march_vectorized: bool = False
    film_jitter: float = 0.5
    trace_every: int = 1
    time_budget_s: float = 0.0
    budget_split: bool = True
    snapshot_every: int = 500
    compact: bool = True


def _render_cfg(opts: InverseOptions) -> RenderConfig:
    return RenderConfig(spp=opts.spp, chunk=min(opts.chunk, opts.spp),
                        use_mesh_normal=opts.use_mesh_normal,
                        march_steps=opts.march_steps,
                        shadow_steps=opts.shadow_steps,
                        march_impl=opts.march_impl,
                        march_vectorized=opts.march_vectorized,
                        film_jitter=opts.film_jitter)


def _apply_mask_constraint(r, m, mask):
    """In-mask roughness/metallic forced to their in-mask means."""
    mask3 = mask[..., None]
    cnt = torch.clamp_min(torch.sum(mask3.to(r.dtype)), 1.0)
    r_mean = torch.sum(r * mask3) / cnt
    m_mean = torch.sum(m * mask3) / cnt
    return torch.where(mask3, r_mean, r), torch.where(mask3, m_mean, m)


def _mats_from_dict(mat) -> Materials:
    return Materials(mat["albedo"], mat["roughness"], mat["metallic"],
                     mat["normal"])


def start_arm_of(ori: Materials, output_type: str = "arm"):
    """The material net's input rows (H·W, 5), clamped to [0, 1]: albedo,
    roughness, metallic of the start maps ``ori``; for "armn" (H·W, 8),
    unclamped, the normal after them."""
    h, w = ori.albedo.shape[:2]
    n = h * w
    if output_type == "armn":
        return torch.cat(
            [ori.albedo.reshape(n, 3), ori.roughness.reshape(n, 1),
             ori.metallic.reshape(n, 1), ori.normal.reshape(n, 3)], -1)
    return torch.clamp(torch.cat(
        [ori.albedo.reshape(n, 3), ori.roughness.reshape(n, 1),
         ori.metallic.reshape(n, 1)], -1), 0, 1)


def _constrained_mats(maps, mask=None) -> Materials:
    """``Materials`` of (albedo, rough, metal, normal); with a ``mask``,
    in-mask roughness and metallic forced to their in-mask means."""
    albedo, rough, metal, nrm = maps
    if mask is not None:
        rough, metal = _apply_mask_constraint(rough, metal, mask)
    return Materials(albedo, rough, metal, nrm)


def mlp_maps_of(start_arm, part: str, hw, output_type: str = "arm",
                mask=None):
    """``maps_of(net, extra)`` of a pos_mlp material phase: the channels
    in ``part`` predicted by the net from ``start_arm``, the rest frozen at
    the current maps (no gradient); ``extra`` is (current maps, envmap)."""
    h, w = hw

    def maps_of(net, extra):
        cur, envmap = extra
        out = net(start_arm)
        albedo = (torch.clamp(out[..., 0:3], 0, 1).reshape(h, w, 3)
                  if "a" in part else cur["albedo"].detach())
        rough = (torch.clamp(out[..., 3:4] * 0.93 + 0.07, 0, 1)
                 .reshape(h, w, 1) if "r" in part
                 else cur["roughness"].detach())
        metal = (torch.clamp(out[..., 4:5], 0, 1).reshape(h, w, 1)
                 if "m" in part else cur["metallic"].detach())
        if output_type == "armn" and "n" in part:
            nrm = out[..., 5:8]
            nrm = (nrm / torch.clamp_min(norm(nrm), 1e-9)).reshape(h, w, 3)
        else:
            nrm = cur["normal"].detach()
        return _constrained_mats((albedo, rough, metal, nrm), mask), envmap
    return maps_of


def material_loss_of(part: str, gt_image, ori: Materials,
                     scale_delta: float = 0.1, use_mesh_normal: bool = True):
    """``loss_of(maps, img, extra)`` of a material phase: the image scaled
    to the photo's mean, 3·(l1/mse)·mse + l1 of its sRGB (the ratio held
    constant), plus ``scale_delta`` times the mean distance of each
    optimised map in ``part`` from its start ``ori``. Aux: (mse, the
    render loss, the map term, the maps detached, the sRGB image)."""
    gt_srgb = linear_to_srgb(gt_image)

    def loss_of(maps, img, extra):
        mats = maps[0]
        albedo, rough, metal, nrm = mats
        ratio = torch.mean(gt_image) / torch.clamp_min(
            torch.mean(img).detach(), 1e-9)
        pred = linear_to_srgb(img * ratio)
        mse = torch.mean((pred - gt_srgb) ** 2)
        l1 = torch.mean(torch.abs(pred - gt_srgb))
        aux = 0.0
        if "a" in part:
            aux = aux + torch.mean(torch.abs(albedo - ori.albedo))
        if "r" in part:
            aux = aux + torch.mean(torch.abs(rough - ori.roughness))
        if "m" in part:
            aux = aux + torch.mean(torch.abs(metal - ori.metallic))
        if "n" in part and not use_mesh_normal:
            aux = aux + torch.mean(torch.abs(nrm - ori.normal))
        scale_ratio = (l1 / torch.clamp_min(mse, 1e-12)).detach()
        render_loss = 3.0 * scale_ratio * mse + l1
        loss = render_loss + aux * scale_delta
        det = Materials(*[t.detach() for t in mats])
        return loss, (mse.detach(), render_loss.detach(),
                      aux.detach() if torch.is_tensor(aux) else aux,
                      det, pred.detach())
    return loss_of


def plan_phase_weights(opts: InverseOptions) -> list:
    """Weighted list of the phases ``optimize`` will execute (material
    1.0, env 0.5, reference-quirk 1-epoch env 0.02)."""
    def env_weight(ln):
        if ln < opts.opt_env_from or ("rm" not in opts.opt_src
                                      and ln == 1
                                      and opts.opt_src != "skip"):
            return 0.02
        return 0.5

    if opts.opt_src == "skip":
        return [1.0]
    plan = []
    for ln in range(1, opts.max_loops + 1):
        plan.append(env_weight(ln))
        if ln >= opts.max_loops:
            break
        for part in opts.opt_order:
            if part == "a" and ln <= 1:
                continue
            plan.append(1.0)
    return plan


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def optimize(gbuf: GBuffer, cam: Camera, mat: dict, output_dir: str,
             opts: InverseOptions, device=None, compact_caps=None) -> dict:
    """Run the alternating optimization on ``device`` (default: the card;
    raises without one unless ``device="cpu"``); returns the best state.
    ``compact_caps`` overrides the probed wavefront-compaction caps (and
    is the only way to compact on the CPU); ``opts.compact=False``
    switches compaction off.

    ``mat``: albedo (H,W,3), roughness (H,W,1), metallic (H,W,1), normal
    (H,W,3), gt_image (H,W,3 linear), optional mask (H,W) bool, optional
    gt_envmap (16,32,3) — numpy arrays or tensors.
    """
    dev = device_mod.resolve(device)
    mat = {k: torch.as_tensor(np.array(_np(v)), device=dev)
           for k, v in mat.items()}
    gbuf = GBuffer(*[t.to(dev) for t in gbuf])
    os.makedirs(os.path.join(output_dir, "best_results"), exist_ok=True)
    timer = PhaseTimer()
    metrics = JsonlLogger(os.path.join(output_dir, "metrics.jsonl"))
    env_frames_dir = os.path.join(output_dir, "env_frames")
    mat_frames_dir = os.path.join(output_dir, "mat_frames")
    os.makedirs(env_frames_dir, exist_ok=True)
    os.makedirs(mat_frames_dir, exist_ok=True)
    env_frames, mat_frames = [], []

    cfg = _render_cfg(opts)
    env_h, env_w = opts.env_hw
    key = rng.key(opts.seed)

    if opts.compact and cfg.max_depth > 2:
        if compact_caps is None and dev.type == "cuda":
            compact_caps = probe_compact_caps(
                rng.key(opts.seed + 99), cfg, cam, gbuf,
                _mats_from_dict(mat),
                torch.ones(tuple(opts.env_hw) + (3,), device=dev))
        if compact_caps:
            cfg = cfg._replace(compact_caps=tuple(compact_caps))
            print("[optimize] wavefront compaction caps: "
                  f"{cfg.compact_caps}", flush=True)

    cap_util = {}   # bounce -> largest live count / cap so far (device)

    def track_caps(records):
        for b, f in compact_cap_utilization(records[0]):
            cap_util[b] = torch.maximum(cap_util[b], f) if b in cap_util \
                else f

    def cap_note():
        """Live count against the compaction caps, read at print cadence
        only; warns when a cap saturates (live rays are being dropped)."""
        parts = []
        for b, f in sorted(cap_util.items()):
            fv = float(f)
            parts.append(f"b{b}={fv:.2f}")
            if fv >= 0.999:
                print(f"[optimize] WARNING: compaction cap saturated at "
                      f"bounce {b} (util {fv:.3f}): live rays are being "
                      "dropped; re-probe compact_caps", flush=True)
        return " cap_util[" + ",".join(parts) + "]" if parts else ""

    gt_image = mat["gt_image"].to(torch.float32)
    gt_srgb = linear_to_srgb(gt_image)

    r_shift, m_shift = 0.7, 0.05
    if "r" not in opts.opt_src:
        mat["roughness"] = mat["roughness"] * 0 + r_shift
    if "m" not in opts.opt_src:
        mat["metallic"] = mat["metallic"] * 0 + m_shift
    albedo_ori = mat["albedo"]
    roughness_ori = mat["roughness"]
    metallic_ori = mat["metallic"]
    normal_ori = mat["normal"] / torch.clamp_min(norm(mat["normal"]), 1e-9)
    mat["normal"] = normal_ori

    h, w = gt_image.shape[:2]
    ori = Materials(albedo_ori, roughness_ori, metallic_ori, normal_ori)
    start_arm = start_arm_of(ori, opts.output_type)

    envmap_net = posmlp.make_envmap_net(
        torch.Generator().manual_seed(1)).to(dev)
    start_env = torch.ones((env_h * env_w, 3), dtype=torch.float32,
                           device=dev)
    brdf_net = posmlp.make_brdf_net(
        opts.output_type, torch.Generator().manual_seed(2)).to(dev)

    saver = SaveBest()
    early_all = EarlyStopping(patience=2, min_delta=0.025)

    def maybe_snapshot(epoch: int) -> None:
        if opts.snapshot_every and epoch > 0 \
                and epoch % opts.snapshot_every == 0:
            saver.save_results(os.path.join(output_dir, "best_results"))

    mask = mat.get("mask")
    if mask is not None:
        mask = mask.to(torch.bool)

    # ---------------- phase steps (opt/step.py)
    def env_maps_of(net, extra):
        return extra, net(start_env).reshape(env_h, env_w, 3)

    def env_loss_of(maps, img, extra):
        pred = linear_to_srgb(img)
        mse = torch.mean((pred - gt_srgb) ** 2)
        l1 = torch.mean(torch.abs(pred - gt_srgb))
        return mse + l1, (mse.detach(), maps[1].detach(), img.detach())

    env_phase = make_phase_step(cfg, cam, gbuf, env_maps_of, env_loss_of,
                                device=dev)
    env_opts = {1: schedules.adam_steplr(1e-3),
                2: schedules.adam_plain(1e-4)}
    env_step_fns = {}

    def get_env_step(loop_num):
        k = 1 if loop_num == 1 else 2
        if k not in env_step_fns:
            env_step_fns[k] = env_phase.make_step(env_opts[k])
        return env_opts[k], env_step_fns[k]

    mat_mask = mask if opts.use_mask else None
    mat_phases = {}

    def get_mat_phase(kind, part):
        key_ = (kind, part)
        if key_ in mat_phases:
            return mat_phases[key_]
        if kind == "mlp":
            maps_of = mlp_maps_of(start_arm, part, (h, w), opts.output_type,
                                  mat_mask)
            opt = schedules.adamw_steplr(3e-4, floor=1.5e-4)
        else:
            def maps_of(params, extra):
                cur, envmap = extra
                albedo = (torch.clamp(params["albedo"], 0, 1)
                          if "a" in part else cur["albedo"])
                rough = (torch.clamp(params["roughness"], 0.07, 1)
                         if "r" in part else cur["roughness"])
                metal = (torch.clamp(params["metallic"], 0, 1)
                         if "m" in part else cur["metallic"])
                if "n" in part and not opts.use_mesh_normal:
                    nr = params["normal"]
                    nrm = nr / torch.clamp_min(norm(nr), 1e-9)
                else:
                    nrm = cur["normal"]
                return (_constrained_mats((albedo, rough, metal, nrm),
                                          mat_mask), envmap)
            opt = schedules.adam_steplr(3e-4, floor=1.5e-4)
        loss_of = material_loss_of(part, gt_image, ori, opts.scale_delta,
                                   opts.use_mesh_normal)
        phase = make_phase_step(cfg, cam, gbuf, maps_of, loss_of,
                                device=dev)
        entry = (phase, phase.make_step(opt), opt)
        mat_phases[key_] = entry
        return entry

    # ---------------- frame helpers (host side)
    def save_env_frame(env_np, pred_srgb_np, loop_num, epoch):
        image_io.write(os.path.join(output_dir, "env.png"),
                       np.clip(env_np, 0, 1), linear_input=False)
        gt_np = _np(gt_srgb)
        canvas = np.zeros_like(gt_np)
        dh = min(env_np.shape[0] * 3, canvas.shape[0] // 2)
        dw = int(dh * env_np.shape[1] / env_np.shape[0])
        env_big = image_io.resize_bilinear_align_corners(env_np, (dh, dw))
        y0 = (canvas.shape[0] - dh) // 2
        x0 = (canvas.shape[1] - dw) // 2
        canvas[y0:y0 + dh, x0:x0 + dw] = np.clip(env_big, 0, 1)
        frame = np.concatenate([gt_np, np.clip(pred_srgb_np, 0, 1), canvas],
                               axis=1)
        p = os.path.join(env_frames_dir,
                         f"opt_env_frame_{loop_num}_{epoch:04d}.png")
        image_io.write(p, frame, linear_input=False)
        env_frames.append(p)
        return frame

    def save_mat_frame(mats: Materials, pred_srgb_np, loop_num, part, epoch):
        tiles = [_np(gt_srgb), np.clip(pred_srgb_np, 0, 1),
                 _np(mats.albedo), np.repeat(_np(mats.roughness), 3, -1),
                 np.repeat(_np(mats.metallic), 3, -1),
                 _np(mats.normal) * 0.5 + 0.5]
        row1 = np.concatenate(tiles[:3], axis=1)
        row2 = np.concatenate(tiles[3:], axis=1)
        frame = np.clip(np.concatenate([row1, row2], axis=0), 0, 1)
        p = os.path.join(mat_frames_dir,
                         f"mat_frame_{loop_num}_{part}_{epoch:04d}.png")
        image_io.write(p, frame, linear_input=False)
        mat_frames.append(p)

    # ---------------- outer alternation
    loop_num = 0
    last_env_frame = None
    final_envmap = None
    deadline = (time.time() + opts.time_budget_s
                if opts.time_budget_s > 0 else None)

    def out_of_time():
        return deadline is not None and time.time() > deadline

    phase_plan = (plan_phase_weights(opts)
                  if deadline is not None and opts.budget_split else [])
    phase_deadline = deadline

    def begin_phase(label):
        nonlocal phase_deadline
        if deadline is None or not phase_plan:
            phase_deadline = deadline
            return
        wgt = phase_plan.pop(0)
        rem = deadline - time.time()
        if rem <= 0:
            phase_deadline = deadline
            return
        slice_s = rem * wgt / (wgt + sum(phase_plan))
        phase_deadline = time.time() + slice_s
        if wgt >= 0.1:
            print(f"[budget] {label}: {slice_s:.0f}s of {rem:.0f}s "
                  "remaining", flush=True)

    def phase_over():
        return (phase_deadline is not None
                and time.time() > phase_deadline) or out_of_time()

    while True:
        loop_num += 1
        env_opt, env_step = get_env_step(loop_num)
        begin_phase(f"env {loop_num}")
        opt_state = env_opt.init(list(envmap_net.parameters()))
        patience = 500 if opts.opt_src == "skip" else 100
        early = EarlyStopping(patience=patience, min_delta=0.01)
        mats_now = _mats_from_dict(mat)
        mse_val = float("nan")
        records = None
        for epoch in range(opts.num_epochs):
            if records is None or epoch % opts.trace_every == 0:
                records = None
                k_tr = rng.fold_in(key, loop_num * 1000000 + epoch)
                with timer.phase("env_trace"):
                    records = env_phase.trace_all(envmap_net, mats_now,
                                                  k_tr)
                    track_caps(records)
            with timer.phase("env_step"):
                loss, aux, _ = env_step(envmap_net, opt_state, mats_now,
                                        records)
                mse, env, img = aux
                mse_val = float(mse)
            metrics.log(phase="env", loop=loop_num, epoch=epoch,
                        mse=mse_val, loss=float(loss))
            saver.update(mse_val, mat["albedo"], mat["roughness"],
                         mat["metallic"], mat["normal"], env, img)
            early(mse_val)
            maybe_snapshot(epoch)
            if epoch % 50 == 0 or early.early_stop:
                print(f"[env {loop_num}] epoch {epoch} loss {float(loss):.4f}"
                      f" mse {mse_val:.4f}" + cap_note(), flush=True)
            if opts.frame_every and (epoch % opts.frame_every == 0
                                     or early.early_stop):
                last_env_frame = save_env_frame(
                    _np(env), _np(linear_to_srgb(img)), loop_num, epoch)
            if early.early_stop:
                print("Early stopping", flush=True)
                break
            if phase_over():
                print("[env] phase budget exhausted", flush=True)
                break
            if loop_num < opts.opt_env_from:
                break
            if "rm" not in opts.opt_src and loop_num == 1 \
                    and opts.opt_src != "skip":
                break

        final_envmap = saver.best["envmap"]
        if final_envmap is not None:
            image_io.write(os.path.join(output_dir, "final_envmap.hdr"),
                           _np(final_envmap))
        if last_env_frame is not None:
            image_io.write(os.path.join(output_dir, "opt_env_img.png"),
                           last_env_frame, linear_input=False)
        if loop_num >= opts.opt_env_from:
            saver.save_results(os.path.join(output_dir, "best_results"))
        early_all(mse_val)
        if early_all.early_stop:
            print("Global early stopping", flush=True)
            break
        if loop_num >= opts.max_loops or opts.opt_src == "skip":
            break
        if out_of_time():
            print("[loop] time budget exhausted", flush=True)
            break

        # ---- material phase
        if loop_num < opts.opt_env_from and loop_num == 1:
            if mat.get("gt_envmap") is not None:
                env4render = mat["gt_envmap"].to(torch.float32)
                print("use gt envmap for brdf optimization")
            else:
                env4render = torch.ones((env_h, env_w, 3),
                                        dtype=torch.float32, device=dev)
                print("Use envmap = 1 for brdf optimization")
        else:
            env4render = final_envmap.detach().clone()
            print("Use optimized envmap for brdf optimization")

        if loop_num <= 1:
            if "r" not in opts.opt_src:
                mat["roughness"] = mat["roughness"] * 0 + r_shift
            if "m" not in opts.opt_src:
                mat["metallic"] = mat["metallic"] * 0 + m_shift

        for part in opts.opt_order:
            if part == "a" and loop_num <= 1:
                continue
            if out_of_time():
                print(f"[mat {part}] time budget exhausted", flush=True)
                break
            patience = max(200 // loop_num, 1)
            delta = 0.005 if "a" in part else 0.001
            early = EarlyStopping(patience=patience, min_delta=delta)
            begin_phase(f"mat {part} {loop_num}")
            cur = {k2: mat[k2] for k2 in
                   ("albedo", "roughness", "metallic", "normal")}
            extra = (cur, env4render)
            if opts.model_name == "none":
                params = {}
                for tok, name in (("a", "albedo"), ("r", "roughness"),
                                  ("m", "metallic")):
                    if tok in part:
                        params[name] = mat[name].clone().requires_grad_()
                if "n" in part and not opts.use_mesh_normal:
                    params["normal"] = mat["normal"].clone().requires_grad_()
                phase, step, opt = get_mat_phase("direct", part)
                label = f"mat_direct[{part}]"
                tag = f"mat-direct {loop_num}/{part}"
            else:
                params = brdf_net
                phase, step, opt = get_mat_phase("mlp", part)
                label = f"mat_mlp[{part}]"
                tag = f"mat-mlp {loop_num}/{part}"
            opt_state = opt.init(list(params.parameters())
                                 if isinstance(params, torch.nn.Module)
                                 else list(params.values()))
            records = None
            for epoch in range(opts.num_epochs):
                if records is None or epoch % opts.trace_every == 0:
                    records = None
                    k_tr = rng.fold_in(
                        key, loop_num * 1000000 + 500000 + epoch)
                    with timer.phase(f"mat_trace[{part}]"):
                        records = phase.trace_all(params, extra, k_tr)
                        track_caps(records)
                with timer.phase(label):
                    loss, auxes, params_pre = step(params, opt_state, extra,
                                                   records)
                    mse, render_loss, aux, mats_cur, pred = auxes
                    mse_val = float(mse)
                metrics.log(phase=label, loop=loop_num, epoch=epoch,
                            mse=mse_val, loss=float(loss))
                saver.update(mse_val, mats_cur.albedo, mats_cur.roughness,
                             mats_cur.metallic, mats_cur.normal, env4render,
                             pred,
                             net_params=(params_pre if opts.model_name
                                         != "none" else None))
                early(mse_val)
                maybe_snapshot(epoch)
                if epoch % 50 == 0 or early.early_stop:
                    print(f"[{tag}] epoch {epoch} loss {float(loss):.4f} "
                          f"mse {mse_val:.4f}" + cap_note(),
                          flush=True)
                if opts.frame_every and (epoch % opts.frame_every == 0
                                         or early.early_stop):
                    save_mat_frame(mats_cur, _np(pred), loop_num, part,
                                   epoch)
                if early.early_stop:
                    print("Early stopping", flush=True)
                    break
                if phase_over():
                    print("[mat] phase budget exhausted", flush=True)
                    break

            # restore the best maps and, for the MLP, the argmin weights
            for k2 in ("albedo", "roughness", "metallic", "normal"):
                if saver.best[k2] is not None:
                    mat[k2] = saver.best[k2]
            if opts.model_name != "none" and saver.best_net_params is not None:
                brdf_net.load_state_dict(saver.best_net_params)
            saver.save_results(os.path.join(output_dir, "best_results"))

    print("[profile] per-phase wall clock:\n" + timer.report(), flush=True)
    metrics.close()
    if env_frames:
        video_io.write_video(env_frames, os.path.join(
            output_dir, "env_optimization.mp4"), fps=10)
    if mat_frames:
        video_io.write_video(mat_frames, os.path.join(
            output_dir, "mat_optimization.mp4"), fps=10)
    best = saver.get_best()
    best["timer"] = dict(timer.totals)
    best["timer_counts"] = dict(timer.counts)
    best["compact_caps"] = cfg.compact_caps
    best["cap_util"] = {b: float(f) for b, f in sorted(cap_util.items())}
    return best
