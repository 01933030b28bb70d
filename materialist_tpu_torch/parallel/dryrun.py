"""Ranks for the sharded paths, and the four agreement checks of the JAX
package's multi-device dry run (``__graft_entry__.py::dryrun_multichip``).

``run_ranks(fn, world, args, device)`` starts ``world`` ranks (on the
card unless the caller asks for the CPU) with
``torch.multiprocessing`` (spawn), each in a process group that meets
through a file in a temporary directory: gloo on the CPU; on CUDA, nccl
when every rank has a card of its own, else gloo (nccl refuses two ranks
on one card). Rank r calls ``fn(device, *args)`` and its return value
(plain Python and numpy only) comes back in rank order. A rank's
exception fails the run with its traceback; the process group has a
timeout and the ranks a deadline, so a hung rank fails the run too.

``dryrun_rank`` is such an ``fn``: the four asserts of the JAX dry run,
with its bounds (``assert_agree``), on a scene given as numpy arrays
(``dryrun_multichip`` runs them on the JAX dry run's toy scene, on the
card unless the caller asks for the CPU; from the command line: ``python
-m materialist_tpu_torch.parallel.dryrun --world 4 [--device cpu]``):

1. the spp-sharded render equals the unsharded render;
2. the px-sharded render equals the per-FilmSlice renders, concatenated;
3. the spp-sharded step's parameters and loss equal the unsharded
   step's, and the parameters and the optimizer state are the same bit
   for bit on every rank;
4. the px-sharded step's loss is finite and equals the sum of the
   per-slice losses, and its gradients equal the sum of the per-slice
   gradients.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops.color import linear_to_srgb
from materialist_tpu_torch.ops.kernels import _lib
from materialist_tpu_torch.parallel.mesh import make_mesh
from materialist_tpu_torch.parallel.sharding import (
    image_loss, make_px_sharded_train_step, make_sharded_train_step,
    px_sharded_render, spp_sharded_render)
from materialist_tpu_torch.render.scene import Materials, make_gbuffer
from materialist_tpu_torch.render.shader import (FilmSlice, RenderConfig,
                                                 compact_cap_utilization,
                                                 render_with_bsdf,
                                                 trace_step_records)


def backend_for(device_type: str, world: int) -> str:
    if device_type == "cpu":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def _rank_main(rank, world, device_type, init_file, timeout, fn, args, q):
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend_for(device_type, world), init_method="file://" + init_file,
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        q.put((rank, True, out))
    except Exception:
        q.put((rank, False, traceback.format_exc()))
        sys.exit(1)


def run_ranks(fn, world: int, args=(), device=None,
              timeout: float = 120.0):
    """Run ``fn(device, *args)`` in ``world`` ranks on ``device`` (default:
    the card; raises without one unless ``device="cpu"``); returns their
    results in rank order. ``fn`` must be importable (spawned ranks import
    it). On CUDA the kernels are built here first, so that the ranks never
    race on the build."""
    device_type = device_mod.resolve(device).type
    if device_type == "cuda":
        _lib.lib()
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="materialist_ranks_")
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, device_type, init_file, timeout, fn,
                               tuple(args), q), daemon=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world)) - set(results))
                raise TimeoutError(f"ranks {late} did not finish within "
                                   f"{timeout} s")
            try:
                rank, ok, out = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in results and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} exited with code "
                                           f"{p.exitcode} and no report")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                raise TimeoutError("a rank did not exit after its report")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]


# ------------------------------------------------------------ the asserts

def assert_agree(a, b, what: str, flip_frac: float = 0.005):
    """Agreement up to the order of float sums: a march's threshold
    compare can flip for a ray on the boundary, a per-ray difference, not
    an estimator fault. So all but ``flip_frac`` of the elements match
    within 1e-5 + 1e-4·|b|, and the means agree to 1e-4 relative.
    Returns (max |a - b|, the fraction outside)."""
    a = a.detach().double()
    b = b.detach().double()
    d = (a - b).abs()
    frac = float((d > 1e-5 + 1e-4 * b.abs()).double().mean())
    if frac > flip_frac:
        raise AssertionError(f"{what}: {frac:.4%} of the elements differ "
                             f"(at most {flip_frac:.2%})")
    rel = abs(float(a.mean() - b.mean())) / (abs(float(b.mean())) + 1e-9)
    if rel >= 1e-4:
        raise AssertionError(f"{what}: means differ by {rel:.3e} relative")
    return float(d.max()), frac


def toy_scene(res: int = 16) -> dict:
    """The JAX dry run's toy scene (``_toy_scene``) as numpy arrays: depth
    2 + U(0, 1) from PRNGKey(0), flat 0.6 albedo, 0.5 roughness, 0.1
    metallic, a white 16×32 envmap and a 0.3 target."""
    depth = 2.0 + rng.uniform(rng.key(0), (res, res))
    return dict(depth=depth.numpy(), flip_depth=False,
                albedo=np.full((res, res, 3), 0.6, np.float32),
                roughness=np.full((res, res, 1), 0.5, np.float32),
                metallic=np.full((res, res, 1), 0.1, np.float32),
                envmap=np.ones((16, 32, 3), np.float32),
                gt=np.full((res, res, 3), 0.3, np.float32))


def scene_on(scene: dict, dev):
    """(cam, gbuf, params, gt_srgb) of a numpy scene on ``dev``; params =
    {"mats": Materials, "envmap"} as fresh leaves that require grad (the
    normal, which the mesh-normal estimator does not read, excepted)."""
    h, w = scene["depth"].shape
    cam = Camera(h, w)
    gbuf = make_gbuffer(scene["depth"], cam, flip_depth=scene["flip_depth"],
                        device=dev)

    def leaf(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=dev).clone().requires_grad_()
    params = {"mats": Materials(leaf(scene["albedo"]),
                                leaf(scene["roughness"]),
                                leaf(scene["metallic"]), gbuf.normal_geo),
              "envmap": leaf(scene["envmap"])}
    gt = linear_to_srgb(torch.as_tensor(scene["gt"], dtype=torch.float32,
                                        device=dev))
    return cam, gbuf, params, gt


def leaves(params):
    """The tensors of ``params`` that require grad, in a fixed order."""
    return [t for t in (*params["mats"], params["envmap"])
            if t.requires_grad]


def identical_across_ranks(tensors) -> bool:
    """Whether every rank holds the same bits in each tensor (rank 0's,
    broadcast, compared with ==; NaN never equals)."""
    same = torch.ones((), dtype=torch.int32, device=tensors[0].device)
    for t in tensors:
        t = t.detach().to(same.device)
        r0 = t.clone()
        dist.broadcast(r0, src=0)
        same = same * int(torch.equal(t, r0))
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same)


def foreign_modules():
    """Modules of the JAX side loaded in this process."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "materialist_tpu"
                  or m.startswith("materialist_tpu."))


def optimizer_state(opt):
    """The tensors of a torch.optim optimizer's state, in a fixed order."""
    return [v for s in opt.state.values() for v in s.values()
            if torch.is_tensor(v)]


def dryrun_rank(dev, scene: dict, cfg_fields: dict, lr: float = 1e-3):
    """The four asserts on this rank (``cfg_fields``: RenderConfig fields;
    spp // chunk must be a multiple of the world size). Rank 0 prints each
    as it passes. Returns {"lines": [...], "peak_bytes": int or None,
    "launches": the kernel launches of the four (None on the CPU),
    "cap_util": {bounce: the largest live count / cap of this rank's own
    slice in the px render and step} ({} without compaction caps: the
    caps are fractions of the slice's rays, so a slice busier than the
    film can fill them and drop rays, on both sides of asserts 2 and 4),
    "foreign_modules": [...]}."""
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = RenderConfig(**cfg_fields)
    cam, gbuf, params, gt = scene_on(scene, dev)
    mats, env = params["mats"], params["envmap"]
    h = gbuf.dist.shape[0]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        _lib.reset_launches()
    lines = []

    def say(line):
        lines.append(line)
        if rank == 0:
            print(f"[dryrun] {line}", flush=True)

    mesh_spp = make_mesh(world, "spp", dev.type)
    mesh_px = make_mesh(world, "px", dev.type)

    # 1. the ranks' chunk keys partition the unsharded chunk-key list
    key = rng.key(7)
    with torch.no_grad():
        ref = render_with_bsdf(key, cfg, cam, gbuf, mats, env)
    img = spp_sharded_render(mesh_spp, cfg, cam)(key, gbuf, mats, env)
    dmax, frac = assert_agree(img, ref, "spp-sharded render")
    say(f"1/4 spp-sharded render == unsharded estimator on {world} ranks "
        f"(max |d| = {dmax:.2e}, decision-flip pixels = {frac:.4%})")

    # 2. the px path keys each slice with fold_in(key, i)
    key = rng.key(2)
    n_rows = h // world
    with torch.no_grad():
        ref = torch.cat([render_with_bsdf(
            rng.fold_in(key, i), cfg, cam, gbuf, mats, env,
            film=FilmSlice(i * n_rows, n_rows)) for i in range(world)])
    img = px_sharded_render(mesh_px, cfg, cam)(key, gbuf, mats, env)
    dmax, frac = assert_agree(img, ref, "px-sharded render")
    say(f"2/4 px-sharded render == per-slice estimator (max |d| = "
        f"{dmax:.2e}, decision-flip pixels = {frac:.4%})")

    # 3. the spp-sharded step against one unsharded step from the same
    # parameters, key and optimizer
    key = rng.key(1)
    _, _, p_sh, _ = scene_on(scene, dev)
    opt = torch.optim.Adam(leaves(p_sh), lr=lr)
    loss = float(make_sharded_train_step(mesh_spp, cfg, cam, opt)(
        p_sh, key, gbuf, gt))
    _, _, p_ref, _ = scene_on(scene, dev)
    opt_ref = torch.optim.Adam(leaves(p_ref), lr=lr)
    loss_ref = image_loss(render_with_bsdf(key, cfg, cam, gbuf,
                                           p_ref["mats"], p_ref["envmap"]),
                          gt)
    loss_ref.backward()
    opt_ref.step()
    loss_ref = float(loss_ref.detach())
    if not np.isfinite(loss) or abs(loss - loss_ref) > 1e-4 * abs(loss_ref):
        raise AssertionError(f"spp-sharded step loss {loss} against the "
                             f"unsharded {loss_ref}")
    dmax, frac = assert_agree(p_sh["mats"].albedo, p_ref["mats"].albedo,
                              "spp-sharded step albedo", flip_frac=0.01)
    if not identical_across_ranks(leaves(p_sh) + optimizer_state(opt)):
        raise AssertionError("the parameters or the optimizer state differ "
                             "between ranks after the spp-sharded step")
    say(f"3/4 spp-sharded train step == unsharded step (loss {loss:.6f}, "
        f"albedo max |d| = {dmax:.2e}, flip elements = {frac:.4%}); "
        "parameters and optimizer state identical on every rank")

    # 4. the px-sharded step against the per-slice losses and gradients,
    # summed (the SUM convention of the all-reduce)
    key = rng.key(3)
    _, _, p_px, _ = scene_on(scene, dev)
    opt = torch.optim.Adam(leaves(p_px), lr=lr)
    loss = float(make_px_sharded_train_step(mesh_px, cfg, cam, opt)(
        p_px, key, gbuf, gt))
    _, _, p_ref, _ = scene_on(scene, dev)
    w = gbuf.dist.shape[1]
    loss_ref = 0.0
    for i in range(world):
        rows = slice(i * n_rows, (i + 1) * n_rows)
        diff = linear_to_srgb(render_with_bsdf(
            rng.fold_in(key, i), cfg, cam, gbuf, p_ref["mats"],
            p_ref["envmap"], film=FilmSlice(i * n_rows, n_rows))) - gt[rows]
        part = (torch.sum(diff ** 2) + torch.sum(torch.abs(diff))) / (
            h * w * 3)
        part.backward()
        loss_ref += float(part.detach())
    if not np.isfinite(loss) or abs(loss - loss_ref) > 1e-5 * abs(loss_ref):
        raise AssertionError(f"px-sharded step loss {loss} against the sum "
                             f"of the slices' {loss_ref}")
    worst = 0.0
    for got, want, name in zip(leaves(p_px), leaves(p_ref),
                               ("albedo", "roughness", "metallic",
                                "envmap")):
        worst = max(worst, assert_agree(got.grad, want.grad,
                                        f"px-sharded step d_{name}")[0])
    say(f"4/4 px-sharded train step on {world} ranks: loss={loss:.6f} "
        f"(sum of the slices' {loss_ref:.6f}), gradients == the sum of "
        f"the per-slice gradients (max |d| = {worst:.2e})")
    cap_util = {}
    with torch.no_grad():
        for seed in (2, 3):
            recs = trace_step_records(
                rng.fold_in(rng.key(seed), rank), cfg, cam, gbuf, mats, env,
                film=FilmSlice(rank * n_rows, n_rows))
            for b, u in compact_cap_utilization(recs):
                cap_util[b] = max(cap_util.get(b, 0.0), float(u))
    on_card = dev.type == "cuda"
    return {"lines": lines, "cap_util": cap_util,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) if on_card
                           else None),
            "launches": dict(_lib.LAUNCHES) if on_card else None,
            "foreign_modules": foreign_modules()}


def dryrun_multichip(world: int, device=None, res: int = 64,
                     timeout: float = 600.0):
    """The JAX dry run's first stage (``__graft_entry__.py``): the four
    asserts on ``world`` ranks, on its toy scene at ``res``² with
    spp = world in chunks of 1, max_depth 3, the "exact" march (4 steps)
    and film jitter 0.5, on ``device`` (default: the card; raises
    without one unless ``device="cpu"``). Returns each rank's result."""
    dev = device_mod.resolve(device)
    cfg = dict(spp=world, chunk=1, max_depth=3, march_impl="exact",
               march_vectorized=True, march_steps=4, shadow_steps=4,
               fine_steps=1, shadow_fine_steps=1, film_jitter=0.5)
    return run_ranks(dryrun_rank, world, args=(toy_scene(res), cfg),
                     device=dev, timeout=timeout)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=dryrun_multichip.__doc__)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--res", type=int, default=64)
    a = ap.parse_args()
    for r, out in enumerate(dryrun_multichip(a.world, a.device, a.res)):
        print(f"rank {r}: four asserts passed; peak bytes "
              f"{out['peak_bytes']}; modules of the JAX side "
              f"{out['foreign_modules']}")
