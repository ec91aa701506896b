#!/usr/bin/env python3
"""Smoke run of the multiframe MAP/IRLS solve on the GPU.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the sharded solves on four cards
    python chip_smoke.py --rehearse    # the same phases at toy sizes on any
                                       # backend; exits 1 and prints no result

One-card phases, in one process:

1. device: ``jax.devices()`` and the card's name and power limit; anything
   but a GPU exits non-zero;
2. memory: ``compiled.memory_analysis()`` of each jitted solve (no
   hand-written kernel is on this path: the objective is plain XLA);
3. golden parity in float32 against the C++ reference's outputs
   (``tests/golden``): icon, dallas TV, dallas4x BTV;
4. solves through ``IRLSMapSolver.solve`` with default options on seeded
   scenes: the flagship geometry with TV and with BTV, and a 4096^2
   16-frame burst with BTV, each against its ground truth with a PSNR floor;
5. the CLI on the flagship scene, written as ENVI (no OpenCV);
6. the card-only checks of ``tests/test_gpu.py``.

``--four-cards`` runs only the sharded solves (frame, band and row x col
meshes, each with the host IRLS loop and ``fused_irls``) and compares each
with the one-card run of the same problem. Any failure exits non-zero; the
last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# The whole run goes without OpenCV (the card's machine need not have it).
sys.modules["cv2"] = None

# PSNR floors (dB) of the seeded solves: the plain XLA path on the CPU, in
# float32 with linear_cg, at the same seeds on the central 240x240 crop of
# each scene gave 34.47 (flagship TV), 33.26 (flagship BTV) and 37.51
# (burst BTV); each floor sits 2.5 dB below (crop versus whole scene). A
# broken gradient costs tens of dB.
FLOORS = {"flagship_tv": 32.0, "flagship_btv": 30.5, "burst4096_btv": 35.0}
FLAGSHIP_SHIFTS = [(0, 0), (1, 1), (0, 1), (1, 0)]


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def make_scene(hw, seed: int, channels: int = 1) -> np.ndarray:
    """A seeded natural-looking scene in [0, 1]: 1/f-filtered noise (texture
    at every scale) plus a few hard-edged shapes."""
    rng = np.random.default_rng(seed)
    h, w = hw
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    out = []
    for _ in range(channels):
        noise = rng.standard_normal((h, w)).astype(np.float32)
        img = np.fft.irfft2(np.fft.rfft2(noise) / f ** 1.2, s=(h, w))
        img = (img - img.min()) / (img.max() - img.min())
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(6):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(0.05, 0.2) * min(h, w)
            level = rng.uniform(0.0, 1.0)
            if rng.random() < 0.5:
                mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            else:
                mask = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < 0.6 * r)
            img = np.where(mask, 0.5 * img + 0.5 * level, img)
        out.append(img.astype(np.float32))
    return np.stack(out)


def burst_shifts(n: int = 16):
    """16 frames at scale 4: the 4x4 integer phase grid, every other frame
    moved by a fixed fraction of a pixel."""
    shifts = []
    for k in range(n):
        i, j = divmod(k % 16, 4)
        frac = (0.5, 0.25) if k % 2 else (0.0, 0.0)
        shifts.append((float(j + frac[0]), float(i + frac[1])))
    return shifts


def build_solver(gt, shifts, scale, reg, *, blur=(3, 1.5), mesh=None,
                 options=None):
    import jax.numpy as jnp

    from super_resolution_tpu.models import ImageModel, ImageModelParameters
    from super_resolution_tpu.motion import MotionShiftSequence
    from super_resolution_tpu.solvers import IRLSMapSolver, IRLSMapSolverOptions

    model = ImageModel.create(ImageModelParameters(
        scale=scale, blur_radius=blur[0], blur_sigma=blur[1],
        motion_sequence=MotionShiftSequence(shifts),
    ))
    gt_j = jnp.asarray(gt)
    lows = [model.apply(gt_j, k) for k in range(len(shifts))]
    solver = IRLSMapSolver(options or IRLSMapSolverOptions(), model, lows,
                           mesh=mesh)
    if reg is not None:
        solver.add_regularizer(*reg)
    return solver, lows


def initial_estimate(lows, scale):
    import jax

    lr0 = lows[0]
    c, h, w = lr0.shape
    return jax.image.resize(lr0, (c, h * scale, w * scale), "linear")


def regularizer(kind: str, lam: float = 0.01):
    from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer
    from super_resolution_tpu.ops.tv import TotalVariationRegularizer

    if kind == "tv":
        return (TotalVariationRegularizer(), lam)
    if kind == "tv3d":
        return (TotalVariationRegularizer(use_3d_total_variation=True), lam)
    return (BilateralTotalVariationRegularizer(3, 0.5), lam)


def psnr(a, b) -> float:
    from super_resolution_tpu.evaluation import psnr as _psnr

    return float(_psnr(np.asarray(a), np.asarray(b)))


def memory_analysis(solver, x0) -> None:
    """``memory_analysis()`` of the solver's jitted inner solve, lowered
    with the arguments it runs with."""
    import dataclasses

    import jax.numpy as jnp

    opts = dataclasses.replace(solver.options)
    opts.adjust_thresholds_adaptively(
        int(np.prod(solver.hr_shape)), solver.regularization_parameter_sum
    )
    inner = solver._build_inner_solver(solver.num_channels, opts)
    weights = tuple(jnp.ones(solver.hr_shape, x0.dtype)
                    for _ in solver.regularizers)
    compiled = inner.lower(
        solver._place_initial(x0), solver.observations, solver.shifts, weights
    ).compile()
    log("   memory_analysis:", compiled.memory_analysis())


# --------------------------------------------------------------- phases


def phase_golden() -> None:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    import test_reference_parity as golden

    for name in ("test_icon_unregularized_parity", "test_dallas_tv_parity",
                 "test_dallas4x_btv_parity_north_star"):
        t0 = time.perf_counter()
        getattr(golden, name)()
        log(f"   {name}: pass ({time.perf_counter() - t0:.1f} s)")


def run_solve(name, gt, shifts, scale, reg_kind, card, floor) -> dict:
    import jax

    from super_resolution_tpu.solvers import IRLSMapSolverOptions

    # Default options with the production inner solver (bench.py's choice).
    options = IRLSMapSolverOptions(least_squares_solver="linear_cg")
    solver, lows = build_solver(gt, shifts, scale, regularizer(reg_kind),
                                options=options)
    x0 = initial_estimate(lows, scale)
    memory_analysis(solver, x0)
    times = []
    for attempt in ("cold", "warm"):
        t0 = time.perf_counter()
        out = jax.block_until_ready(solver.solve(x0))
        times.append(time.perf_counter() - t0)
    iters = solver.last_inner_iterations
    pixels = int(np.prod(solver.hr_shape))
    quality = psnr(out, gt)
    stats = jax.devices()[0].memory_stats() or {}
    row = {
        "solve": name, "hr": list(gt.shape), "frames": len(shifts),
        "psnr_db": quality, "floor_db": floor,
        "seconds_cold": times[0], "seconds_warm": times[1],
        "inner_iterations": int(iters),
        "mpixel_iters_per_s": iters * pixels / times[1] / 1e6,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "card": card,
    }
    log("   " + json.dumps(row))
    if not np.isfinite(np.asarray(out)).all():
        raise AssertionError(f"{name}: non-finite output")
    if quality < floor:
        raise AssertionError(f"{name}: PSNR {quality:.3f} dB < floor {floor}")
    return row


def phase_cli(gt, tmp: str, floor: float) -> None:
    from super_resolution_tpu.cli.super_resolve import main as cli_main
    from super_resolution_tpu.spectral import HyperspectralDataLoader

    scene = os.path.join(tmp, "flagship_scene")
    HyperspectralDataLoader(scene).save_image(gt)
    motion = os.path.join(tmp, "motion.txt")
    with open(motion, "w") as f:
        f.write("\n".join(f"{dx} {dy}" for dx, dy in FLAGSHIP_SHIFTS) + "\n")
    result = os.path.join(tmp, "cli_result")
    argv = [
        "--data_path", scene + ".config", "--generate_lr_images",
        "--number_of_frames", "4", "--motion_sequence_path", motion,
        "--upsampling_scale", "4", "--blur_radius", "3", "--blur_sigma", "1.5",
        "--regularizer", "tv", "--regularization_parameter", "0.01",
        "--solver", "linear_cg", "--evaluators", "psnr",
        "--result_path", result,
    ]
    t0 = time.perf_counter()
    code = cli_main(argv)
    log(f"   cli exit code {code} ({time.perf_counter() - t0:.1f} s)")
    if code != 0:
        raise AssertionError(f"CLI exited {code}")
    loader = HyperspectralDataLoader(result + ".config")
    loader.load_image_from_envi_file()
    out = np.asarray(loader.get_image().array)
    quality = psnr(out, gt)
    log(f"   cli result PSNR {quality:.3f} dB (floor {floor})")
    if quality < floor:
        raise AssertionError(f"CLI result PSNR {quality:.3f} dB below floor")


def phase_gpu_checks(device) -> None:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    import test_gpu

    for name in sorted(n for n in dir(test_gpu) if n.startswith("test_")):
        getattr(test_gpu, name)(device)
        log(f"   {name}: pass")


def one_card(rehearse: bool, card: str) -> None:
    import jax

    flag_hw = (64, 64) if rehearse else (1000, 1000)
    burst_hw = (96, 96) if rehearse else (4096, 4096)
    floors = dict(FLOORS)
    if rehearse:
        floors = {k: 0.0 for k in floors}

    log("phase 2+4: solves (memory analysis of each jitted solve first)")
    flag_gt = make_scene(flag_hw, seed=1)
    run_solve("flagship_tv", flag_gt, FLAGSHIP_SHIFTS, 4, "tv", card,
              floors["flagship_tv"])
    run_solve("flagship_btv", flag_gt, FLAGSHIP_SHIFTS, 4, "btv", card,
              floors["flagship_btv"])
    burst_gt = make_scene(burst_hw, seed=2)
    run_solve("burst4096_btv", burst_gt, burst_shifts(), 4, "btv", card,
              floors["burst4096_btv"])

    log("phase 3: golden parity (float32)")
    phase_golden()

    log("phase 5: CLI on the flagship scene (ENVI, no OpenCV)")
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        phase_cli(flag_gt, tmp, floors["flagship_tv"])

    log("phase 6: card-only checks (tests/test_gpu.py)")
    if rehearse:
        log("   skipped: no card")
    else:
        phase_gpu_checks(jax.devices()[0])


# ------------------------------------------------------------ four cards


def compare_mesh(name, gt, shifts, scale, reg_kind, axes, devices,
                 rehearse) -> None:
    import jax
    import jax.numpy as jnp

    from super_resolution_tpu.parallel import make_mesh
    from super_resolution_tpu.solvers import IRLSMapSolverOptions

    mesh = make_mesh(axes, devices)
    opts = dict(max_num_irls_iterations=2, max_num_solver_iterations=10,
                least_squares_solver="linear_cg")
    for fused in (False, True):
        o = IRLSMapSolverOptions(fused_irls=fused, **opts)
        single, lows = build_solver(gt, shifts, scale, regularizer(reg_kind),
                                    options=o)
        sharded, _ = build_solver(gt, shifts, scale, regularizer(reg_kind),
                                  options=o, mesh=mesh)
        x0 = initial_estimate(lows, scale)
        w = jnp.asarray(np.random.default_rng(3).uniform(0.5, 1.5, gt.shape),
                        x0.dtype)

        def evaluate(solver):
            make_spatial = solver._spatial_objective(o, solver.num_channels)
            if make_spatial is not None:
                vg = make_spatial(solver.observations, solver.shifts)
            else:
                vg = solver._value_and_grad(o, solver.observations,
                                            solver.shifts)
            f = jax.jit(lambda x, w: vg.prepare((w,))(x))
            return f(solver._place_initial(x0), solver._place_initial(w))

        with jax.default_matmul_precision("highest"):
            c1, g1 = evaluate(single)
            cm, gm = evaluate(sharded)
        cost_rel = abs(float(cm) - float(c1)) / abs(float(c1))
        grad_err = float(jnp.max(jnp.abs(jnp.asarray(gm) - g1))
                         / jnp.max(jnp.abs(g1)))
        x1 = jax.block_until_ready(single.solve(x0))
        t0 = time.perf_counter()
        xm = jax.block_until_ready(sharded.solve(x0))
        t_mesh = time.perf_counter() - t0
        rel_l2 = float(jnp.linalg.norm(jnp.asarray(xm) - x1)
                       / jnp.linalg.norm(x1))
        d_psnr = abs(psnr(xm, gt) - psnr(x1, gt))
        shard_devices = sorted(
            s.device.id for s in sharded.observations.addressable_shards
        )
        out_devices = sorted(d.id for d in xm.sharding.device_set)
        row = {
            "mesh": name, "axes": axes, "fused_irls": fused,
            "cost_rel": cost_rel, "grad_rel": grad_err, "rel_l2": rel_l2,
            "psnr_diff_db": d_psnr, "psnr_db": psnr(xm, gt),
            "mesh_solve_seconds": t_mesh,
            "observation_shard_devices": shard_devices,
            "result_devices": out_devices,
        }
        log("   " + json.dumps(row))
        if not rehearse and len(set(shard_devices)) < len(devices):
            raise AssertionError(f"{name}: shards on {shard_devices}")
        if cost_rel > 1e-5 or grad_err > 1e-5:
            raise AssertionError(f"{name}: objective differs {cost_rel} {grad_err}")
        if rel_l2 > 1e-3 or d_psnr > 0.01:
            raise AssertionError(f"{name}: solve differs {rel_l2} {d_psnr}")


def four_cards(rehearse: bool) -> None:
    import jax

    from super_resolution_tpu.parallel import (
        BAND_AXIS,
        COL_AXIS,
        FRAME_AXIS,
        ROW_AXIS,
    )

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devices)}")
    log("devices:", [(d.id, d.device_kind) for d in devices])
    burst_hw = (96, 96) if rehearse else (4096, 4096)
    band_hw = (32, 32) if rehearse else (512, 512)
    bands = 8 if rehearse else 64
    burst = make_scene(burst_hw, seed=2)
    compare_mesh("frame4", burst, burst_shifts(), 4, "btv",
                 {FRAME_AXIS: 4}, devices, rehearse)
    stack = make_scene(band_hw, seed=4, channels=bands)
    compare_mesh("band4", stack, FLAGSHIP_SHIFTS, 2, "tv3d",
                 {BAND_AXIS: 4}, devices, rehearse)
    compare_mesh("rowcol2x2", burst, burst_shifts(), 4, "btv",
                 {ROW_AXIS: 2, COL_AXIS: 2}, devices, rehearse)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded solves, on four cards")
    parser.add_argument("--rehearse", action="store_true",
                        help="toy sizes on any backend; exits 1, no result")
    args = parser.parse_args(argv)

    import jax

    log("phase 1: device")
    devices = jax.devices()
    log("  ", devices)
    card = card_line()
    log("  ", card)
    platform = devices[0].platform
    if platform != "gpu" and not args.rehearse:
        log(f"no GPU: JAX runs on {platform}")
        return 1

    from super_resolution_tpu.utils.compile_cache import configure_compile_cache

    log("   compile cache:", configure_compile_cache())
    if args.four_cards:
        four_cards(args.rehearse)
    else:
        one_card(args.rehearse, card)
    if args.rehearse:
        log("rehearsal finished; no accelerator result")
        return 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": platform,
        "kind": devices[0].device_kind,
        "count": 4 if args.four_cards else len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
