"""Frame-mesh scaling across a REAL process boundary (jax.distributed).

The scaling story needs at least one point with a process boundary in it
(the >=2-hosts north-star, BASELINE.md). This harness runs the SAME
frame-sharded MAP solve (fixed iteration budget) in two configurations:

  1p: one process owning 1 CPU device      — all K frames on one device
  2p: two processes x 1 CPU device each,   — K/2 frames per process,
      joined by ``jax.distributed.initialize`` over localhost gRPC (the
      same code path a multi-host run takes)

and reports frame-iters/s for each plus the speedup. On this 2-vCPU host
the 2-process run genuinely uses both cores, so the speedup reflects real
parallel work with the gradient psum crossing the process boundary every
CG iteration. Every worker is pinned to the CPU: these are CPU numbers, not
device numbers; the artifact is the cross-process collective path.

Run:  python experiments/multihost_scaling.py
Output: one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

COORD = "127.0.0.1:47693"
FRAMES = 16
HR = 384
ITERS = 8
REPEATS = 3


def worker(process_id: int, num_processes: int) -> None:
    # One CORE per process: in the loopback analogy a "host" is one core, so
    # the 1-process baseline must not silently use the whole machine via
    # XLA:CPU intra-op threading while the 2-process run splits it.
    try:
        os.sched_setaffinity(0, {process_id % (os.cpu_count() or 1)})
    except (AttributeError, OSError):
        pass
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax

    jax.config.update("jax_platforms", "cpu")
    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=COORD,
            num_processes=num_processes,
            process_id=process_id,
        )
    import numpy as np
    import jax.numpy as jnp

    from super_resolution_tpu.models import ImageModel, ImageModelParameters
    from super_resolution_tpu.motion import MotionShiftSequence
    from super_resolution_tpu.parallel import (
        FRAME_AXIS,
        make_mesh,
        make_sharded_map_solver,
        shard_problem,
    )

    n_global = num_processes  # 1 device per process
    assert len(jax.devices()) == n_global

    rng = np.random.default_rng(7)
    hr = jnp.asarray(rng.random((1, HR, HR)), jnp.float32)
    seq = MotionShiftSequence(
        ([(0, 0), (1, 1), (-1, 0), (0, -1)] * ((FRAMES + 3) // 4))[:FRAMES]
    )
    model = ImageModel.create(
        ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0,
                             motion_sequence=seq)
    )
    obs = jnp.stack([model.apply(hr, k) for k in range(FRAMES)])
    shifts = jnp.asarray(seq.as_array(), jnp.float32)
    kernel = jnp.asarray(model.blur_operator.kernel, jnp.float32)

    mesh = make_mesh({FRAME_AXIS: n_global})
    x0, obs_s, shifts_s = shard_problem(mesh, jnp.zeros_like(hr), obs, shifts)
    solve = make_sharded_map_solver(
        mesh, kernel, 2, max_shift=3, max_iterations=ITERS,
        gradient_norm_threshold=0.0, cost_decrease_threshold=0.0,
        parameter_variation_threshold=0.0,
    )
    out = solve(x0, obs_s, shifts_s, ())  # compile + warm
    jax.block_until_ready(out.x)
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = solve(x0, obs_s, shifts_s, ())
        jax.block_until_ready(out.x)
        best = min(best, time.perf_counter() - t0)
    if process_id == 0:
        print(json.dumps({
            "processes": num_processes,
            "frame_iters_per_s": round(FRAMES * ITERS / best, 1),
            "best_solve_s": round(best, 4),
        }), flush=True)


def orchestrate() -> int:
    results = {}
    for nproc in (1, 2):
        procs = []
        for pid in range(nproc):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--process_id", str(pid), "--num_processes", str(nproc)],
                env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"},
                stdout=subprocess.PIPE, text=True,
            ))
        outs = [p.communicate(timeout=600)[0] for p in procs]
        if any(p.returncode != 0 for p in procs):
            print(f"FAIL at {nproc} processes", file=sys.stderr)
            return 1
        for line in "".join(outs).splitlines():
            line = line.strip()
            if line.startswith("{"):
                results[nproc] = json.loads(line)
    speedup = (
        results[2]["frame_iters_per_s"] / results[1]["frame_iters_per_s"]
    )
    print(json.dumps({
        "metric": "multihost_loopback_frame_mesh_scaling",
        "unit": "frame-iters/s",
        "environment": "cpu-loopback (2-vCPU host; 1 device/process)",
        "points": [results[1], results[2]],
        "speedup_2p_over_1p": round(speedup, 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    if "--process_id" in sys.argv:
        pid = int(sys.argv[sys.argv.index("--process_id") + 1])
        n = int(sys.argv[sys.argv.index("--num_processes") + 1])
        worker(pid, n)
        sys.exit(0)
    sys.exit(orchestrate())
