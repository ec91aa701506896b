"""Multi-host (multi-process) loopback validation of the distributed solver.

Launches N processes on this host, each owning some CPU devices, joined into
one JAX distributed runtime (``jax.distributed.initialize`` — the same
code path a multi-host run takes). Every worker is pinned to the CPU, so the
rehearsal never opens an accelerator. The frame-sharded MAP
solve then runs over the global mesh and every process checks the result
against a locally computed single-process reference.

Run:  python experiments/multihost_loopback.py            (orchestrator)
      ... which spawns itself with --process_id / --num_processes.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

COORD = "127.0.0.1:47655"
DEVICES_PER_PROCESS = 2


def worker(process_id: int, num_processes: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEVICES_PER_PROCESS}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=COORD,
        num_processes=num_processes,
        process_id=process_id,
    )
    import numpy as np
    import jax.numpy as jnp

    from super_resolution_tpu.models import ImageModel, ImageModelParameters
    from super_resolution_tpu.motion import MotionShiftSequence
    from super_resolution_tpu.parallel import FRAME_AXIS, make_mesh, make_sharded_map_solver, shard_problem
    from super_resolution_tpu.solvers import make_map_value_and_grad, minimize

    n_global = DEVICES_PER_PROCESS * num_processes
    assert len(jax.devices()) == n_global, (len(jax.devices()), n_global)

    rng = np.random.default_rng(7)
    hr = jnp.asarray(rng.random((1, 16, 16)), jnp.float32)
    seq = MotionShiftSequence([(0, 0), (1, 1), (-1, 0), (0, -1)] * (n_global // 4))
    model = ImageModel.create(
        ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq)
    )
    obs = jnp.stack([model.apply(hr, k) for k in range(n_global)])
    shifts = jnp.asarray(seq.as_array(), jnp.float32)
    kernel = jnp.asarray(model.blur_operator.kernel, jnp.float32)

    mesh = make_mesh({FRAME_AXIS: n_global})
    x0, obs_s, shifts_s = shard_problem(mesh, jnp.zeros_like(hr), obs, shifts)
    solve = make_sharded_map_solver(mesh, kernel, 2, max_shift=3, max_iterations=25)
    out = solve(x0, obs_s, shifts_s, ())
    result = np.asarray(jax.device_get(out.x))

    vg = make_map_value_and_grad(obs, shifts, kernel, 2, max_shift=3)
    ref = minimize(lambda x: vg(x, ()), jnp.zeros_like(hr), max_iterations=25)
    err = np.abs(result - np.asarray(ref.x)).max()
    print(f"[process {process_id}] devices={n_global} max|dist-local|={err:.2e}", flush=True)
    assert err < 1e-3, err  # f32 reduction-order noise across device layouts
    print(f"[process {process_id}] OK", flush=True)


def orchestrate(num_processes: int = 2) -> int:
    procs = []
    for pid in range(num_processes):
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--process_id", str(pid), "--num_processes", str(num_processes)],
                env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"},
            )
        )
    codes = [p.wait(timeout=600) for p in procs]
    ok = all(c == 0 for c in codes)
    print("multihost loopback:", "PASS" if ok else f"FAIL {codes}")
    return 0 if ok else 1


if __name__ == "__main__":
    if "--process_id" in sys.argv:
        pid = int(sys.argv[sys.argv.index("--process_id") + 1])
        n = int(sys.argv[sys.argv.index("--num_processes") + 1])
        worker(pid, n)
    else:
        sys.exit(orchestrate())
