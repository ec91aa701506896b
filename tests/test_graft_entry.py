"""Driver-hook regression tests for __graft_entry__.py.

``entry()`` returns the flagship objective step for a compile check, and
``dryrun_multichip(N)`` rehearses the multi-device sharding paths on N
virtual CPU devices. The dryrun must never open an accelerator: it forces
virtual CPU devices before any backend initializes, and its child process is
pinned to the CPU as well, so it can run beside a process that holds the
card.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_returns_jittable_step():
    import jax

    sys.path.insert(0, REPO)
    try:
        from __graft_entry__ import entry
    finally:
        sys.path.remove(REPO)

    fn, args = entry()
    # Lowering traces the whole fused objective; abstract eval only (fast,
    # backend-independent) — the driver compiles it on the real chip.
    lowered = jax.jit(fn).lower(*args)
    assert lowered is not None
    cost, grad = jax.eval_shape(fn, *args)
    assert cost.shape == ()
    assert grad.shape == args[0].shape


@pytest.mark.parametrize("n_devices", [2])
def test_dryrun_multichip_never_touches_default_backend(n_devices):
    # Subprocess: dryrun_multichip clears and re-initializes JAX backends,
    # which must not leak into this test process. The child is pinned to
    # the CPU explicitly, so it never opens an accelerator.
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # conftest's 8-device flag; dryrun sets its own
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            "from __graft_entry__ import dryrun_multichip; "
            f"dryrun_multichip({n_devices}); print('DRYRUN_OK')",
        ],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DRYRUN_OK" in proc.stdout
