"""Multi-process (multi-host loopback) distributed solve test.

Spawns 2 processes joined by ``jax.distributed.initialize`` over localhost —
the code path a multi-host run takes — and checks the frame-sharded solve
against a local reference inside each process. The children are pinned to
the CPU, so the test never opens an accelerator."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "multihost_loopback.py")


@pytest.mark.timeout(300)
def test_two_process_loopback():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [sys.executable, SCRIPT],
        env=env,
        capture_output=True,
        text=True,
        timeout=280,
    )
    assert result.returncode == 0, result.stdout + result.stderr
    assert "PASS" in result.stdout
