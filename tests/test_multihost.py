"""Multi-host (DCN) smoke test: two localhost processes, four global virtual
CPU devices, one batch-sharded solve with psum'd global stats.

SURVEY.md §5 distributed row: the reference has zero distribution; the
multi-host entry is ``jax.distributed.initialize`` wrapped by
``parallel.mesh.initialize_distributed``. This test proves that entry and the
cross-process collective path are live — no card or real multi-host
needed.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import quadrotor_hovering_setup
from accelerated_tinympc_tpu.solver.batched import (
    batch_stats, init_state_batched, solve_batched,
)

WORKER = pathlib.Path(__file__).parent / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_solve():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coord, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    stats = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("STATS"):
                _tag, pid, n, conv, itsum = line.split()
                stats[int(pid)] = (float(n), float(conv), float(itsum))
    assert set(stats) == {0, 1}, outs
    # psum makes every process see identical global stats.
    assert stats[0] == stats[1]

    # And they match a single-process run of the same global batch.
    import jax
    import jax.numpy as jnp

    problem, cache, x0 = quadrotor_hovering_setup()
    settings = atm.Settings(max_iter=60, check_termination=1,
                            abs_pri_tol=0.02, abs_dua_tol=0.02)
    B = 16
    rng = np.random.default_rng(11)
    x0s = rng.standard_normal((B, 12)).astype(np.float32) * 0.1 + np.asarray(
        x0, np.float32
    )
    st = init_state_batched(B, 12, 4, 10)
    st = st.replace(x=st.x.at[:, 0, :].set(jnp.asarray(x0s)))
    st = jax.jit(lambda s: solve_batched(s, problem, cache, settings))(st)
    ref = batch_stats(st, settings)
    n, conv, itsum = stats[0]
    assert n == B
    assert conv == pytest.approx(
        float(ref["converged_fraction"]) * B, abs=0.01
    )
    assert itsum == pytest.approx(
        float(ref["iterations_mean"]) * B, rel=1e-6
    )

    # Pallas sharded path across the process boundary: both workers ran
    # sharded_fused_solve over the same global mesh and checked their
    # addressable output shards against an unsharded fused solve.
    fused = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("FUSED"):
                _tag, pid, n, rows, diff = line.split()
                fused[int(pid)] = (float(n), int(rows), float(diff))
    assert set(fused) == {0, 1}, outs
    for pid, (n, rows, diff) in fused.items():
        assert n == B, (pid, n)
        assert rows == B // 2, (pid, rows)  # half the batch lives here
        assert diff < 1e-5, (pid, diff)
