"""Tracing / profiling utilities (SURVEY.md §5: the reference has only dead
timing code — reference: src/tinympc/admm.cpp:10 — and its DSE profiling lived
in external tools; here profiling is first-class).

- :func:`trace` wraps ``jax.profiler`` for on-demand traces.
- :func:`time_fn` measures steady-state wall time of a jitted callable with
  warm-up + ``block_until_ready``.
- :func:`solver_cost` gives the analytic per-solve FLOP/byte model of the
  condensed iteration (the roofline numerator for kernel work).
- :func:`device_info` / :func:`require_gpu` / :data:`PEAKS` name the device a
  measurement ran on and its published peaks. A measurement that finds no
  GPU fails; it never reports a CPU number under a device metric.
"""

from __future__ import annotations

import contextlib
import shutil
import subprocess
import time
from typing import Any, Callable, Iterator

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace of the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(
    fn: Callable[..., Any],
    *args: Any,
    reps: int = 5,
    warmup: int = 1,
) -> dict[str, float]:
    """Best/mean wall time of ``fn(*args)`` with device-blocking semantics."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return {
        "best_s": min(times),
        "mean_s": sum(times) / len(times),
        "reps": float(reps),
    }


def _pow2(n: int) -> int:
    return 1 << max(4, (int(n) - 1).bit_length())


def solver_cost(nx: int, nu: int, horizon: int, iters: int) -> dict[str, float]:
    """Analytic cost of one condensed-tier solve per instance.

    ``flops`` counts the unpadded math of the folded iteration (four
    matmuls per iteration, ops/fused_admm.py); ``flops_padded`` what the
    fused kernel issues at its power-of-two widths. ``state_bytes_per_solve``
    is the fused kernel's device-memory traffic per solve (carries + x0
    terms in, iterates + carries + stats out); the XLA condensed tier moves
    roughly that much *per iteration*.
    """
    Dx, Du = horizon * nx, (horizon - 1) * nu
    Dxp, Dup = _pow2(Dx), _pow2(Du)
    flops = 2 * iters * (Du * Dx + Du * Du + Dx * Du + Du * Du)
    flops_padded = 2 * iters * (Dup * Dxp + Dup * Dup + Dxp * Dup + Dup * Dup)
    state_bytes = 4 * ((4 * Dup + 3 * Dxp) + (5 * Dup + 4 * Dxp + 8))
    return {
        "flops": float(flops),
        "flops_padded": float(flops_padded),
        "state_bytes_per_solve": float(state_bytes),
    }


# Published peaks by ``device_kind`` (NVIDIA H100 / H200 data sheets, dense
# rates without sparsity, at the full power limit). f32 is the CUDA-core rate
# the solver's IEEE-f32 products run at; tf32/bf16 are the tensor-core rates.
PEAKS: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
    "NVIDIA H100 PCIe": {
        "f32_flops": 51e12, "tf32_flops": 378e12, "bf16_flops": 756e12,
        "hbm_bytes_per_s": 2.0e12,
    },
    "NVIDIA H200": {
        "f32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
        "hbm_bytes_per_s": 4.8e12,
    },
}


def peaks(device_kind: str) -> dict[str, float]:
    """Published peaks of ``device_kind``; an unknown device is an error."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "accelerated_tinympc_tpu.utils.profiling.PEAKS with its source"
        )
    return PEAKS[device_kind]


def device_info() -> dict[str, Any]:
    """The device a measurement runs on, as JAX reports it."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict[str, Any]:
    """:func:`device_info`, or ``SystemExit`` when JAX finds no GPU — a
    measurement never falls back to the CPU."""
    try:
        info = device_info()
    except Exception as exc:  # the requested backend cannot start
        raise SystemExit(f"no GPU found: {exc!r}") from None
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU found (JAX platform {info['platform']!r}); device "
            "measurements run on the card only"
        )
    return info


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, the
    line every device measurement is reported beside."""
    if shutil.which("nvidia-smi") is None:
        raise SystemExit("nvidia-smi not found")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def peak_bytes_in_use() -> int | None:
    """``peak_bytes_in_use`` of device 0 (what the program's arrays took)."""
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def memory_summary(compiled) -> dict[str, int]:
    """The buffer sizes XLA planned for a compiled executable."""
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {
        k: int(getattr(m, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
        ) if hasattr(m, k)
    }
