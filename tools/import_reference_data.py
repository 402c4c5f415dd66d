"""Import numeric problem/trajectory data from the reference C++ headers into .npz.

The reference ships its quadrotor plant models and reference trajectories as C++
initializer-list headers (reference: examples/problem_data/*.hpp,
examples/trajectory_data/*.hpp). This tool parses the *numbers only* (no code) into
NumPy archives under accelerated_tinympc_tpu/models/data/ so the framework and
its golden tests can consume them.

All reference arrays are row-major flat initializers (e.g. Adyn_data[NSTATES*NSTATES],
see reference examples/quadrotor_hovering.cpp:34-43 mapping them with Eigen::RowMajor).

Usage:  python tools/import_reference_data.py [--reference /root/reference]
"""

from __future__ import annotations

import argparse
import pathlib
import re

import numpy as np

ARRAY_RE = re.compile(
    r"tinytype\s+(\w+)\s*\[[^\]]*\]\s*=\s*\{(.*?)\};", re.DOTALL
)
SCALAR_RE = re.compile(r"tinytype\s+(\w+)\s*=\s*([-0-9.eE+]+)\s*;")


def parse_header(path: pathlib.Path) -> dict[str, np.ndarray]:
    text = path.read_text()
    out: dict[str, np.ndarray] = {}
    for name, body in ARRAY_RE.findall(text):
        vals = [float(tok) for tok in re.split(r"[,\s]+", body.strip()) if tok]
        out[name] = np.asarray(vals, dtype=np.float64)
    for name, val in SCALAR_RE.findall(text):
        out[name] = np.float64(val)
    return out


# Quadrotor problem headers: nx=12, nu=4 (reference glob_opts.hpp:5-6).
NX, NU = 12, 4

PROBLEM_SHAPES = {
    "Adyn_data": (NX, NX),
    "Bdyn_data": (NX, NU),
    "Kinf_data": (NU, NX),
    "Pinf_data": (NX, NX),
    "Quu_inv_data": (NU, NU),
    "AmBKt_data": (NX, NX),
    "coeff_d2p_data": (NX, NU),
    "Q_data": (NX,),
    "R_data": (NU,),
}


def import_problem(src: pathlib.Path, dst: pathlib.Path) -> None:
    raw = parse_header(src)
    arrs = {}
    for name, shape in PROBLEM_SHAPES.items():
        arrs[name.removesuffix("_data")] = raw[name].reshape(shape)
    arrs["rho"] = raw["rho_value"]
    np.savez(dst, **arrs)
    print(f"{src.name} -> {dst} ({sorted(arrs)})")


def import_trajectory(src: pathlib.Path, dst: pathlib.Path) -> None:
    raw = parse_header(src)
    if "Xref_data" in raw:
        flat = raw["Xref_data"]
    else:
        # Some snapshot headers are truncated mid-initializer (no closing "};").
        # Parse from the opening brace to EOF and drop any incomplete final row.
        text = src.read_text()
        body = text.split("{", 1)[1]
        toks = [t for t in re.split(r"[,\s]+", body) if t and t not in "};"]
        # A token truncated mid-number (e.g. "0.00") is still parseable; drop the
        # partial row it belongs to below.
        flat = np.asarray([float(t.rstrip("};")) for t in toks], dtype=np.float64)
    ntotal = flat.size // NX
    flat = flat[: ntotal * NX]
    np.savez(dst, Xref=flat.reshape(ntotal, NX))
    print(f"{src.name} -> {dst} (Xref {ntotal}x{NX})")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default="/root/reference")
    ap.add_argument(
        "--out",
        default=str(pathlib.Path(__file__).resolve().parents[1]
                    / "accelerated_tinympc_tpu" / "models" / "data"),
    )
    args = ap.parse_args()
    ref = pathlib.Path(args.reference)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    for hz in (20, 50, 100):
        import_problem(
            ref / "examples" / "problem_data" / f"quadrotor_{hz}hz_params.hpp",
            out / f"quadrotor_{hz}hz_params.npz",
        )
    for name in (
        "quadrotor_20hz_y_axis_line",
        "quadrotor_20hz_ref_hover",
        "quadrotor_100hz_ref_hover",
    ):
        import_trajectory(
            ref / "examples" / "trajectory_data" / f"{name}.hpp",
            out / f"{name}.npz",
        )


if __name__ == "__main__":
    main()
