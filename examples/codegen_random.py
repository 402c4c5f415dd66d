"""Random-LTI codegen sweep (capability parity with reference:
examples/codegen_random.cpp, generalized): generate deployment projects for
random stabilizable plants over a sweep of (nx, nu, N) shapes — the shape
stress test for both the precompute and the emitted solver.

Run: python examples/codegen_random.py [--out-root DIR]  (default: a
directory under the system temporary directory)
"""

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.api import tiny_codegen
from accelerated_tinympc_tpu.models import random_lti_problem


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-root", default=str(pathlib.Path(
        tempfile.gettempdir()) / "tinympc_random"))
    ap.add_argument("--shapes", default="2x2x3,4x2x8,12x4x10,16x8x20",
                    help="comma-separated nx x nu x N")
    args = ap.parse_args()
    atm.utils.enable_compile_cache()

    for spec in args.shapes.split(","):
        nx, nu, N = (int(v) for v in spec.split("x"))
        problem, rho = random_lti_problem(seed=nx * 100 + nu, nx=nx, nu=nu,
                                          horizon=N)
        out = tiny_codegen(
            np.asarray(problem.A), np.asarray(problem.B),
            np.asarray(problem.Q), np.asarray(problem.R),
            rho=rho, horizon=N,
            output_dir=pathlib.Path(args.out_root) / f"plant_{spec}",
            u_min=np.asarray(problem.u_min[0]),
            u_max=np.asarray(problem.u_max[0]),
            gen_wrapper=False,
        )
        print(f"nx={nx} nu={nu} N={N} -> {out}")


if __name__ == "__main__":
    main()
