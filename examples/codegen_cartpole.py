"""Cartpole codegen (capability parity with reference:
examples/codegen_cartpole.cpp): generate a standalone C++ deployment project
for the upright cartpole, build it, and run the emitted MPC demo.

Unlike the reference (which copies Eigen + its own sources into the output,
codegen.cpp:615-654), the generated project is dependency-free C++17.

Run: python examples/codegen_cartpole.py [--out DIR]  (default: a directory
under the system temporary directory)
"""

import argparse
import pathlib
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.api import build_project, tiny_codegen
from accelerated_tinympc_tpu.models import cartpole


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(pathlib.Path(tempfile.gettempdir())
                                         / "tinympc_cartpole_project"))
    ap.add_argument("--no-build", action="store_true")
    args = ap.parse_args()
    atm.utils.enable_compile_cache()

    out = tiny_codegen(
        cartpole.A, cartpole.B, cartpole.Q_DIAG, cartpole.R_DIAG,
        rho=cartpole.RHO, horizon=10, output_dir=args.out,
        x_min=-5.0, x_max=5.0, u_min=-5.0, u_max=5.0,
        settings=atm.Settings(max_iter=100, check_termination=1),
        gen_wrapper=True,
    )
    print(f"generated project at {out}")
    for f in sorted(p.relative_to(out) for p in out.rglob("*") if p.is_file()):
        print(f"  {f}")

    if not args.no_build:
        binary = build_project(out)
        print(f"built {binary}; running 5 MPC ticks from x0=(0.3, 0, 0.1, 0):")
        res = subprocess.run(
            [str(binary), "0.3", "0", "0.1", "0", "5"],
            capture_output=True, text=True, check=True,
        )
        print(res.stdout)


if __name__ == "__main__":
    main()
