// Reference-binary baseline: times the *unmodified* reference TinyMPC solver
// (linked from /root/reference) on this host's CPU, one core, to give the
// measured denominator for the device headline ("Nx one reference CPU core").
//
// Workload matches examples/quadrotor_hovering.cpp:73-114 (20 Hz params,
// bounds +-0.5/+-5, hover z=2 setpoint, duals reset per tick, plant sim
// x+ = A x + B u). Two modes:
//   fixed : max_iter=<iters>, check_termination=1000 (never) — fixed work
//   adapt : max_iter=100, check_termination=1, tol 1e-3 — reference defaults
//
// Timing: warm-up loop, then R reps of the full T-tick receding-horizon loop;
// reports the best rep (min wall time) as solves/s plus mean iterations.
//
// Build (see tools/golden/README.md):
//   g++ -O3 -march=native -std=c++17 -I/root/reference/include/Eigen \
//       -I/root/reference/src -I/root/reference/examples \
//       tools/golden/bench_reference.cpp /root/reference/src/tinympc/admm.cpp \
//       -o /tmp/bench_reference
// Usage: bench_reference <fixed|adapt> <iters> <ticks> <reps>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <tinympc/admm.hpp>
#ifndef PARAM_HEADER
#define PARAM_HEADER "problem_data/quadrotor_20hz_params.hpp"
#endif
#include PARAM_HEADER

extern "C" {

TinyCache cache;
TinyWorkspace work;
TinySettings settings;
TinySolver solver{&settings, &cache, &work};

int main(int argc, char** argv)
{
    if (argc < 5) { std::fprintf(stderr, "args: <fixed|adapt> iters ticks reps\n"); return 2; }
    const bool fixed = std::strcmp(argv[1], "fixed") == 0;
    const int iters = std::atoi(argv[2]);
    const int ticks = std::atoi(argv[3]);
    const int reps = std::atoi(argv[4]);

    cache.rho = rho_value;
    cache.Kinf = Eigen::Map<Matrix<tinytype, NINPUTS, NSTATES, Eigen::RowMajor>>(Kinf_data);
    cache.Pinf = Eigen::Map<Matrix<tinytype, NSTATES, NSTATES, Eigen::RowMajor>>(Pinf_data);
    cache.Quu_inv = Eigen::Map<Matrix<tinytype, NINPUTS, NINPUTS, Eigen::RowMajor>>(Quu_inv_data);
    cache.AmBKt = Eigen::Map<Matrix<tinytype, NSTATES, NSTATES, Eigen::RowMajor>>(AmBKt_data);
    cache.coeff_d2p = Eigen::Map<Matrix<tinytype, NSTATES, NINPUTS, Eigen::RowMajor>>(coeff_d2p_data);

    work.Adyn = Eigen::Map<Matrix<tinytype, NSTATES, NSTATES, Eigen::RowMajor>>(Adyn_data);
    work.Bdyn = Eigen::Map<Matrix<tinytype, NSTATES, NINPUTS, Eigen::RowMajor>>(Bdyn_data);
    work.Q = Eigen::Map<tiny_VectorNx>(Q_data);
    work.R = Eigen::Map<tiny_VectorNu>(R_data);
    work.u_min = tiny_MatrixNuNhm1::Constant(-0.5);
    work.u_max = tiny_MatrixNuNhm1::Constant(0.5);
    work.x_min = tiny_MatrixNxNh::Constant(-5);
    work.x_max = tiny_MatrixNxNh::Constant(5);
    work.Uref = tiny_MatrixNuNhm1::Zero();

    settings.abs_pri_tol = 0.001;
    settings.abs_dua_tol = 0.001;
    settings.max_iter = fixed ? iters : 100;
    settings.check_termination = fixed ? 1000000 : 1;
    settings.en_input_bound = 1;
    settings.en_state_bound = 1;

    tiny_VectorNx Xref_origin, x0_init, x0, x1;
    Xref_origin << 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0;
    x0_init << 0, 1, 0, 0.2, 0, 0, 0.1, 0, 0, 0, 0, 0;

    double best_s = 1e300;
    long long total_iters = 0;
    double checksum = 0;
    for (int rep = 0; rep < reps + 1; ++rep) {   // rep 0 = warm-up, untimed
        // Full reset per rep so every rep does identical work.
        work.Xref = Xref_origin.replicate<1, NHORIZON>();
        work.x = tiny_MatrixNxNh::Zero();
        work.q = tiny_MatrixNxNh::Zero();
        work.p = tiny_MatrixNxNh::Zero();
        work.v = tiny_MatrixNxNh::Zero();
        work.vnew = tiny_MatrixNxNh::Zero();
        work.g = tiny_MatrixNxNh::Zero();
        work.u = tiny_MatrixNuNhm1::Zero();
        work.r = tiny_MatrixNuNhm1::Zero();
        work.d = tiny_MatrixNuNhm1::Zero();
        work.z = tiny_MatrixNuNhm1::Zero();
        work.znew = tiny_MatrixNuNhm1::Zero();
        work.y = tiny_MatrixNuNhm1::Zero();
        x0 = x0_init;
        long long rep_iters = 0;

        auto t0 = std::chrono::steady_clock::now();
        for (int k = 0; k < ticks; ++k) {
            work.x.col(0) = x0;
            work.y = tiny_MatrixNuNhm1::Zero();
            work.g = tiny_MatrixNxNh::Zero();
            tiny_solve(&solver);
            rep_iters += work.iter;
            x1 = work.Adyn * x0 + work.Bdyn * work.u.col(0);
            x0 = x1;
        }
        auto t1 = std::chrono::steady_clock::now();
        if (rep > 0) {
            double s = std::chrono::duration<double>(t1 - t0).count();
            if (s < best_s) best_s = s;
            total_iters = rep_iters;  // identical every rep
            checksum += (double)x0(2);
        }
    }

    std::printf("{\"mode\": \"%s\", \"iters_per_solve\": %.2f, \"ticks\": %d, "
                "\"best_loop_s\": %.6f, \"solves_per_s\": %.1f, "
                "\"admm_iters_per_s\": %.1f, \"checksum\": %.6f}\n",
                fixed ? "fixed" : "adapt", (double)total_iters / ticks, ticks,
                best_s, ticks / best_s, total_iters / best_s, checksum);
    return 0;
}

} /* extern "C" */
