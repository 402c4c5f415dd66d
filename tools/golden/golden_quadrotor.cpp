// Golden-data harness: drives the *reference* TinyMPC solver (linked from
// /root/reference, unmodified) through the hovering and tracking MPC loops and
// dumps full-precision trajectories for parity tests of the JAX engine.
//
// Loop structure mirrors the reference examples (quadrotor_hovering.cpp:90-114,
// quadrotor_tracking.cpp:93-118); this file only adds CSV dumping.
//
// Usage: golden_quadrotor <hovering|tracking> <max_iter> <check_termination> <steps> <out_prefix>
//   check_termination > max_iter => effectively fixed-iteration mode.
// Outputs:
//   <out_prefix>_traj.csv   per step: k, x0[nx], u0[nu], iters, status
//   <out_prefix>_solve0.csv full workspace after the first tiny_solve
//                           (rows: name, then row-major values)

#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <tinympc/admm.hpp>
// Parameter rate selectable at compile time:
//   g++ ... -DPARAM_HEADER='"problem_data/quadrotor_100hz_params.hpp"' ...
#ifndef PARAM_HEADER
#define PARAM_HEADER "problem_data/quadrotor_20hz_params.hpp"
#endif
#ifndef TRAJ_HEADER
#define TRAJ_HEADER "trajectory_data/quadrotor_20hz_y_axis_line.hpp"
#endif
#include PARAM_HEADER
#include TRAJ_HEADER

extern "C" {

TinyCache cache;
TinyWorkspace work;
TinySettings settings;
TinySolver solver{&settings, &cache, &work};

static void dump_mat(FILE* f, const char* name, const tinytype* data, int rows, int cols)
{
    // Eigen fixed-size matrices are column-major; emit row-major for numpy.
    std::fprintf(f, "%s", name);
    for (int r = 0; r < rows; ++r)
        for (int c = 0; c < cols; ++c)
            std::fprintf(f, ",%.17g", (double)data[c * rows + r]);
    std::fprintf(f, "\n");
}

int main(int argc, char** argv)
{
    if (argc < 6) { std::fprintf(stderr, "args: mode max_iter check steps out_prefix\n"); return 2; }
    const bool tracking = std::strcmp(argv[1], "tracking") == 0;
    const int max_iter = std::atoi(argv[2]);
    const int check = std::atoi(argv[3]);
    const int steps = std::atoi(argv[4]);
    const char* prefix = argv[5];

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

    work.Xref = tiny_MatrixNxNh::Zero();
    work.Uref = tiny_MatrixNuNhm1::Zero();
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
    work.primal_residual_state = 0;
    work.primal_residual_input = 0;
    work.dual_residual_state = 0;
    work.dual_residual_input = 0;
    work.status = 0;
    work.iter = 0;

    settings.abs_pri_tol = 0.001;
    settings.abs_dua_tol = 0.001;
    settings.max_iter = max_iter;
    settings.check_termination = check;
    settings.en_input_bound = 1;
    settings.en_state_bound = 1;

    Matrix<tinytype, NSTATES, NTOTAL> Xref_total;
    tiny_VectorNx x0, x1;
    if (tracking) {
        Xref_total = Eigen::Map<Matrix<tinytype, NTOTAL, NSTATES, Eigen::RowMajor>>(Xref_data).transpose();
        work.Xref = Xref_total.block<NSTATES, NHORIZON>(0, 0);
        x0 = work.Xref.col(0);
    } else {
        tiny_VectorNx Xref_origin;
        Xref_origin << 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0;
        work.Xref = Xref_origin.replicate<1, NHORIZON>();
        x0 << 0, 1, 0, 0.2, 0, 0, 0.1, 0, 0, 0, 0, 0;
    }

    char fname[512];
    std::snprintf(fname, sizeof fname, "%s_traj.csv", prefix);
    FILE* traj = std::fopen(fname, "w");
    std::snprintf(fname, sizeof fname, "%s_solve0.csv", prefix);
    FILE* s0 = std::fopen(fname, "w");

    for (int k = 0; k < steps; ++k) {
        work.x.col(0) = x0;
        if (tracking)
            work.Xref = Xref_total.block<NSTATES, NHORIZON>(0, k);
        work.y = tiny_MatrixNuNhm1::Zero();
        work.g = tiny_MatrixNxNh::Zero();

        tiny_solve(&solver);

        if (k == 0) {
            dump_mat(s0, "x", work.x.data(), NSTATES, NHORIZON);
            dump_mat(s0, "u", work.u.data(), NINPUTS, NHORIZON - 1);
            dump_mat(s0, "q", work.q.data(), NSTATES, NHORIZON);
            dump_mat(s0, "r", work.r.data(), NINPUTS, NHORIZON - 1);
            dump_mat(s0, "p", work.p.data(), NSTATES, NHORIZON);
            dump_mat(s0, "d", work.d.data(), NINPUTS, NHORIZON - 1);
            dump_mat(s0, "v", work.v.data(), NSTATES, NHORIZON);
            dump_mat(s0, "vnew", work.vnew.data(), NSTATES, NHORIZON);
            dump_mat(s0, "z", work.z.data(), NINPUTS, NHORIZON - 1);
            dump_mat(s0, "znew", work.znew.data(), NINPUTS, NHORIZON - 1);
            dump_mat(s0, "g", work.g.data(), NSTATES, NHORIZON);
            dump_mat(s0, "y", work.y.data(), NINPUTS, NHORIZON - 1);
            std::fprintf(s0, "residuals,%.17g,%.17g,%.17g,%.17g\n",
                         (double)work.primal_residual_state, (double)work.dual_residual_state,
                         (double)work.primal_residual_input, (double)work.dual_residual_input);
            std::fprintf(s0, "iter,%d\nstatus,%d\n", work.iter, work.status);
        }

        std::fprintf(traj, "%d", k);
        for (int i = 0; i < NSTATES; ++i) std::fprintf(traj, ",%.17g", (double)x0(i));
        for (int i = 0; i < NINPUTS; ++i) std::fprintf(traj, ",%.17g", (double)work.u.col(0)(i));
        std::fprintf(traj, ",%d,%d\n", work.iter, work.status);

        x1 = work.Adyn * x0 + work.Bdyn * work.u.col(0);
        x0 = x1;
    }
    std::fclose(traj);
    std::fclose(s0);
    return 0;
}

} /* extern "C" */
