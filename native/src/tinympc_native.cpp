// tinympc_native: runtime-dimensioned host-side ADMM MPC solver.
//
// First-class native runtime component of accelerated_tinympc_tpu (the JAX
// package's C++ counterpart for host deployment and fast CPU cross-checks).
// Semantics match the TinyMPC ADMM schedule the JAX engine implements
// (documented against reference src/tinympc/admm.cpp in solver/admm.py):
// forward rollout with cached infinite-horizon gains, slack projection, dual
// ascent, linear-cost refresh, residual check (early exit skips the slack
// save + backward pass), backward gradient recursion.
//
// Design (deliberately different from the reference's compile-time-fixed-size
// Eigen design): runtime dimensions, instance handles instead of a global
// singleton, flat double-precision arrays, a built-in double-precision
// infinite-horizon Riccati precompute, and a batched entry point.
//
// C API only — bind from Python via ctypes (see
// accelerated_tinympc_tpu/native/__init__.py).

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct SocCone {
    std::vector<int> ball;
    int axis = 0;
    double mu = 0, shift = 0;
};

struct Solver {
    int nx = 0, nu = 0, N = 0;
    int max_iter = 100, check_termination = 1;
    double abs_pri_tol = 1e-3, abs_dua_tol = 1e-3;
    int en_state_bound = 0, en_input_bound = 0;
    double rho = 0;

    // problem data (row-major)
    std::vector<double> A, B, Qdiag, Rdiag;
    std::vector<double> u_min, u_max, x_min, x_max;  // (N-1,nu)/(N,nx)
    std::vector<double> Xref;                        // (N, nx)
    // cache
    std::vector<double> Kinf, Pinf, Quu_inv, AmBKt;
    // second-order cones ||w[ball]|| <= mu * (w[axis] + shift), applied
    // per knot after the box clip (parity with solver/cones.py).
    std::vector<SocCone> input_cones, state_cones;
    // iterates
    std::vector<double> x, u, q, r, p, d, v, vnew, z, znew, g, y;
    int iter = 0, status = 11;
    double pri_state = 0, pri_input = 0, dua_state = 0, dua_input = 0;
};

inline void matvec(const double *M, const double *vec, double *out,
                   int rows, int cols) {
    for (int i = 0; i < rows; ++i) {
        double acc = 0;
        for (int j = 0; j < cols; ++j) acc += M[i * cols + j] * vec[j];
        out[i] = acc;
    }
}

inline void matvec_t(const double *M, const double *vec, double *out,
                     int rows, int cols) {
    for (int j = 0; j < cols; ++j) out[j] = 0;
    for (int i = 0; i < rows; ++i)
        for (int j = 0; j < cols; ++j) out[j] += M[i * cols + j] * vec[i];
}

inline void matmul(const double *Am, const double *Bm, double *out,
                   int n, int k, int m) {
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < m; ++j) {
            double acc = 0;
            for (int t = 0; t < k; ++t) acc += Am[i * k + t] * Bm[t * m + j];
            out[i * m + j] = acc;
        }
}

// Gauss-Jordan inverse with partial pivoting (small dense systems).
bool invert(std::vector<double> M, double *out, int n) {
    std::vector<double> I(n * n, 0.0);
    for (int i = 0; i < n; ++i) I[i * n + i] = 1.0;
    for (int col = 0; col < n; ++col) {
        int piv = col;
        for (int i = col + 1; i < n; ++i)
            if (std::fabs(M[i * n + col]) > std::fabs(M[piv * n + col]))
                piv = i;
        if (std::fabs(M[piv * n + col]) < 1e-300) return false;
        if (piv != col) {
            for (int j = 0; j < n; ++j) {
                std::swap(M[piv * n + j], M[col * n + j]);
                std::swap(I[piv * n + j], I[col * n + j]);
            }
        }
        const double inv = 1.0 / M[col * n + col];
        for (int j = 0; j < n; ++j) {
            M[col * n + j] *= inv;
            I[col * n + j] *= inv;
        }
        for (int i = 0; i < n; ++i) {
            if (i == col) continue;
            const double f = M[i * n + col];
            if (f == 0) continue;
            for (int j = 0; j < n; ++j) {
                M[i * n + j] -= f * M[col * n + j];
                I[i * n + j] -= f * I[col * n + j];
            }
        }
    }
    std::memcpy(out, I.data(), sizeof(double) * n * n);
    return true;
}

// Infinite-horizon Riccati fixed point (same math as the Python precompute:
// P0 = rho*I, iterate K/P to |dK| < tol, then cache Quu_inv / AmBKt).
bool riccati(Solver &s, int max_iters, double tol) {
    const int nx = s.nx, nu = s.nu;
    std::vector<double> Q1(nx * nx, 0.0), R1(nu * nu, 0.0);
    for (int i = 0; i < nx; ++i) Q1[i * nx + i] = s.Qdiag[i] + s.rho;
    for (int i = 0; i < nu; ++i) R1[i * nu + i] = s.Rdiag[i] + s.rho;

    std::vector<double> P(nx * nx, 0.0), Pn(nx * nx), K(nu * nx, 0.0),
        Kn(nu * nx), Kprev(nu * nx, 0.0);
    for (int i = 0; i < nx; ++i) P[i * nx + i] = s.rho;

    std::vector<double> BtP(nu * nx), BtPB(nu * nu), BtPA(nu * nx),
        lhs_inv(nu * nu), AmBK(nx * nx), PAmBK(nx * nx), tmp(nx * nx);
    for (int it = 0; it < max_iters; ++it) {
        // BtP = B^T P ; BtPB = BtP B ; BtPA = BtP A
        for (int i = 0; i < nu; ++i)
            for (int j = 0; j < nx; ++j) {
                double acc = 0;
                for (int t = 0; t < nx; ++t)
                    acc += s.B[t * nu + i] * P[t * nx + j];
                BtP[i * nx + j] = acc;
            }
        matmul(BtP.data(), s.B.data(), BtPB.data(), nu, nx, nu);
        matmul(BtP.data(), s.A.data(), BtPA.data(), nu, nx, nx);
        std::vector<double> lhs(nu * nu);
        for (int i = 0; i < nu * nu; ++i) lhs[i] = R1[i] + BtPB[i];
        if (!invert(lhs, lhs_inv.data(), nu)) return false;
        matmul(lhs_inv.data(), BtPA.data(), Kn.data(), nu, nu, nx);
        // Pn = Q1 + A^T P (A - B K)
        matmul(s.B.data(), Kn.data(), AmBK.data(), nx, nu, nx);
        for (int i = 0; i < nx * nx; ++i) AmBK[i] = s.A[i] - AmBK[i];
        matmul(P.data(), AmBK.data(), PAmBK.data(), nx, nx, nx);
        for (int i = 0; i < nx; ++i)
            for (int j = 0; j < nx; ++j) {
                double acc = 0;
                for (int t = 0; t < nx; ++t)
                    acc += s.A[t * nx + i] * PAmBK[t * nx + j];
                Pn[i * nx + j] = Q1[i * nx + j] + acc;
            }
        double dK = 0;
        for (int i = 0; i < nu * nx; ++i)
            dK = std::fmax(dK, std::fabs(Kn[i] - Kprev[i]));
        K = Kn;
        P = Pn;
        if (dK < tol) break;
        Kprev = Kn;
    }
    s.Kinf = K;
    s.Pinf = P;
    // Quu_inv = (R1 + B^T Pinf B)^{-1}
    for (int i = 0; i < nu; ++i)
        for (int j = 0; j < nx; ++j) {
            double acc = 0;
            for (int t = 0; t < nx; ++t)
                acc += s.B[t * nu + i] * P[t * nx + j];
            BtP[i * nx + j] = acc;
        }
    matmul(BtP.data(), s.B.data(), BtPB.data(), nu, nx, nu);
    std::vector<double> lhs(nu * nu);
    for (int i = 0; i < nu * nu; ++i) lhs[i] = R1[i] + BtPB[i];
    s.Quu_inv.assign(nu * nu, 0.0);
    if (!invert(lhs, s.Quu_inv.data(), nu)) return false;
    // AmBKt = (A - B Kinf)^T
    matmul(s.B.data(), K.data(), AmBK.data(), nx, nu, nx);
    s.AmBKt.assign(nx * nx, 0.0);
    for (int i = 0; i < nx; ++i)
        for (int j = 0; j < nx; ++j)
            s.AmBKt[j * nx + i] = s.A[i * nx + j] - AmBK[i * nx + j];
    return true;
}

void forward_pass(Solver &s) {
    const int nx = s.nx, nu = s.nu;
    std::vector<double> Kx(nu), Ax(nx), Bu(nx);
    for (int k = 0; k < s.N - 1; ++k) {
        matvec(s.Kinf.data(), &s.x[k * nx], Kx.data(), nu, nx);
        for (int i = 0; i < nu; ++i)
            s.u[k * nu + i] = -Kx[i] - s.d[k * nu + i];
        matvec(s.A.data(), &s.x[k * nx], Ax.data(), nx, nx);
        matvec(s.B.data(), &s.u[k * nu], Bu.data(), nx, nu);
        for (int i = 0; i < nx; ++i) s.x[(k + 1) * nx + i] = Ax[i] + Bu[i];
    }
}

// Exact Euclidean SOC projection (closed form as solver/cones.py
// project_cone: interior unchanged, polar cone to the apex, else boundary).
inline void project_soc(double *w, const SocCone &c) {
    double a2 = 0;
    for (int b : c.ball) a2 += w[b] * w[b];
    const double a = std::sqrt(a2);
    const double sft = w[c.axis] + c.shift;
    if (a <= c.mu * sft) return;
    if (c.mu * a <= -sft) {
        for (int b : c.ball) w[b] = 0;
        w[c.axis] = -c.shift;
        return;
    }
    const double cc = (c.mu * a + sft) / (c.mu * c.mu + 1.0);
    const double scale = a > 0 ? c.mu * cc / a : 0;
    for (int b : c.ball) w[b] *= scale;
    w[c.axis] = cc - c.shift;
}

void update_slack(Solver &s) {
    const int nx = s.nx, nu = s.nu;
    for (int k = 0; k < s.N - 1; ++k)
        for (int i = 0; i < nu; ++i) {
            const int idx = k * nu + i;
            double zi = s.u[idx] + s.y[idx];
            if (s.en_input_bound) {
                zi = zi < s.u_min[idx] ? s.u_min[idx]
                     : (zi > s.u_max[idx] ? s.u_max[idx] : zi);
            }
            s.znew[idx] = zi;
        }
    for (const SocCone &c : s.input_cones)
        for (int k = 0; k < s.N - 1; ++k) project_soc(&s.znew[k * nu], c);
    for (int k = 0; k < s.N; ++k)
        for (int i = 0; i < nx; ++i) {
            const int idx = k * nx + i;
            double vi = s.x[idx] + s.g[idx];
            if (s.en_state_bound) {
                vi = vi < s.x_min[idx] ? s.x_min[idx]
                     : (vi > s.x_max[idx] ? s.x_max[idx] : vi);
            }
            s.vnew[idx] = vi;
        }
    for (const SocCone &c : s.state_cones)
        for (int k = 0; k < s.N; ++k) project_soc(&s.vnew[k * nx], c);
}

void update_dual(Solver &s) {
    for (size_t i = 0; i < s.y.size(); ++i) s.y[i] += s.u[i] - s.znew[i];
    for (size_t i = 0; i < s.g.size(); ++i) s.g[i] += s.x[i] - s.vnew[i];
}

void update_linear_cost(Solver &s) {
    const int nx = s.nx, nu = s.nu, N = s.N;
    for (int k = 0; k < N - 1; ++k)
        for (int i = 0; i < nu; ++i) {
            const int idx = k * nu + i;
            s.r[idx] = -s.rho * (s.znew[idx] - s.y[idx]);
        }
    for (int k = 0; k < N; ++k)
        for (int i = 0; i < nx; ++i) {
            const int idx = k * nx + i;
            s.q[idx] = -s.Xref[idx] * s.Qdiag[i]
                       - s.rho * (s.vnew[idx] - s.g[idx]);
        }
    std::vector<double> Px(nx);
    matvec_t(s.Pinf.data(), &s.Xref[(N - 1) * nx], Px.data(), nx, nx);
    for (int i = 0; i < nx; ++i) {
        const int idx = (N - 1) * nx + i;
        s.p[idx] = -Px[i] - s.rho * (s.vnew[idx] - s.g[idx]);
    }
}

bool termination(Solver &s) {
    if (s.check_termination <= 0) return false;
    if (s.iter % s.check_termination != 0) return false;
    double ps = 0, pi = 0, ds = 0, di = 0;
    for (size_t i = 0; i < s.x.size(); ++i) {
        ps = std::fmax(ps, std::fabs(s.x[i] - s.vnew[i]));
        ds = std::fmax(ds, std::fabs(s.v[i] - s.vnew[i]));
    }
    for (size_t i = 0; i < s.u.size(); ++i) {
        pi = std::fmax(pi, std::fabs(s.u[i] - s.znew[i]));
        di = std::fmax(di, std::fabs(s.z[i] - s.znew[i]));
    }
    s.pri_state = ps;
    s.pri_input = pi;
    s.dua_state = ds * s.rho;
    s.dua_input = di * s.rho;
    return ps < s.abs_pri_tol && pi < s.abs_pri_tol &&
           s.dua_state < s.abs_dua_tol && s.dua_input < s.abs_dua_tol;
}

void backward_pass(Solver &s) {
    const int nx = s.nx, nu = s.nu;
    std::vector<double> Btp(nu), Mp(nx), Kr(nx);
    for (int k = s.N - 2; k >= 0; --k) {
        matvec_t(s.B.data(), &s.p[(k + 1) * nx], Btp.data(), nx, nu);
        for (int i = 0; i < nu; ++i) Btp[i] += s.r[k * nu + i];
        matvec(s.Quu_inv.data(), Btp.data(), &s.d[k * nu], nu, nu);
        matvec(s.AmBKt.data(), &s.p[(k + 1) * nx], Mp.data(), nx, nx);
        matvec_t(s.Kinf.data(), &s.r[k * nu], Kr.data(), nu, nx);
        for (int i = 0; i < nx; ++i)
            s.p[k * nx + i] = s.q[k * nx + i] + Mp[i] - Kr[i];
    }
}

int solve_one(Solver &s) {
    s.status = 11;
    s.iter = 0;
    for (int it = 0; it < s.max_iter; ++it) {
        s.iter = it + 1;
        forward_pass(s);
        update_slack(s);
        update_dual(s);
        update_linear_cost(s);
        if (termination(s)) {
            s.status = 1;
            return 0;
        }
        s.v = s.vnew;
        s.z = s.znew;
        backward_pass(s);
    }
    return 1;
}

// One fixed `iters`-iteration chunk with residuals recorded every iteration
// but no early exit (the adaptive outer loop owns termination — mirrors
// solver/adaptive_rho.py's chunk settings).
void run_chunk(Solver &s, int iters) {
    const int save_check = s.check_termination;
    const double save_pri = s.abs_pri_tol, save_dua = s.abs_dua_tol;
    s.check_termination = 1;
    s.abs_pri_tol = -1.0;  // residuals computed, never satisfied
    s.abs_dua_tol = -1.0;
    for (int it = 0; it < iters; ++it) {
        s.iter = it + 1;
        forward_pass(s);
        update_slack(s);
        update_dual(s);
        update_linear_cost(s);
        (void)termination(s);  // records pri/dua residual fields
        s.v = s.vnew;
        s.z = s.znew;
        backward_pass(s);
    }
    s.check_termination = save_check;
    s.abs_pri_tol = save_pri;
    s.abs_dua_tol = save_dua;
}

}  // namespace

extern "C" {

void *tn_create(int nx, int nu, int N,
                const double *A, const double *B,
                const double *Qdiag, const double *Rdiag, double rho) {
    auto *s = new Solver();
    s->nx = nx;
    s->nu = nu;
    s->N = N;
    s->rho = rho;
    s->A.assign(A, A + nx * nx);
    s->B.assign(B, B + nx * nu);
    s->Qdiag.assign(Qdiag, Qdiag + nx);
    s->Rdiag.assign(Rdiag, Rdiag + nu);
    const int sx = N * nx, su = (N - 1) * nu;
    for (auto *vec : {&s->x, &s->q, &s->p, &s->v, &s->vnew, &s->g})
        vec->assign(sx, 0.0);
    for (auto *vec : {&s->u, &s->r, &s->d, &s->z, &s->znew, &s->y})
        vec->assign(su, 0.0);
    s->Xref.assign(sx, 0.0);
    s->u_min.assign(su, -1e17);
    s->u_max.assign(su, 1e17);
    s->x_min.assign(sx, -1e17);
    s->x_max.assign(sx, 1e17);
    if (!riccati(*s, 1000, 1e-5)) {
        delete s;
        return nullptr;
    }
    return s;
}

void tn_destroy(void *h) { delete static_cast<Solver *>(h); }

void tn_set_settings(void *h, int max_iter, int check_termination,
                     double abs_pri_tol, double abs_dua_tol) {
    auto *s = static_cast<Solver *>(h);
    s->max_iter = max_iter;
    s->check_termination = check_termination;
    s->abs_pri_tol = abs_pri_tol;
    s->abs_dua_tol = abs_dua_tol;
}

void tn_set_bounds(void *h, const double *u_min, const double *u_max,
                   const double *x_min, const double *x_max) {
    auto *s = static_cast<Solver *>(h);
    const int su = (s->N - 1) * s->nu, sx = s->N * s->nx;
    if (u_min && u_max) {
        s->u_min.assign(u_min, u_min + su);
        s->u_max.assign(u_max, u_max + su);
        s->en_input_bound = 1;
    }
    if (x_min && x_max) {
        s->x_min.assign(x_min, x_min + sx);
        s->x_max.assign(x_max, x_max + sx);
        s->en_state_bound = 1;
    }
}

void tn_set_xref(void *h, const double *Xref) {
    auto *s = static_cast<Solver *>(h);
    s->Xref.assign(Xref, Xref + s->N * s->nx);
}

void tn_set_x0(void *h, const double *x0) {
    auto *s = static_cast<Solver *>(h);
    std::memcpy(s->x.data(), x0, sizeof(double) * s->nx);
}

void tn_reset_duals(void *h) {
    auto *s = static_cast<Solver *>(h);
    std::fill(s->y.begin(), s->y.end(), 0.0);
    std::fill(s->g.begin(), s->g.end(), 0.0);
}

// Append one SOC constraint; is_state selects the per-knot vector it
// constrains (0 = input u_k, 1 = state x_k). Applied at every knot.
void tn_add_cone(void *h, int is_state, int nball, const int *ball,
                 int axis, double mu, double shift) {
    auto *s = static_cast<Solver *>(h);
    SocCone c;
    c.ball.assign(ball, ball + nball);
    c.axis = axis;
    c.mu = mu;
    c.shift = shift;
    (is_state ? s->state_cones : s->input_cones).push_back(c);
}

void tn_clear_cones(void *h) {
    auto *s = static_cast<Solver *>(h);
    s->input_cones.clear();
    s->state_cones.clear();
}

int tn_solve(void *h) { return solve_one(*static_cast<Solver *>(h)); }

// Stall-guarded OSQP-style rho adaptation (the native counterpart of
// solver/adaptive_rho.py: chunked iterations; when progress stalls AND the
// primal/dual residual imbalance exceeds adapt_factor, rescale rho by
// sqrt(pri/dua) clipped to [rho_min, rho_max], rescale the duals by
// rho_old/rho_new, and re-run the double-precision Riccati precompute).
// Returns 0 on convergence (status 1), 1 on budget exhaustion; *rho_out
// (optional) receives the final rho, *iters_out the total iterations.
int tn_solve_adaptive_rho(void *h, int chunk, int max_total_iter,
                          double adapt_factor, double stall_factor,
                          double rho_min, double rho_max,
                          double *rho_out, int *iters_out) {
    auto *s = static_cast<Solver *>(h);
    if (chunk < 1) chunk = 25;
    double prev_max = 1e300;
    int total = 0;
    s->status = 11;
    while (total < max_total_iter) {
        run_chunk(*s, chunk);
        total += chunk;
        const double pri = std::fmax(s->pri_state, s->pri_input);
        const double dua = std::fmax(s->dua_state, s->dua_input);
        if (pri < s->abs_pri_tol && dua < s->abs_dua_tol) {
            s->status = 1;
            break;
        }
        const double max_res = std::fmax(pri, dua);
        const bool stalled = max_res * stall_factor > prev_max;
        prev_max = max_res;
        const double ratio = std::sqrt(std::fmax(pri, 1e-12) /
                                       std::fmax(dua, 1e-12));
        if (stalled && (ratio > adapt_factor || ratio < 1.0 / adapt_factor)) {
            double new_rho = s->rho * ratio;
            new_rho = std::fmin(std::fmax(new_rho, rho_min), rho_max);
            if (new_rho != s->rho) {
                const double scale = s->rho / new_rho;
                for (double &v : s->y) v *= scale;
                for (double &v : s->g) v *= scale;
                s->rho = new_rho;
                riccati(*s, 1000, 1e-5);  // f64 refresh, reference stopping
                prev_max = 1e300;         // fresh contraction after the swap
            }
        }
    }
    s->iter = total;
    if (rho_out) *rho_out = s->rho;
    if (iters_out) *iters_out = total;
    return s->status == 1 ? 0 : 1;
}

int tn_iter(void *h) { return static_cast<Solver *>(h)->iter; }
int tn_status(void *h) { return static_cast<Solver *>(h)->status; }

void tn_get_u(void *h, double *out) {
    auto *s = static_cast<Solver *>(h);
    std::memcpy(out, s->u.data(), sizeof(double) * (s->N - 1) * s->nu);
}

void tn_get_x(void *h, double *out) {
    auto *s = static_cast<Solver *>(h);
    std::memcpy(out, s->x.data(), sizeof(double) * s->N * s->nx);
}

void tn_get_cache(void *h, double *Kinf, double *Pinf, double *Quu_inv,
                  double *AmBKt) {
    auto *s = static_cast<Solver *>(h);
    std::memcpy(Kinf, s->Kinf.data(), sizeof(double) * s->nu * s->nx);
    std::memcpy(Pinf, s->Pinf.data(), sizeof(double) * s->nx * s->nx);
    std::memcpy(Quu_inv, s->Quu_inv.data(), sizeof(double) * s->nu * s->nu);
    std::memcpy(AmBKt, s->AmBKt.data(), sizeof(double) * s->nx * s->nx);
}

// Batched host solve: B independent cold-start instances sharing this
// solver's problem data; x0s (Bn, nx), u_out (Bn, (N-1)*nu) row-major.
// Instances are embarrassingly parallel (each works on a private Solver
// copy), so the loop threads with OpenMP when compiled with -fopenmp.
void tn_solve_batch(void *h, const double *x0s, int Bn, double *u_out,
                    int *iters_out, int *status_out) {
    auto *base = static_cast<Solver *>(h);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int b = 0; b < Bn; ++b) {
        Solver s = *base;  // value copy: independent iterates
        for (auto *vec : {&s.x, &s.q, &s.p, &s.v, &s.vnew, &s.g,
                          &s.u, &s.r, &s.d, &s.z, &s.znew, &s.y})
            std::fill(vec->begin(), vec->end(), 0.0);
        tn_set_x0(&s, x0s + b * base->nx);
        const int flag = solve_one(s);
        (void)flag;
        std::memcpy(u_out + b * (s.N - 1) * s.nu, s.u.data(),
                    sizeof(double) * (s.N - 1) * s.nu);
        if (iters_out) iters_out[b] = s.iter;
        if (status_out) status_out[b] = s.status;
    }
}

// Batched host adaptive-rho solve: B independent cold-start instances,
// each running the stall-guarded adaptation above on a private Solver copy
// (per-instance rho trajectories — the host mirror of
// solver/batched_ops.solve_adaptive_rho_batched). OpenMP-parallel.
void tn_solve_batch_adaptive(void *h, const double *x0s, int Bn,
                             int chunk, int max_total_iter,
                             double adapt_factor, double stall_factor,
                             double rho_min, double rho_max,
                             double *u_out, double *rho_out,
                             int *iters_out, int *status_out) {
    auto *base = static_cast<Solver *>(h);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int b = 0; b < Bn; ++b) {
        Solver s = *base;  // value copy: independent iterates + cache
        for (auto *vec : {&s.x, &s.q, &s.p, &s.v, &s.vnew, &s.g,
                          &s.u, &s.r, &s.d, &s.z, &s.znew, &s.y})
            std::fill(vec->begin(), vec->end(), 0.0);
        tn_set_x0(&s, x0s + b * base->nx);
        double rho = 0.0;
        int iters = 0;
        (void)tn_solve_adaptive_rho(&s, chunk, max_total_iter,
                                    adapt_factor, stall_factor,
                                    rho_min, rho_max, &rho, &iters);
        std::memcpy(u_out + b * (s.N - 1) * s.nu, s.u.data(),
                    sizeof(double) * (s.N - 1) * s.nu);
        if (rho_out) rho_out[b] = rho;
        if (iters_out) iters_out[b] = iters;
        if (status_out) status_out[b] = s.status;
    }
}

}  // extern "C"
