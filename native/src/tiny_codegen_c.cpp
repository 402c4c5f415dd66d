// C-callable code generation entry, argument-for-argument with the
// reference's tiny_codegen (reference: src/tinympc/codegen.hpp:10-15; driven
// by examples/codegen_cartpole.cpp:63-66). The generator itself lives in
// Python (accelerated_tinympc_tpu/api/codegen.py); this shim marshals the C
// argument list into a binary args file (layout documented in
// api/codegen_cli.py) and exec's the CLI module — fork/execvp, no system(3),
// no shell.
//
// Argument conventions match the reference exactly: matrices are
// column-major (Eigen Map order, reference codegen.cpp:245-252); bounds are
// enabled iff both min and max pointers are non-null (codegen.cpp:227-243);
// x bounds are (nx, N), u bounds (nu, N-1). `tinympc_dir` — the reference's
// "where the framework sources live" argument (codegen_cartpole.cpp:44) —
// here names the directory containing the accelerated_tinympc_tpu package
// (it is prepended to PYTHONPATH for the child). The Python interpreter
// defaults to "python3"; override with the TINYMPC_PYTHON env var.
//
// Build: make -C native libtinympc_codegen.so

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include <sys/wait.h>
#include <unistd.h>

typedef double tinytype;  // the reference root build's scalar (glob_opts.hpp:3)

namespace {

bool write_all(FILE* f, const void* p, size_t n)
{
    return std::fwrite(p, 1, n, f) == n;
}

}  // namespace

extern "C" int tiny_codegen(int nx, int nu, int N,
                            tinytype* Adyn, tinytype* Bdyn,
                            tinytype* Q, tinytype* R,
                            tinytype* x_min, tinytype* x_max,
                            tinytype* u_min, tinytype* u_max,
                            tinytype rho, tinytype abs_pri_tol,
                            tinytype abs_dua_tol,
                            int max_iters, int check_termination,
                            int gen_wrapper,
                            const char* tinympc_dir, const char* output_dir)
{
    if (nx <= 0 || nu <= 0 || N <= 1 || !Adyn || !Bdyn || !Q || !R ||
        !output_dir) {
        std::fprintf(stderr, "tiny_codegen: bad arguments\n");
        return 1;
    }
    const int has_xb = (x_min != nullptr && x_max != nullptr) ? 1 : 0;
    const int has_ub = (u_min != nullptr && u_max != nullptr) ? 1 : 0;

    // The argument file goes to $TMPDIR (/tmp when it is unset).
    const char* tmpdir = std::getenv("TMPDIR");
    std::string tmpl = std::string(tmpdir && *tmpdir ? tmpdir : "/tmp") +
                       "/tiny_codegen_args_XXXXXX";
    char* argfile = &tmpl[0];
    int fd = mkstemp(argfile);
    if (fd < 0) {
        std::perror("tiny_codegen: mkstemp");
        return 1;
    }
    FILE* f = fdopen(fd, "wb");
    if (!f) {
        std::perror("tiny_codegen: fdopen");
        close(fd);
        unlink(argfile);
        return 1;
    }

    const int32_t ints[8] = {nx, nu, N, max_iters, check_termination,
                             gen_wrapper, has_xb, has_ub};
    const double reals[3] = {(double)rho, (double)abs_pri_tol,
                             (double)abs_dua_tol};
    bool ok = write_all(f, "TINYCGC1", 8) &&
              write_all(f, ints, sizeof ints) &&
              write_all(f, reals, sizeof reals) &&
              write_all(f, Adyn, sizeof(double) * nx * nx) &&
              write_all(f, Bdyn, sizeof(double) * nx * nu) &&
              write_all(f, Q, sizeof(double) * nx) &&
              write_all(f, R, sizeof(double) * nu);
    if (ok && has_xb)
        ok = write_all(f, x_min, sizeof(double) * nx * N) &&
             write_all(f, x_max, sizeof(double) * nx * N);
    if (ok && has_ub)
        ok = write_all(f, u_min, sizeof(double) * nu * (N - 1)) &&
             write_all(f, u_max, sizeof(double) * nu * (N - 1));
    if (std::fclose(f) != 0) ok = false;
    if (!ok) {
        std::fprintf(stderr, "tiny_codegen: failed writing %s\n", argfile);
        unlink(argfile);
        return 1;
    }

    const char* py = std::getenv("TINYMPC_PYTHON");
    if (!py || !*py) py = "python3";

    pid_t pid = fork();
    if (pid < 0) {
        std::perror("tiny_codegen: fork");
        unlink(argfile);
        return 1;
    }
    if (pid == 0) {
        if (tinympc_dir && *tinympc_dir) {
            const char* old = std::getenv("PYTHONPATH");
            std::string pp = std::string(tinympc_dir) +
                             (old && *old ? std::string(":") + old : "");
            setenv("PYTHONPATH", pp.c_str(), 1);
        }
        // The generator runs on CPU; keep any accelerator out of the child.
        setenv("JAX_PLATFORMS", "cpu", 1);
        execlp(py, py, "-m", "accelerated_tinympc_tpu.api.codegen_cli",
               argfile, output_dir, (char*)nullptr);
        std::perror("tiny_codegen: execlp");
        _exit(127);
    }
    int status = 0;
    if (waitpid(pid, &status, 0) < 0) {
        std::perror("tiny_codegen: waitpid");
        unlink(argfile);
        return 1;
    }
    unlink(argfile);
    if (WIFEXITED(status)) return WEXITSTATUS(status);
    std::fprintf(stderr, "tiny_codegen: generator terminated abnormally\n");
    return 1;
}
