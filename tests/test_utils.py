"""Aux subsystems (SURVEY.md §5): profiling helpers, numerical-health
reporting, and checkpoint/resume of warm-start state across processes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import quadrotor_hovering_setup
from accelerated_tinympc_tpu.utils import save_pytree
from accelerated_tinympc_tpu.utils.debugging import finite_state, health_report
from accelerated_tinympc_tpu.utils.profiling import solver_cost, time_fn
from accelerated_tinympc_tpu.utils.serialization import load_like


class TestProfiling:
    def test_time_fn(self):
        f = jax.jit(lambda x: x * 2.0)
        stats = time_fn(f, jnp.ones((8, 8)), reps=2)
        assert stats["best_s"] > 0 and stats["mean_s"] >= stats["best_s"]

    def test_solver_cost_model(self):
        c = solver_cost(12, 4, 10, iters=100)
        assert c["flops_padded"] > c["flops"] > 0
        # padded model matches the fused kernel's issued matmuls: 4 per
        # iteration at its power-of-two widths (Dx 120 -> 128, Du 36 -> 64)
        assert c["flops_padded"] == 2 * 100 * (
            64 * 128 + 64 * 64 + 128 * 64 + 64 * 64)


class TestHealth:
    def test_finite_and_report(self):
        problem, cache, x0 = quadrotor_hovering_setup()
        st = atm.set_x0(atm.init_state(12, 4, 10), jnp.asarray(x0, jnp.float32))
        out = jax.jit(
            lambda s: atm.solve(
                s, problem, cache, atm.Settings(max_iter=10, check_termination=0)
            )
        )(st)
        assert bool(finite_state(out))
        rep = health_report(out)
        assert rep["all_finite"] and rep["nonfinite_instances"] == []

    def test_detects_nan(self):
        st = atm.init_state(12, 4, 10)
        st = st.replace(u=st.u.at[0, 0].set(jnp.nan))
        rep = health_report(st)
        assert not rep["all_finite"]
        assert rep["nonfinite_instances"] == [0]


class TestCheckpointResume:
    """Warm-start state survives a save/load cycle: resuming mid-MPC produces
    the same trajectory as an uninterrupted run (the reference's analogue is
    its persistent in-memory workspace, quadrotor_hovering.cpp:99-104)."""

    def test_resume_matches_uninterrupted(self, tmp_path):
        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=15, check_termination=0)
        from accelerated_tinympc_tpu.api import mpc_rollout

        x0j = jnp.asarray(x0, jnp.float32)
        # uninterrupted 20 ticks
        _, xf_full, trace_full = jax.jit(
            lambda x: mpc_rollout(problem, cache, settings, x, 20)
        )(x0j)

        # 10 ticks, checkpoint, restore in a fresh pytree, 10 more
        st10, x10, _ = jax.jit(
            lambda x: mpc_rollout(problem, cache, settings, x, 10)
        )(x0j)
        ck = tmp_path / "state.npz"
        save_pytree(ck, (st10, x10))
        st_loaded, x_loaded = load_like(ck, (st10, x10))
        _, xf_resumed, trace_tail = jax.jit(
            lambda s, x: mpc_rollout(
                problem, cache, settings, jnp.asarray(x), 10, state=s
            )
        )(jax.tree.map(jnp.asarray, st_loaded), x_loaded)

        np.testing.assert_allclose(
            np.asarray(xf_resumed), np.asarray(xf_full), rtol=0, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(trace_tail.u), np.asarray(trace_full.u[10:]),
            rtol=0, atol=1e-6,
        )


class TestCheckpointValidation:
    """Deployment-grade serialization: a corrupt, truncated, or mismatched
    checkpoint fails loudly with the offending field named (the counterpart
    of the reference's compile-time workspace/dims consistency,
    codegen.cpp:131-160 + 322-479)."""

    def _state(self):
        return atm.set_x0(atm.init_state(12, 4, 10), jnp.ones(12))

    def test_roundtrip_preserves_structure(self, tmp_path):
        st = self._state()
        p = tmp_path / "st.npz"
        save_pytree(p, st)
        st2 = load_like(p, atm.init_state(12, 4, 10))
        assert type(st2) is type(st)
        jax.tree.map(
            lambda a, b: np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b)),
            st, st2,
        )

    def test_manifest_readable(self, tmp_path):
        from accelerated_tinympc_tpu.utils.serialization import read_manifest

        p = tmp_path / "st.npz"
        save_pytree(p, self._state())
        m = read_manifest(p)
        assert m["format_version"] >= 2
        assert any("x" in ent["name"] for ent in m["leaves"])
        assert all(ent["dtype"] == "float32" or "int" in ent["dtype"]
                   for ent in m["leaves"])

    def test_wrong_dims_template_fails(self, tmp_path):
        p = tmp_path / "st.npz"
        save_pytree(p, self._state())
        with pytest.raises(ValueError, match="shape"):
            load_like(p, atm.init_state(8, 2, 5))

    def test_wrong_type_fails(self, tmp_path):
        problem, cache, _ = quadrotor_hovering_setup()
        p = tmp_path / "pc.npz"
        save_pytree(p, cache)
        with pytest.raises(ValueError):
            load_like(p, atm.init_state(12, 4, 10))

    def test_truncated_file_fails(self, tmp_path):
        st = self._state()
        p = tmp_path / "st.npz"
        save_pytree(p, st)
        # Rewrite the npz dropping one leaf but keeping the manifest.
        d = dict(np.load(p))
        keys = [k for k in d if k.startswith("leaf_")]
        del d[keys[-1]]
        np.savez(p, **d)
        with pytest.raises(ValueError, match="missing|truncated"):
            load_like(p, atm.init_state(12, 4, 10))

    def test_no_manifest_fails(self, tmp_path):
        p = tmp_path / "raw.npz"
        np.savez(p, leaf_0=np.zeros(3))
        with pytest.raises(ValueError, match="manifest"):
            load_like(p, atm.init_state(12, 4, 10))

    def test_problem_cache_dim_check(self, tmp_path):
        from accelerated_tinympc_tpu.utils import (
            load_problem_cache, save_problem_cache,
        )

        problem, cache, _ = quadrotor_hovering_setup()
        p = tmp_path / "pc.npz"
        save_problem_cache(p, problem, cache, atm.Settings())
        p2, c2, s2 = load_problem_cache(p)  # clean load still works
        assert p2.A.shape == (12, 12) and s2 is not None
        # Corrupt: Kinf with the wrong dims for these dynamics.
        d = dict(np.load(p))
        del d["__manifest__"]
        d["cache_Kinf"] = np.zeros((3, 7), np.float32)
        np.savez(p, **d)
        with pytest.raises(ValueError, match="Kinf"):
            load_problem_cache(p)
        # Corrupt: field missing entirely.
        del d["cache_Pinf"]
        np.savez(p, **d)
        with pytest.raises(ValueError, match="Pinf"):
            load_problem_cache(p)


class TestCrossProcessResume:
    """A checkpoint written by a separate OS process resumes bit-compatibly
    in this one (SURVEY.md §5 checkpoint/resume — the reference's analogue
    is codegen freezing state for another machine, codegen.cpp:322-479)."""

    def test_subprocess_checkpoint_resumes(self, tmp_path):
        import subprocess
        import sys

        ck = tmp_path / "ck.npz"
        repo_root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
        script = f"""
import sys
sys.path.insert(0, {repo_root!r})
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.api import mpc_rollout
from accelerated_tinympc_tpu.models import quadrotor_hovering_setup
from accelerated_tinympc_tpu.utils import save_pytree
problem, cache, x0 = quadrotor_hovering_setup()
settings = atm.Settings(max_iter=15, check_termination=0)
st10, x10, _ = jax.jit(
    lambda x: mpc_rollout(problem, cache, settings, x, 10)
)(jnp.asarray(x0, jnp.float32))
save_pytree({str(ck)!r}, (st10, x10))
"""
        subprocess.run([sys.executable, "-c", script], check=True,
                       capture_output=True, text=True, timeout=600)

        from accelerated_tinympc_tpu.api import mpc_rollout

        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=15, check_termination=0)
        x0j = jnp.asarray(x0, jnp.float32)
        _, xf_full, _ = jax.jit(
            lambda x: mpc_rollout(problem, cache, settings, x, 20)
        )(x0j)
        template = (atm.init_state(12, 4, 10), x0j)
        st_loaded, x_loaded = load_like(ck, template)
        _, xf_resumed, _ = jax.jit(
            lambda s, x: mpc_rollout(
                problem, cache, settings, jnp.asarray(x), 10, state=s
            )
        )(jax.tree.map(jnp.asarray, st_loaded), x_loaded)
        np.testing.assert_allclose(
            np.asarray(xf_resumed), np.asarray(xf_full), rtol=0, atol=1e-6
        )


class TestFaultDetection:
    """Divergence surfaces as per-instance non-finite flags (SURVEY.md §5
    failure-detection row): an unstable plant with bounds disabled blows up
    within the solve, and health_report pinpoints the instances."""

    def test_diverging_instance_flagged(self):
        import accelerated_tinympc_tpu.models.quadrotor as qm

        problem, cache, x0 = quadrotor_hovering_setup()
        # unstable plant + no projection: rollout explodes
        problem = problem.replace(
            A=problem.A * 3.0,
        )
        settings = atm.Settings(
            max_iter=200, check_termination=0,
            en_state_bound=False, en_input_bound=False,
        )
        from accelerated_tinympc_tpu.solver.batched import (
            init_state_batched, solve_batched,
        )

        st = init_state_batched(2, 12, 4, 10)
        st = st.replace(
            x=st.x.at[:, 0, :].set(
                jnp.asarray(np.stack([np.asarray(x0), np.zeros(12)]),
                            jnp.float32)
            )
        )
        out = jax.jit(
            lambda s: solve_batched(s, problem, cache, settings)
        )(st)
        rep = health_report(out)
        if not rep["all_finite"]:
            assert 0 in rep["nonfinite_instances"]
        else:
            # even if it stays finite, residuals must reflect the blow-up
            assert rep["max_residual"] > 1e3


class TestProfilerTrace:
    def test_trace_writes_artifacts(self, tmp_path):
        from accelerated_tinympc_tpu.utils import trace

        f = jax.jit(lambda x: x @ x.T)
        x = jnp.ones((64, 64))
        with trace(str(tmp_path)):
            jax.block_until_ready(f(x))
        files = list(tmp_path.rglob("*"))
        assert any("trace" in str(p) or p.suffix in (".pb", ".gz", ".json")
                   for p in files), files


def test_cost_models():
    """The analytic cost model has the right scaling shape (padding
    monotone, useful <= padded, linear in iterations)."""
    from accelerated_tinympc_tpu.utils.profiling import solver_cost

    c = solver_cost(12, 4, 10, 100)
    assert c["flops"] <= c["flops_padded"]
    c2 = solver_cost(12, 4, 10, 200)
    assert c2["flops"] == 2 * c["flops"]
    assert c2["state_bytes_per_solve"] == c["state_bytes_per_solve"]
    # Exact powers of two need no padding.
    e = solver_cost(8, 4, 9, 10)   # Dx = 72 -> 128, Du = 32 -> 32
    assert e["flops_padded"] > e["flops"]


class TestDeviceReporting:
    """Device metrics name their device and never fall back to the CPU."""

    def test_require_gpu_fails_on_cpu(self):
        from accelerated_tinympc_tpu.utils.profiling import require_gpu

        with pytest.raises(SystemExit, match="no GPU"):
            require_gpu()

    def test_device_info_names_platform_kind_count(self):
        from accelerated_tinympc_tpu.utils.profiling import device_info

        info = device_info()
        assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                        "count": jax.device_count()}

    @pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3",
                                      "NVIDIA H100 PCIe", "NVIDIA H200"])
    def test_peaks_known(self, kind):
        from accelerated_tinympc_tpu.utils.profiling import peaks

        p = peaks(kind)
        assert p["bf16_flops"] > p["tf32_flops"] > p["f32_flops"] > 0
        assert p["hbm_bytes_per_s"] > 1e12

    def test_peaks_unknown_device_is_an_error(self):
        from accelerated_tinympc_tpu.utils.profiling import peaks

        with pytest.raises(KeyError, match="no published peaks"):
            peaks("cpu")


class TestCompileCache:
    def test_env_dir_wins_and_nothing_else_is_set(self, monkeypatch, tmp_path):
        from accelerated_tinympc_tpu.utils import compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_fixed_path_inside_checkout(self, monkeypatch):
        from accelerated_tinympc_tpu.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            path = compile_cache.enable_compile_cache()
            assert path == str(compile_cache.CACHE_DIR)
            assert jax.config.jax_compilation_cache_dir == path
            assert compile_cache.CACHE_DIR.name == ".jax_cache"
            gi = (compile_cache.CACHE_DIR.parent / ".gitignore").read_text()
            assert ".jax_cache/" in gi.split()
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


class TestCompareSchedules:
    """utils.parity.compare_schedules: counts equal, or one check apart at a
    knife edge of the tolerance on a small share of instances."""

    S = atm.Settings(check_termination=2, abs_pri_tol=1e-2, abs_dua_tol=1e-2)

    def _case(self, it_b, r_first, share_ok=True):
        from accelerated_tinympc_tpu.utils.parity import compare_schedules

        B = 200
        it_a = np.full(B, 10)
        r = np.full((B, 4), 5e-3)
        r_a, r_b = r.copy(), r.copy()
        r_a[0] = r_first
        u = np.zeros((B, 3))
        it_b = np.concatenate([[it_b], np.full(B - 1, 10)])
        return compare_schedules((it_a, r_a, u), (it_b, r_b, u), self.S,
                                 max_share=0.01 if share_ok else 0.0)

    @pytest.mark.parametrize("it_b,r_first,share_ok,expect", [
        (10, 5e-3, True, True),           # identical schedules
        (12, 9.95e-3, True, True),        # one check apart at the edge
        (12, 5e-3, True, False),          # one check apart, far from edge
        (14, 9.95e-3, True, False),       # two checks apart
        (12, 9.95e-3, False, False),      # share of differences too large
    ])
    def test_rule(self, it_b, r_first, share_ok, expect):
        ok, err, detail = self._case(it_b, r_first, share_ok)
        assert ok == expect, detail
        assert detail["differing"] == (0 if it_b == 10 else 1)

    def test_measured_drift_widens_the_edge(self):
        """A first stopper 10 % under the tolerance is a knife edge when the
        tiers' residuals at equal counts differ by 12 % of it."""
        from accelerated_tinympc_tpu.utils.parity import compare_schedules

        B = 200
        it_a, it_b = np.full(B, 10), np.full(B, 10)
        it_b[0] = 12
        r_a = np.full((B, 4), 5e-3)
        r_b = r_a.copy()
        r_a[0] = 9e-3
        r_b[1, 1] = 5e-3 + 1.2e-3
        u = np.zeros((B, 3))
        ok, _err, detail = compare_schedules((it_a, r_a, u), (it_b, r_b, u),
                                             self.S)
        assert ok and detail["residual_drift_over_tol"] == pytest.approx(0.12)
        r_b[1, 1] = 5e-3
        ok, _err, _ = compare_schedules((it_a, r_a, u), (it_b, r_b, u), self.S)
        assert not ok

    def test_controls_compared_where_counts_agree(self):
        from accelerated_tinympc_tpu.utils.parity import compare_schedules

        it = np.full(4, 5)
        r = np.full((4, 4), 1e-3)
        u_a = np.zeros((4, 2))
        u_b = u_a.copy()
        u_b[2, 1] = 3e-4
        ok, err, _ = compare_schedules((it, r, u_a), (it, r, u_b), self.S)
        assert not ok and err == pytest.approx(3e-4)


class TestMemoryReporting:
    def test_memory_summary_of_compiled(self):
        from accelerated_tinympc_tpu.utils.profiling import memory_summary

        compiled = jax.jit(lambda x: x @ x.T).lower(
            jnp.ones((16, 8))).compile()
        m = memory_summary(compiled)
        assert m["argument_size_in_bytes"] == 16 * 8 * 4
        assert m["output_size_in_bytes"] == 16 * 16 * 4

    def test_peak_bytes_in_use_is_int_or_none(self):
        from accelerated_tinympc_tpu.utils.profiling import peak_bytes_in_use

        p = peak_bytes_in_use()
        assert p is None or isinstance(p, int)
