"""delta-f PIC solver tests: RK tableau via the oscillator fake state
(modeled on the reference's test/test_integrator.cpp), deposition/gather
invariants, and statistical golden comparison."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from emme_tpu import from_config
from emme_tpu.solvers import pic


def test_rk3_harmonic_oscillator():
    """Integrate x'' = -x with the 3-stage tableau; the reference's own test
    accepts deviation < 1e-5 from sin(t) over t in [0, 10]
    (test_integrator.cpp:50-79)."""
    state = jnp.array([0.0, 1.0])  # (x, v)

    def velocity(s):
        return jnp.array([s[1], -s[0]])

    def update(s, vel, dt):
        return s + vel * dt

    dt = 0.01
    n = 1000
    s = state
    for i in range(n):
        s, _ = pic.rk3_generic(s, velocity, update, dt)
    t = n * dt
    assert abs(float(s[0]) - np.sin(t)) < 1e-5
    assert abs(float(s[1]) - np.cos(t)) < 1e-5


def test_rk3_error_estimate_small_for_smooth():
    state = jnp.array([0.0, 1.0])
    velocity = lambda s: jnp.array([s[1], -s[0]])
    update = lambda s, vel, dt: s + vel * dt
    _, v = pic.rk3_generic(state, velocity, update, 0.01)
    err = pic.rk3_error_estimate(
        v, 0.01, lambda c, dt: jnp.linalg.norm(c * dt))
    assert float(err) < 1e-4


@pytest.fixture(scope="module")
def pic_params(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=64)
    return from_config(cfg)


def test_quasi_neutrality_coef(pic_params):
    qn = np.asarray(pic.quasi_neutrality_coef(pic_params))
    assert qn.shape == (64,)
    assert np.isfinite(qn).all()
    # symmetric about the field line centre up to the grid's half-cell offset
    cw = float(pic.cell_width(pic_params))
    from scipy.special import ive
    L = float(pic_params.length)
    b0 = float(pic_params.b_theta) * (1 + float(pic_params.shat) ** 2 * L**2)
    expected0 = 1.0 / ((1 + 1 - ive(0, b0)) * cw)  # tau = 1
    assert qn[0] == pytest.approx(expected0, rel=1e-10)


def test_deposition_charge_conservation(pic_params):
    p = pic_params
    key = jax.random.PRNGKey(1)
    s = pic.init_state(p, 16, key)
    # neutral weights deposit nothing; j0 is refreshed (nonzero) after solve
    s2 = pic.solve_field(p, s, pic.quasi_neutrality_coef(p))
    assert np.isfinite(np.asarray(s2.field)).all()
    assert np.abs(np.asarray(s2.j0)).max() > 0
    # total deposited charge equals sum of den: compare sums
    den = np.asarray(s2.j0) * np.asarray(s.weight) * np.asarray(s2.dc_pb)
    qn = np.asarray(pic.quasi_neutrality_coef(p))
    total_field = np.sum(np.asarray(s2.field) / qn)
    assert abs(total_field - den.sum()) < 1e-10 * abs(den.sum())


def test_deposit_matmul_matches_segment(pic_params):
    """The one-hot matmul deposition (the GPU default) is algebraically the same
    scatter as segment_sum (CPU default), including the periodic (idx+1)
    wrap and chunk padding."""
    p = pic_params
    nf = int(p.npoints)
    rng = np.random.default_rng(7)
    m = 1000  # deliberately not a multiple of the chunk size
    den = jnp.asarray(rng.normal(size=m) + 1j * rng.normal(size=m))
    idx = jnp.asarray(rng.integers(0, nf, size=m).astype(np.int32))
    w = jnp.asarray(rng.uniform(size=m))
    d_seg = pic.deposit(den, idx, w, nf, method="segment")
    d_mm = pic.deposit(den, idx, w, nf, method="matmul")
    assert np.abs(np.asarray(d_seg) - np.asarray(d_mm)).max() < 1e-12


def test_gather_matmul_matches_take(pic_params):
    """The one-hot matmul gather reproduces the indexed-load CIC
    gather, including the periodic stencil wrap."""
    p = pic_params
    nf = int(p.npoints)
    cw = float(pic.cell_width(p))
    rng = np.random.default_rng(8)
    field = jnp.asarray(rng.normal(size=nf) + 1j * rng.normal(size=nf))
    m = 777
    idx = jnp.asarray(rng.integers(0, nf, size=m).astype(np.int32))
    w = jnp.asarray(rng.uniform(size=m))
    phi_t, dphi_t = pic.gather_cic(field, idx, w, nf, cw, method="take")
    phi_m, dphi_m = pic.gather_cic(field, idx, w, nf, cw, method="matmul")
    assert np.abs(np.asarray(phi_t) - np.asarray(phi_m)).max() < 1e-12
    assert np.abs(np.asarray(dphi_t) - np.asarray(dphi_m)).max() < 1e-12


def test_pic_short_run_finite(pic_params):
    stats, s, _ = pic.run(pic_params, 8, 20, 0.25, key=jax.random.PRNGKey(3))
    st = np.asarray(stats)
    assert st.shape == (20, 3)
    assert np.isfinite(st).all()
    assert (st[:, 2] > 0).all()


def test_pic_streaming_field_dumps(pic_params, tmp_path):
    """run_streaming flushes per-step fields DURING the run (parity with
    main.cpp:105-110): the streamed file holds exactly the per-step fields
    the buffered run returns, and partial chunks stream too."""
    p = pic_params
    key = jax.random.PRNGKey(3)
    path = tmp_path / "fields.bin"
    stats_s, s_s = pic.run_streaming(p, 8, 7, 0.25, path, key=key,
                                     chunk_steps=3)
    stats_b, s_b, fields = pic.run(p, 8, 7, 0.25, key=key,
                                   record_fields=True)
    nf = np.asarray(s_b.field).shape[-1]
    streamed = np.fromfile(path, dtype=np.complex128).reshape(7, nf)
    assert np.abs(streamed - np.asarray(fields)).max() < 1e-12
    assert np.abs(np.asarray(stats_s) - np.asarray(stats_b)).max() < 1e-12


@pytest.mark.slow
def test_pic_statistical_golden(tokamak_cfg, golden_eigenvalues):
    """256x256-marker run must reproduce the reference PIC gamma/omega within
    sampling noise (different RNG)."""
    cfg = dict(tokamak_cfg, npoints=256, marker_per_cell=256)
    p = from_config(cfg)
    stats, _, _ = pic.run(p, 256, 180, 0.25, key=jax.random.PRNGKey(42))
    om = pic.calculate_omega(np.asarray(stats), 0.25)
    ref = complex(*golden_eigenvalues["pic_tok256"]["omega"])
    assert abs(om.imag - ref.imag) / abs(ref.imag) < 0.10   # growth rate
    assert abs(om.real - ref.real) / abs(ref.real) < 0.05   # |frequency|


def test_calculate_omega_fft_synthetic():
    """The FFT fit recovers a known signed frequency and growth rate from a
    synthetic e^{(gamma - i omega) t} stats series (including negative and
    positive omega), where the reference's peak-count fit is unsigned."""
    dt, n = 0.25, 200
    t = dt * np.arange(n)
    for om_true in (-0.83, 0.61):
        gam_true = 0.2
        phi = np.exp((gam_true - 1j * om_true) * t) * (0.3 - 0.1j)
        stats = np.stack([phi.real, phi.imag, np.abs(phi)], axis=1)
        om = pic.calculate_omega_fft(stats, dt)
        assert om.imag == pytest.approx(gam_true, rel=1e-6)
        assert om.real == pytest.approx(om_true, rel=5e-3)
        # the peak-count fit sees only |omega|
        om_peak = pic.calculate_omega(stats, dt)
        assert om_peak.real == pytest.approx(abs(om_true), rel=0.05)


@pytest.mark.slow
def test_pic_fft_omega_sign_matches_eigen(tokamak_cfg, golden_eigenvalues):
    """On the real 256x256 run the FFT fit must agree with the peak-count
    fit in magnitude AND carry the eigen-method eigenvalue's sign."""
    cfg = dict(tokamak_cfg, npoints=256, marker_per_cell=256)
    p = from_config(cfg)
    stats, _, _ = pic.run(p, 256, 180, 0.25, key=jax.random.PRNGKey(42))
    om = pic.calculate_omega_fft(np.asarray(stats), 0.25)
    ref_pic = complex(*golden_eigenvalues["pic_tok256"]["omega"])
    assert abs(abs(om.real) - ref_pic.real) / ref_pic.real < 0.05
    assert om.real < 0  # eigen golden frequency is negative


def test_step_adaptive(pic_params):
    """Adaptive halving/doubling with rollback (solver_pic.h:437-457)."""
    p = pic_params
    qn = pic.quasi_neutrality_coef(p)
    s = pic.init_state(p, 8, jax.random.PRNGKey(5))
    s2, dt_taken, next_dt = pic.step_adaptive(p, s, 0.25, qn,
                                              upper_err_bound=1e-4,
                                              lower_err_bound=1e-12)
    assert dt_taken <= 0.25
    assert np.isfinite(np.asarray(s2.field)).all()
    # a tighter bound forces halving
    s3, dt2, _ = pic.step_adaptive(p, s, 0.25, qn, upper_err_bound=1e-9,
                                   lower_err_bound=1e-14)
    assert dt2 < 0.25


def test_run_timed_matches_fused_run(pic_params):
    """The per-phase-timed host loop computes the same trajectory as the
    fused lax.scan run (same key, same RK stages)."""
    from emme_tpu.utils.timer import Timer

    p = pic_params
    key = jax.random.PRNGKey(3)
    stats_a, s_a, _ = pic.run(p, 8, 5, 0.25, key=key)
    stats_b, s_b, _ = pic.run_timed(p, 8, 5, 0.25, key=key)
    np.testing.assert_allclose(np.asarray(stats_a), stats_b, rtol=1e-10)
    # the reference's phase sections exist (solver_pic.h:127-155)
    acc = Timer.get_timer()._acc
    for name in ("Particle Pushing", "Field Solve", "Diagnostics"):
        assert name in acc


@pytest.mark.slow
def test_run_adaptive_and_nonuniform_fit(pic_params):
    p = pic_params
    times, stats, s = pic.run_adaptive(p, 8, 1.0, 0.25, key=jax.random.PRNGKey(4),
                                       upper_err_bound=1e-5)
    assert times[-1] == pytest.approx(1.0, abs=1e-9)
    assert len(times) == len(stats)
    om = pic.calculate_omega_nonuniform(times, stats)
    assert np.isfinite(om.real) and np.isfinite(om.imag)


def test_run_gather_deposit_method_passthrough(pic_params):
    p = pic_params
    key = jax.random.PRNGKey(5)
    a, _, _ = pic.run(p, 8, 3, 0.25, key=key, gather_method="take",
                      deposit_method="segment")
    b, _, _ = pic.run(p, 8, 3, 0.25, key=key, gather_method="matmul",
                      deposit_method="matmul")
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8)


@pytest.mark.slow
def test_driver_pic_adaptive_and_timers(tmp_path, tokamak_cfg):
    from emme_tpu import driver

    cfg = dict(tokamak_cfg, npoints=32, marker_per_cell=4, step_number=4,
               method="PIC", time_step_adaptive=True)
    res = driver.run(cfg, output_dir=tmp_path / "a", verbose=False)
    r = res["result"]["(None)"]["scan_result"][0]
    assert r["adaptive_steps"] >= 4
    assert r["adaptive_final_time"] == pytest.approx(4 * 0.25)

    cfg2 = dict(tokamak_cfg, npoints=32, marker_per_cell=4, step_number=3,
                method="PIC", pic_timers=True)
    res2 = driver.run(cfg2, output_dir=tmp_path / "b", verbose=False)
    assert "eigenvalue" in res2["result"]["(None)"]["scan_result"][0]


def test_run_sorted_matches_run(tokamak_cfg):
    # the sorted-window path (cell-local one-hot gather/deposit over W-cell
    # windows, unwrapped eta between re-sorts, guard-cell periodic fold)
    # must reproduce the reference path to roundoff, with ZERO window
    # violations (the guard width is chosen from the realized max |v_para|)
    import jax
    import numpy as np
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.solvers import pic

    cfg = dict(tokamak_cfg, npoints=64)
    p = from_config(cfg)
    key = jax.random.PRNGKey(0)
    stats_ref, s_ref, _ = pic.run(p, 32, 12, 0.25, key=key)
    stats_w, s_w, viols = pic.run_sorted(p, 32, 12, 0.25, key=key,
                                         resort_every=4, window=32,
                                         chunk_markers=256)
    assert int(viols) == 0
    assert np.abs(np.asarray(stats_ref) - np.asarray(stats_w)).max() < 1e-12
    fr = np.asarray(s_ref.field)
    fw = np.asarray(s_w.field)
    assert np.abs(fr - fw).max() < 1e-12 * np.abs(fr).max() + 1e-13


def test_omega_fit_views_golden(goldens_dir):
    """Both gamma time-weight conventions (plain loop vs EMME_USE_VIEWS,
    solver_pic.h:479-501) match the reference binary compiled each way on
    the deterministic series of tests/goldens/tools/gen_omega_fit.cpp."""
    import json as _json
    with open(goldens_dir / "omega_fit.json") as f:
        g = _json.load(f)
    dt, gam, w = 0.25, 0.21, 0.83
    n = 180
    i = np.arange(1, n + 1)
    t = i * dt
    grow = np.exp(gam * t)
    stats = np.stack([grow * np.cos(w * t) + 1e-3 * np.sin(3.1 * t),
                      grow * np.sin(w * t),
                      grow * (1.0 + 0.01 * np.sin(1.7 * t))], axis=1)
    om_plain = pic.calculate_omega(stats, dt)
    om_views = pic.calculate_omega(stats, dt, views=True)
    assert om_plain.real == pytest.approx(g["plain"][0], rel=1e-12)
    assert om_plain.imag == pytest.approx(g["plain"][1], rel=1e-12)
    assert om_views.real == pytest.approx(g["views"][0], rel=1e-12)
    assert om_views.imag == pytest.approx(g["views"][1], rel=1e-12)
    # the two conventions genuinely differ (the golden discriminates)
    assert abs(om_plain.imag - om_views.imag) > 1e-3
