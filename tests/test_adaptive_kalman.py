"""Kalman/UKF trackers and adaptive/estimation filters."""

import numpy as np
import jax.numpy as jnp

from r4w_tpu.ops import adaptive, filters, kalman


# ---------------------------------------------------------------- Kalman


def test_kalman_scalar_converges():
    rng = np.random.default_rng(0)
    z = 1.0 + 0.5 * rng.standard_normal(200)
    p = kalman.KalmanParams.scalar(process_var=1e-5, meas_var=0.25)
    xs, covs = kalman.kalman_filter(p, z)
    assert abs(float(xs[-1, 0]) - 1.0) < 0.1
    assert float(covs[-1, 0, 0]) < 0.05  # variance shrinks


def test_kalman_tracks_ramp():
    rng = np.random.default_rng(1)
    t = np.arange(300) * 0.1
    truth = 2.0 * t
    z = truth + 0.5 * rng.standard_normal(len(t))
    p = kalman.KalmanParams.constant_velocity(0.1, q_accel=1e-2,
                                              r_meas=0.25)
    xs, _ = kalman.kalman_filter(p, z)
    # position locks onto ramp, velocity estimate near 2
    assert abs(float(xs[-1, 0]) - truth[-1]) < 0.5
    assert abs(float(xs[-1, 1]) - 2.0) < 0.3


def test_ukf_nonlinear_measurement():
    # state: scalar x near 3; measurement z = x^2 + noise
    rng = np.random.default_rng(2)
    truth = 3.0
    z = truth**2 + 0.5 * rng.standard_normal(150)
    xs, covs = kalman.ukf_filter(
        fx=lambda x: x, hx=lambda x: x * x,
        q=1e-6 * np.eye(1), r=0.25 * np.eye(1),
        measurements=z, x0=np.asarray([2.0]), cov0=np.eye(1))
    assert abs(float(xs[-1, 0]) - truth) < 0.1
    n = kalman.nees(xs[-50:], covs[-50:], np.full((50, 1), truth))
    assert float(jnp.mean(n)) < 10.0  # consistent covariance


# -------------------------------------------------------------- adaptive


def test_lms_identifies_channel():
    rng = np.random.default_rng(3)
    h = np.asarray([0.8, -0.4, 0.2, 0.1])
    x = rng.standard_normal(4000).astype(np.float32)
    d = np.convolve(x, h)[: len(x)]
    _, e, w = adaptive.lms_filter(x, d, num_taps=4, mu=0.5)
    assert np.allclose(np.asarray(w), h, atol=0.05)
    assert float(np.mean(np.abs(np.asarray(e)[-500:]) ** 2)) < 1e-3


def test_rls_identifies_complex_channel():
    rng = np.random.default_rng(4)
    h = np.asarray([0.7 + 0.3j, -0.2 + 0.5j, 0.1 - 0.1j])
    x = (rng.standard_normal(1500) + 1j * rng.standard_normal(1500)
         ).astype(np.complex64)
    d = np.convolve(x, h)[: len(x)]
    _, e, w = adaptive.rls_filter(x, d, num_taps=3, lam=0.995)
    # y = w^H u identifies conj(h)
    assert np.allclose(np.conj(np.asarray(w)), h, atol=0.05)
    assert float(np.mean(np.abs(np.asarray(e)[-300:]) ** 2)) < 1e-3


def test_adaptive_notch_removes_tone():
    rng = np.random.default_rng(5)
    n = 6000
    tone = 2.0 * np.exp(2j * np.pi * 0.123 * np.arange(n))
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
    x = (tone + noise).astype(np.complex64)
    resid, narrow = adaptive.adaptive_notch(x, num_taps=32, mu=0.05)
    tail = np.asarray(resid)[-2000:]
    # tone power (4.0) crushed into the noise (0.18)
    assert float(np.mean(np.abs(tail) ** 2)) < 0.5
    assert float(np.mean(np.abs(np.asarray(narrow)[-2000:]) ** 2)) > 2.0


def test_savgol_preserves_polynomial():
    t = np.linspace(-1, 1, 101)
    poly = 1.0 + 2.0 * t + 3.0 * t**2
    y = np.asarray(adaptive.savgol_smooth(poly.astype(np.float32),
                                          window=11, polyorder=3))
    assert np.allclose(y[10:-10], poly[10:-10], atol=1e-3)


def test_savgol_smooths_noise():
    rng = np.random.default_rng(6)
    x = np.sin(np.linspace(0, 4 * np.pi, 400))
    noisy = x + 0.3 * rng.standard_normal(400)
    y = np.asarray(adaptive.savgol_smooth(noisy.astype(np.float32),
                                          window=21, polyorder=3))
    err_out = np.mean((y[25:-25] - x[25:-25]) ** 2)
    err_in = np.mean((noisy[25:-25] - x[25:-25]) ** 2)
    assert err_out < err_in / 3


def test_wiener_denoises():
    rng = np.random.default_rng(7)
    n = 4096
    sig = np.exp(2j * np.pi * 0.05 * np.arange(n))
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.5
    x = (sig + noise).astype(np.complex64)
    y = np.asarray(adaptive.wiener_filter(x, noise_power=0.5, nfft=256))
    err_out = np.mean(np.abs(y - sig) ** 2)
    err_in = np.mean(np.abs(x - sig) ** 2)
    assert err_out < err_in / 2


def test_lattice_zero_reflection_is_passthrough():
    x = np.random.default_rng(8).standard_normal(64).astype(np.float32)
    y = np.asarray(adaptive.lattice_filter(np.zeros(4), x))
    assert np.allclose(y, x, atol=1e-6)


def test_lattice_matches_direct_fir():
    # reflection coeffs from a known LPC polynomial; lattice output must
    # equal the direct-form prediction-error filter A(z) applied to x
    a = np.asarray([1.0, -0.5, 0.25])
    k = adaptive.lattice_from_lpc(a)
    x = np.random.default_rng(9).standard_normal(128).astype(np.float32)
    y_lat = np.asarray(adaptive.lattice_filter(k, x))
    y_dir = np.asarray(filters.fir_apply(jnp.asarray(a, jnp.float32), x))
    assert np.allclose(y_lat, y_dir, atol=1e-4)


def test_comb_feedforward_nulls():
    # y = x - x[n-K] nulls DC and multiples of fs/K
    n, k = 1024, 8
    dc = np.ones(n, np.float32)
    y = np.asarray(adaptive.comb_feedforward(dc, k, alpha=-1.0))
    assert np.max(np.abs(y[k:])) < 1e-6
    tone = np.cos(2 * np.pi * np.arange(n) / k).astype(np.float32)
    y2 = np.asarray(adaptive.comb_feedforward(tone, k, alpha=-1.0))
    assert np.max(np.abs(y2[k:])) < 1e-5


def test_comb_feedback_impulse_response():
    n, k, a = 64, 4, 0.5
    x = np.zeros(n, np.float32)
    x[0] = 1.0
    y = np.asarray(adaptive.comb_feedback(x, k, alpha=a))
    expect = np.zeros(n)
    expect[0::k] = a ** np.arange(len(expect[0::k]))
    assert np.allclose(y, expect, atol=1e-6)


def test_memory_polynomial_identification():
    rng = np.random.default_rng(10)
    n = 3000
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) *
         0.3).astype(np.complex64)
    true_c = np.zeros((3, 3), np.complex64)
    true_c[0, 0] = 1.0
    true_c[1, 0] = -0.1 + 0.05j  # 3rd-order compression
    true_c[0, 1] = 0.08j         # linear memory
    y = np.asarray(adaptive.memory_polynomial_apply(true_c, x))
    est = np.asarray(adaptive.identify_memory_polynomial(x, y, memory=3))
    assert np.allclose(est, true_c, atol=1e-3)
    y_hat = np.asarray(adaptive.memory_polynomial_apply(est, x))
    assert float(adaptive.nmse_db(y, y_hat)) < -40.0


def test_am_am_curve_monotone_for_compressive_pa():
    x = np.linspace(0.01, 1.0, 500).astype(np.complex64)
    c = np.zeros((3, 1), np.complex64)
    c[0, 0], c[1, 0] = 1.0, -0.3
    y = adaptive.memory_polynomial_apply(c, x)
    amps, outs = adaptive.am_am_curve(x, y, num_bins=16)
    outs = np.asarray(outs)
    assert outs[8] > 0 and outs[15] < 0.85  # compression at high drive


def test_fft_filter_matches_direct():
    rng = np.random.default_rng(11)
    taps = rng.standard_normal(63).astype(np.float32)
    x = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
         ).astype(np.complex64)
    y_fft = np.asarray(adaptive.fft_filter(taps, x))
    y_dir = np.asarray(filters.fir_apply(taps, x.real)) + \
        1j * np.asarray(filters.fir_apply(taps, x.imag))
    assert np.max(np.abs(y_fft - y_dir)) < 1e-3


def test_lora_mxu_chirp_synthesis_matches_gather():
    """symbol_chirps obeys the chirp shift identity up[(n+s) % N] =
    up[n]·up[s]·exp(j2πns/N) (computed here in numpy float64), and the
    demodulator recovers every symbol."""
    import jax.numpy as jnp

    from r4w_tpu.waveforms import lora
    from r4w_tpu.waveforms.lora import chirp as chirp_mod

    p = lora.LoRaParams(sf=7)
    syms = np.arange(128, dtype=np.int32).reshape(2, 64)
    got = np.asarray(chirp_mod.symbol_chirps(p, syms))
    up = np.asarray(chirp_mod.base_upchirp(p)).astype(np.complex128)
    n = np.arange(128)
    want = (up[None, None, :] * up[syms][..., None]
            * np.exp(2j * np.pi * n[None, None, :] * syms[..., None] / 128))
    assert np.max(np.abs(got - want)) < 5e-3
    out, _, _ = lora.demodulate_symbols(p, jnp.asarray(got))
    assert np.array_equal(np.asarray(out).reshape(-1), np.arange(128))


def test_lora_mxu_rejects_oversample():
    """Oversampled chirps shift by symbol·oversample samples (chirp.rs
    generate_symbol_chirp_fast), and demodulation decimates back."""
    import jax.numpy as jnp

    from r4w_tpu.waveforms import lora
    from r4w_tpu.waveforms.lora import chirp as chirp_mod

    p = lora.LoRaParams(sf=7, oversample=2)
    syms = np.asarray([[0, 5, 127]], np.int32)
    got = np.asarray(chirp_mod.symbol_chirps(p, syms))
    up = np.asarray(chirp_mod.base_upchirp(p))
    for i, s in enumerate(syms[0]):
        np.testing.assert_array_equal(got[0, i], np.roll(up, -2 * s))
    out, _, _ = lora.demodulate_symbols(p, jnp.asarray(got))
    assert np.array_equal(np.asarray(out), syms)
