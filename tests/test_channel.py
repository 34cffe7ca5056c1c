"""Channel model statistical tests (SURVEY.md §4 'Statistical' pattern)."""

import jax
import jax.numpy as jnp
import numpy as np

from r4w_tpu import channel as ch


def _tone(n=4096):
    t = jnp.arange(n)
    return jnp.exp(1j * 0.1 * t).astype(jnp.complex64)


def test_awgn_snr_matches_configured():
    x = _tone(1 << 14)
    for snr in (0.0, 10.0, 20.0):
        y = ch.awgn(jax.random.key(1), x, snr)
        meas = float(ch.measure_snr(x, y))
        assert abs(meas - snr) < 1.0, (snr, meas)


def test_cfo_rotates_tone():
    fs = 125_000.0
    x = jnp.ones(1000, jnp.complex64)
    y = ch.cfo(x, cfo_hz=1000.0, sample_rate=fs)
    # instantaneous frequency == 1000 Hz
    dphase = np.angle(np.asarray(y[1:]) * np.conj(np.asarray(y[:-1])))
    freq = np.mean(dphase) * fs / (2 * np.pi)
    assert abs(freq - 1000.0) < 1.0


def test_rayleigh_unit_mean_power():
    x = jnp.ones(1 << 16, jnp.complex64)
    y = ch.rayleigh(jax.random.key(2), x)
    p = float(jnp.mean(jnp.abs(y) ** 2))
    assert abs(p - 1.0) < 0.05


def test_rician_k_factor_power():
    x = jnp.ones(1 << 16, jnp.complex64)
    y = ch.rician(jax.random.key(3), x, k_factor=5.0)
    p = float(jnp.mean(jnp.abs(y) ** 2))
    assert abs(p - 1.0) < 0.05


def test_multipath_2ray():
    x = jnp.zeros(16, jnp.complex64).at[0].set(1.0)
    y = ch.multipath_2ray(x, delay_samples=3, amplitude=0.5)
    y = np.asarray(y)
    assert abs(y[0] - 1.0) < 1e-6
    assert abs(y[3] - 0.5) < 1e-6


def test_jakes_fading_statistics():
    h = ch.jakes_fading(jax.random.key(4), 1 << 15, doppler_hz=100.0,
                        sample_rate=125_000.0)
    p = float(jnp.mean(jnp.abs(h) ** 2))
    assert 0.5 < p < 2.0  # unit-ish power
    # fading must actually vary
    assert float(jnp.std(jnp.abs(h))) > 0.1


def test_tdl_profiles_exist_and_apply():
    x = _tone(8192)
    for profile in ("EPA", "EVA", "ETU"):
        y = ch.tdl_channel(jax.random.key(5), x, profile, 30.72e6, 50.0)
        assert y.shape == x.shape
        assert np.all(np.isfinite(np.asarray(y).view(np.float32)))


def test_rms_delay_spread_ordering():
    assert ch.rms_delay_spread("EPA") < ch.rms_delay_spread("EVA")
    assert ch.rms_delay_spread("EVA") < ch.rms_delay_spread("ETU")


def test_apply_channel_dispatch():
    x = _tone()
    for model in ("ideal", "awgn", "awgn_cfo", "multipath", "rayleigh",
                  "rician", "tdl_awgn", "jakes"):
        cfg = ch.ChannelConfig(model=model, snr_db=15.0, cfo_hz=100.0,
                               multipath_delay=2, multipath_amplitude=0.3,
                               sample_rate=125_000.0)
        y = ch.apply_channel(jax.random.key(6), x, cfg)
        assert y.shape == x.shape


def test_theoretical_ber_monotone():
    snrs = jnp.asarray([-20.0, -10.0, 0.0])
    ber = np.asarray(ch.theoretical_ber_awgn(snrs, 7))
    assert ber[0] > ber[1] > ber[2]


def test_vmapped_monte_carlo_lanes():
    """Thousands of AWGN lanes via vmap — the batch-first 'parallel.rs'."""
    x = _tone(1024)
    keys = jax.random.split(jax.random.key(7), 64)
    ys = jax.vmap(lambda k: ch.awgn(k, x, 10.0))(keys)
    assert ys.shape == (64, 1024)
    # lanes are decorrelated
    c = np.corrcoef(np.asarray(ys[0].real), np.asarray(ys[1].real))[0, 1]
    assert abs(c) < 0.9
