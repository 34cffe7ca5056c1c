"""Link-budget, propagation & satellite-link fills.

Re-designs of link_budget.rs, link_budget_optimizer.rs,
satellite_link_budget_calculator.rs, satellite_link_predictor.rs,
satellite_tle_propagator.rs, rain_attenuation_predictor.rs,
troposcatter_propagation.rs, rf_propagation_model.rs,
free_space_optical_channel.rs, propagation_mode_sounder.rs,
frequency_domain_channel_sounder.rs, multipath_profile_extractor.rs,
multipath_equalizer_sparse.rs, channel_estimator.rs,
dynamic_channel.rs.

Scalar link math is pure numpy (control plane); sounding/estimation is
batched jnp correlation work.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE

C_LIGHT = 299_792_458.0
K_BOLTZ_DBW = -228.6   # dBW/K/Hz

# ------------------------------------------------------- link budgets


def fspl_db(range_m: float, freq_hz: float):
    """Free-space path loss (link_budget.rs)."""
    return 20.0 * np.log10(4.0 * np.pi * np.asarray(range_m)
                           * freq_hz / C_LIGHT)


def link_budget(tx_power_dbw: float, tx_gain_db: float,
                rx_gain_db: float, range_m: float, freq_hz: float,
                bandwidth_hz: float, system_temp_k: float = 290.0,
                misc_loss_db: float = 0.0):
    """End-to-end link budget (link_budget.rs /
    satellite_link_budget_calculator.rs): returns a dict with EIRP,
    path loss, received power, noise floor, C/N and C/N0."""
    eirp = tx_power_dbw + tx_gain_db
    pl = float(fspl_db(range_m, freq_hz))
    prx = eirp - pl - misc_loss_db + rx_gain_db
    n0 = K_BOLTZ_DBW + 10.0 * np.log10(system_temp_k)
    noise = n0 + 10.0 * np.log10(bandwidth_hz)
    return {"eirp_dbw": eirp, "path_loss_db": pl, "prx_dbw": prx,
            "noise_dbw": noise, "cn_db": prx - noise,
            "cn0_dbhz": prx - n0}


def link_budget_optimize(range_m: float, freq_hz: float,
                         bandwidth_hz: float, required_cn_db: float,
                         tx_gain_db: float = 0.0,
                         rx_gain_db: float = 0.0,
                         margin_db: float = 3.0):
    """Solve for the minimum TX power meeting C/N + margin
    (link_budget_optimizer.rs)."""
    zero = link_budget(0.0, tx_gain_db, rx_gain_db, range_m, freq_hz,
                       bandwidth_hz)
    need = required_cn_db + margin_db - zero["cn_db"]
    return need    # dBW


# ------------------------------------------------------------ TLE/orbit


@dataclasses.dataclass
class Tle:
    """Parsed two-line-element set (satellite_tle_propagator.rs).
    Fields needed for a simplified (circular-orbit SGP4-lite)
    propagation."""
    inclination_deg: float
    raan_deg: float
    eccentricity: float
    arg_perigee_deg: float
    mean_anomaly_deg: float
    mean_motion_rev_day: float
    epoch_yr: int = 2026
    epoch_day: float = 0.0

    @classmethod
    def parse(cls, line1: str, line2: str) -> "Tle":
        return cls(
            inclination_deg=float(line2[8:16]),
            raan_deg=float(line2[17:25]),
            eccentricity=float("0." + line2[26:33].strip()),
            arg_perigee_deg=float(line2[34:42]),
            mean_anomaly_deg=float(line2[43:51]),
            mean_motion_rev_day=float(line2[52:63]),
            epoch_yr=2000 + int(line1[18:20]),
            epoch_day=float(line1[20:32]),
        )


def tle_propagate(tle: Tle, t_since_epoch_s):
    """Simplified Keplerian propagation of a TLE to ECI positions
    (satellite_tle_propagator.rs — two-body, no J2; adequate for
    pass-prediction-scale tests). Returns (N, 3) meters."""
    mu = 3.986004418e14
    n_rad = tle.mean_motion_rev_day * 2.0 * np.pi / 86400.0
    a = (mu / n_rad ** 2) ** (1.0 / 3.0)
    t = jnp.atleast_1d(jnp.asarray(t_since_epoch_s, REAL_DTYPE))
    m = np.deg2rad(tle.mean_anomaly_deg) + n_rad * t
    # Kepler solve (static 8 Newton steps — jit-safe; the TLE fields
    # are design-time constants, only t is traced)
    e = tle.eccentricity
    ecc_an = m
    for _ in range(8):
        ecc_an = ecc_an - (ecc_an - e * jnp.sin(ecc_an) - m) \
            / (1.0 - e * jnp.cos(ecc_an))
    nu = 2.0 * jnp.arctan2(np.sqrt(1 + e) * jnp.sin(ecc_an / 2),
                           np.sqrt(1 - e) * jnp.cos(ecc_an / 2))
    r = a * (1.0 - e * jnp.cos(ecc_an))
    # perifocal -> ECI
    w = np.deg2rad(tle.arg_perigee_deg)
    inc = np.deg2rad(tle.inclination_deg)
    raan = np.deg2rad(tle.raan_deg)
    xp = r * jnp.cos(nu)
    yp = r * jnp.sin(nu)
    cw, sw = np.cos(w), np.sin(w)
    ci, si = np.cos(inc), np.sin(inc)
    co, so = np.cos(raan), np.sin(raan)
    x = (co * cw - so * sw * ci) * xp + (-co * sw - so * cw * ci) * yp
    y = (so * cw + co * sw * ci) * xp + (-so * sw + co * cw * ci) * yp
    z = (sw * si) * xp + (cw * si) * yp
    return jnp.stack([x, y, z], axis=-1).astype(REAL_DTYPE)


def pass_predict(tle: Tle, site_ecef_m, t_grid_s,
                 min_elevation_deg: float = 10.0,
                 max_passes: int = 16):
    """Visibility windows over a time grid (satellite_link_predictor.rs,
    ECI≈ECEF simplification — fine for geometry-shape tests).
    jit-safe fixed-capacity form (VERDICT r4 #6): returns
    `(t_start[K], t_end[K], max_elev_deg[K], valid[K])` for up to
    K = max_passes windows in time order (t_end inclusive, matching
    the original list form)."""
    from r4w_tpu.ops.events import masked_indices

    pos = tle_propagate(tle, t_grid_s)
    site = jnp.asarray(site_ecef_m, REAL_DTYPE)
    look = pos - site[None, :]
    up = site / jnp.linalg.norm(site)
    elev = 90.0 - jnp.rad2deg(jnp.arccos(jnp.clip(
        (look @ up) / jnp.linalg.norm(look, axis=-1), -1.0, 1.0)))
    vis = elev > min_elevation_deg
    t = jnp.asarray(t_grid_s, REAL_DTYPE)
    n = t.shape[0]
    prev = jnp.concatenate([jnp.zeros(1, bool), vis[:-1]])
    nxt = jnp.concatenate([vis[1:], jnp.zeros(1, bool)])
    starts, valid = masked_indices(vis & ~prev, max_passes)
    ends, _ev = masked_indices(vis & ~nxt, max_passes)  # inclusive
    # per-pass max elevation: one (K, N) broadcast reduction
    i = jnp.arange(n)
    in_pass = (i[None, :] >= starts[:, None]) & (i[None, :]
                                                 <= ends[:, None])
    max_el = jnp.max(jnp.where(in_pass, elev[None, :], -jnp.inf),
                     axis=1)
    tpad = jnp.concatenate([t, jnp.zeros(1, REAL_DTYPE)])
    return (jnp.where(valid, tpad[starts], 0.0),
            jnp.where(valid, tpad[jnp.minimum(ends, n - 1)], 0.0),
            jnp.where(valid, max_el, 0.0), valid)


# ----------------------------------------------------------- weather


def rain_attenuation_db_per_km(rate_mm_hr: float, freq_ghz: float,
                               polarization: str = "h"):
    """ITU-R P.838-style specific rain attenuation γ = k·R^α
    (rain_attenuation_predictor.rs). k/α from a compact fit of the
    published coefficients over 1–100 GHz."""
    f = np.clip(freq_ghz, 1.0, 100.0)
    lf = np.log10(f)
    if polarization == "h":
        k = 10.0 ** (-4.33 + 2.73 * lf - 0.31 * lf ** 2)
        alpha = 1.07 + 0.23 * np.exp(-((lf - 0.7) ** 2) / 0.4)
    else:
        k = 10.0 ** (-4.45 + 2.75 * lf - 0.32 * lf ** 2)
        alpha = 1.06 + 0.22 * np.exp(-((lf - 0.7) ** 2) / 0.4)
    return float(k * rate_mm_hr ** alpha)


def troposcatter_loss_db(range_km: float, freq_mhz: float,
                         scatter_angle_mrad: float = 10.0):
    """Empirical troposcatter median path loss
    (troposcatter_propagation.rs): NBS-101-flavored
    L = 30log f + 30log θ + 10log d + fixed."""
    return (30.0 * np.log10(freq_mhz)
            + 30.0 * np.log10(scatter_angle_mrad)
            + 10.0 * np.log10(range_km) + 57.0)


def propagation_loss_db(model: str, range_m: float, freq_hz: float,
                        h_tx_m: float = 30.0, h_rx_m: float = 1.5):
    """Multi-model path loss (rf_propagation_model.rs): fspl /
    two-ray / hata-urban."""
    if model == "fspl":
        return float(fspl_db(range_m, freq_hz))
    if model == "two_ray":
        return float(40.0 * np.log10(range_m)
                     - 20.0 * np.log10(h_tx_m * h_rx_m))
    if model == "hata_urban":
        f_mhz = freq_hz / 1e6
        d_km = range_m / 1e3
        a_hm = (1.1 * np.log10(f_mhz) - 0.7) * h_rx_m \
            - (1.56 * np.log10(f_mhz) - 0.8)
        return float(69.55 + 26.16 * np.log10(f_mhz)
                     - 13.82 * np.log10(h_tx_m) - a_hm
                     + (44.9 - 6.55 * np.log10(h_tx_m))
                     * np.log10(d_km))
    raise ValueError(f"unknown model '{model}'")


def fso_link_margin_db(tx_power_dbm: float, range_m: float,
                       beam_divergence_mrad: float = 1.0,
                       rx_aperture_m: float = 0.1,
                       visibility_km: float = 10.0,
                       sensitivity_dbm: float = -30.0):
    """Free-space-optical link margin (free_space_optical_channel.rs):
    geometric spreading + Kruse visibility attenuation."""
    beam_radius = range_m * beam_divergence_mrad * 1e-3 / 2.0
    geo_loss = -20.0 * np.log10(
        min(1.0, rx_aperture_m / (2.0 * max(beam_radius, 1e-6))))
    atten = 13.0 / visibility_km * (range_m / 1000.0)  # dB (550nm-ish)
    prx = tx_power_dbm - geo_loss - atten
    return prx - sensitivity_dbm


# -------------------------------------------------------- channel sound


def freq_domain_sound(tx_known, rx, n_fft: int | None = None):
    """Frequency-domain channel sounding
    (frequency_domain_channel_sounder.rs): H = FFT(rx)/FFT(tx) with
    regularization; returns (H, impulse response)."""
    tx = jnp.asarray(tx_known, IQ_DTYPE)
    rx = jnp.asarray(rx, IQ_DTYPE)
    n = n_fft or tx.shape[0]
    tf = jnp.fft.fft(tx, n)
    rf = jnp.fft.fft(rx, n)
    h = rf * jnp.conj(tf) / (jnp.abs(tf) ** 2 + 1e-6)
    return h, jnp.fft.ifft(h)


def multipath_profile(tx_known, rx, n_paths: int = 8,
                      min_rel: float = 0.05):
    """Power-delay profile extraction (multipath_profile_extractor.rs):
    correlate, pick the strongest taps. jit-safe fixed-capacity form
    (VERDICT r4 #6): returns `(delays[n_paths] int32,
    gains[n_paths] complex, valid[n_paths])` — the n_paths strongest
    taps in delay order, `valid` False where the tap fell below
    min_rel·peak (its delay is parked at n, its gain zeroed)."""
    _, imp = freq_domain_sound(tx_known, rx)
    mag = jnp.abs(imp)
    n = mag.shape[0]
    peak = jnp.max(mag)
    vals, idx = jax.lax.top_k(mag, n_paths)
    valid = vals > min_rel * peak
    # delay order with rejected taps parked past the end
    delays = jnp.sort(jnp.where(valid, idx, n))
    valid = delays < n
    gains = jnp.where(valid,
                      jnp.concatenate([imp, jnp.zeros(1, imp.dtype)]
                                      )[delays], 0.0)
    return delays.astype(jnp.int32), gains, valid


def sparse_multipath_equalize(rx, taps, n_fft: int = 1024):
    """Invert a sparse multipath channel in the frequency domain
    (multipath_equalizer_sparse.rs): build H from the known taps and
    apply regularized ZF per block."""
    rx = jnp.asarray(rx, IQ_DTYPE)
    h = np.zeros(n_fft, np.complex64)
    for d, g in taps:
        h[d % n_fft] = g
    hf = jnp.asarray(np.fft.fft(h))
    n = (rx.shape[0] // n_fft) * n_fft
    frames = rx[:n].reshape(-1, n_fft)
    eq = jnp.fft.ifft(jnp.fft.fft(frames, axis=-1) * jnp.conj(hf)
                      / (jnp.abs(hf) ** 2 + 1e-3), axis=-1)
    return eq.reshape(-1)


def ls_channel_estimate(tx_pilots, rx_pilots, n_taps: int = 8):
    """Time-domain least-squares channel estimator
    (channel_estimator.rs): solve the Toeplitz LS for the FIR channel.

    Pure jnp (jit/vmap-safe): the Toeplitz data matrix is one gather
    and the complex LS solves through the real-block normal
    equations (core.linalg.complex_lstsq)."""
    from r4w_tpu.core.linalg import complex_lstsq

    x = jnp.asarray(tx_pilots, IQ_DTYPE)
    y = jnp.asarray(rx_pilots, IQ_DTYPE)
    rows = x.shape[0] - n_taps + 1
    idx = jnp.arange(rows)[:, None] + (n_taps - 1
                                       - jnp.arange(n_taps))[None, :]
    a = x[idx]                                  # (rows, n_taps)
    b = y[n_taps - 1:n_taps - 1 + rows]
    return complex_lstsq(a, b).astype(IQ_DTYPE)


class DynamicChannel:
    """Time-varying two-state channel (dynamic_channel.rs): good/bad
    Markov switching of SNR, deterministic given the seed."""

    def __init__(self, snr_good_db: float = 20.0,
                 snr_bad_db: float = 0.0, p_gb: float = 0.05,
                 p_bg: float = 0.3, seed: int = 0):
        self.states = (snr_good_db, snr_bad_db)
        self.p_gb, self.p_bg = p_gb, p_bg
        self.rng = np.random.default_rng(seed)
        self.bad = False

    def step(self) -> float:
        if self.bad:
            if self.rng.uniform() < self.p_bg:
                self.bad = False
        else:
            if self.rng.uniform() < self.p_gb:
                self.bad = True
        return self.states[1] if self.bad else self.states[0]


def mode_sound(rx_sweep, freqs_hz, threshold_rel: float = 0.3,
               max_modes: int = 16):
    """Propagation-mode sounding (propagation_mode_sounder.rs): find
    the supported modes (local maxima) in a swept-frequency response —
    e.g. ionospheric layer returns. jit-safe fixed-capacity form
    (VERDICT r4 #6): `(freqs[K], mags[K], valid[K])` for the first
    K = max_modes modes in sweep order."""
    from r4w_tpu.ops.events import masked_indices

    mag = jnp.abs(jnp.asarray(rx_sweep))
    f = jnp.asarray(freqs_hz, REAL_DTYPE)
    peak = jnp.max(mag)
    is_peak = ((mag[1:-1] > mag[:-2]) & (mag[1:-1] >= mag[2:])
               & (mag[1:-1] > threshold_rel * peak))
    idx, valid = masked_indices(is_peak, max_modes)
    idx = idx + 1  # is_peak[i] refers to mag[i+1]
    fpad = jnp.concatenate([f, jnp.zeros(2, REAL_DTYPE)])
    mpad = jnp.concatenate([mag, jnp.zeros(2, mag.dtype)])
    return (jnp.where(valid, fpad[idx], 0.0),
            jnp.where(valid, mpad[idx], 0.0), valid)


BLOCKS = {
    "link_budget": ("link_budget", "math",
                    "EIRP/path-loss/C-N budget (link_budget.rs)",
                    ("range_m", "freq_hz")),
    "link_budget_optimizer": ("link_budget_optimize", "math",
                              "min TX power solve "
                              "(link_budget_optimizer.rs)",
                              ("required_cn_db",)),
    "satellite_link_budget": ("link_budget", "math",
                              "satellite budget incl. C/N0 "
                              "(satellite_link_budget_calculator.rs)"),
    "satellite_tle_propagator": ("tle_propagate", "gnss",
                                 "Keplerian TLE propagation "
                                 "(satellite_tle_propagator.rs)"),
    "satellite_link_predictor": ("pass_predict", "gnss",
                                 "visibility pass windows "
                                 "(satellite_link_predictor.rs)",
                                 ("min_elevation_deg",)),
    "rain_attenuation_predictor": ("rain_attenuation_db_per_km",
                                   "channel",
                                   "ITU-R k*R^alpha rain loss "
                                   "(rain_attenuation_predictor.rs)",
                                   ("rate_mm_hr", "freq_ghz")),
    "troposcatter_propagation": ("troposcatter_loss_db", "channel",
                                 "median troposcatter loss "
                                 "(troposcatter_propagation.rs)"),
    "rf_propagation_model": ("propagation_loss_db", "channel",
                             "fspl/two-ray/hata "
                             "(rf_propagation_model.rs)", ("model",)),
    "free_space_optical_channel": ("fso_link_margin_db", "channel",
                                   "FSO margin w/ visibility "
                                   "(free_space_optical_channel.rs)",
                                   ("visibility_km",)),
    "frequency_domain_channel_sounder": (
        "freq_domain_sound", "measurement",
        "H(f) + impulse response "
        "(frequency_domain_channel_sounder.rs)"),
    "multipath_profile_extractor": ("multipath_profile", "measurement",
                                    "power-delay profile taps "
                                    "(multipath_profile_extractor.rs)",
                                    ("n_paths",)),
    "multipath_equalizer_sparse": ("sparse_multipath_equalize",
                                   "filter",
                                   "known-tap FD equalizer "
                                   "(multipath_equalizer_sparse.rs)"),
    "channel_estimator": ("ls_channel_estimate", "measurement",
                          "time-domain LS FIR estimate "
                          "(channel_estimator.rs)", ("n_taps",)),
    "dynamic_channel": ("DynamicChannel", "channel",
                        "Markov good/bad SNR switching "
                        "(dynamic_channel.rs)", ("p_gb", "p_bg")),
    "propagation_mode_sounder": ("mode_sound", "measurement",
                                 "swept-mode detection "
                                 "(propagation_mode_sounder.rs)"),
}
