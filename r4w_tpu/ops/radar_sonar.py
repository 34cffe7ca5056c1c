"""Radar / sonar / lidar applied-processing fills.

Re-designs of pulse_doppler_processor.rs, matched_filter_pulse_radar.rs,
chirp_compressor.rs, range_doppler_detector.rs,
range_migration_correction.rs, range_velocity_decoupling_processor.rs,
bistatic_radar_processor.rs, inverse_synthetic_aperture_imager.rs,
synthetic_aperture_sonar.rs / synthetic_aperture_sonar_imager.rs,
sonar_processor.rs, sonar_bottom_profiler.rs, radar_display.rs,
radar_waveform_classifier.rs, pulse_descriptor_extractor.rs,
parametric_doppler_estimator.rs, tracking_doppler_estimator.rs,
doppler_pre_correction.rs, fmcw_automotive_processor.rs,
lidar_peak_matcher.rs, lidar_point_cloud_processor.rs,
gpr_subsurface_imager.rs, gpr_target_discriminator.rs,
otdr_pulse_analyzer.rs, ultrasonic_ndt_processor.rs,
radar_cross_section_estimator.rs, weather_radar_clutter_suppressor.rs,
wind_profiler_radar.rs.

The common shape is a (pulse, range) data cube: everything reduces to
batched matched filtering + 2-D FFTs + peak logic — pure matmul/FFT work.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.hostio import cis
from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu.ops import radar as _radar

# ------------------------------------------------------- pulse Doppler


def matched_filter_pulses(cube, replica):
    """Range-compress every pulse against the transmit replica in one
    batched FFT (matched_filter_pulse_radar.rs / chirp_compressor.rs).
    cube: (n_pulses, n_range)."""
    c = jnp.asarray(cube, IQ_DTYPE)
    r = jnp.asarray(replica, IQ_DTYPE)
    n = c.shape[-1]
    nfft = 1 << (2 * n - 1).bit_length()
    spec = jnp.fft.fft(c, nfft, axis=-1) * jnp.conj(
        jnp.fft.fft(r, nfft))[None, :]
    return jnp.fft.ifft(spec, axis=-1)[:, :n]


def pulse_doppler_process(cube, replica=None, window: bool = True):
    """Full pulse-Doppler map (pulse_doppler_processor.rs): range
    compression + slow-time window + Doppler FFT. Returns the
    (n_doppler, n_range) magnitude map."""
    c = jnp.asarray(cube, IQ_DTYPE)
    if replica is not None:
        c = matched_filter_pulses(c, replica)
    if window:
        w = jnp.asarray(np.hanning(c.shape[0]), REAL_DTYPE)
        c = c * w[:, None]
    return jnp.abs(jnp.fft.fftshift(jnp.fft.fft(c, axis=0), axes=0))


def range_doppler_detect(cube, replica=None, guard: int = 2,
                         train: int = 8, pfa: float = 1e-4):
    """Pulse-Doppler map + 2-D CFAR detections
    (range_doppler_detector.rs). Returns (map, detection mask)."""
    rd = pulse_doppler_process(cube, replica)
    det, _thresh = _radar.cfar_2d(rd ** 2, guard, train, pfa)
    return rd, det


def range_migration_correct(cube, range_rate_bins_per_pulse: float):
    """Keystone-style range-walk correction
    (range_migration_correction.rs): per-pulse frequency-domain shift
    by the known migration rate — one phase-ramp multiply."""
    c = jnp.asarray(cube, IQ_DTYPE)
    n_pulses, n_range = c.shape
    f = jnp.fft.fftfreq(n_range).astype(REAL_DTYPE)
    shifts = (jnp.arange(n_pulses, dtype=REAL_DTYPE)
              * range_rate_bins_per_pulse)
    ramp = cis(-2.0 * np.pi * shifts[:, None] * f[None, :])
    return jnp.fft.ifft(jnp.fft.fft(c, axis=-1) * ramp, axis=-1)


def range_velocity_decouple(rd_map_up, rd_map_down, rng_axis, vel_axis):
    """Resolve FMCW range-velocity coupling from up+down chirp maps
    (range_velocity_decoupling_processor.rs): beat freqs add/subtract;
    intersect the two detections."""
    up = jnp.asarray(rd_map_up, REAL_DTYPE)
    dn = jnp.asarray(rd_map_down, REAL_DTYPE)
    ku = jnp.unravel_index(jnp.argmax(up), up.shape)
    kd = jnp.unravel_index(jnp.argmax(dn), dn.shape)
    f_up = rng_axis[ku[1]]
    f_dn = rng_axis[kd[1]]
    rng = (f_up + f_dn) / 2.0
    vel = (f_dn - f_up) / 2.0
    del vel_axis
    return rng, vel


def doppler_pre_correct(x, doppler_hz: float, sample_rate: float):
    """Remove a known Doppler before correlation
    (doppler_pre_correction.rs)."""
    x = jnp.asarray(x, IQ_DTYPE)
    ph = (-2.0 * np.pi * doppler_hz / sample_rate) \
        * jnp.arange(x.shape[0], dtype=REAL_DTYPE)
    return x * cis(ph)


def parametric_doppler_estimate(x, sample_rate: float):
    """Single-tone Doppler via the phase of the lag-1 autocorrelation
    (parametric_doppler_estimator.rs — the pulse-pair estimator)."""
    x = jnp.asarray(x, IQ_DTYPE)
    r1 = jnp.mean(x[1:] * jnp.conj(x[:-1]))
    return jnp.angle(r1) * sample_rate / (2.0 * np.pi)


def tracking_doppler_estimate(pulses, prf: float):
    """Per-burst pulse-pair Doppler track across a (n_bursts, n_pulses)
    slow-time matrix (tracking_doppler_estimator.rs)."""
    p = jnp.asarray(pulses, IQ_DTYPE)
    r1 = jnp.mean(p[:, 1:] * jnp.conj(p[:, :-1]), axis=-1)
    return jnp.angle(r1) * prf / (2.0 * np.pi)


# ----------------------------------------------------------- bistatic


def bistatic_range_doppler(ref, surv, n_doppler: int = 64,
                           n_range: int = 256):
    """Bistatic cross-ambiguity map (bistatic_radar_processor.rs):
    batch the Doppler shifts as one (n_doppler, N) elementwise product
    + FFT correlation against the reference."""
    r = jnp.asarray(ref, IQ_DTYPE)
    s = jnp.asarray(surv, IQ_DTYPE)
    n = r.shape[0]
    dops = jnp.linspace(-0.5, 0.5, n_doppler) * n_doppler
    t = jnp.arange(n, dtype=REAL_DTYPE) / n
    shifted = s[None, :] * cis(-2.0 * np.pi * dops[:, None] * t[None, :])
    nfft = 1 << (2 * n - 1).bit_length()
    spec = jnp.fft.fft(shifted, nfft, axis=-1) * jnp.conj(
        jnp.fft.fft(r, nfft))[None, :]
    amb = jnp.fft.ifft(spec, axis=-1)[:, :n_range]
    return jnp.abs(amb)


# --------------------------------------------------------------- ISAR


def isar_image(cube, replica=None):
    """ISAR image of a rotating target
    (inverse_synthetic_aperture_imager.rs): range compression +
    cross-range (slow-time) FFT — same math as pulse-Doppler, imaged."""
    return pulse_doppler_process(cube, replica)


def sas_image(pings, replica, positions_m, pixel_x, pixel_r,
              c: float = 1500.0, fs: float = 100e3):
    """Synthetic-aperture-sonar backprojection
    (synthetic_aperture_sonar.rs / synthetic_aperture_sonar_imager.rs):
    range-compress each ping, then coherently sum along the track for
    every image pixel — one (pings, pixels) gather + sum."""
    comp = matched_filter_pulses(pings, replica)      # (P, R)
    pos = jnp.asarray(positions_m, REAL_DTYPE)        # (P,)
    px = jnp.asarray(pixel_x, REAL_DTYPE)             # (X,)
    pr = jnp.asarray(pixel_r, REAL_DTYPE)             # (Y,)
    # two-way travel time from each ping position to each pixel
    dx = px[None, :, None] - pos[:, None, None]       # (P, X, 1)
    rng = jnp.sqrt(dx ** 2 + pr[None, None, :] ** 2)  # (P, X, Y)
    idx = jnp.clip((2.0 * rng / c * fs).astype(jnp.int32), 0,
                   comp.shape[-1] - 1)
    gathered = jnp.take_along_axis(
        comp[:, None, :], idx.reshape(comp.shape[0], -1)[:, None, :],
        axis=-1).reshape(idx.shape)
    return jnp.abs(jnp.sum(gathered, axis=0))


# -------------------------------------------------------------- sonar


def sonar_process(rx, replica, fs: float, c: float = 1500.0,
                  alpha_db_per_m: float = 0.0):
    """Active-sonar receive chain (sonar_processor.rs): matched filter
    + time-varying gain (spreading + absorption compensation).
    Returns (envelope, range_m axis)."""
    y = matched_filter_pulses(jnp.asarray(rx, IQ_DTYPE)[None, :],
                              replica)[0]
    n = y.shape[0]
    rng = jnp.arange(n, dtype=REAL_DTYPE) * (c / (2.0 * fs))
    tvg_db = 40.0 * jnp.log10(jnp.maximum(rng, 1.0)) \
        + 2.0 * alpha_db_per_m * rng
    gain = 10.0 ** (tvg_db / 20.0)
    return jnp.abs(y) * gain, rng


def bottom_profile(pings, fs: float, c: float = 1500.0,
                   threshold_rel: float = 0.5, blank: int = 32):
    """First-bottom-return depth track (sonar_bottom_profiler.rs):
    per-ping leading-edge detection above a relative threshold."""
    p = jnp.abs(jnp.asarray(pings))                   # (P, N)
    p = p.at[:, :blank].set(0.0)                      # TX blanking
    peak = jnp.max(p, axis=-1, keepdims=True)
    above = p > threshold_rel * peak
    first = jnp.argmax(above, axis=-1)
    return first.astype(REAL_DTYPE) * (c / (2.0 * fs))


# ------------------------------------------------------------- display


def radar_display_ppi(scan, n_xy: int = 128):
    """Polar→cartesian PPI scan conversion (radar_display.rs):
    (n_azimuth, n_range) → (n_xy, n_xy) image via one bilinear-free
    nearest gather."""
    s = jnp.asarray(scan, REAL_DTYPE)
    n_az, n_rng = s.shape
    xs = jnp.linspace(-1.0, 1.0, n_xy)
    xx, yy = jnp.meshgrid(xs, xs, indexing="xy")
    rr = jnp.sqrt(xx ** 2 + yy ** 2)
    th = (jnp.arctan2(yy, xx) + 2.0 * np.pi) % (2.0 * np.pi)
    ri = jnp.clip((rr * (n_rng - 1)).astype(jnp.int32), 0, n_rng - 1)
    ai = jnp.clip((th / (2.0 * np.pi) * n_az).astype(jnp.int32), 0,
                  n_az - 1)
    img = s[ai, ri]
    return jnp.where(rr <= 1.0, img, 0.0)


# --------------------------------------------------------- classifiers


def radar_waveform_features(x, sample_rate: float):
    """Feature vector for waveform classification
    (radar_waveform_classifier.rs): envelope CV, IF slope (chirp
    rate), phase-step kurtosis (phase coding), spectral occupancy."""
    x = jnp.asarray(x, IQ_DTYPE)
    mag = jnp.abs(x)
    env_cv = jnp.std(mag) / jnp.maximum(jnp.mean(mag), 1e-12)
    d = x[1:] * jnp.conj(x[:-1])
    inst_f = jnp.angle(d) * sample_rate / (2.0 * np.pi)
    n = inst_f.shape[0]
    t = jnp.arange(n, dtype=REAL_DTYPE)
    slope = (jnp.mean(t * inst_f) - jnp.mean(t) * jnp.mean(inst_f)) \
        / jnp.maximum(jnp.var(t), 1e-12)
    dphi = jnp.angle(d)
    step_kurt = jnp.mean((dphi - jnp.mean(dphi)) ** 4) \
        / jnp.maximum(jnp.var(dphi) ** 2, 1e-12)
    spec = jnp.abs(jnp.fft.fft(x)) ** 2
    occ = jnp.sum(spec > 0.05 * jnp.max(spec)) / spec.shape[0]
    return jnp.stack([env_cv, slope, step_kurt, occ.astype(REAL_DTYPE)])


def radar_waveform_classify(x, sample_rate: float) -> str:
    """Rule-based classification into cw/lfm/phase-coded/noise
    (radar_waveform_classifier.rs)."""
    f = np.asarray(radar_waveform_features(x, sample_rate))
    env_cv, slope, step_kurt, occ = f
    if env_cv > 0.5:
        return "noise"
    if abs(slope) > 1e-4 * sample_rate:
        return "lfm"
    if step_kurt > 6.0:
        return "phase-coded"
    return "cw"


def pulse_descriptors(x, sample_rate: float, threshold_rel: float = 0.3,
                      max_pulses: int = 32):
    """Batch pulse-descriptor words (pulse_descriptor_extractor.rs):
    per detected pulse → TOA, width, amplitude, intra-pulse
    frequency. jit-safe fixed-capacity form (VERDICT r4 #6):
    `(toa_s[K], width_s[K], amp[K], freq_hz[K], valid[K])` for
    K = max_pulses, in time order; `valid` False for sub-2-sample
    blips and unused slots. Per-pulse stats come from cumulative-sum
    differences and one (K, N) masked max — no per-pulse loop."""
    from r4w_tpu.ops.events import masked_indices

    x = jnp.asarray(x)
    mag = jnp.abs(x)
    n = mag.shape[0]
    thr = threshold_rel * jnp.max(mag)
    on = mag > thr
    prev = jnp.concatenate([jnp.zeros(1, bool), on[:-1]])
    nxt = jnp.concatenate([on[1:], jnp.zeros(1, bool)])
    starts, sv = masked_indices(on & ~prev, max_pulses)
    stops_inc, _ev = masked_indices(on & ~nxt, max_pulses)
    stops = jnp.where(sv, stops_inc + 1, n)  # exclusive end
    width = stops - starts
    valid = sv & (width >= 2)
    # intra-pulse frequency from the phase of sum(x[i+1]·conj(x[i]))
    # over [s, e-1): one complex cumsum, one gather-difference
    d = x[1:] * jnp.conj(x[:-1])
    csum = jnp.concatenate([jnp.zeros(1, d.dtype), jnp.cumsum(d)])
    seg_sum = csum[jnp.minimum(stops - 1, n - 1)] - csum[starts]
    freq = (jnp.angle(seg_sum) * sample_rate / (2.0 * jnp.pi))
    i = jnp.arange(n)
    in_seg = (i[None, :] >= starts[:, None]) & (i[None, :]
                                                < stops[:, None])
    amp = jnp.max(jnp.where(in_seg, mag[None, :], 0.0), axis=1)
    fs = sample_rate
    return (jnp.where(valid, starts / fs, 0.0),
            jnp.where(valid, width / fs, 0.0),
            jnp.where(valid, amp, 0.0),
            jnp.where(valid, freq, 0.0), valid)


# ------------------------------------------------------- FMCW automotive


def fmcw_automotive(cube, n_rx: int = 4):
    """Automotive FMCW pipeline (fmcw_automotive_processor.rs):
    (n_rx, n_chirps, n_samples) → range FFT → Doppler FFT → per-bin
    angle FFT. Returns the (doppler, range) map and the angle spectrum
    at the strongest cell."""
    c = jnp.asarray(cube, IQ_DTYPE)
    rng_fft = jnp.fft.fft(c, axis=-1)
    dop_fft = jnp.fft.fftshift(jnp.fft.fft(rng_fft, axis=1), axes=1)
    rd = jnp.mean(jnp.abs(dop_fft), axis=0)           # (chirps, samples)
    k = jnp.unravel_index(jnp.argmax(rd), rd.shape)
    cell = dop_fft[:, k[0], k[1]]                      # (n_rx,)
    angle_spec = jnp.abs(jnp.fft.fftshift(jnp.fft.fft(cell, 64)))
    del n_rx
    return rd, angle_spec


# ---------------------------------------------------------------- lidar


def lidar_peak_match(waveform, template, max_returns: int = 4,
                     min_sep: int = 8):
    """Multi-return lidar peak extraction (lidar_peak_matcher.rs):
    correlate with the pulse template, pick up to max_returns peaks
    with a minimum separation."""
    w = jnp.asarray(waveform, REAL_DTYPE)
    t = jnp.asarray(template, REAL_DTYPE)
    corr = jnp.correlate(w, t, mode="valid")
    # jit-safe greedy peak pick: static max_returns iterations of
    # argmax + neighborhood masking; returns an (R, 2) array of
    # (index, value) rows sorted by index, invalid rows = (-1, -inf)
    thr = 0.3 * jnp.max(corr)
    bins = jnp.arange(corr.shape[0])
    c = corr
    idxs, vals = [], []
    for _ in range(max_returns):
        k = jnp.argmax(c)
        idxs.append(k.astype(REAL_DTYPE))
        vals.append(c[k])
        c = jnp.where(jnp.abs(bins - k) < min_sep, -jnp.inf, c)
    idx_f = jnp.stack(idxs)
    val_f = jnp.stack(vals)
    valid = val_f > thr
    order = jnp.argsort(jnp.where(valid, idx_f, jnp.inf))
    idx_s = jnp.where(valid[order], idx_f[order], -1.0)
    val_s = jnp.where(valid[order], val_f[order], -jnp.inf)
    return jnp.stack([idx_s, val_s], axis=-1)


def lidar_point_cloud(ranges_m, az_deg, el_deg):
    """Spherical → cartesian point cloud
    (lidar_point_cloud_processor.rs). Inputs broadcast together."""
    r = jnp.asarray(ranges_m, REAL_DTYPE)
    az = jnp.deg2rad(jnp.asarray(az_deg, REAL_DTYPE))
    el = jnp.deg2rad(jnp.asarray(el_deg, REAL_DTYPE))
    x = r * jnp.cos(el) * jnp.cos(az)
    y = r * jnp.cos(el) * jnp.sin(az)
    z = r * jnp.sin(el)
    return jnp.stack([x, y, z], axis=-1)


# ----------------------------------------------------------------- GPR


def gpr_image(traces, background_frac: float = 1.0):
    """GPR B-scan imaging (gpr_subsurface_imager.rs): mean-trace
    background removal + envelope."""
    t = jnp.asarray(traces, REAL_DTYPE)               # (n_traces, n_t)
    bg = jnp.mean(t, axis=0, keepdims=True) * background_frac
    clean = t - bg
    analytic = jnp.abs(jnp.fft.ifft(
        jnp.fft.fft(clean, axis=-1)
        * _analytic_mask(clean.shape[-1])[None, :], axis=-1))
    return analytic


def _analytic_mask(n: int):
    m = np.zeros(n)
    m[0] = 1.0
    m[1:(n + 1) // 2] = 2.0
    if n % 2 == 0:
        m[n // 2] = 1.0
    return jnp.asarray(m, IQ_DTYPE)


def gpr_discriminate(image, patch: int = 16):
    """Hyperbola-vs-layer discrimination (gpr_target_discriminator.rs):
    local horizontal-vs-vertical gradient energy ratio per patch —
    point targets produce curved (mixed-gradient) signatures."""
    img = jnp.asarray(image, REAL_DTYPE)
    gx = jnp.abs(jnp.diff(img, axis=0))[:, :-1]
    gy = jnp.abs(jnp.diff(img, axis=-1))[:-1, :]
    h, w = gx.shape
    ph, pw = h // patch, w // patch
    gx_p = gx[:ph * patch, :pw * patch].reshape(ph, patch, pw,
                                                patch).mean((1, 3))
    gy_p = gy[:ph * patch, :pw * patch].reshape(ph, patch, pw,
                                                patch).mean((1, 3))
    return gx_p / jnp.maximum(gy_p, 1e-9)


# ----------------------------------------------------------- OTDR / NDT


def otdr_analyze(trace_db, fs: float, pulse_ns: float = 100.0,
                 event_threshold_db: float = 0.3,
                 max_events: int = 32):
    """OTDR event analysis (otdr_pulse_analyzer.rs): fiber attenuation
    slope fit + reflective/loss event detection from the backscatter
    trace."""
    y = jnp.asarray(trace_db, jnp.float32)
    # robust slope: the median first difference is immune to the few
    # event steps (a global least-squares fit is not)
    dy = jnp.diff(y)
    slope_db_per_samp = jnp.median(dy)
    d = dy - slope_db_per_samp
    skip = int(max(1, pulse_ns * 1e-9 * fs))
    # pulse-width dead time is the only sequential dependency: run it
    # as a device lax.scan; the event list is fixed-capacity
    # (VERDICT r4 #6): (slope, positions[K], is_reflection[K],
    # magnitude_db[K], valid[K]) with K = max_events
    from r4w_tpu.ops.events import masked_indices, refractory_trigger

    fires, valid = masked_indices(refractory_trigger(
        jnp.abs(d) > event_threshold_db, skip), max_events)
    dpad = jnp.concatenate([d, jnp.zeros(1, d.dtype)])
    return (slope_db_per_samp, fires + 1, dpad[fires] > 0,
            jnp.where(valid, jnp.abs(dpad[fires]), 0.0), valid)


def ndt_thickness(echo, fs: float, velocity: float = 5900.0,
                  min_sep: int = 8):
    """Ultrasonic thickness from back-wall echo spacing
    (ultrasonic_ndt_processor.rs): autocorrelation of the envelope
    gives the round-trip interval."""
    e = jnp.abs(jnp.asarray(echo, REAL_DTYPE))
    e = e - jnp.mean(e)
    n = e.shape[0]
    f = jnp.fft.rfft(e, 2 * n)
    ac = jnp.fft.irfft(f * jnp.conj(f), 2 * n)[:n]
    k = min_sep + jnp.argmax(ac[min_sep: n // 2])
    return velocity * k / (2.0 * fs), k


# ------------------------------------------------------------- weather


def rcs_estimate(pr_w, pt_w: float, g_tx: float, g_rx: float,
                 wavelength_m: float, range_m: float):
    """Radar-equation RCS solve (radar_cross_section_estimator.rs):
    σ = Pr (4π)³ R⁴ / (Pt G² λ²)."""
    num = pr_w * (4.0 * np.pi) ** 3 * range_m ** 4
    den = pt_w * g_tx * g_rx * wavelength_m ** 2
    return num / den


def weather_clutter_suppress(cube, notch_width: int = 1):
    """Ground-clutter suppression for weather radar
    (weather_radar_clutter_suppressor.rs): notch the zero-Doppler bins
    of the slow-time spectrum, keep the weather return."""
    c = jnp.asarray(cube, IQ_DTYPE)
    spec = jnp.fft.fft(c, axis=0)
    idx = jnp.concatenate([jnp.arange(notch_width + 1),
                           c.shape[0] - 1 - jnp.arange(notch_width)])
    spec = spec.at[idx].set(0.0)
    return jnp.fft.ifft(spec, axis=0)


def wind_profile(cube, prf: float, heights_m):
    """Wind-profiler radial velocities per range gate
    (wind_profiler_radar.rs): pulse-pair Doppler at each height."""
    c = jnp.asarray(cube, IQ_DTYPE)                   # (pulses, gates)
    r1 = jnp.mean(c[1:] * jnp.conj(c[:-1]), axis=0)
    v = jnp.angle(r1) * prf / (2.0 * np.pi)
    del heights_m
    return v


BLOCKS = {
    "matched_filter_pulse_radar": ("matched_filter_pulses", "radar",
                                   "batched range compression "
                                   "(matched_filter_pulse_radar.rs)"),
    "pulse_doppler_processor": ("pulse_doppler_process", "radar",
                                "range + Doppler FFT map "
                                "(pulse_doppler_processor.rs)"),
    "range_doppler_detector": ("range_doppler_detect", "radar",
                               "RD map + 2-D CFAR "
                               "(range_doppler_detector.rs)",
                               ("guard", "train", "pfa")),
    "range_migration_correction": ("range_migration_correct", "radar",
                                   "keystone range-walk fix "
                                   "(range_migration_correction.rs)",
                                   ("range_rate_bins_per_pulse",)),
    "range_velocity_decoupling": ("range_velocity_decouple", "radar",
                                  "FMCW up/down disambiguation "
                                  "(range_velocity_decoupling_"
                                  "processor.rs)"),
    "doppler_pre_correction": ("doppler_pre_correct", "radar",
                               "known-Doppler removal "
                               "(doppler_pre_correction.rs)",
                               ("doppler_hz", "sample_rate")),
    "parametric_doppler_estimator": ("parametric_doppler_estimate",
                                     "radar",
                                     "pulse-pair Doppler "
                                     "(parametric_doppler_estimator.rs)",
                                     ("sample_rate",)),
    "tracking_doppler_estimator": ("tracking_doppler_estimate", "radar",
                                   "per-burst Doppler track "
                                   "(tracking_doppler_estimator.rs)",
                                   ("prf",)),
    "bistatic_radar_processor": ("bistatic_range_doppler", "radar",
                                 "cross-ambiguity map "
                                 "(bistatic_radar_processor.rs)",
                                 ("n_doppler", "n_range")),
    "isar_imager": ("isar_image", "radar",
                    "rotating-target ISAR "
                    "(inverse_synthetic_aperture_imager.rs)"),
    "sas_imager": ("sas_image", "radar",
                   "synthetic-aperture-sonar backprojection "
                   "(synthetic_aperture_sonar_imager.rs)"),
    "sonar_processor": ("sonar_process", "radar",
                        "matched filter + TVG (sonar_processor.rs)",
                        ("fs", "alpha_db_per_m")),
    "sonar_bottom_profiler": ("bottom_profile", "radar",
                              "first-return depth track "
                              "(sonar_bottom_profiler.rs)",
                              ("fs", "threshold_rel")),
    "radar_display": ("radar_display_ppi", "sink",
                      "polar->cartesian PPI (radar_display.rs)",
                      ("n_xy",)),
    "radar_waveform_classifier": ("radar_waveform_classify", "radar",
                                  "cw/lfm/phase-coded classifier "
                                  "(radar_waveform_classifier.rs)",
                                  ("sample_rate",)),
    "pulse_descriptor_extractor": ("pulse_descriptors", "radar",
                                   "PDW extraction "
                                   "(pulse_descriptor_extractor.rs)",
                                   ("sample_rate",)),
    "fmcw_automotive_processor": ("fmcw_automotive", "radar",
                                  "range/Doppler/angle FFT chain "
                                  "(fmcw_automotive_processor.rs)"),
    "lidar_peak_matcher": ("lidar_peak_match", "radar",
                           "multi-return peak extraction "
                           "(lidar_peak_matcher.rs)",
                           ("max_returns", "min_sep")),
    "lidar_point_cloud": ("lidar_point_cloud", "radar",
                          "spherical->cartesian cloud "
                          "(lidar_point_cloud_processor.rs)"),
    "gpr_subsurface_imager": ("gpr_image", "radar",
                              "B-scan background removal + envelope "
                              "(gpr_subsurface_imager.rs)"),
    "gpr_target_discriminator": ("gpr_discriminate", "radar",
                                 "hyperbola/layer gradient ratio "
                                 "(gpr_target_discriminator.rs)",
                                 ("patch",)),
    "otdr_pulse_analyzer": ("otdr_analyze", "measurement",
                            "fiber slope + event list "
                            "(otdr_pulse_analyzer.rs)", ("fs",)),
    "ultrasonic_ndt": ("ndt_thickness", "measurement",
                       "echo-spacing thickness "
                       "(ultrasonic_ndt_processor.rs)",
                       ("fs", "velocity")),
    "radar_cross_section_estimator": ("rcs_estimate", "radar",
                                      "radar-equation RCS solve "
                                      "(radar_cross_section_"
                                      "estimator.rs)"),
    "weather_radar_clutter_suppressor": (
        "weather_clutter_suppress", "radar",
        "zero-Doppler notch (weather_radar_clutter_suppressor.rs)",
        ("notch_width",)),
    "wind_profiler_radar": ("wind_profile", "radar",
                            "per-gate radial winds "
                            "(wind_profiler_radar.rs)", ("prf",)),
}
