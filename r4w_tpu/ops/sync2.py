"""Sync/timing/control fills — second tier of the reference's
synchronization tail.

Re-designs of afc.rs, correlator.rs, carrier_recovery.rs, clock_recovery_mm.rs,
symbol_sync.rs, timing_error_detector.rs, timing_phase_detector_hybrid.rs,
blind_timing_recovery.rs, feedforward_timing_estimator.rs,
delay_lock_loop.rs, freq_lock_detector.rs, pll_carrier_tracking.rs,
phase_locked_loop_biquad.rs, control_loop.rs, pid_controller.rs,
correlate_estimate.rs, cross_correlator.rs, periodic_autocorrelator.rs,
polyphase_golay_correlator.rs, preamble_gen.rs,
burst_gating_controller.rs, agc_attack_decay.rs, feedforward_agc.rs,
time_sync.rs, network_time_synchronizer.rs, multi_rate_clock.rs,
irig_b_decoder.rs, gps_time.rs, csac_reference_oscillator.rs,
constellation_rotation_detector.rs, tuning_estimator.rs.

Feedback loops are ``lax.scan`` recursions with explicit carried state;
feed-forward estimators are single batched FFT/correlation passes.
"""

from __future__ import annotations

import dataclasses

import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.hostio import cis
from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE

# ------------------------------------------------------ carrier control


def afc(x, sample_rate: float, alpha: float = 0.01, state: float = 0.0):
    """Automatic frequency control (afc.rs): IIR-averaged phase
    increment drives an NCO that centers the signal. Returns
    (corrected, freq_track_hz, final_freq_hz)."""
    x = jnp.asarray(x, IQ_DTYPE)
    dphi = jnp.angle(x[1:] * jnp.conj(x[:-1]))
    dphi = jnp.concatenate([dphi[:1], dphi])

    def step(carry, d):
        f, ph = carry
        f = f + alpha * (d - f)
        ph = ph + f
        return (f, ph), (f, ph)

    (f_fin, _), (f_tr, ph_tr) = lax.scan(
        step, (jnp.asarray(state, REAL_DTYPE),
               jnp.asarray(0.0, REAL_DTYPE)), dphi.astype(REAL_DTYPE))
    y = x * cis(-ph_tr)
    hz = f_tr * (sample_rate / (2.0 * np.pi))
    return y, hz, f_fin * (sample_rate / (2.0 * np.pi))


def carrier_recovery_mpsk(x, order: int = 4, bw: float = 0.02):
    """Decision-directed M-PSK carrier recovery (carrier_recovery.rs):
    raise to the Mth power to strip modulation, track the residual
    with a 2nd-order loop. Returns (corrected, phase_track)."""
    x = jnp.asarray(x, IQ_DTYPE)
    stripped = x ** order
    zeta, wn = 0.707, bw
    g1 = 2 * zeta * wn
    g2 = wn * wn

    def step(carry, s):
        ph, f = carry
        err = jnp.angle(s * cis(-order * ph)) / order
        f = f + g2 * err
        ph = ph + f + g1 * err
        return (ph, f), ph

    (_, _), phases = lax.scan(
        step, (jnp.asarray(0.0, REAL_DTYPE), jnp.asarray(0.0, REAL_DTYPE)),
        stripped)
    return x * cis(-phases), phases


def pll_carrier_tracking(x, loop_bw: float = 0.02, damping: float = 0.707):
    """2nd-order PLL tracking a dominant carrier
    (pll_carrier_tracking.rs). Returns (mixed-down, phase, freq)."""
    x = jnp.asarray(x, IQ_DTYPE)
    g1 = 2 * damping * loop_bw
    g2 = loop_bw * loop_bw

    def step(carry, s):
        ph, f = carry
        err = jnp.angle(s * cis(-ph))
        f = f + g2 * err
        ph = ph + f + g1 * err
        return (ph, f), (ph, f)

    (_, _), (phases, freqs) = lax.scan(
        step, (jnp.asarray(0.0, REAL_DTYPE), jnp.asarray(0.0, REAL_DTYPE)),
        x)
    return x * cis(-phases), phases, freqs


def pll_biquad(x, loop_bw: float = 0.05, damping: float = 0.707):
    """Biquad-form PLL (phase_locked_loop_biquad.rs): same dynamics,
    reported as the filtered instantaneous phase estimate."""
    _, phases, freqs = pll_carrier_tracking(x, loop_bw, damping)
    return phases, freqs


def freq_lock_detector(freqs, tol: float = 0.01, window: int = 64):
    """Declare lock when the loop-frequency variance over a sliding
    window drops below tol^2 (freq_lock_detector.rs)."""
    f = jnp.asarray(freqs, REAL_DTYPE)
    n = (f.shape[0] // window) * window
    frames = f[:n].reshape(-1, window)
    var = jnp.var(frames, axis=-1)
    return var < tol * tol


def constellation_rotation_detect(x, order: int = 4):
    """Estimate the fixed constellation rotation of an M-PSK burst
    (constellation_rotation_detector.rs): angle of E[x^M]/M."""
    x = jnp.asarray(x, IQ_DTYPE)
    return jnp.angle(jnp.mean(x ** order)) / order


def tuning_estimate(x, sample_rate: float, nfft: int = 4096):
    """Coarse carrier-offset estimate from the spectrum centroid around
    the peak bin (tuning_estimator.rs)."""
    x = jnp.asarray(x, IQ_DTYPE)
    spec = jnp.abs(jnp.fft.fft(x[:nfft] * jnp.asarray(
        np.hanning(min(nfft, x.shape[0])), REAL_DTYPE), nfft)) ** 2
    spec = jnp.fft.fftshift(spec)
    freqs = (jnp.arange(nfft, dtype=REAL_DTYPE) - nfft // 2) \
        * (sample_rate / nfft)
    k = jnp.argmax(spec)
    lo = jnp.maximum(k - 2, 0)
    w = lax.dynamic_slice(spec, (lo,), (5,))
    fr = lax.dynamic_slice(freqs, (lo,), (5,))
    return jnp.sum(w * fr) / jnp.maximum(jnp.sum(w), 1e-12)


# ------------------------------------------------------ timing recovery


def symbol_sync_mm(x, sps: int, bw: float = 0.01, mu0: float = 0.0):
    """Mueller & Müller decision-directed clock recovery producing one
    output per symbol (clock_recovery_mm.rs / symbol_sync.rs).

    Sequential by nature → lax.scan over symbols; the fractional
    interpolator is a linear gather (one dynamic_slice
    per symbol, no data-dependent shapes)."""
    x = jnp.asarray(x, IQ_DTYPE)
    n_sym = x.shape[0] // sps - 2
    gain_mu = bw
    gain_omega = 0.25 * bw * bw

    def interp(pos):
        i = jnp.floor(pos).astype(jnp.int32)
        frac = (pos - i).astype(REAL_DTYPE)
        pair = lax.dynamic_slice(x, (i,), (2,))
        return pair[0] * (1 - frac).astype(IQ_DTYPE) \
            + pair[1] * frac.astype(IQ_DTYPE)

    def step(carry, _):
        pos, omega, prev_s, prev_d = carry
        s = interp(pos)
        d = lax.complex(jnp.sign(s.real), jnp.sign(s.imag))
        err = (prev_d.real * s.real - d.real * prev_s.real
               + prev_d.imag * s.imag - d.imag * prev_s.imag)
        err = jnp.clip(err, -1.0, 1.0)
        omega = omega + gain_omega * err
        pos = pos + omega + gain_mu * err
        pos = jnp.minimum(pos, x.shape[0] - 2.0)
        return (pos, omega, s, d), s

    init = (jnp.asarray(mu0, REAL_DTYPE), jnp.asarray(float(sps),
                                                      REAL_DTYPE),
            jnp.asarray(0j, IQ_DTYPE), jnp.asarray(0j, IQ_DTYPE))
    _, syms = lax.scan(step, init, None, length=n_sym)
    return syms


def timing_error_detector(x, sps: int, kind: str = "gardner"):
    """Per-symbol timing-error sequence without feedback
    (timing_error_detector.rs): diagnostic TED output over a block."""
    x = jnp.asarray(x, IQ_DTYPE)
    n_sym = x.shape[0] // sps - 1
    idx = jnp.arange(n_sym) * sps
    cur = x[idx]
    nxt = x[idx + sps]
    mid = x[idx + sps // 2]
    if kind == "gardner":
        e = ((nxt.real - cur.real) * mid.real
             + (nxt.imag - cur.imag) * mid.imag)
    elif kind == "early_late":
        early = x[jnp.maximum(idx + sps - sps // 4, 0)]
        late = x[idx + sps + sps // 4 - sps]
        e = (jnp.abs(late) - jnp.abs(early)) * jnp.abs(cur)
    else:
        raise ValueError(f"unknown TED '{kind}'")
    return e.astype(REAL_DTYPE)


def hybrid_timing_phase_detector(x, sps: int):
    """Blend Gardner (NDA) and M&M-style (DD) error signals — the
    hybrid detector (timing_phase_detector_hybrid.rs). Weighting moves
    toward DD as SNR (decision confidence) rises."""
    g = timing_error_detector(x, sps, "gardner")
    x = jnp.asarray(x, IQ_DTYPE)
    n_sym = x.shape[0] // sps - 1
    idx = jnp.arange(n_sym) * sps
    cur, nxt = x[idx], x[idx + sps]
    d_cur = lax.complex(jnp.sign(cur.real), jnp.sign(cur.imag))
    d_nxt = lax.complex(jnp.sign(nxt.real), jnp.sign(nxt.imag))
    mm = (d_cur.real * nxt.real - d_nxt.real * cur.real
          + d_cur.imag * nxt.imag - d_nxt.imag * cur.imag)
    conf = jnp.minimum(jnp.mean(jnp.abs(cur)) /  # decision confidence
                       jnp.maximum(jnp.std(jnp.abs(cur)), 1e-6), 10.0) / 10.0
    return (1.0 - conf) * g + conf * mm.astype(REAL_DTYPE)


def feedforward_timing_estimate(x, sps: int):
    """Oerder–Meyr square-law feedforward symbol-timing estimator
    (feedforward_timing_estimator.rs / blind_timing_recovery.rs):
    tau = -angle( Σ |x[n]|^2 e^{-j2πn/sps} ) · sps/2π — one reduction,
    no feedback loop."""
    x = jnp.asarray(x, IQ_DTYPE)
    n = x.shape[0]
    w = cis(-2.0 * np.pi * jnp.arange(n, dtype=REAL_DTYPE) / sps)
    c = jnp.sum((jnp.abs(x) ** 2).astype(IQ_DTYPE) * w)
    tau = -jnp.angle(c) / (2.0 * np.pi) * sps
    return (tau + sps) % sps


def blind_timing_recover(x, sps: int):
    """Feedforward recovery: estimate tau then decimate at the nearest
    integer offset (blind_timing_recovery.rs)."""
    tau = feedforward_timing_estimate(x, sps)
    off = jnp.round(tau).astype(jnp.int32) % sps
    n_sym = (x.shape[0] - sps) // sps
    idx = off + jnp.arange(n_sym) * sps
    return jnp.asarray(x)[idx], tau


def delay_lock_loop(x, ref, sps: int, bw: float = 0.01):
    """Code-delay tracking DLL over a known reference sequence
    (delay_lock_loop.rs): early/late correlators a half-symbol apart,
    scan over symbol groups."""
    x = jnp.asarray(x, IQ_DTYPE)
    ref = jnp.asarray(ref, IQ_DTYPE)
    m = ref.shape[0]

    def corr_at(delay):
        i = jnp.clip(jnp.round(delay).astype(jnp.int32), 0,
                     x.shape[0] - m)
        seg = lax.dynamic_slice(x, (i,), (m,))
        return jnp.abs(jnp.vdot(ref, seg))

    def step(delay, _):
        e = corr_at(delay - sps / 2)
        l = corr_at(delay + sps / 2)
        disc = (e - l) / jnp.maximum(e + l, 1e-9)
        delay = delay - bw * disc * sps
        return delay, delay

    d0 = jnp.asarray(float(sps), REAL_DTYPE)
    final, track = lax.scan(step, d0, None, length=64)
    return final, track


# -------------------------------------------------------- correlators


def cross_correlator(a, b, normalize: bool = True):
    """Full FFT cross-correlation with optional normalization
    (cross_correlator.rs). Returns (lags, corr)."""
    a = jnp.asarray(a, IQ_DTYPE)
    b = jnp.asarray(b, IQ_DTYPE)
    n = a.shape[0] + b.shape[0] - 1
    nfft = 1 << (n - 1).bit_length()
    c = jnp.fft.ifft(jnp.fft.fft(a, nfft)
                     * jnp.conj(jnp.fft.fft(b, nfft)))
    c = jnp.concatenate([c[-(b.shape[0] - 1):], c[:a.shape[0]]])
    if normalize:
        c = c / jnp.maximum(jnp.sqrt(jnp.sum(jnp.abs(a) ** 2)
                                     * jnp.sum(jnp.abs(b) ** 2)), 1e-12)
    lags = jnp.arange(-(b.shape[0] - 1), a.shape[0])
    return lags, c


def correlate_estimate(x, pattern, threshold: float = 0.7):
    """Detect a known pattern and estimate its offset + phase + gain
    (correlate_estimate.rs)."""
    lags, c = cross_correlator(x, pattern)
    mag = jnp.abs(c)
    k = jnp.argmax(mag)
    found = mag[k] > threshold
    phase = jnp.angle(c[k])
    gain = mag[k]
    return found, lags[k], phase, gain


def periodic_autocorrelator(x, period: int, n_periods: int = 8):
    """Average correlation between the block and itself shifted by k
    periods (periodic_autocorrelator.rs): detects cyclic structure."""
    x = jnp.asarray(x, IQ_DTYPE)
    n = x.shape[0] - period * n_periods
    base = x[:n]
    vals = []
    for k in range(1, n_periods + 1):
        seg = x[k * period:k * period + n]
        vals.append(jnp.vdot(base, seg)
                    / jnp.maximum(jnp.sqrt(
                        jnp.sum(jnp.abs(base) ** 2)
                        * jnp.sum(jnp.abs(seg) ** 2)), 1e-12))
    return jnp.stack(vals)


def golay_complementary_pair(n: int = 32):
    """Golay complementary pair by recursive construction
    (polyphase_golay_correlator.rs). len must be a power of two."""
    a = np.array([1.0])
    b = np.array([1.0])
    while a.shape[0] < n:
        a, b = np.concatenate([a, b]), np.concatenate([a, -b])
    return jnp.asarray(a, REAL_DTYPE), jnp.asarray(b, REAL_DTYPE)


def golay_correlate(x, n: int = 32):
    """Correlate against a Golay pair; the pair's summed
    autocorrelation is a perfect 2n·δ — sidelobe-free detection
    (polyphase_golay_correlator.rs)."""
    ga, gb = golay_complementary_pair(n)
    _, ca = cross_correlator(x, ga.astype(IQ_DTYPE), normalize=False)
    _, cb = cross_correlator(x, gb.astype(IQ_DTYPE), normalize=False)
    return ca, cb


def preamble_gen(kind: str = "alternating", n_bits: int = 64):
    """Standard preamble bit patterns (preamble_gen.rs)."""
    if kind == "alternating":
        return jnp.asarray([1, 0] * (n_bits // 2), jnp.int32)
    if kind == "barker13":
        b = [1, 1, 1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1]
        return jnp.asarray((b * (n_bits // 13 + 1))[:n_bits], jnp.int32)
    if kind == "golay":
        a, _ = golay_complementary_pair(n_bits)
        return ((jnp.asarray(a) + 1) // 2).astype(jnp.int32)
    raise ValueError(f"unknown preamble kind '{kind}'")


# ------------------------------------------------------------ AGC / gating


def feedforward_agc(x, target: float = 1.0, window: int = 64):
    """Block-wise feedforward AGC (feedforward_agc.rs): per-window RMS
    normalization — no feedback transient."""
    x = jnp.asarray(x)
    n = (x.shape[0] // window) * window
    frames = x[:n].reshape(-1, window)
    rms = jnp.sqrt(jnp.mean(jnp.abs(frames) ** 2, axis=-1, keepdims=True))
    out = frames * (target / jnp.maximum(rms, 1e-12)).astype(x.dtype)
    tail = x[n:] * (target / jnp.maximum(
        jnp.sqrt(jnp.mean(jnp.abs(x[n:]) ** 2)), 1e-12)).astype(x.dtype) \
        if x.shape[0] > n else x[n:]
    return jnp.concatenate([out.reshape(-1), tail])


def agc_attack_decay(x, target: float = 1.0, attack: float = 0.1,
                     decay: float = 0.01, state: float = 1.0):
    """AGC with separate attack/decay rates (agc_attack_decay.rs)."""
    x = jnp.asarray(x)
    mag = jnp.abs(x).astype(REAL_DTYPE)

    def step(gain, m):
        err = target - m * gain
        rate = jnp.where(err < 0, attack, decay)
        gain = jnp.maximum(gain + rate * err, 1e-6)
        return gain, gain

    final, gains = lax.scan(step, jnp.asarray(state, REAL_DTYPE), mag)
    return x * gains.astype(x.dtype), final


def burst_gating_controller(power_db, open_db: float, close_db: float,
                            hang: int = 16):
    """Burst TX/RX gate with hang time (burst_gating_controller.rs):
    opens above open_db, closes only after ``hang`` samples below
    close_db."""
    p = jnp.asarray(power_db, REAL_DTYPE)

    def step(carry, pt):
        gate, cnt = carry
        above = pt > open_db
        below = pt < close_db
        cnt = jnp.where(above, 0, jnp.where(below, cnt + 1, 0))
        gate = jnp.where(above, 1, jnp.where(cnt >= hang, 0, gate))
        return (gate, cnt), gate

    (_, _), gates = lax.scan(
        step, (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32)), p)
    return gates


# ------------------------------------------------------- control loops


def pid_controller(error, kp: float, ki: float, kd: float,
                   state=(0.0, 0.0)):
    """Discrete PID over an error sequence (pid_controller.rs).
    Returns (control, (integral, last_error))."""
    e = jnp.asarray(error, REAL_DTYPE)

    def step(carry, et):
        integ, prev = carry
        integ = integ + et
        deriv = et - prev
        u = kp * et + ki * integ + kd * deriv
        return (integ, et), u

    (integ, prev), u = lax.scan(
        step, (jnp.asarray(state[0], REAL_DTYPE),
               jnp.asarray(state[1], REAL_DTYPE)), e)
    return u, (integ, prev)


def control_loop_2nd(error, loop_bw: float, damping: float = 0.707,
                     state=(0.0, 0.0)):
    """Generic 2nd-order loop filter: phase+frequency integrators — the
    shared core of PLL/FLL/DLL gains (control_loop.rs)."""
    g1 = 2 * damping * loop_bw
    g2 = loop_bw * loop_bw
    e = jnp.asarray(error, REAL_DTYPE)

    def step(carry, et):
        ph, f = carry
        f = f + g2 * et
        ph = ph + f + g1 * et
        return (ph, f), (ph, f)

    (ph, f), (phs, fs) = lax.scan(
        step, (jnp.asarray(state[0], REAL_DTYPE),
               jnp.asarray(state[1], REAL_DTYPE)), e)
    return phs, fs, (ph, f)


# --------------------------------------------------------- time & clocks


@dataclasses.dataclass
class GpsTime:
    """GPS week + seconds-of-week <-> UTC-ish conversions (gps_time.rs).
    Leap seconds handled via an explicit offset (18 s as of 2017)."""
    week: int
    tow: float

    GPS_EPOCH_UNIX = 315964800.0     # 1980-01-06T00:00:00Z
    LEAP_SECONDS = 18.0

    @classmethod
    def from_unix(cls, t: float) -> "GpsTime":
        g = t - cls.GPS_EPOCH_UNIX + cls.LEAP_SECONDS
        week = int(g // 604800)
        return cls(week=week, tow=g - week * 604800)

    def to_unix(self) -> float:
        return (self.week * 604800 + self.tow
                + self.GPS_EPOCH_UNIX - self.LEAP_SECONDS)


def irig_b_encode(seconds_of_day: int, frame_rate: int = 100):
    """Encode an IRIG-B time-of-day frame as pulse-width symbols
    (irig_b_decoder.rs counterpart): 100 symbols; markers P at
    positions 0,9,19,...,99; BCD seconds/minutes/hours fields.
    Symbol widths: 0 -> 0.2, 1 -> 0.5, marker -> 0.8 of a bit period.
    Returns the width array (len 100)."""
    sec = seconds_of_day % 60
    minute = (seconds_of_day // 60) % 60
    hour = seconds_of_day // 3600

    def bcd(v, bits):
        return [(v >> i) & 1 for i in range(bits)]

    sym = np.zeros(frame_rate)
    sym[0] = 2  # reference marker
    # seconds: units (bits 1-4), tens (bits 6-8); position 5 is a 0
    u, t = sec % 10, sec // 10
    vals = bcd(u, 4) + [0] + bcd(t, 3)
    sym[1:9] = vals
    sym[9] = 2
    u, t = minute % 10, minute // 10
    vals = bcd(u, 4) + [0] + bcd(t, 3) + [0]
    sym[10:18] = vals[:8]
    sym[19] = 2
    u, t = hour % 10, hour // 10
    vals = bcd(u, 4) + [0] + bcd(t, 2) + [0, 0]
    sym[20:28] = vals[:8]
    for p in range(29, frame_rate, 10):
        sym[p] = 2
    widths = np.where(sym == 2, 0.8, np.where(sym == 1, 0.5, 0.2))
    return jnp.asarray(widths, REAL_DTYPE), jnp.asarray(sym, jnp.int32)


def irig_b_decode(widths):
    """Decode pulse widths back to time of day (irig_b_decoder.rs)."""
    w = np.asarray(widths)
    sym = np.where(w > 0.65, 2, np.where(w > 0.35, 1, 0))

    def debcd(bits):
        return sum(b << i for i, b in enumerate(bits))

    sec = debcd(sym[1:5]) + 10 * debcd(sym[6:9])
    minute = debcd(sym[10:14]) + 10 * debcd(sym[15:18])
    hour = debcd(sym[20:24]) + 10 * debcd(sym[25:27])
    return hour * 3600 + minute * 60 + sec


def network_time_offset(t1: float, t2: float, t3: float, t4: float):
    """NTP-style offset/delay from a four-timestamp exchange
    (network_time_synchronizer.rs / time_sync.rs):
    offset = ((t2-t1)+(t3-t4))/2, delay = (t4-t1)-(t3-t2)."""
    offset = ((t2 - t1) + (t3 - t4)) / 2.0
    delay = (t4 - t1) - (t3 - t2)
    return offset, delay


class MultiRateClock:
    """Derive multiple integer-divided sample clocks from one master
    counter (multi_rate_clock.rs)."""

    def __init__(self, master_rate: float, divisors: tuple[int, ...]):
        self.master_rate = master_rate
        self.divisors = divisors
        self.count = 0

    def advance(self, n: int):
        """Advance n master ticks; returns ticks elapsed per derived
        clock."""
        out = []
        for d in self.divisors:
            out.append((self.count + n) // d - self.count // d)
        self.count += n
        return tuple(out)

    def time(self) -> float:
        return self.count / self.master_rate


def csac_allan_deviation(freq_error, tau_samples: int):
    """Overlapping Allan deviation of a fractional-frequency series at
    one averaging interval (csac_reference_oscillator.rs health
    metric)."""
    y = jnp.asarray(freq_error, REAL_DTYPE)
    m = tau_samples
    n = (y.shape[0] // m) * m
    means = jnp.mean(y[:n].reshape(-1, m), axis=-1)
    d = jnp.diff(means)
    return jnp.sqrt(0.5 * jnp.mean(d * d))


BLOCKS = {
    "afc": ("afc", "sync", "automatic frequency control (afc.rs)",
            ("sample_rate", "alpha")),
    "carrier_recovery": ("carrier_recovery_mpsk", "sync",
                         "Mth-power carrier recovery "
                         "(carrier_recovery.rs)", ("order", "bw")),
    "pll_carrier_tracking": ("pll_carrier_tracking", "sync",
                             "2nd-order carrier PLL "
                             "(pll_carrier_tracking.rs)", ("loop_bw",)),
    "pll_biquad": ("pll_biquad", "sync",
                   "biquad PLL (phase_locked_loop_biquad.rs)",
                   ("loop_bw",)),
    "freq_lock_detector": ("freq_lock_detector", "sync",
                           "loop lock detector (freq_lock_detector.rs)",
                           ("tol", "window")),
    "constellation_rotation_detector": (
        "constellation_rotation_detect", "sync",
        "M-PSK rotation estimate (constellation_rotation_detector.rs)",
        ("order",)),
    "tuning_estimator": ("tuning_estimate", "sync",
                         "spectrum-centroid offset (tuning_estimator.rs)",
                         ("sample_rate",)),
    "clock_recovery_mm": ("symbol_sync_mm", "sync",
                          "Mueller&Muller clock recovery "
                          "(clock_recovery_mm.rs / symbol_sync.rs)",
                          ("sps", "bw")),
    "timing_error_detector": ("timing_error_detector", "sync",
                              "Gardner/early-late TED "
                              "(timing_error_detector.rs)",
                              ("sps", "kind")),
    "hybrid_timing_detector": (
        "hybrid_timing_phase_detector", "sync",
        "NDA/DD blended TED (timing_phase_detector_hybrid.rs)",
        ("sps",)),
    "feedforward_timing": ("feedforward_timing_estimate", "sync",
                           "Oerder-Meyr square-law timing "
                           "(feedforward_timing_estimator.rs)",
                           ("sps",)),
    "blind_timing_recovery": ("blind_timing_recover", "sync",
                              "feedforward timing + decimate "
                              "(blind_timing_recovery.rs)", ("sps",)),
    "delay_lock_loop": ("delay_lock_loop", "sync",
                        "early/late code DLL (delay_lock_loop.rs)",
                        ("sps", "bw")),
    "cross_correlator": ("cross_correlator", "measurement",
                         "normalized FFT xcorr (cross_correlator.rs)"),
    "correlate_estimate": ("correlate_estimate", "sync",
                           "pattern offset/phase/gain "
                           "(correlate_estimate.rs)", ("threshold",)),
    "periodic_autocorrelator": ("periodic_autocorrelator",
                                "measurement",
                                "cyclic-structure detector "
                                "(periodic_autocorrelator.rs)",
                                ("period", "n_periods")),
    "golay_correlator": ("golay_correlate", "sync",
                         "sidelobe-free Golay pair correlator "
                         "(polyphase_golay_correlator.rs)", ("n",)),
    "preamble_gen": ("preamble_gen", "source",
                     "standard preamble patterns (preamble_gen.rs)",
                     ("kind", "n_bits")),
    "feedforward_agc": ("feedforward_agc", "filter",
                        "block RMS AGC (feedforward_agc.rs)",
                        ("target", "window")),
    "agc_attack_decay": ("agc_attack_decay", "filter",
                         "attack/decay AGC (agc_attack_decay.rs)",
                         ("target", "attack", "decay")),
    "burst_gating_controller": ("burst_gating_controller", "sync",
                                "hang-time burst gate "
                                "(burst_gating_controller.rs)",
                                ("open_db", "close_db", "hang")),
    "pid_controller": ("pid_controller", "math",
                       "discrete PID (pid_controller.rs)",
                       ("kp", "ki", "kd")),
    "control_loop": ("control_loop_2nd", "math",
                     "2nd-order loop filter core (control_loop.rs)",
                     ("loop_bw", "damping")),
    "gps_time": ("GpsTime", "math",
                 "GPS week/TOW conversions (gps_time.rs)"),
    "irig_b": ("irig_b_encode", "source",
               "IRIG-B frame encode/decode (irig_b_decoder.rs)"),
    "network_time_sync": ("network_time_offset", "math",
                          "NTP 4-timestamp offset/delay "
                          "(network_time_synchronizer.rs)"),
    "multi_rate_clock": ("MultiRateClock", "math",
                         "divided sample clocks (multi_rate_clock.rs)",
                         ("master_rate", "divisors")),
    "csac_allan_deviation": ("csac_allan_deviation", "measurement",
                             "Allan deviation "
                             "(csac_reference_oscillator.rs)",
                             ("tau_samples",)),
}
