"""MIMO detection/precoding & adaptive array fills.

Re-designs of mimo_detector.rs, mimo_precoder.rs,
mimo_spatial_multiplexer.rs, orthogonal_space_time_block_code.rs,
millimeter_wave_beamforming.rs, beam_steering_controller.rs,
adaptive_nulling_beamformer.rs / rf_mitigation_adaptive_nulling.rs,
generalized_sidelobe_canceller.rs,
full_duplex_self_interference_canceller.rs,
adaptive_interference_canceller.rs, noma_decoder.rs,
ris_phase_controller.rs, oam_beam_generator.rs,
antenna_array_response.rs, acoustic_beamformer_adaptive.rs,
ultrasound_beam_synthesizer.rs, successive_interference_canceller.rs
(power-domain form; the spatial SIC lives in ops/mimo.sic_decode).

Matrix work (ZF/MMSE/SVD/LCMV) is dense linear algebra — exactly what
a batched matmul; per-symbol detection is one batched solve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.hostio import cis
from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu.ops.radar import steering_vector


def _steer(n_elems: int, angle_deg: float, spacing: float = 0.5):
    """Single 1-D steering vector (radar.steering_vector is batched
    over angles with (n, spacing, angles) ordering)."""
    return steering_vector(n_elems, spacing,
                           jnp.asarray([angle_deg]))[0]

# -------------------------------------------------------- MIMO detect


def mimo_detect_zf(y, h):
    """Zero-forcing detector (mimo_detector.rs): x̂ = H⁺y.
    y: (..., Nr), h: (Nr, Nt)."""
    hp = jnp.linalg.pinv(jnp.asarray(h, IQ_DTYPE))
    return jnp.einsum("tr,...r->...t", hp, jnp.asarray(y, IQ_DTYPE))


def mimo_detect_mmse(y, h, noise_var: float):
    """MMSE detector: x̂ = (HᴴH + σ²I)⁻¹Hᴴy."""
    h = jnp.asarray(h, IQ_DTYPE)
    g = jnp.linalg.solve(
        h.conj().T @ h + noise_var * jnp.eye(h.shape[1], dtype=IQ_DTYPE),
        h.conj().T)
    return jnp.einsum("tr,...r->...t", g, jnp.asarray(y, IQ_DTYPE))


def mimo_detect_ml(y, h, constellation):
    """Exact ML detection by enumerating the Nt-fold constellation
    product as ONE (batch, |C|^Nt) distance matmul (mimo_detector.rs
    sphere-decoder role, brute-force-batched).
    Practical for |C|^Nt up to a few thousand."""
    h = jnp.asarray(h, IQ_DTYPE)
    c = jnp.asarray(constellation, IQ_DTYPE)
    nt = h.shape[1]
    m = c.shape[0]
    grids = jnp.meshgrid(*([jnp.arange(m)] * nt), indexing="ij")
    combos = jnp.stack([g.reshape(-1) for g in grids], axis=-1)  # (K,Nt)
    cand = c[combos]                                             # (K,Nt)
    pred = cand @ h.T                                            # (K,Nr)
    y = jnp.asarray(y, IQ_DTYPE)
    d = jnp.sum(jnp.abs(y[..., None, :] - pred[None, ...]) ** 2, axis=-1)
    best = jnp.argmin(d, axis=-1)
    return combos[best], cand[best]


def mimo_precode_svd(h):
    """SVD precoding (mimo_precoder.rs): returns (precoder V, combiner
    Uᴴ, singular values) so the channel diagonalizes to S."""
    u, s, vh = jnp.linalg.svd(jnp.asarray(h, IQ_DTYPE),
                              full_matrices=False)
    return vh.conj().T, u.conj().T, s


def spatial_multiplex(streams):
    """Map independent streams onto TX antennas
    (mimo_spatial_multiplexer.rs): (Nt, N) stack + per-antenna power
    normalization."""
    s = jnp.stack([jnp.asarray(x, IQ_DTYPE) for x in streams])
    return s / np.sqrt(s.shape[0])


def ostbc34_encode(syms):
    """Rate-3/4 orthogonal STBC for 4 TX antennas
    (orthogonal_space_time_block_code.rs): 3 symbols over 4 slots,
    the standard complex orthogonal design."""
    s = jnp.asarray(syms, IQ_DTYPE)
    n = (s.shape[0] // 3) * 3
    s1, s2, s3 = s[0:n:3], s[1:n:3], s[2:n:3]
    z = jnp.zeros_like(s1)
    # rows = time slots, columns = antennas
    blocks = jnp.stack([
        jnp.stack([s1, s2, s3, z], axis=-1),
        jnp.stack([-jnp.conj(s2), jnp.conj(s1), z, s3], axis=-1),
        jnp.stack([jnp.conj(s3), z, -jnp.conj(s1), s2], axis=-1),
        jnp.stack([z, jnp.conj(s3), -jnp.conj(s2), -s1], axis=-1),
    ], axis=1)                                    # (B, 4 slots, 4 tx)
    return blocks


def ostbc34_decode(rx_blocks, h):
    """Matched-filter combining for the rate-3/4 OSTBC over a flat
    SISO-per-antenna channel h: (4,) (single RX antenna)."""
    r = jnp.asarray(rx_blocks, IQ_DTYPE)          # (B, 4)
    h = jnp.asarray(h, IQ_DTYPE)
    h1, h2, h3, h4 = h[0], h[1], h[2], h[3]
    r1, r2, r3, r4 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    s1 = (jnp.conj(h1) * r1 + h2 * jnp.conj(r2) - h3 * jnp.conj(r3)
          - jnp.conj(h4) * r4)
    s2 = (jnp.conj(h2) * r1 - h1 * jnp.conj(r2) + jnp.conj(h4) * r3
          - h3 * jnp.conj(r4))
    s3 = (jnp.conj(h3) * r1 + jnp.conj(h4) * r2 + h1 * jnp.conj(r3)
          + h2 * jnp.conj(r4))
    norm = jnp.sum(jnp.abs(h) ** 2)
    out = jnp.stack([s1, s2, s3], axis=-1) / norm
    return out.reshape(-1)


# ----------------------------------------------------- power-domain SIC


def noma_superpose(x_near, x_far, p_near: float = 0.2):
    """Power-domain NOMA superposition (noma_decoder.rs TX side)."""
    a = jnp.asarray(x_near, IQ_DTYPE)
    b = jnp.asarray(x_far, IQ_DTYPE)
    return np.sqrt(p_near) * a + np.sqrt(1.0 - p_near) * b


def noma_decode_near(y, constellation, p_near: float = 0.2):
    """Near-user SIC decode (noma_decoder.rs /
    successive_interference_canceller.rs): decode the strong (far)
    user, subtract, then decode own signal."""
    c = jnp.asarray(constellation, IQ_DTYPE)
    y = jnp.asarray(y, IQ_DTYPE)
    far_scale = np.sqrt(1.0 - p_near)
    d = jnp.abs(y[:, None] - far_scale * c[None, :])
    far_idx = jnp.argmin(d, axis=-1)
    resid = y - far_scale * c[far_idx]
    d2 = jnp.abs(resid[:, None] - np.sqrt(p_near) * c[None, :])
    near_idx = jnp.argmin(d2, axis=-1)
    return near_idx.astype(jnp.int32), far_idx.astype(jnp.int32)


# ------------------------------------------------------ adaptive arrays


def array_response(n_elems: int, angles_deg, spacing: float = 0.5):
    """Array manifold over a set of angles (antenna_array_response.rs):
    (n_angles, n_elems) steering matrix."""
    a = jnp.atleast_1d(jnp.asarray(angles_deg, REAL_DTYPE))
    return steering_vector(n_elems, spacing, a)


def lcmv_weights(r, constraints, gains):
    """Linearly-constrained minimum-variance beamformer
    (adaptive_nulling_beamformer.rs / rf_mitigation_adaptive_nulling.rs):
    w = R⁻¹C (CᴴR⁻¹C)⁻¹ g. constraints: (N, K), gains: (K,)."""
    r = jnp.asarray(r, IQ_DTYPE)
    c = jnp.asarray(constraints, IQ_DTYPE)
    g = jnp.asarray(gains, IQ_DTYPE)
    rinv_c = jnp.linalg.solve(r, c)
    inner = c.conj().T @ rinv_c
    return rinv_c @ jnp.linalg.solve(inner, g)


def null_steer_weights(n_elems: int, look_deg: float, null_degs,
                       spacing: float = 0.5, loading: float = 1e-3):
    """Steer unity gain at look_deg and hard nulls at null_degs via
    LCMV with identity-plus-interference covariance."""
    look = _steer(n_elems, look_deg, spacing)
    nulls = [_steer(n_elems, d, spacing) for d in null_degs]
    c = jnp.stack([look] + nulls, axis=-1)
    g = jnp.asarray([1.0] + [0.0] * len(nulls), IQ_DTYPE)
    r = jnp.eye(n_elems, dtype=IQ_DTYPE) * loading
    for v in nulls:
        r = r + jnp.outer(v, jnp.conj(v))
    return lcmv_weights(r, c, g)


def gsc_cancel(x, look_deg: float, spacing: float = 0.5,
               mu: float = 0.05, n_iter: int | None = None):
    """Generalized sidelobe canceller
    (generalized_sidelobe_canceller.rs): fixed beamformer + blocking
    matrix + LMS adaptive branch. x: (N_elems, T)."""
    x = jnp.asarray(x, IQ_DTYPE)
    n = x.shape[0]
    # steering vector + blocking matrix are DESIGN-TIME math from the
    # static look angle — build them in numpy so the block stays
    # jit-safe when x is traced (the QR never sees a tracer)
    ang = np.deg2rad(look_deg)
    v = np.exp(1j * 2.0 * np.pi * spacing * np.sin(ang)
               * np.arange(n)) / n
    d_vec = jnp.asarray(v, IQ_DTYPE)
    main = jnp.einsum("n,nt->t", jnp.conj(d_vec), x)
    # blocking matrix: orthogonal complement of the steering vector
    q, _ = np.linalg.qr(np.column_stack([v, np.eye(n)[:, : n - 1]]))
    b = jnp.asarray(q[:, 1:], IQ_DTYPE)            # (N, N-1)
    blocked = jnp.einsum("nm,nt->mt", jnp.conj(b), x)

    def step(w, inp):
        u, d = inp                                  # u: (N-1,), d: scalar
        y = jnp.vdot(w, u)
        e = d - y
        w = w + mu * jnp.conj(e) * u / (jnp.vdot(u, u).real + 1e-6)
        return w, e

    w0 = jnp.zeros((n - 1,), IQ_DTYPE)
    _, out = jax.lax.scan(step, w0, (blocked.T, main))
    return out


def self_interference_cancel(rx, tx_known, n_taps: int = 32,
                             mu: float = 0.5):
    """Full-duplex digital SI canceller
    (full_duplex_self_interference_canceller.rs /
    adaptive_interference_canceller.rs): NLMS from the known transmit
    stream onto the receive stream."""
    d = jnp.asarray(rx, IQ_DTYPE)
    x = jnp.asarray(tx_known, IQ_DTYPE)
    xpad = jnp.concatenate([jnp.zeros((n_taps - 1,), IQ_DTYPE), x])
    idx = jnp.arange(d.shape[0])[:, None] + jnp.arange(n_taps)[None, :]
    xmat = xpad[idx][:, ::-1]

    def step(w, inp):
        xv, dn = inp
        y = jnp.vdot(w, xv)
        e = dn - y
        w = w + mu * jnp.conj(e) * xv / (jnp.vdot(xv, xv).real + 1e-6)
        return w, e

    w0 = jnp.zeros((n_taps,), IQ_DTYPE)
    wf, err = jax.lax.scan(step, w0, (xmat, d))
    return err, wf


# --------------------------------------------------- mmWave / RIS / OAM


def mmwave_beam_search(h, codebook_bits: int = 4, n_elems: int = 16,
                       spacing: float = 0.5):
    """Analog beam training (millimeter_wave_beamforming.rs): sweep a
    DFT codebook, return the index/gain per codeword — one matmul."""
    h = jnp.asarray(h, IQ_DTYPE)                   # (N,) channel
    n_beams = 1 << codebook_bits
    angles = jnp.linspace(-90.0, 90.0, n_beams)
    book = array_response(n_elems, angles, spacing)  # (B, N)
    gains = jnp.abs(book.conj() @ h) / np.sqrt(n_elems)
    k = jnp.argmax(gains)
    return k, gains, angles[k]


def beam_steering_phases(n_elems: int, angle_deg: float,
                         spacing: float = 0.5, quant_bits: int = 0):
    """Per-element phase commands for a steering controller
    (beam_steering_controller.rs); optional phase-shifter
    quantization."""
    v = _steer(n_elems, angle_deg, spacing)
    ph = jnp.angle(v)
    if quant_bits > 0:
        step = 2.0 * np.pi / (1 << quant_bits)
        ph = jnp.round(ph / step) * step
    return ph


def ris_phase_config(h_tx_ris, h_ris_rx, quant_bits: int = 2):
    """RIS phase configuration (ris_phase_controller.rs): co-phase the
    cascaded channel h2[n]·e^{jφn}·h1[n]; quantized phase shifters."""
    h1 = jnp.asarray(h_tx_ris, IQ_DTYPE)
    h2 = jnp.asarray(h_ris_rx, IQ_DTYPE)
    want = -jnp.angle(h1 * h2)
    step = 2.0 * np.pi / (1 << quant_bits)
    phases = jnp.round(want / step) * step
    gain = jnp.abs(jnp.sum(h1 * h2 * cis(phases)))
    return phases, gain


def oam_beam(n_elems_ring: int, mode: int):
    """Uniform-circular-array OAM excitation (oam_beam_generator.rs):
    element k gets phase 2π·mode·k/N; orthogonality across modes."""
    k = jnp.arange(n_elems_ring, dtype=REAL_DTYPE)
    return cis(2.0 * np.pi * mode * k / n_elems_ring) \
        / np.sqrt(n_elems_ring)


def delay_and_sum(x, delays):
    """Time-domain delay-and-sum beamformer
    (acoustic_beamformer_adaptive.rs fixed part /
    ultrasound_beam_synthesizer.rs): integer-sample delays, (N, T).

    Delays may be traced (one circular gather per element, jit/vmap
    safe) — steering can ride inside a scanned search loop."""
    x = jnp.asarray(x)
    d = jnp.asarray(delays, jnp.int32)
    t = x.shape[-1]
    idx = (jnp.arange(t)[None, :] + d[:, None]) % t
    return jnp.mean(jnp.take_along_axis(x, idx, axis=-1), axis=0)


def ultrasound_focus_delays(n_elems: int, pitch_m: float, focus_m: float,
                            c: float = 1540.0, fs: float = 20e6):
    """Focusing delay profile for an ultrasound array
    (ultrasound_beam_synthesizer.rs): geometric path-length
    differences to a focal point on the axis."""
    xk = (np.arange(n_elems) - (n_elems - 1) / 2.0) * pitch_m
    path = np.sqrt(focus_m ** 2 + xk ** 2)
    dt = (path - focus_m) / c
    return jnp.asarray(np.round(dt * fs), jnp.int32)


BLOCKS = {
    "mimo_detector": ("mimo_detect_mmse", "demodulator",
                      "ZF/MMSE/ML MIMO detection (mimo_detector.rs)",
                      ("noise_var",)),
    "mimo_precoder": ("mimo_precode_svd", "modulator",
                      "SVD precoding (mimo_precoder.rs)"),
    "mimo_spatial_multiplexer": ("spatial_multiplex", "modulator",
                                 "stream->antenna mapping "
                                 "(mimo_spatial_multiplexer.rs)"),
    "orthogonal_stbc": ("ostbc34_encode", "modulator",
                        "rate-3/4 4-TX OSTBC "
                        "(orthogonal_space_time_block_code.rs)"),
    "noma_decoder": ("noma_decode_near", "demodulator",
                     "power-domain NOMA SIC (noma_decoder.rs)",
                     ("p_near",)),
    "antenna_array_response": ("array_response", "math",
                               "array manifold "
                               "(antenna_array_response.rs)",
                               ("n_elems", "spacing")),
    "adaptive_nulling_beamformer": ("null_steer_weights", "radar",
                                    "LCMV null steering "
                                    "(adaptive_nulling_beamformer.rs)",
                                    ("look_deg", "null_degs")),
    "generalized_sidelobe_canceller": (
        "gsc_cancel", "radar",
        "GSC fixed+adaptive branch "
        "(generalized_sidelobe_canceller.rs)", ("look_deg",)),
    "full_duplex_si_canceller": (
        "self_interference_cancel", "filter",
        "NLMS self-interference canceller "
        "(full_duplex_self_interference_canceller.rs)", ("n_taps",)),
    "mmwave_beam_search": ("mmwave_beam_search", "radar",
                           "DFT codebook beam training "
                           "(millimeter_wave_beamforming.rs)",
                           ("codebook_bits",)),
    "beam_steering_controller": ("beam_steering_phases", "radar",
                                 "phase commands + quantization "
                                 "(beam_steering_controller.rs)",
                                 ("angle_deg", "quant_bits")),
    "ris_phase_controller": ("ris_phase_config", "radar",
                             "RIS co-phasing (ris_phase_controller.rs)",
                             ("quant_bits",)),
    "oam_beam_generator": ("oam_beam", "source",
                           "UCA OAM mode excitation "
                           "(oam_beam_generator.rs)", ("mode",)),
    "delay_and_sum_beamformer": ("delay_and_sum", "radar",
                                 "time-domain delay&sum "
                                 "(acoustic_beamformer_adaptive.rs)"),
    "ultrasound_beam_synthesizer": ("ultrasound_focus_delays", "radar",
                                    "focal delay profile "
                                    "(ultrasound_beam_synthesizer.rs)",
                                    ("pitch_m", "focus_m")),
}
