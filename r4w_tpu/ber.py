"""Batched BER-vs-theory acceptance gates.

Re-design of the reference's `ber_tool.rs` (BerTester :44, confidence
intervals :164, PerTester :220) and the MEASURABLE_OBJECTIVES "BER
accuracy <10% deviation from theory" clause as one vectorised
Monte-Carlo engine: every scheme runs millions of bits as a single
(lanes × symbols × constellation) tensor program — on the device the nearest-
point search is a matmul, and a full linear-fleet acceptance sweep
is sub-second.

Two measurement levels:

* `linear_ber_monte_carlo` — constellation-level loop (map → AWGN →
  nearest point → count), validating the Gray maps, constellation
  normalisation, and noise calibration against closed forms.
* `waveform_ber_monte_carlo` — drives the actual `Waveform` classes
  through `channel.awgn`, converting the per-sample SNR to Eb/N0 via
  the samples-per-symbol integration gain, so the full TX→RX chain is
  held to the same theory curves.

`ber_acceptance_report` packages measured vs theory with Wilson
confidence intervals; `tests/test_ber_theory.py` gates deviation <10%.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu.ops.measure import (
    ber_confidence_interval,
    theoretical_ber_bpsk,
    theoretical_ber_fsk_noncoherent,
    theoretical_ber_mpsk,
    theoretical_ber_mqam_exact,
)
from r4w_tpu.waveforms.linear_mod import (
    index_to_value,
    psk_constellation,
    psk_value_to_index,
    qam_constellation,
    qam_value_to_index,
)

LINEAR_SCHEMES = ("bpsk", "qpsk", "8psk", "16qam", "64qam")


def _scheme_tables(scheme: str) -> tuple[np.ndarray, np.ndarray, int]:
    """(constellation, value_to_index, bits_per_symbol)."""
    if scheme.endswith("psk"):
        m = {"bpsk": 2, "qpsk": 4, "8psk": 8}[scheme]
        return psk_constellation(m), psk_value_to_index(m), int(np.log2(m))
    m = int(scheme[:-3])
    return qam_constellation(m), qam_value_to_index(m), int(np.log2(m))


def theoretical_ber(scheme: str, ebn0_db) -> jax.Array:
    """Closed-form Gray-coded AWGN BER for a linear scheme or
    'fsk-noncoherent'."""
    if scheme == "fsk-noncoherent":
        return theoretical_ber_fsk_noncoherent(ebn0_db)
    if scheme in ("bpsk", "qpsk"):
        return theoretical_ber_bpsk(ebn0_db)
    if scheme.endswith("psk"):
        return theoretical_ber_mpsk(ebn0_db, {"8psk": 8}[scheme])
    return theoretical_ber_mqam_exact(ebn0_db, int(scheme[:-3]))


@functools.partial(jax.jit, static_argnames=("scheme", "n_bits"))
def linear_ber_monte_carlo(scheme: str, ebn0_db, n_bits: int, key):
    """Measured BER over n_bits random bits at each Eb/N0 point.

    ebn0_db: (P,) points. Returns (P,) measured BER. The whole sweep is
    one batched tensor program (P × S symbols live at once).
    """
    con, v2i, k = _scheme_tables(scheme)
    conj = jnp.asarray(con, IQ_DTYPE)
    n_sym = n_bits // k
    ebn0 = 10.0 ** (jnp.asarray(ebn0_db, REAL_DTYPE) / 10.0)  # (P,)

    kb, kn = jax.random.split(key)
    vals = jax.random.randint(kb, (n_sym,), 0, 1 << k)  # symbol values
    tx = conj[jnp.asarray(v2i)[vals]]  # (S,), Es == 1 by construction

    # N0 = Es / (k·γb); complex noise with total variance N0 per sample
    n0 = 1.0 / (k * ebn0)  # (P,)
    noise = jax.random.normal(kn, (2, ebn0.shape[0], n_sym), REAL_DTYPE)
    noise_c = jax.lax.complex(noise[0], noise[1]) * jnp.sqrt(
        n0 / 2.0)[:, None]
    rx = tx[None, :] + noise_c  # (P, S)

    d2 = jnp.abs(rx[..., None] - conj) ** 2  # (P, S, M)
    idx = jnp.argmin(d2, axis=-1)
    i2v = jnp.asarray(index_to_value(v2i))
    got_vals = i2v[idx]  # (P, S)

    diff = jnp.bitwise_xor(got_vals, vals[None, :])
    bit_errors = jnp.sum(
        (diff[..., None] >> jnp.arange(k)) & 1, axis=(-1, -2))
    return bit_errors / (n_sym * k)


@functools.partial(jax.jit, static_argnames=("n_bits",))
def fsk_noncoherent_ber_monte_carlo(ebn0_db, n_bits: int, key):
    """Orthogonal noncoherent BFSK: decide max |tone correlation|."""
    ebn0 = 10.0 ** (jnp.asarray(ebn0_db, REAL_DTYPE) / 10.0)  # (P,)
    kb, kn, kp = jax.random.split(key, 3)
    bits = jax.random.randint(kb, (n_bits,), 0, 2)
    n0 = 1.0 / ebn0  # Es = Eb = 1
    noise = jax.random.normal(kn, (4, ebn0.shape[0], n_bits), REAL_DTYPE)
    scale = jnp.sqrt(n0 / 2.0)[:, None]
    n_sig = jax.lax.complex(noise[0], noise[1]) * scale
    n_oth = jax.lax.complex(noise[2], noise[3]) * scale
    del kp  # carrier phase is irrelevant to the |·| decision statistic
    r_sig = jnp.abs(1.0 + n_sig)
    r_oth = jnp.abs(n_oth)
    errors = jnp.sum((r_oth > r_sig).astype(jnp.int32), axis=-1)
    return errors / n_bits


def waveform_ber_monte_carlo(name: str, snr_db: float, n_bytes: int = 64,
                             lanes: int = 16, seed: int = 0,
                             sample_rate: float = 125_000.0):
    """Measured BER + implied Eb/N0 through the real Waveform chain.

    Returns (ber, ebn0_db): the per-sample `snr_db` maps to
    Eb/N0 = snr + 10·log10(sps / bits_per_symbol) because symbol
    integration over sps samples adds coherent gain.
    """
    from r4w_tpu.channel import awgn
    from r4w_tpu.waveforms import create_waveform

    wf = create_waveform(name, sample_rate)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, n_bytes).astype(np.uint8)
    tx = wf.modulate(payload.tobytes())
    ref_bits = np.unpackbits(payload)

    errors = total = 0
    for lane in range(lanes):
        rx = awgn(jax.random.key(seed * 1000 + lane), tx, snr_db)
        res = wf.demodulate(rx)
        got = np.asarray(res.bits)[: n_bytes].astype(np.uint8)
        got_bits = np.unpackbits(got)
        n = min(len(got_bits), len(ref_bits))
        errors += int(np.sum(got_bits[:n] != ref_bits[:n]))
        errors += len(ref_bits) - n  # missing bits count as errors
        total += len(ref_bits)

    k = wf.info().bits_per_symbol
    sps = wf.samples_per_symbol()
    ebn0_db = snr_db + 10.0 * np.log10(sps / k)
    return errors / total, ebn0_db


@dataclasses.dataclass
class BerGateResult:
    scheme: str
    ebn0_db: float
    measured: float
    theory: float
    deviation: float          # |measured − theory| / theory
    ci_low: float
    ci_high: float
    n_bits: int

    @property
    def theory_in_ci(self) -> bool:
        return self.ci_low <= self.theory <= self.ci_high


def ber_acceptance_report(schemes_points: dict[str, tuple[float, ...]],
                          n_bits: int = 1_000_000, seed: int = 0
                          ) -> list[BerGateResult]:
    """Run the constellation-level acceptance sweep.

    schemes_points: scheme -> Eb/N0 points (dB). Points should sit where
    theory is tight (Pb ≈ 1e-3..3e-2) and n_bits keeps the relative CI
    under a few percent.
    """
    out = []
    for i, (scheme, points) in enumerate(sorted(schemes_points.items())):
        pts = jnp.asarray(points, REAL_DTYPE)
        key = jax.random.key(seed + 7 * i)
        if scheme == "fsk-noncoherent":
            measured = fsk_noncoherent_ber_monte_carlo(pts, n_bits, key)
        else:
            measured = linear_ber_monte_carlo(scheme, pts, n_bits, key)
        measured = np.asarray(measured)
        theory = np.asarray(theoretical_ber(scheme, pts))
        for p, m, t in zip(points, measured, theory):
            errs = int(round(float(m) * n_bits))
            lo, hi = ber_confidence_interval(errs, n_bits)
            out.append(BerGateResult(
                scheme=scheme, ebn0_db=float(p), measured=float(m),
                theory=float(t),
                deviation=abs(float(m) - float(t)) / max(float(t), 1e-12),
                ci_low=lo, ci_high=hi, n_bits=n_bits))
    return out


DEFAULT_GATE_POINTS: dict[str, tuple[float, ...]] = {
    # points chosen where Pb ∈ ~[1e-3, 3e-2]: approximations are tight
    # and 1M bits give <5% relative statistical error
    "bpsk": (4.0, 6.0, 7.0),
    "qpsk": (4.0, 6.0, 7.0),
    "8psk": (7.0, 9.0, 10.0),
    "16qam": (8.0, 10.0, 11.0),
    "64qam": (11.0, 12.5, 14.0),
    "fsk-noncoherent": (8.0, 10.0),
}


def main():  # pragma: no cover - CLI entry
    import json

    results = ber_acceptance_report(DEFAULT_GATE_POINTS)
    worst = max(r.deviation for r in results)
    print(json.dumps({
        "gates": [dataclasses.asdict(r) for r in results],
        "worst_deviation": worst,
        "pass": worst < 0.10,
    }, indent=1))


if __name__ == "__main__":  # pragma: no cover
    main()
