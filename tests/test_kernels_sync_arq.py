"""LoRa dechirp, FIR and rotator paths, LoRa sync/packet, ARQ/HARQ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from r4w_tpu import arq
from r4w_tpu.waveforms import lora
from r4w_tpu.waveforms.lora import chirp as chirp_mod
from r4w_tpu.waveforms.lora import packet as lora_packet
from r4w_tpu.waveforms.lora import sync as lora_sync

pytestmark = pytest.mark.slow  # heavy integration lane


# ------------------------------------------------- dechirp, FIR, rotator


def test_dechirp_power_matches_fft():
    """demodulate_symbols' dechirp-FFT decisions equal numpy's."""
    p = lora.LoRaParams(sf=7)
    syms = jnp.asarray(np.random.default_rng(0).integers(0, 128, 24))
    x = chirp_mod.symbol_chirps(p, syms)
    got, _, mag = lora.demodulate_symbols(p, x)
    down = np.asarray(chirp_mod.base_downchirp(p))
    ref = np.abs(np.fft.fft(np.asarray(x) * down, axis=-1))
    assert np.array_equal(np.asarray(got), np.asarray(syms))
    np.testing.assert_allclose(np.asarray(mag), ref.max(-1), rtol=1e-4)


def test_decimating_fir_matches_numpy():
    from r4w_tpu.ops import filters as F

    rng = np.random.default_rng(1)
    taps = rng.standard_normal(31).astype(np.float32)
    sig = rng.standard_normal(997).astype(np.float32)
    for factor in (1, 4):
        y, _ = F.decimating_fir(taps, sig, factor)
        ref = np.convolve(sig, taps)[: sig.size][::factor]
        assert np.asarray(y).shape == ref.shape
        assert np.max(np.abs(np.asarray(y) - ref)) < 1e-4, factor


def test_freq_xlating_mix_matches_numpy():
    from r4w_tpu.ops import filters as F

    rng = np.random.default_rng(2)
    x = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)
         ).astype(np.complex64)
    y, _, _ = F.freq_xlating_fir(np.ones(1, np.float32), x, 2500.0, 1e6)
    t = np.arange(3000)
    ref = x * np.exp(-2j * np.pi * 2500.0 / 1e6 * t)
    assert np.max(np.abs(np.asarray(y) - ref)) < 1e-3


# ------------------------------------------------------------------- sync


def test_preamble_detection_and_frame_alignment():
    p = lora.LoRaParams(sf=7)
    payload = jnp.asarray([0xAA, 0x55, 0x0F])
    tx = lora.modulate(p, payload, include_preamble=True)
    # prepend noise-only gap
    rng = np.random.default_rng(3)
    gap = 0.05 * (rng.standard_normal(777) + 1j * rng.standard_normal(777))
    rx = jnp.concatenate([jnp.asarray(gap, jnp.complex64), tx])
    res = lora_sync.detect_preamble(p, rx)
    assert bool(res.detected)
    # frame start within half a symbol of the true offset
    assert abs(int(res.frame_start) - 777) <= p.samples_per_symbol // 2
    aligned, res2 = lora_sync.synchronize(p, rx)
    assert aligned is not None
    result = lora.demodulate(p, aligned)
    assert np.asarray(result.payload[:3]).tolist() == [0xAA, 0x55, 0x0F]


def test_preamble_cfo_estimate():
    p = lora.LoRaParams(sf=7)
    tx = lora.modulate(p, jnp.asarray([1, 2]), include_preamble=True)
    cfo_true = 400.0
    t = np.arange(tx.shape[-1]) / p.sample_rate
    rx = np.asarray(tx) * np.exp(2j * np.pi * cfo_true * t)
    res = lora_sync.detect_preamble(p, jnp.asarray(rx.astype(np.complex64)))
    assert bool(res.detected)
    # CFO resolution = one dechirp bin = bw/2^sf ≈ 977 Hz; interpolated
    # estimate should land within one bin
    assert abs(float(res.cfo_hz) - cfo_true) < 1000.0


def test_no_preamble_in_noise():
    p = lora.LoRaParams(sf=7)
    rng = np.random.default_rng(4)
    noise = (rng.standard_normal(6000) + 1j * rng.standard_normal(6000)
             ).astype(np.complex64)
    res = lora_sync.detect_preamble(p, jnp.asarray(noise))
    assert not bool(res.detected)


# ------------------------------------------------------------------ packet


def test_packet_header_and_crc_roundtrip():
    data = lora_packet.build_packet(b"payload!", cr=2, crc_enabled=True)
    payload, crc_ok = lora_packet.parse_packet(data)
    assert payload == b"payload!" and crc_ok is True
    # corrupt payload -> crc fails, header still parses
    bad = data.copy(); bad[5] ^= 0xFF
    payload2, crc_ok2 = lora_packet.parse_packet(bad)
    assert crc_ok2 is False
    # corrupt header -> rejected
    bad2 = data.copy(); bad2[2] ^= 0x01
    _, crc3 = lora_packet.parse_packet(bad2)
    assert crc3 is None


def test_packet_over_lora_modem():
    p = lora.LoRaParams(sf=7)
    frame = lora_packet.build_packet(b"framed msg")
    tx = lora.modulate(p, jnp.asarray(frame), include_preamble=False)
    result = lora.demodulate(p, tx)
    payload, crc_ok = lora_packet.parse_packet(np.asarray(result.payload))
    assert payload == b"framed msg" and crc_ok is True


# --------------------------------------------------------------------- arq


def test_selective_repeat_arq():
    a = arq.SelectiveRepeatArq(window=4, max_retries=2)
    seqs = [a.send(bytes([i])) for i in range(6)]
    assert a.pending() == seqs[:4]
    a.on_ack(seqs[0])
    assert a.stats.delivered == 1
    assert a.on_nack(seqs[1])
    assert a.on_nack(seqs[1])
    assert not a.on_nack(seqs[1])  # exceeded budget
    assert a.stats.failed == 1
    assert a.stats.retransmissions == 2


def test_harq_incremental_redundancy_gain():
    """Rate-1 first transmission fails where soft-combined rate-1/2
    succeeds — the defining HARQ-II property."""
    rng = np.random.default_rng(5)
    wins = 0
    for trial in range(6):
        bits = rng.integers(0, 2, 96)
        ok1, ok2 = arq.harq_roundtrip_demo(bits, noise_std=0.95, rng=rng)
        if ok2 and not ok1:
            wins += 1
        if ok1 and not ok2:
            wins -= 2  # combining should never hurt this often
    assert wins >= 1


def test_shift_add_fir_matches_conv():
    """The shift-add FIR lowering computes exactly the conv path."""
    import numpy as np
    import jax.numpy as jnp
    from r4w_tpu.ops import filters as F

    rng = np.random.default_rng(0)
    for k in (4, 32, 129):
        x = jnp.asarray(rng.standard_normal(4096).astype(np.float32))
        taps = jnp.asarray(rng.standard_normal(k).astype(np.float32))
        want = np.convolve(np.asarray(x), np.asarray(taps))[k - 1:4096]
        got = np.asarray(F._conv_valid_shift_add(x, taps))
        np.testing.assert_allclose(got, want, atol=2e-4)
        # and the dispatcher still agrees on this platform
        via = np.asarray(F._conv_valid(x, taps))
        np.testing.assert_allclose(via, want, atol=2e-4)
