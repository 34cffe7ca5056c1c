"""C API (native/r4w_capi.cpp) cross-validated against the JAX core.

The C library re-implements the hot conventions (Gray maps, LoRa
whitening/Hamming/interleave, chirp phase law, PSK constellations) for
embedded C callers — the reference's r4w-ffi role
(crates/r4w-ffi/src/lib.rs:958-1374 waveform API, :256 FFT, :490
chirp, :645 ring buffer). These tests pin the C implementations to the
JAX implementations sample-for-sample / byte-for-byte, which is the
strongest possible parity check: one spec, two independent codebases.
"""

import numpy as np
import pytest

from r4w_tpu.native import capi

pytestmark = pytest.mark.skipif(
    not capi.available(), reason=f"C library unavailable: "
    f"{capi.build_error()}")


def _lib():
    return capi.get_lib()


# ---------------------------------------------------------------- core


def test_version_and_abi():
    lib = _lib()
    assert lib.r4w_version().decode().count(".") == 2
    assert lib.r4w_abi_version() >= 1


def test_complex_helpers_match_numpy():
    lib = _lib()
    a = lib.r4w_complex_new(3.0, 4.0)
    assert lib.r4w_complex_magnitude(a) == pytest.approx(5.0)
    assert lib.r4w_complex_power(a) == pytest.approx(25.0)
    assert lib.r4w_complex_phase(a) == pytest.approx(np.angle(3 + 4j))
    b = lib.r4w_complex_from_polar(2.0, np.pi / 3)
    assert complex(b.re, b.im) == pytest.approx(2 * np.exp(1j * np.pi / 3))
    m = lib.r4w_complex_mul(a, b)
    assert complex(m.re, m.im) == pytest.approx(
        (3 + 4j) * 2 * np.exp(1j * np.pi / 3))
    c = lib.r4w_complex_conj(a)
    assert (c.re, c.im) == (3.0, -4.0)
    s = lib.r4w_complex_add(a, b)
    assert complex(s.re, s.im) == pytest.approx(
        (3 + 4j) + 2 * np.exp(1j * np.pi / 3))


# ----------------------------------------------------------------- FFT


@pytest.mark.parametrize("n", [64, 1024, 100, 37])  # pow2 + Bluestein
def test_fft_matches_numpy(n):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    got = capi.fft_forward(x)
    np.testing.assert_allclose(got, np.fft.fft(x), rtol=1e-9, atol=1e-9)
    back = capi.fft_inverse(got)
    np.testing.assert_allclose(back, x, rtol=1e-9, atol=1e-9)


def test_fft_find_peak():
    import ctypes

    lib = _lib()
    n = 256
    tone = np.exp(2j * np.pi * 37 * np.arange(n) / n)
    spec = capi.fft_forward(tone)
    bin_ = ctypes.c_size_t()
    mag = ctypes.c_double()
    ph = ctypes.c_double()
    rc = lib.r4w_fft_find_peak(
        spec.ctypes.data_as(ctypes.POINTER(capi.Complex)), n,
        ctypes.byref(bin_), ctypes.byref(mag), ctypes.byref(ph))
    assert rc == capi.OK
    assert bin_.value == 37
    assert mag.value == pytest.approx(n, rel=1e-9)


def test_power_spectrum_db():
    import ctypes

    lib = _lib()
    x = np.array([1 + 0j, 0 + 0j, 10 + 0j], np.complex128)
    out = np.zeros(3, np.float64)
    rc = lib.r4w_fft_power_spectrum_db(
        x.ctypes.data_as(ctypes.POINTER(capi.Complex)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 3)
    assert rc == capi.OK
    assert out[0] == pytest.approx(0.0)
    assert out[1] == -200.0
    assert out[2] == pytest.approx(20.0)


# --------------------------------------------------------------- chirp


def test_chirp_matches_jax_base_chirps():
    from r4w_tpu.waveforms.lora import chirp as jchirp
    from r4w_tpu.waveforms.lora.params import LoRaParams

    params = LoRaParams(sf=7, bw_hz=125_000)
    c = capi.CChirp(7, 125_000, 1)
    assert c.samples_per_symbol == params.samples_per_symbol
    np.testing.assert_allclose(
        c.upchirp(), np.asarray(jchirp.base_upchirp(params)),
        atol=2e-6)  # complex64 quantization on the JAX side
    np.testing.assert_allclose(
        c.downchirp(), np.asarray(jchirp.base_downchirp(params)),
        atol=2e-6)


@pytest.mark.parametrize("sym", [0, 1, 42, 127])
def test_chirp_symbol_matches_jax(sym):
    import jax.numpy as jnp

    from r4w_tpu.waveforms.lora import chirp as jchirp
    from r4w_tpu.waveforms.lora.params import LoRaParams

    params = LoRaParams(sf=7, bw_hz=125_000)
    want = np.asarray(
        jchirp.symbol_chirps(params, jnp.array([sym])))[0]
    c = capi.CChirp(7, 125_000, 1)
    np.testing.assert_allclose(c.symbol(sym), want, atol=2e-6)


# ---------------------------------------------------------- ringbuffer


def test_ringbuffer_roundtrip():
    import ctypes

    lib = _lib()
    rb = lib.r4w_ringbuffer_new(100)  # rounds up to 128
    try:
        assert lib.r4w_ringbuffer_capacity(rb) == 128
        assert lib.r4w_ringbuffer_is_empty(rb)
        assert lib.r4w_ringbuffer_push(
            rb, lib.r4w_complex_new(1.0, -2.0)) == capi.OK
        assert lib.r4w_ringbuffer_len(rb) == 1
        out = capi.Complex()
        assert lib.r4w_ringbuffer_pop(rb, ctypes.byref(out)) == capi.OK
        assert (out.re, out.im) == (1.0, -2.0)
        assert lib.r4w_ringbuffer_pop(rb, ctypes.byref(out)) == \
            capi.ERR_EMPTY
        # slice path
        data = np.arange(200, dtype=np.float64).view(np.complex128)
        pushed = lib.r4w_ringbuffer_push_slice(
            rb, data.ctypes.data_as(ctypes.POINTER(capi.Complex)),
            data.size)
        assert pushed == 100  # all fit (cap 128)
        assert lib.r4w_ringbuffer_len(rb) == 100
        got = np.zeros(100, np.complex128)
        popped = lib.r4w_ringbuffer_pop_slice(
            rb, got.ctypes.data_as(ctypes.POINTER(capi.Complex)), 100)
        assert popped == 100
        np.testing.assert_array_equal(got, data)
    finally:
        lib.r4w_ringbuffer_free(rb)


def test_ringbuffer_full():
    lib = _lib()
    rb = lib.r4w_ringbuffer_new(2)
    try:
        one = lib.r4w_complex_new(1.0, 0.0)
        assert lib.r4w_ringbuffer_push(rb, one) == capi.OK
        assert lib.r4w_ringbuffer_push(rb, one) == capi.OK
        assert lib.r4w_ringbuffer_is_full(rb)
        assert lib.r4w_ringbuffer_push(rb, one) == capi.ERR_FULL
    finally:
        lib.r4w_ringbuffer_free(rb)


# -------------------------------------------------------- signal utils


def test_generate_tone_and_shift():
    import ctypes

    lib = _lib()
    n, fs, f = 128, 1000.0, 100.0
    buf = np.zeros(n, np.complex128)
    p = buf.ctypes.data_as(ctypes.POINTER(capi.Complex))
    assert lib.r4w_generate_tone(f, fs, p, n) == capi.OK
    t = np.arange(n) / fs
    np.testing.assert_allclose(buf, np.exp(2j * np.pi * f * t),
                               atol=1e-12)
    # shifting by -f brings it back to DC
    assert lib.r4w_frequency_shift(p, n, -f, fs) == capi.OK
    np.testing.assert_allclose(buf, np.ones(n), atol=1e-9)


def test_add_awgn_snr():
    import ctypes

    lib = _lib()
    n = 4096
    buf = np.ones(n, np.complex128)
    p = buf.ctypes.data_as(ctypes.POINTER(capi.Complex))
    assert lib.r4w_add_awgn(p, n, 10.0) == capi.OK
    noise = buf - 1.0
    measured = 10 * np.log10(1.0 / np.mean(np.abs(noise) ** 2))
    assert measured == pytest.approx(10.0, abs=1.0)


# ----------------------------------------------------------- waveforms


def test_bpsk_matches_jax_modulate():
    from r4w_tpu.waveforms import create_waveform

    wf_j = create_waveform("BPSK", 8000.0)
    wf_c = capi.CWaveform.bpsk(8000.0, 1000.0)
    assert wf_c.samples_per_symbol == wf_j.samples_per_symbol()
    data = b"\xa5\x17\x00\xff"
    got = wf_c.modulate(data)
    want = np.asarray(wf_j.modulate(np.frombuffer(data, np.uint8)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert wf_c.demodulate(got) == data


def test_qpsk_matches_jax_modulate():
    from r4w_tpu.waveforms import create_waveform

    wf_j = create_waveform("QPSK", 8000.0)
    wf_c = capi.CWaveform.qpsk(8000.0, 1000.0)
    data = b"\x3c\x99\x42"
    got = wf_c.modulate(data)
    want = np.asarray(wf_j.modulate(np.frombuffer(data, np.uint8)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert wf_c.demodulate(got) == data


def test_qpsk_demod_under_noise():
    wf_c = capi.CWaveform.qpsk(8000.0, 1000.0)
    data = bytes(range(32))
    iq = wf_c.modulate(data)
    rng = np.random.default_rng(3)
    noisy = iq + 0.1 * (rng.standard_normal(iq.size)
                        + 1j * rng.standard_normal(iq.size))
    assert wf_c.demodulate(noisy) == data


def test_lora_modulate_matches_jax():
    import jax.numpy as jnp

    from r4w_tpu.waveforms.lora import modem
    from r4w_tpu.waveforms.lora.params import LoRaParams

    params = LoRaParams(sf=7, bw_hz=125_000)
    payload = np.array([0x48, 0x69, 0x21, 0x00, 0x7f], np.int32)
    want = np.asarray(modem.modulate(params, jnp.asarray(payload),
                                     include_preamble=True))
    wf_c = capi.CWaveform.lora(7, 125_000, 125_000.0)
    got = wf_c.modulate(bytes(payload.tolist()))
    assert got.size == want.size
    np.testing.assert_allclose(got, want, atol=3e-6)


def test_lora_c_roundtrip_and_cross_demod():
    """C-modulated payload decodes via C *and* via the JAX demod."""
    import jax.numpy as jnp

    from r4w_tpu.waveforms.lora import modem
    from r4w_tpu.waveforms.lora.params import LoRaParams

    params = LoRaParams(sf=7, bw_hz=125_000)
    payload = b"r4w-capi"
    wf_c = capi.CWaveform.lora(7, 125_000, 125_000.0)
    iq = wf_c.modulate(payload)
    # strip preamble: 8 up + 2 sync + 2.25 down
    n = params.samples_per_symbol
    pre = 8 * n + 2 * n + 2 * n + n // 4
    body = iq[pre:]
    # C demod
    got_c = wf_c.demodulate(body)
    assert got_c[: len(payload)] == payload
    # JAX demod of C samples (cross-implementation interop)
    res = modem.demodulate(params, jnp.asarray(body.astype(np.complex64)))
    got_j = bytes(np.asarray(res.payload).astype(np.uint8).tolist())
    assert got_j[: len(payload)] == payload


def test_lora_jax_tx_c_rx():
    """JAX-modulated payload decodes through the C demodulator."""
    import jax.numpy as jnp

    from r4w_tpu.waveforms.lora import modem
    from r4w_tpu.waveforms.lora.params import LoRaParams

    params = LoRaParams(sf=8, bw_hz=125_000)
    payload = np.frombuffer(b"hello world", np.uint8).astype(np.int32)
    body = np.asarray(modem.modulate(params, jnp.asarray(payload),
                                     include_preamble=False))
    wf_c = capi.CWaveform.lora(8, 125_000, 125_000.0)
    got = wf_c.demodulate(body.astype(np.complex128))
    assert got[: payload.size] == bytes(payload.tolist())


def test_waveform_metadata():
    wf = capi.CWaveform.lora(9, 250_000, 500_000.0)  # oversample 2
    assert wf.name == "LoRa"
    assert wf.samples_per_symbol == (1 << 9) * 2
    lib = _lib()
    assert lib.r4w_waveform_get_type(wf._h) == capi.WAVEFORM_LORA


def test_invalid_parameters_rejected():
    lib = _lib()
    assert not lib.r4w_waveform_lora_new(4, 125_000, 125_000.0)  # bad SF
    assert not lib.r4w_waveform_lora_new(7, 99_000, 99_000.0)  # bad BW
    assert not lib.r4w_waveform_lora_new(7, 125_000, 130_000.0)  # frac osf
    assert not lib.r4w_waveform_bpsk_new(-1.0, 100.0)
    assert not lib.r4w_chirp_new(13, 125_000, 1)
    assert not lib.r4w_ringbuffer_new(1)


def test_c_example_compiles_and_runs(tmp_path):
    """The REAL C-caller proof: compile examples/11_capi_demo.c with a
    C compiler against libr4w.so and run it — no Python in the loop
    (the reference ships the same kind of usage example,
    r4w-ffi/src/lib.rs:27-52)."""
    import os
    import shutil
    import subprocess

    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    so = os.path.join(os.path.dirname(capi._SO), "libr4w.so")
    assert os.path.exists(so)  # built by capi.available() in the gate
    exe = tmp_path / "capi_demo"
    subprocess.run(
        [cc, "-O2", "-o", str(exe),
         os.path.join(root, "examples", "11_capi_demo.c"),
         "-I", os.path.join(root, "r4w_tpu", "native"),
         "-L", os.path.dirname(so), "-lr4w", "-lm",
         f"-Wl,-rpath,{os.path.dirname(so)}"],
        check=True, capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
    assert 'demodulated: "hello from C"' in out.stdout
