"""Remaining infrastructure fills + named aliases.

Covers the last reference modules without a named counterpart here:

* IO plumbing — file_source_sink.rs, file_descriptor_source_sink.rs,
  tcp_source_sink.rs, socket_pdu.rs, stream_control.rs,
  signal_recorder_indexed.rs.
* Frequency hopping as standalone blocks — frequency_hopper.rs,
  frequency_hopping.rs, frequency_hopping_controller.rs (the FHSS
  waveform in waveforms/fhss.py is the full modem; these are the
  GNU-Radio-style hop-control blocks).
* speech_enhancement_beamforming.rs — delay-and-sum + spectral
  postfilter composition.
* simd_utils.rs — explicit batched complex kernels; on the device XLA
  vectorization is XLA's job, these exist so pipelines can name them.
* Named aliases (same math already shipped elsewhere):
  cross_ambiguity_function.rs → ops/ew.cross_ambiguity,
  fmcw_radar.rs → waveforms FMCW, iq_balance.rs →
  ops/impairments.iq_imbalance_correct, linear_equalizer.rs →
  ops/equalizers LMS, ml_sequence_detector.rs → ops/equalizers MLSE,
  noise_reduction.rs → ops/applied.spectral_subtraction,
  phase_noise_model.rs → ops/impairments.phase_noise,
  power_amplifier_dpd.rs → ops/impairments DPD,
  tapped_delay_line.rs → channel/tdl.TappedDelayLine role.
"""

from __future__ import annotations

import os
import socket
import struct

import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE

# ------------------------------------------------------------ file IO


def file_sink(path: str, x, mode: str = "wb"):
    """Raw sample file sink (file_source_sink.rs)."""
    arr = np.asarray(x)
    with open(path, mode) as f:
        arr.tofile(f)
    return arr.shape[0]


def file_source(path: str, dtype=np.complex64, count: int = -1,
                offset_items: int = 0):
    """Raw sample file source (file_source_sink.rs)."""
    dt = np.dtype(dtype)
    with open(path, "rb") as f:
        f.seek(offset_items * dt.itemsize)
        data = np.fromfile(f, dtype=dt, count=count)
    return jnp.asarray(data)


def fd_sink(fd: int, x):
    """File-descriptor sink (file_descriptor_source_sink.rs)."""
    data = np.asarray(x).tobytes()
    written = 0
    while written < len(data):
        written += os.write(fd, data[written:])
    return written


def fd_source(fd: int, n_items: int, dtype=np.complex64):
    """File-descriptor source (file_descriptor_source_sink.rs)."""
    dt = np.dtype(dtype)
    want = n_items * dt.itemsize
    chunks = []
    got = 0
    while got < want:
        b = os.read(fd, want - got)
        if not b:
            break
        chunks.append(b)
        got += len(b)
    return jnp.asarray(np.frombuffer(b"".join(chunks), dtype=dt))


class TcpSink:
    """Length-prefixed TCP sample sink (tcp_source_sink.rs)."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port), timeout=10)

    def send(self, x):
        data = np.asarray(x).astype(np.complex64).tobytes()
        self.sock.sendall(struct.pack(">I", len(data)) + data)

    def close(self):
        self.sock.close()


class TcpSource:
    """Accepting side of the TCP sample link (tcp_source_sink.rs)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.server = socket.socket()
        self.server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server.bind((host, port))
        self.server.listen(1)
        self.conn = None

    @property
    def port(self) -> int:
        return self.server.getsockname()[1]

    def accept(self):
        self.conn, _ = self.server.accept()

    def recv(self):
        hdr = self._recv_exact(4)
        n = struct.unpack(">I", hdr)[0]
        data = self._recv_exact(n)
        return jnp.asarray(np.frombuffer(data, np.complex64))

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            b = self.conn.recv(n - len(out))
            if not b:
                raise ConnectionError("peer closed")
            out += b
        return out

    def close(self):
        if self.conn:
            self.conn.close()
        self.server.close()


def socket_pdu_pair():
    """Connected UDP PDU socket pair (socket_pdu.rs): returns
    (send(bytes), recv()->bytes, close)."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    port = rx.getsockname()[1]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(data: bytes):
        tx.sendto(data, ("127.0.0.1", port))

    def recv() -> bytes:
        return rx.recvfrom(65536)[0]

    def close():
        tx.close()
        rx.close()

    return send, recv, close


class StreamControl:
    """Run/pause/single-step gate over a block pipeline
    (stream_control.rs)."""

    def __init__(self):
        self.state = "running"
        self._steps = 0

    def pause(self):
        self.state = "paused"

    def resume(self):
        self.state = "running"

    def single_step(self):
        self.state = "paused"
        self._steps += 1

    def process(self, x):
        if self.state == "running":
            return x
        if self._steps > 0:
            self._steps -= 1
            return x
        return jnp.asarray(x)[0:0]


class IndexedRecorder:
    """Indexed IQ recorder (signal_recorder_indexed.rs): appends
    blocks to a data file and keeps an in-memory (offset, n, meta)
    index for random access."""

    def __init__(self, path: str):
        self.path = path
        self.index: list[tuple[int, int, dict]] = []
        self._off = 0
        open(path, "wb").close()

    def record(self, x, **meta):
        arr = np.asarray(x).astype(np.complex64)
        with open(self.path, "ab") as f:
            arr.tofile(f)
        self.index.append((self._off, arr.shape[0], meta))
        self._off += arr.shape[0]
        return len(self.index) - 1

    def read(self, entry: int):
        off, n, meta = self.index[entry]
        dt = np.dtype(np.complex64)
        with open(self.path, "rb") as f:
            f.seek(off * dt.itemsize)
            data = np.fromfile(f, dtype=dt, count=n)
        return jnp.asarray(data), meta

    def find(self, **query):
        return [i for i, (_, _, m) in enumerate(self.index)
                if all(m.get(k) == v for k, v in query.items())]


# ----------------------------------------------------- frequency hop


def hop_pattern_lfsr(n_channels: int, n_hops: int, seed: int = 0x5A):
    """LFSR-driven pseudo-random hop pattern (frequency_hopper.rs):
    full-range, repeats only after the LFSR period."""
    from r4w_tpu.ops import spreading as _spreading
    bits_needed = max(1, int(np.ceil(np.log2(n_channels))))
    bits = np.asarray(_spreading.lfsr_bits(
        16, 0b1000000000010110, seed, n_hops * bits_needed))
    words = bits.reshape(n_hops, bits_needed)
    vals = words @ (1 << np.arange(bits_needed))
    return jnp.asarray(vals % n_channels, jnp.int32)


def hop_frequencies(pattern, base_hz: float, spacing_hz: float):
    """Channel index → RF frequency (frequency_hopping.rs)."""
    return base_hz + jnp.asarray(pattern, REAL_DTYPE) * spacing_hz


class FrequencyHoppingController:
    """Sample-indexed hop scheduling (frequency_hopping_controller.rs):
    dwell/guard timing and the channel active at any sample index —
    the deterministic (not wall-clock) form the batch design uses."""

    def __init__(self, pattern, dwell_samples: int,
                 guard_samples: int = 0):
        self.pattern = np.asarray(pattern)
        self.dwell = int(dwell_samples)
        self.guard = int(guard_samples)
        self.period = self.dwell + self.guard

    def channel_at(self, sample_idx):
        idx = np.asarray(sample_idx) // self.period
        return jnp.asarray(
            self.pattern[idx % self.pattern.shape[0]], jnp.int32)

    def in_guard(self, sample_idx):
        return jnp.asarray(
            (np.asarray(sample_idx) % self.period) >= self.dwell)

    def hop_boundaries(self, n_samples: int):
        return jnp.arange(0, n_samples, self.period)


# ----------------------------------------------- speech beamforming


def speech_enhance_beamform(mics, delays, fs: float,
                            noise_frames: int = 6):
    """Delay-and-sum + spectral-subtraction postfilter
    (speech_enhancement_beamforming.rs): array gain first, then the
    single-channel restoration pass."""
    from r4w_tpu.ops.beamforming import delay_and_sum
    from r4w_tpu.ops.audio import voice_restore
    das = delay_and_sum(jnp.asarray(mics, REAL_DTYPE), delays)
    return voice_restore(das, fs, noise_frames=noise_frames)


# -------------------------------------------------------------- DPD


def dpd_learn_polynomial(pa_in, pa_out, order: int = 5):
    """Indirect-learning digital predistortion
    (power_amplifier_dpd.rs / digital_predistortion.rs): fit the PA
    post-inverse y→x with an odd-order memoryless polynomial
    Σ c_k y|y|^{2k}; the same coefficients applied PRE-PA linearize
    the chain. Pure jnp (jit-safe); returns (coef, gain) as device
    scalars — the real-block LS is core.linalg.complex_lstsq."""
    from r4w_tpu.core.linalg import complex_lstsq

    x = jnp.asarray(pa_in, IQ_DTYPE)
    y = jnp.asarray(pa_out, IQ_DTYPE)
    # normalize the gain so the polynomial fits shape, not scale
    g = jnp.vdot(y, x) / jnp.vdot(y, y)
    y = y * g
    cols = [y * jnp.abs(y) ** (2 * k) for k in range((order + 1) // 2)]
    a = jnp.stack(cols, axis=-1)
    coef = complex_lstsq(a, x)
    return coef.astype(IQ_DTYPE), g


def dpd_apply(x, coef):
    """Apply the learned predistortion polynomial before the PA."""
    z = jnp.asarray(x, IQ_DTYPE)
    c = jnp.asarray(coef, IQ_DTYPE)
    out = jnp.zeros_like(z)
    for k in range(c.shape[0]):
        out = out + c[k] * z * jnp.abs(z) ** (2 * k)
    return out


# ----------------------------------------------------------- simd ops


def cmul(a, b):
    """Batched complex multiply (simd_utils.rs — on the device XLA
    vectorization is XLA's job; this exists so pipelines can name it)."""
    return jnp.asarray(a, IQ_DTYPE) * jnp.asarray(b, IQ_DTYPE)


def cmac(acc, a, b):
    """Complex multiply-accumulate (simd_utils.rs)."""
    return jnp.asarray(acc, IQ_DTYPE) + cmul(a, b)


def rotator_apply(x, phase_inc: float, phase0: float = 0.0):
    """Phase rotator (simd_utils.rs / rotator role): e^{j(φ0+nΔ)}·x."""
    from r4w_tpu.core.hostio import cis
    x = jnp.asarray(x, IQ_DTYPE)
    ph = phase0 + phase_inc * jnp.arange(x.shape[0], dtype=REAL_DTYPE)
    return x * cis(ph)


BLOCKS = {
    "file_sink": ("file_sink", "sink",
                  "raw sample file sink (file_source_sink.rs)"),
    "file_source": ("file_source", "source",
                    "raw sample file source (file_source_sink.rs)",
                    ("dtype", "count")),
    "fd_sink": ("fd_sink", "sink",
                "file-descriptor sink "
                "(file_descriptor_source_sink.rs)"),
    "fd_source": ("fd_source", "source",
                  "file-descriptor source "
                  "(file_descriptor_source_sink.rs)"),
    "tcp_sink": ("TcpSink", "sink",
                 "length-prefixed TCP sink (tcp_source_sink.rs)",
                 ("host", "port")),
    "tcp_source": ("TcpSource", "source",
                   "TCP sample source (tcp_source_sink.rs)", ("port",)),
    "socket_pdu": ("socket_pdu_pair", "source",
                   "UDP PDU socket pair (socket_pdu.rs)"),
    "stream_control": ("StreamControl", "math",
                       "run/pause/step gate (stream_control.rs)"),
    "signal_recorder_indexed": ("IndexedRecorder", "sink",
                                "indexed IQ recorder "
                                "(signal_recorder_indexed.rs)",
                                ("path",)),
    "frequency_hopper": ("hop_pattern_lfsr", "source",
                         "LFSR hop pattern (frequency_hopper.rs)",
                         ("n_channels", "n_hops")),
    "frequency_hopping": ("hop_frequencies", "math",
                          "channel -> RF map (frequency_hopping.rs)",
                          ("base_hz", "spacing_hz")),
    "frequency_hopping_controller": (
        "FrequencyHoppingController", "sync",
        "sample-indexed hop schedule "
        "(frequency_hopping_controller.rs)",
        ("dwell_samples", "guard_samples")),
    "speech_enhancement_beamforming": (
        "speech_enhance_beamform", "filter",
        "DAS + spectral postfilter "
        "(speech_enhancement_beamforming.rs)", ("fs",)),
    "dpd_learn": ("dpd_learn_polynomial", "filter",
                  "indirect-learning DPD fit "
                  "(power_amplifier_dpd.rs)", ("order",)),
    "dpd_apply": ("dpd_apply", "filter",
                  "apply predistortion polynomial "
                  "(digital_predistortion.rs)"),
    "simd_cmul": ("cmul", "math",
                  "batched complex multiply (simd_utils.rs)"),
    "simd_cmac": ("cmac", "math",
                  "complex multiply-accumulate (simd_utils.rs)"),
    "rotator": ("rotator_apply", "math",
                "phase rotator (simd_utils.rs rotator role)",
                ("phase_inc",)),
}


def alias_blocks():
    """Named aliases for capabilities shipped in other modules —
    registered so a reference user finds every block by its name.
    Returns name -> (factory, category, description)."""
    from r4w_tpu.ops import applied, equalizers, ew, impairments
    from r4w_tpu.channel import tdl as _tdl
    from r4w_tpu.waveforms import create_waveform
    return {
        "cross_ambiguity_function": (
            lambda **k: ew.cross_ambiguity, "radar",
            "CAF surface (cross_ambiguity_function.rs -> "
            "ops/ew.cross_ambiguity)"),
        "fmcw_radar": (
            lambda **k: create_waveform("fmcw",
                                        k.get("sample_rate", 1e6)),
            "radar",
            "FMCW waveform (fmcw_radar.rs -> create_waveform('fmcw'))"),
        "iq_balance": (
            lambda **k: impairments.iq_imbalance_correct, "filter",
            "IQ balance correction (iq_balance.rs -> "
            "impairments.iq_imbalance_correct)"),
        "linear_equalizer": (
            lambda **k: equalizers.lms_equalize, "filter",
            "adaptive linear equalizer (linear_equalizer.rs -> "
            "ops/equalizers.lms_equalize)"),
        "ml_sequence_detector": (
            lambda **k: equalizers.mlse_equalize, "demodulator",
            "MLSE (ml_sequence_detector.rs -> "
            "ops/equalizers.mlse_equalize)"),
        "noise_reduction": (
            lambda **k: applied.spectral_subtraction, "filter",
            "spectral subtraction (noise_reduction.rs -> "
            "ops/applied.spectral_subtraction)"),
        "phase_noise_model": (
            lambda **k: impairments.phase_noise, "channel",
            "Wiener phase noise (phase_noise_model.rs -> "
            "impairments.phase_noise)"),
        "power_amplifier_dpd": (
            lambda **k: (dpd_learn_polynomial, dpd_apply), "filter",
            "indirect-learning DPD (power_amplifier_dpd.rs / "
            "digital_predistortion.rs)"),
        "tapped_delay_line": (
            lambda **k: _tdl.tdl_channel, "channel",
            "TDL fading core (tapped_delay_line.rs -> "
            "channel/tdl.tdl_channel)"),
    }
