"""Stream plumbing & scalar-math blocks — GNU-Radio utility tail.

Re-designs of the reference's flat utility blocks (probe.rs,
probe_avg_mag_sqrd.rs, probe_power.rs, probe_rate.rs, probe_density.rs,
peak_detector.rs, peak_hold.rs, plateau_detector.rs, sample_and_hold.rs,
sample_counter.rs, integrate_and_dump.rs, integrate.rs, repeat.rs,
interleave.rs, permute.rs, keep_m_in_n.rs,
moving_avg_decim.rs, stretch.rs, mute.rs, power_squelch.rs,
envelope_detector.rs, random_source.rs, signal_source.rs,
signal_generator.rs, null_sink_source.rs, vector_sink.rs,
vector_insert.rs, throttle.rs / throttle_blk.rs, endian_swap.rs,
bitwise_ops.rs, numeric_conversions.rs, float_to_complex.rs,
magnitude_squared.rs, nlog10.rs, log_blk.rs, max_blk.rs,
exponentiate.rs, transcendental.rs, phase_ops.rs, phase_shift.rs,
phase_unwrap.rs, frequency_shift.rs, rf_mixer.rs, multiply_matrix.rs,
matrix_eigenvalue.rs, check_lfsr.rs, stream_switch.rs,
stream_to_streams.rs, stream_byte_converter.rs, sample_ops.rs).

Each block is a small pure batched function over whole sample blocks —
the batch-first equivalent of the reference's per-sample `process()`
loops. Stateful recursions (peak hold, envelope, squelch gating) use
``lax.scan`` with explicit carried state so long captures can be chained
block-to-block.
"""

from __future__ import annotations

import time

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.hostio import cis
from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE

# ------------------------------------------------------------- probes


def probe_avg_mag_sqrd(x, alpha: float = 0.0001, state: float = 0.0):
    """Single-pole IIR average of |x|^2 (probe_avg_mag_sqrd.rs).

    Returns (series, final) so the probe can be read mid-stream and
    chained across blocks via ``state``.
    """
    p = jnp.abs(jnp.asarray(x)) ** 2

    def step(avg, pt):
        avg = avg + alpha * (pt - avg)
        return avg, avg

    final, series = lax.scan(step, jnp.asarray(state, REAL_DTYPE),
                             p.astype(REAL_DTYPE))
    return series, final


def probe_power(x) -> jax.Array:
    """Mean power of a block (probe_power.rs)."""
    x = jnp.asarray(x)
    return jnp.mean(jnp.abs(x) ** 2).astype(REAL_DTYPE)


def probe_density(bits, alpha: float = 0.01, state: float = 0.5):
    """IIR-averaged density of ones in a bit stream (probe_density.rs)."""
    b = jnp.asarray(bits, REAL_DTYPE)

    def step(d, bt):
        d = d + alpha * (bt - d)
        return d, d

    final, series = lax.scan(step, jnp.asarray(state, REAL_DTYPE), b)
    return series, final


def probe_rate(n_items: int, t0: float, t1: float) -> float:
    """Items/second between two host timestamps (probe_rate.rs)."""
    dt = max(t1 - t0, 1e-12)
    return float(n_items) / dt


# ---------------------------------------------------- peaks & plateaus


def peak_detector(x, threshold: float = 0.0, look: int = 1):
    """Boolean mask of local maxima above ``threshold``
    (peak_detector.rs). A sample is a peak when it is >= its ``look``
    neighbours on both sides and above the threshold."""
    x = jnp.asarray(x, REAL_DTYPE)
    pad = jnp.pad(x, (look, look), constant_values=-jnp.inf)
    win = jnp.stack([pad[i:i + x.shape[0]] for i in range(2 * look + 1)])
    is_max = x >= jnp.max(win, axis=0)
    return is_max & (x > threshold)


def peak_hold(x, decay: float = 0.999, state: float = 0.0):
    """Peak hold with exponential decay (peak_hold.rs)."""
    mag = jnp.abs(jnp.asarray(x)).astype(REAL_DTYPE)

    def step(h, m):
        h = jnp.maximum(m, h * decay)
        return h, h

    final, series = lax.scan(step, jnp.asarray(state, REAL_DTYPE), mag)
    return series, final


def plateau_detector(gate, min_len: int = 8):
    """Mark the END of each run of >=min_len consecutive ones
    (plateau_detector.rs semantics: emit a single pulse per plateau)."""
    g = jnp.asarray(gate).astype(jnp.int32)

    def step(run, gt):
        run = (run + gt) * gt           # consecutive-ones counter
        return run, run

    _, runs = lax.scan(step, jnp.asarray(0, jnp.int32), g)
    ended = jnp.concatenate([runs[:-1] * (1 - g[1:]), runs[-1:]])
    return ended >= min_len


def sample_and_hold(x, ctrl):
    """Hold the most recent sample where ctrl==1 (sample_and_hold.rs).
    Vectorized: cummax over sampled indices, then gather."""
    x = jnp.asarray(x)
    c = jnp.asarray(ctrl).astype(bool)
    idx = jnp.where(c, jnp.arange(x.shape[0]), -1)
    held = lax.cummax(idx)
    return jnp.where(held >= 0, x[jnp.maximum(held, 0)], jnp.zeros_like(x[0]))


def sample_counter(x, state: int = 0):
    """Running sample count alongside the (pass-through) stream
    (sample_counter.rs)."""
    x = jnp.asarray(x)
    n = jnp.asarray(state, jnp.int32) + x.shape[0]
    return x, n


# --------------------------------------------------- rate manipulation


def integrate_and_dump(x, length: int):
    """Sum consecutive groups of ``length`` samples (integrate_and_dump.rs)."""
    x = jnp.asarray(x)
    n = (x.shape[0] // length) * length
    return jnp.sum(x[:n].reshape(-1, length), axis=-1)


def keep_m_in_n(x, m: int, n: int, offset: int = 0):
    """Keep m samples out of every n (keep_m_in_n.rs)."""
    x = jnp.asarray(x)
    k = (x.shape[0] // n) * n
    blocks = x[:k].reshape(-1, n)
    return blocks[:, offset:offset + m].reshape(-1)


def moving_avg_decim(x, length: int, decim: int = 1, scale: float = 1.0):
    """Moving average with built-in decimation (moving_avg_decim.rs)."""
    x = jnp.asarray(x)
    kern = jnp.ones((length,), REAL_DTYPE) * (scale / length)
    if jnp.iscomplexobj(x):
        y = lax.complex(
            jnp.convolve(x.real, kern, mode="full"),
            jnp.convolve(x.imag, kern, mode="full"))[:x.shape[0]]
        y = y.astype(IQ_DTYPE)
    else:
        y = jnp.convolve(x.astype(REAL_DTYPE), kern, mode="full")[:x.shape[0]]
    return y[::decim]


def stretch(x, lo: float):
    """Clamp-from-below: samples under ``lo`` are pulled up to it
    (stretch.rs — GR stretch_ff dynamic-range floor)."""
    return jnp.maximum(jnp.asarray(x, REAL_DTYPE), lo)


def mute(x, muted) -> jax.Array:
    """Zero the stream while muted (mute.rs). ``muted`` is a scalar or
    per-sample gate."""
    x = jnp.asarray(x)
    g = 1.0 - jnp.asarray(muted, REAL_DTYPE)
    return (x * g).astype(x.dtype)


def power_squelch(x, threshold_db: float, alpha: float = 0.01,
                  state: float = 0.0):
    """Gate the stream open while IIR-averaged power exceeds the
    threshold (power_squelch.rs)."""
    thr = 10.0 ** (threshold_db / 10.0)
    series, final = probe_avg_mag_sqrd(x, alpha=alpha, state=state)
    gate = (series > thr).astype(REAL_DTYPE)
    return (jnp.asarray(x) * gate).astype(jnp.asarray(x).dtype), final


def envelope_detector(x, attack: float = 0.2, release: float = 0.001,
                      state: float = 0.0):
    """Rectify + asymmetric one-pole smoothing (envelope_detector.rs)."""
    mag = jnp.abs(jnp.asarray(x)).astype(REAL_DTYPE)

    def step(env, m):
        a = jnp.where(m > env, attack, release)
        env = env + a * (m - env)
        return env, env

    final, series = lax.scan(step, jnp.asarray(state, REAL_DTYPE), mag)
    return series, final


# ------------------------------------------------------------ sources


def random_source(key, n: int, kind: str = "uniform_byte"):
    """Seeded random stream (random_source.rs)."""
    if kind == "uniform_byte":
        return jax.random.randint(key, (n,), 0, 256, jnp.int32)
    if kind == "uniform":
        return jax.random.uniform(key, (n,), REAL_DTYPE, -1.0, 1.0)
    if kind == "gaussian":
        return jax.random.normal(key, (n,), REAL_DTYPE)
    if kind == "bits":
        return jax.random.bernoulli(key, 0.5, (n,)).astype(jnp.int32)
    raise ValueError(f"unknown random source kind '{kind}'")


def signal_source(n: int, sample_rate: float, freq_hz: float,
                  waveform: str = "cos", amplitude: float = 1.0,
                  offset: float = 0.0, phase: float = 0.0):
    """Classic signal source (signal_source.rs / signal_generator.rs):
    cos/sin/complex exponential/square/triangle/sawtooth/const."""
    t = jnp.arange(n, dtype=REAL_DTYPE) / sample_rate
    arg = 2.0 * jnp.pi * freq_hz * t + phase
    frac = (arg / (2.0 * jnp.pi)) % 1.0
    if waveform == "cos":
        y = jnp.cos(arg)
    elif waveform == "sin":
        y = jnp.sin(arg)
    elif waveform in ("exp", "complex"):
        y = cis(arg)
    elif waveform == "square":
        y = jnp.where(frac < 0.5, 1.0, -1.0)
    elif waveform == "triangle":
        y = 4.0 * jnp.abs(frac - 0.5) - 1.0
    elif waveform == "sawtooth":
        y = 2.0 * frac - 1.0
    elif waveform == "const":
        y = jnp.ones((n,), REAL_DTYPE)
    else:
        raise ValueError(f"unknown waveform '{waveform}'")
    y = amplitude * y + offset
    return y.astype(IQ_DTYPE if waveform in ("exp", "complex") else REAL_DTYPE)


def signal_generator_sweep(n: int, sample_rate: float, f0_hz: float,
                           f1_hz: float, amplitude: float = 1.0):
    """Linear frequency sweep source (signal_generator.rs sweep mode)."""
    t = jnp.arange(n, dtype=REAL_DTYPE) / sample_rate
    k = (f1_hz - f0_hz) / (n / sample_rate)
    phase = 2.0 * jnp.pi * (f0_hz * t + 0.5 * k * t * t)
    return (amplitude * cis(phase)).astype(IQ_DTYPE)


def null_source(n: int, dtype=IQ_DTYPE):
    """All-zero source (null_sink_source.rs)."""
    return jnp.zeros((n,), dtype)


def null_sink(x) -> int:
    """Discard the stream; returns the number of items consumed
    (null_sink_source.rs)."""
    return int(jnp.asarray(x).shape[0])


class VectorSink:
    """Accumulate blocks to a host-side vector (vector_sink.rs)."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []

    def process(self, x):
        self._chunks.append(np.asarray(x))
        return x

    def data(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0,))
        return np.concatenate(self._chunks)

    def reset(self):
        self._chunks.clear()


def vector_insert(x, vec, period: int, offset: int = 0):
    """Insert ``vec`` into the stream every ``period`` input samples
    (vector_insert.rs)."""
    x = jnp.asarray(x)
    vec = jnp.asarray(vec, x.dtype)
    n = (x.shape[0] // period) * period
    blocks = x[:n].reshape(-1, period)
    vrep = jnp.broadcast_to(vec, (blocks.shape[0], vec.shape[0]))
    if offset == 0:
        out = jnp.concatenate([vrep, blocks], axis=1)
    else:
        out = jnp.concatenate(
            [blocks[:, :offset], vrep, blocks[:, offset:]], axis=1)
    return jnp.concatenate([out.reshape(-1), x[n:]])


class Throttle:
    """Host-side average-rate limiter (throttle.rs / throttle_blk.rs).
    Sleeps so that cumulative items/sec does not exceed the target."""

    def __init__(self, rate_items_per_sec: float):
        self.rate = float(rate_items_per_sec)
        self._t0: float | None = None
        self._items = 0

    def process(self, x):
        n = int(np.asarray(x).shape[0])
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        self._items += n
        due = self._t0 + self._items / self.rate
        if due > now:
            time.sleep(due - now)
        return x


# ----------------------------------------------------- scalar math ops


def magnitude_squared(x):
    """|x|^2 (magnitude_squared.rs)."""
    x = jnp.asarray(x)
    return (x.real * x.real + x.imag * x.imag).astype(REAL_DTYPE) \
        if jnp.iscomplexobj(x) else (x * x).astype(REAL_DTYPE)


def nlog10(x, n: float = 10.0, k: float = 0.0, floor: float = 1e-20):
    """n*log10(x)+k with a numerical floor (nlog10.rs)."""
    return (n * jnp.log10(jnp.maximum(jnp.asarray(x, REAL_DTYPE), floor))
            + k)


def log_block(x, base: float | None = None, floor: float = 1e-20):
    """Elementwise logarithm (log_blk.rs)."""
    y = jnp.log(jnp.maximum(jnp.asarray(x, REAL_DTYPE), floor))
    if base is not None:
        y = y / np.log(base)
    return y


def max_block(*xs):
    """Elementwise max across streams (max_blk.rs)."""
    out = jnp.asarray(xs[0], REAL_DTYPE)
    for x in xs[1:]:
        out = jnp.maximum(out, jnp.asarray(x, REAL_DTYPE))
    return out


def exponentiate(x, exponent: float):
    """x**k, preserving complex dtype (exponentiate.rs)."""
    x = jnp.asarray(x)
    return jnp.power(x, exponent)


_TRANSCENDENTAL = {
    "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan,
    "asin": jnp.arcsin, "acos": jnp.arccos, "atan": jnp.arctan,
    "sinh": jnp.sinh, "cosh": jnp.cosh, "tanh": jnp.tanh,
    "exp": jnp.exp, "log": jnp.log, "sqrt": jnp.sqrt,
}


def transcendental(x, name: str):
    """Apply a named transcendental function (transcendental.rs)."""
    try:
        fn = _TRANSCENDENTAL[name]
    except KeyError:
        raise ValueError(f"unknown transcendental '{name}'") from None
    return fn(jnp.asarray(x))


# -------------------------------------------------------- phase / mix


def phase_shift(x, phase_rad: float):
    """Constant phase rotation (phase_shift.rs / phase_ops.rs)."""
    return (jnp.asarray(x, IQ_DTYPE) * cis(jnp.asarray(phase_rad,
                                                       REAL_DTYPE)))


def phase_unwrap(phase):
    """Unwrap radian phase (phase_unwrap.rs) — branch-free cumulative
    correction."""
    p = jnp.asarray(phase, REAL_DTYPE)
    d = jnp.diff(p)
    jumps = jnp.round(d / (2.0 * jnp.pi))
    corr = jnp.concatenate([jnp.zeros((1,), REAL_DTYPE),
                            jnp.cumsum(jumps)])
    return p - 2.0 * jnp.pi * corr


def phase_wrap(phase):
    """Wrap to (-pi, pi] (phase_ops.rs)."""
    p = jnp.asarray(phase, REAL_DTYPE)
    return jnp.angle(cis(p))


def frequency_shift(x, shift_hz: float, sample_rate: float,
                    phase0: float = 0.0):
    """Mix by a complex exponential (frequency_shift.rs). Returns
    (shifted, next_phase) so blocks chain continuously."""
    x = jnp.asarray(x, IQ_DTYPE)
    n = x.shape[0]
    w = 2.0 * np.pi * shift_hz / sample_rate
    ph = phase0 + w * jnp.arange(n, dtype=REAL_DTYPE)
    nxt = (phase0 + w * n) % (2.0 * np.pi)
    return x * cis(ph), nxt


def rf_mixer(x, lo, mode: str = "complex"):
    """Mixer (rf_mixer.rs): complex multiply, or real mixing that
    produces sum+difference products."""
    x = jnp.asarray(x)
    lo = jnp.asarray(lo)
    if mode == "complex":
        return (x.astype(IQ_DTYPE) * lo.astype(IQ_DTYPE))
    if mode == "real":
        return (x.real * lo.real).astype(REAL_DTYPE)
    raise ValueError(f"unknown mixer mode '{mode}'")


# ---------------------------------------------------- vectors/matrices


def multiply_matrix(x, a):
    """Per-sample matrix multiply y = A @ x (multiply_matrix.rs).
    x: (..., K) stream of K-vectors, a: (M, K)."""
    return jnp.einsum("mk,...k->...m", jnp.asarray(a), jnp.asarray(x))


def matrix_eigenvalue(a, hermitian: bool = True, iters: int = 200):
    """Dominant eigenpair (matrix_eigenvalue.rs). Hermitian path uses
    eigh; general square matrices use power iteration."""
    a = jnp.asarray(a)
    if hermitian:
        w, v = jnp.linalg.eigh(a)
        return w[-1], v[:, -1]

    def step(v, _):
        v = a @ v
        return v / jnp.linalg.norm(v), None

    v0 = jnp.ones((a.shape[0],), a.dtype) / np.sqrt(a.shape[0])
    v, _ = lax.scan(step, v0, None, length=iters)
    lam = (jnp.conj(v) @ (a @ v)) / (jnp.conj(v) @ v)
    return lam, v


# ----------------------------------------------------------- bit utils


def endian_swap(words, word_bits: int = 16):
    """Byte-swap within words (endian_swap.rs)."""
    w = jnp.asarray(words, jnp.uint32)
    if word_bits == 16:
        return ((w & 0xFF) << 8) | ((w >> 8) & 0xFF)
    if word_bits == 32:
        return (((w & 0xFF) << 24) | ((w & 0xFF00) << 8)
                | ((w >> 8) & 0xFF00) | ((w >> 24) & 0xFF))
    raise ValueError("word_bits must be 16 or 32")


def bitwise_op(x, y, op: str):
    """Elementwise and/or/xor/not on integer streams (bitwise_ops.rs)."""
    x = jnp.asarray(x, jnp.int32)
    if op == "not":
        return ~x
    y = jnp.asarray(y, jnp.int32)
    if op == "and":
        return x & y
    if op == "or":
        return x | y
    if op == "xor":
        return x ^ y
    raise ValueError(f"unknown bitwise op '{op}'")


def short_to_float(x, scale: float = 32768.0):
    """i16 → f32 (numeric_conversions.rs)."""
    return jnp.asarray(x, REAL_DTYPE) / scale


def float_to_short(x, scale: float = 32768.0):
    return jnp.clip(jnp.asarray(x, REAL_DTYPE) * scale,
                    -32768, 32767).astype(jnp.int16)


def float_to_complex(re, im=None):
    """Two real streams → one complex stream (float_to_complex.rs)."""
    re = jnp.asarray(re, REAL_DTYPE)
    if im is None:
        im = jnp.zeros_like(re)
    return lax.complex(re, jnp.asarray(im, REAL_DTYPE)).astype(IQ_DTYPE)


def repack_bits(bits, k_in: int, k_out: int, msb_first: bool = True):
    """Repack k_in-bit symbols into k_out-bit symbols
    (stream_byte_converter.rs)."""
    b = jnp.asarray(bits, jnp.int32)
    if msb_first:
        shifts = jnp.arange(k_in - 1, -1, -1)
    else:
        shifts = jnp.arange(k_in)
    raw = ((b[:, None] >> shifts[None, :]) & 1).reshape(-1)
    n = (raw.shape[0] // k_out) * k_out
    groups = raw[:n].reshape(-1, k_out)
    if msb_first:
        weights = 1 << jnp.arange(k_out - 1, -1, -1)
    else:
        weights = 1 << jnp.arange(k_out)
    return jnp.sum(groups * weights[None, :], axis=-1)


def check_lfsr(bits, taps: int, nbits: int, sync_len: int = 64):
    """Self-synchronizing PRBS checker (check_lfsr.rs): seed the LFSR
    from the first ``nbits`` received bits, then count mismatches
    between predicted and received bits. Returns (errors, tested).

    jit-safe for register widths < 31 (int32 state in a lax.scan; the
    static tap mask unrolls to a fixed XOR chain); wider registers
    fall back to the host bigint path (jax x64 is disabled)."""
    if nbits >= 31:
        b = np.asarray(bits).astype(np.int64)
        state = 0
        for i in range(nbits):
            state = ((state << 1) | int(b[i])) & ((1 << nbits) - 1)
        errors = 0
        for i in range(nbits, len(b)):
            fb = bin(state & taps).count("1") & 1
            errors += int(fb != b[i])
            state = ((state << 1) | int(b[i])) & ((1 << nbits) - 1)
        return errors, len(b) - nbits

    b = jnp.asarray(bits).astype(jnp.int32)
    mask = (1 << nbits) - 1
    tap_pos = [p for p in range(nbits) if (taps >> p) & 1]

    def shift(state, bit):
        return ((state << 1) | bit) & mask

    def seed(state, bit):
        return shift(state, bit), None

    state0, _ = lax.scan(seed, jnp.asarray(0, jnp.int32), b[:nbits])

    def step(state, bit):
        fb = jnp.asarray(0, jnp.int32)
        for p in tap_pos:  # static taps: fixed XOR chain
            fb = fb ^ ((state >> p) & 1)
        err = (fb != bit).astype(jnp.int32)
        return shift(state, bit), err

    _, errs = lax.scan(step, state0, b[nbits:])
    return jnp.sum(errs), b.shape[0] - nbits


# ---------------------------------------------------- stream selection


def stream_switch(streams, select: int):
    """Select one of N streams (stream_switch.rs)."""
    stack = jnp.stack([jnp.asarray(s) for s in streams])
    return stack[select]


def stream_to_streams(x, n: int):
    """Deinterleave one stream into n (stream_to_streams.rs)."""
    x = jnp.asarray(x)
    k = (x.shape[0] // n) * n
    return x[:k].reshape(-1, n).T


def streams_to_stream(xs):
    """Interleave n streams into one (inverse of stream_to_streams)."""
    stack = jnp.stack([jnp.asarray(s) for s in xs])  # (n, L)
    return stack.T.reshape(-1)


# Registry table — consumed by r4w_tpu.registry._populate.
# name -> (attr, category, description, params)
BLOCKS = {
    "probe_avg_mag_sqrd": ("probe_avg_mag_sqrd", "measurement",
                           "IIR |x|^2 probe (probe_avg_mag_sqrd.rs)",
                           ("alpha",)),
    "probe_power": ("probe_power", "measurement",
                    "block mean power (probe_power.rs)"),
    "probe_density": ("probe_density", "measurement",
                      "IIR ones-density probe (probe_density.rs)",
                      ("alpha",)),
    "probe_rate": ("probe_rate", "measurement",
                   "items/sec between host timestamps (probe_rate.rs)"),
    "peak_detector": ("peak_detector", "measurement",
                      "local-maxima detector (peak_detector.rs)",
                      ("threshold", "look")),
    "peak_hold": ("peak_hold", "measurement",
                  "decaying peak hold (peak_hold.rs)", ("decay",)),
    "plateau_detector": ("plateau_detector", "measurement",
                         "plateau end pulses (plateau_detector.rs)",
                         ("min_len",)),
    "sample_and_hold": ("sample_and_hold", "math",
                        "gated sample & hold (sample_and_hold.rs)"),
    "sample_counter": ("sample_counter", "math",
                       "running item counter (sample_counter.rs)"),
    "integrate_and_dump": ("integrate_and_dump", "math",
                           "block integrate & dump (integrate_and_dump.rs)",
                           ("length",)),
    "keep_m_in_n": ("keep_m_in_n", "math",
                    "keep m of every n samples (keep_m_in_n.rs)",
                    ("m", "n", "offset")),
    "moving_avg_decim": ("moving_avg_decim", "filter",
                         "moving average + decimate (moving_avg_decim.rs)",
                         ("length", "decim")),
    "stretch": ("stretch", "math", "dynamic-range floor (stretch.rs)",
                ("lo",)),
    "mute": ("mute", "math", "stream mute gate (mute.rs)"),
    "power_squelch": ("power_squelch", "sync",
                      "power-gated squelch (power_squelch.rs)",
                      ("threshold_db", "alpha")),
    "envelope_detector": ("envelope_detector", "demodulator",
                          "attack/release envelope (envelope_detector.rs)",
                          ("attack", "release")),
    "random_source": ("random_source", "source",
                      "seeded random stream (random_source.rs)", ("kind",)),
    "signal_source": ("signal_source", "source",
                      "tone/square/triangle source (signal_source.rs)",
                      ("sample_rate", "freq_hz", "waveform")),
    "signal_generator_sweep": ("signal_generator_sweep", "source",
                               "linear sweep source (signal_generator.rs)",
                               ("f0_hz", "f1_hz")),
    "null_source": ("null_source", "source",
                    "all-zero source (null_sink_source.rs)"),
    "null_sink": ("null_sink", "sink",
                  "discard sink (null_sink_source.rs)"),
    "vector_sink": ("VectorSink", "sink",
                    "host-side accumulator (vector_sink.rs)"),
    "vector_insert": ("vector_insert", "math",
                      "periodic vector insertion (vector_insert.rs)",
                      ("period", "offset")),
    "throttle": ("Throttle", "sink",
                 "host rate limiter (throttle.rs)", ("rate",)),
    "magnitude_squared": ("magnitude_squared", "math",
                          "|x|^2 (magnitude_squared.rs)"),
    "nlog10": ("nlog10", "math", "n*log10(x)+k (nlog10.rs)", ("n", "k")),
    "log_block": ("log_block", "math", "elementwise log (log_blk.rs)"),
    "max_block": ("max_block", "math", "elementwise max (max_blk.rs)"),
    "exponentiate": ("exponentiate", "math", "x**k (exponentiate.rs)",
                     ("exponent",)),
    "transcendental": ("transcendental", "math",
                       "named transcendental fn (transcendental.rs)",
                       ("name",)),
    "phase_shift": ("phase_shift", "math",
                    "constant phase rotation (phase_shift.rs)",
                    ("phase_rad",)),
    "phase_unwrap": ("phase_unwrap", "math",
                     "phase unwrapping (phase_unwrap.rs)"),
    "phase_wrap": ("phase_wrap", "math", "wrap to (-pi,pi] (phase_ops.rs)"),
    "frequency_shift": ("frequency_shift", "math",
                        "complex mixer w/ carried phase "
                        "(frequency_shift.rs)",
                        ("shift_hz", "sample_rate")),
    "rf_mixer": ("rf_mixer", "math",
                 "complex/real mixer (rf_mixer.rs)", ("mode",)),
    "multiply_matrix": ("multiply_matrix", "math",
                        "per-sample matrix multiply (multiply_matrix.rs)"),
    "matrix_eigenvalue": ("matrix_eigenvalue", "math",
                          "dominant eigenpair (matrix_eigenvalue.rs)"),
    "endian_swap": ("endian_swap", "math",
                    "byte swap in words (endian_swap.rs)", ("word_bits",)),
    "bitwise_op": ("bitwise_op", "math",
                   "and/or/xor/not streams (bitwise_ops.rs)", ("op",)),
    "short_to_float": ("short_to_float", "math",
                       "i16 -> f32 (numeric_conversions.rs)"),
    "float_to_short": ("float_to_short", "math",
                       "f32 -> i16 (numeric_conversions.rs)"),
    "float_to_complex": ("float_to_complex", "math",
                         "re/im -> complex (float_to_complex.rs)"),
    "repack_bits": ("repack_bits", "math",
                    "k-bit -> l-bit repacking (stream_byte_converter.rs)",
                    ("k_in", "k_out")),
    "check_lfsr": ("check_lfsr", "measurement",
                   "self-sync PRBS checker (check_lfsr.rs)",
                   ("taps", "nbits")),
    "stream_switch": ("stream_switch", "math",
                      "N-way stream selector (stream_switch.rs)",
                      ("select",)),
    "stream_to_streams": ("stream_to_streams", "math",
                          "deinterleave 1->N (stream_to_streams.rs)",
                          ("n",)),
    "streams_to_stream": ("streams_to_stream", "math",
                          "interleave N->1 (stream_to_streams.rs)"),
}
