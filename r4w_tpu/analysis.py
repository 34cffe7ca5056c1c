"""Spectrum analysis (analysis/spectrum.rs re-design, ~1.5k LoC family).

SpectrumAnalyzer: windowed PSD with peak table, 3 dB bandwidth,
occupied bandwidth, ASCII/CSV/JSON rendering; Waterfall: STFT frame
stack with ASCII rendering (analysis/waterfall.rs + GUI streaming view).
Peak tables re-design analysis/peaks.rs; the summary statistics
(mean/RMS/crest/percentiles) re-design analysis/statistics.rs; the
family entry point is analysis/mod.rs.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from r4w_tpu.ops import measure


@dataclasses.dataclass
class SpectrumPeak:
    freq_hz: float
    power_db: float
    bin: int


@dataclasses.dataclass
class SpectrumResult:
    freqs_hz: np.ndarray
    psd_db: np.ndarray
    peaks: list[SpectrumPeak]
    total_power_db: float
    bandwidth_3db_hz: float
    occupied_bandwidth_hz: float  # 99% power

    def to_csv(self) -> str:
        lines = ["freq_hz,psd_db"]
        lines += [f"{f:.1f},{p:.2f}" for f, p in
                  zip(self.freqs_hz, self.psd_db)]
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "freqs_hz": self.freqs_hz.tolist(),
            "psd_db": self.psd_db.tolist(),
            "peaks": [dataclasses.asdict(p) for p in self.peaks],
            "total_power_db": self.total_power_db,
            "bandwidth_3db_hz": self.bandwidth_3db_hz,
            "occupied_bandwidth_hz": self.occupied_bandwidth_hz,
        })

    def to_ascii(self, width: int = 70, height: int = 14) -> str:
        n = len(self.psd_db)
        step = max(1, n // width)
        cols = [float(np.max(self.psd_db[i:i + step]))
                for i in range(0, n, step)][:width]
        lo = float(np.percentile(cols, 5))
        hi = max(cols)
        rng = max(hi - lo, 1e-9)
        rows = []
        for r in range(height, 0, -1):
            level = lo + rng * r / height
            rows.append("".join("#" if c >= level else " " for c in cols))
        axis = (f"{self.freqs_hz[0]/1e3:+.0f}k"
                + " " * (width - 12) + f"{self.freqs_hz[-1]/1e3:+.0f}k")
        return "\n".join(rows + [axis])


class SpectrumAnalyzer:
    """Windowed Welch PSD + measurements (analysis/spectrum.rs:324)."""

    def __init__(self, sample_rate: float, fft_size: int = 1024,
                 window: str = "hann", averages: int = 8):
        self.sample_rate = sample_rate
        self.fft_size = fft_size
        self.window = window
        self.averages = averages

    def compute(self, samples, n_peaks: int = 3) -> SpectrumResult:
        x = np.asarray(samples, np.complex64)
        psd = np.asarray(measure.welch_psd(
            x, nperseg=self.fft_size, window=self.window,
            sample_rate=self.sample_rate))
        psd_db = 10.0 * np.log10(np.maximum(psd, 1e-30))
        freqs = np.fft.fftshift(
            np.fft.fftfreq(self.fft_size, 1.0 / self.sample_rate))
        # peak table: local maxima sorted by power
        order = np.argsort(psd_db)[::-1]
        peaks = []
        taken: list[int] = []
        for idx in order:
            if len(peaks) >= n_peaks:
                break
            if any(abs(idx - t) < self.fft_size // 64 for t in taken):
                continue
            peaks.append(SpectrumPeak(float(freqs[idx]),
                                      float(psd_db[idx]), int(idx)))
            taken.append(idx)
        total_power = float(np.mean(np.abs(x) ** 2))
        # 3 dB bandwidth around the strongest peak
        pk = peaks[0].bin if peaks else int(np.argmax(psd_db))
        thresh = psd_db[pk] - 3.0
        above = psd_db >= thresh
        bw3 = float(above.sum()) * self.sample_rate / self.fft_size
        # 99% occupied bandwidth
        p_lin = psd / psd.sum()
        csum = np.cumsum(p_lin)
        lo_i = int(np.searchsorted(csum, 0.005))
        hi_i = int(np.searchsorted(csum, 0.995))
        occ = (hi_i - lo_i) * self.sample_rate / self.fft_size
        return SpectrumResult(
            freqs_hz=freqs, psd_db=psd_db, peaks=peaks,
            total_power_db=10 * np.log10(max(total_power, 1e-30)),
            bandwidth_3db_hz=bw3, occupied_bandwidth_hz=occ,
        )


class Waterfall:
    """STFT frame stack with ASCII rendering (GUI streaming/waterfall)."""

    CHARS = " .:-=+*#%@"

    def __init__(self, sample_rate: float, fft_size: int = 256,
                 hop: int | None = None):
        self.sample_rate = sample_rate
        self.fft_size = fft_size
        self.hop = hop or fft_size // 2

    def compute(self, samples) -> np.ndarray:
        """(frames, fft_size) power dB, DC-centered."""
        import jax.numpy as jnp

        from r4w_tpu.core.hostio import to_device

        x = to_device(np.asarray(samples, np.complex64))
        frames = measure.stft(x, self.fft_size, self.hop)
        # transfer |.|^2 (real): only the power leaves the device
        power = np.asarray(jnp.abs(frames) ** 2)
        power = np.fft.fftshift(power, axes=-1)
        return 10.0 * np.log10(np.maximum(power, 1e-30))

    def to_ascii(self, samples, max_rows: int = 24, width: int = 70) -> str:
        wf = self.compute(samples)
        if wf.shape[0] == 0:
            return "(no frames)"
        step_r = max(1, wf.shape[0] // max_rows)
        step_c = max(1, wf.shape[1] // width)
        img = wf[::step_r, ::step_c][:max_rows, :width]
        lo, hi = np.percentile(img, 5), img.max()
        rng = max(hi - lo, 1e-9)
        lines = []
        for row in img:
            q = np.clip((row - lo) / rng * (len(self.CHARS) - 1), 0,
                        len(self.CHARS) - 1).astype(int)
            lines.append("".join(self.CHARS[v] for v in q))
        return "\n".join(lines)
