"""Accelerator backend seam (fpga_accel.rs / r4w-fpga re-design:
r4w-fpga/src/error.rs, zynq/mod.rs + zynq/mmap.rs + zynq/uio.rs +
zynq/dma.rs + zynq/registers.rs, lattice/mod.rs + lattice/spi.rs +
lattice/ftdi.rs — the /dev/mem, UIO and FTDI/SPI host drivers whose
offload role the JAX device fills; register-map semantics are not
ported, per SURVEY §2.8).

The reference exposes an `FpgaAccelerator` trait (r4w-fpga
traits.rs:26) with fft/fir/chirp-correlate offload entry points and
three backends (sim / zynq / lattice). Here the accelerator IS JAX's
default compute device, so the trait maps to a thin Backend protocol
with two implementations:

* ``JaxAccelerator`` — offload = jit-compiled jnp on whatever device
  jax selected (the GPU in production, CPU in tests). This is the
  analogue of the reference's real-hardware backends.
* ``SimulatedAccelerator`` — pure numpy, mirroring r4w-fpga's
  `sim` backend (a software model used when no device exists), and
  doubling as the cross-check oracle.

Capability discovery mirrors traits.rs (supports_fft/fir/correlate +
max sizes).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np


@dataclasses.dataclass(frozen=True)
class AcceleratorCapabilities:
    """Discovery record (traits.rs DeviceCapabilities role)."""
    name: str
    max_fft: int
    supports_fft: bool = True
    supports_fir: bool = True
    supports_chirp_correlate: bool = True


class Accelerator(Protocol):
    """FpgaAccelerator-trait analogue."""

    def capabilities(self) -> AcceleratorCapabilities: ...

    def fft(self, x): ...

    def fir(self, x, taps): ...

    def chirp_correlate(self, x, chirp): ...


class JaxAccelerator:
    """The XLA backend — jit-compiled offload paths."""

    def __init__(self):
        import jax
        import jax.numpy as jnp

        self._fft = jax.jit(jnp.fft.fft)

        def _fir(x, taps):
            n = x.shape[-1] + taps.shape[-1] - 1
            nfft = 1 << (int(n) - 1).bit_length()
            return jnp.fft.ifft(
                jnp.fft.fft(x, nfft) * jnp.fft.fft(taps, nfft))[..., :n]

        def _chirp_corr(x, chirp):
            n = x.shape[-1]
            nfft = 1 << (2 * int(n) - 1).bit_length()
            c = jnp.fft.ifft(jnp.fft.fft(x, nfft)
                             * jnp.conj(jnp.fft.fft(chirp, nfft)))
            return c[..., :n]

        self._fir_fn = jax.jit(_fir)
        self._corr_fn = jax.jit(_chirp_corr)
        self._platform = jax.devices()[0].platform

    def capabilities(self) -> AcceleratorCapabilities:
        return AcceleratorCapabilities(
            name=f"jax-{self._platform}", max_fft=1 << 24)

    def fft(self, x):
        import jax.numpy as jnp
        return self._fft(jnp.asarray(x, jnp.complex64))

    def fir(self, x, taps):
        import jax.numpy as jnp
        return self._fir_fn(jnp.asarray(x, jnp.complex64),
                            jnp.asarray(taps, jnp.complex64))

    def chirp_correlate(self, x, chirp):
        import jax.numpy as jnp
        return self._corr_fn(jnp.asarray(x, jnp.complex64),
                             jnp.asarray(chirp, jnp.complex64))


class SimulatedAccelerator:
    """Software model (r4w-fpga sim/mod.rs role): numpy reference."""

    def capabilities(self) -> AcceleratorCapabilities:
        return AcceleratorCapabilities(name="sim", max_fft=1 << 20)

    def fft(self, x):
        return np.fft.fft(np.asarray(x, np.complex64))

    def fir(self, x, taps):
        return np.convolve(np.asarray(x, np.complex64),
                           np.asarray(taps, np.complex64))

    def chirp_correlate(self, x, chirp):
        x = np.asarray(x, np.complex64)
        c = np.asarray(chirp, np.complex64)
        n = x.shape[-1]
        nfft = 1 << (2 * n - 1).bit_length()
        out = np.fft.ifft(np.fft.fft(x, nfft)
                          * np.conj(np.fft.fft(c, nfft)))
        return out[:n]


def create_accelerator(backend: str = "jax") -> Accelerator:
    """Factory (r4w-fpga lib.rs:33-45 backend selection)."""
    if backend == "jax":
        return JaxAccelerator()
    if backend == "sim":
        return SimulatedAccelerator()
    raise ValueError(f"unknown accelerator backend '{backend}'")
