"""r4w_tpu — batch-first SDR/DSP waveform framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the r4w
("Rust for Waveforms") SDR platform: 46+ waveforms behind a common
``Waveform`` API, a GNU-Radio-style DSP op library, channel simulation,
FEC codecs, and a GNSS acquisition/tracking/scenario stack — all expressed
as pure, jit/vmap-composable functions over blocks of complex IQ samples
instead of streaming per-sample state machines.

Design stance (see SURVEY.md §7):
  * every op is ``f(params, state, x[block]) -> (state, y[block])``
  * channels take explicit ``jax.random.PRNGKey``s → thousands of
    Monte-Carlo lanes via ``vmap``/``shard_map``
  * waveforms are frozen-dataclass param structs + pure modulate/demodulate
  * hot kernels (dechirp-FFT-argmax, PCPS correlation, trellis ACS) are
    batched through XLA, with a hand-written CUDA kernel only where a
    card measurement shows XLA losing (kernels/).
"""

__version__ = "0.1.0"

from r4w_tpu.waveforms import WaveformFactory, list_waveforms, create_waveform

__all__ = [
    "WaveformFactory",
    "list_waveforms",
    "create_waveform",
    "__version__",
]
