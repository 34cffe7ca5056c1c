"""CUDA kernels called through JAX's foreign function interface.

The sources sit beside this module. `load()` compiles them with `nvcc`
for Hopper (`sm_90a`) into `build/` on first use, loads the library
and registers each handler as a CUDA custom call. The build happens
once per checkout; a stale library (older than its source) is rebuilt.

Where the environment variable R4W_CUDA_LIBRARY names a library, that
prebuilt file is loaded as it is and nvcc is never asked for: a
container image compiles it in its build stage with

    python -m r4w_tpu.kernels.cuda /path/to/libr4w_cuda.so

and ships it to a runtime that has no CUDA toolkit.

A CUDA kernel has no interpret mode: where no CUDA device is present,
callers run the plain JAX version of the same contract instead (see
`fec.convolutional.viterbi_forward_ref`). On a CUDA device a failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = (os.path.join(_DIR, "viterbi.cu"),)
BUILD_DIR = os.path.join(_DIR, "build")
LIBRARY = os.path.join(BUILD_DIR, "libr4w_cuda.so")

# custom-call target -> exported handler symbol
_TARGETS = {
    "r4w_viterbi_forward": "R4wViterbiForward",
    "r4w_viterbi_traceback": "R4wViterbiTraceback",
}

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_command(out: str) -> list[str]:
    """The nvcc command line that builds the kernel library into `out`."""
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", out, *_SOURCES]


def _stale(out: str) -> bool:
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(s) > built for s in _SOURCES)


def build(out: str = LIBRARY) -> str:
    """Compile the kernel library into `out` if it is missing or stale."""
    if not _stale(out):
        return out
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(build_command(tmp), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: concurrent builders never mix
    return out


def library_path() -> str:
    """The prebuilt library R4W_CUDA_LIBRARY names, else the checkout's
    own build (compiled here if missing or stale)."""
    prebuilt = os.environ.get("R4W_CUDA_LIBRARY")
    if not prebuilt:
        return build()
    if not os.path.isfile(prebuilt):
        raise RuntimeError(f"R4W_CUDA_LIBRARY={prebuilt} is not a file")
    return prebuilt


def load():
    """Build or find, load and register the CUDA kernels (once per
    process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(library_path())
            for target, symbol in _TARGETS.items():
                jax.ffi.register_ffi_target(
                    target, jax.ffi.pycapsule(getattr(lib, symbol)),
                    platform="CUDA")
            _lib = lib
    return _lib


def viterbi_forward(rx: jax.Array, code_of: np.ndarray):
    """Packed-decision Viterbi forward pass on the GPU.

    rx: (L, T, R) float32 soft values (+1 ~ bit 0); code_of: (S, 2)
    int32 codeword index per (state, input bit), S = 2^(K-1) <= 64.
    Returns decisions (L, T, 2) uint32 — bit s' of the 64-bit word
    (word 0 low) is 1 iff target state s' took predecessor 2m+1 — and
    the final path metrics (L, S) float32.
    """
    load()
    lead = rx.shape[:-1]
    s = int(code_of.shape[0])
    return jax.ffi.ffi_call(
        "r4w_viterbi_forward",
        (jax.ShapeDtypeStruct(lead + (2,), jnp.uint32),
         jax.ShapeDtypeStruct(rx.shape[:-2] + (s,), jnp.float32)),
        vmap_method="broadcast_all",
    )(rx, jnp.asarray(code_of, jnp.int32))


def viterbi_traceback(dec: jax.Array, start: jax.Array, half: int):
    """Per-frame traceback over packed decisions: dec (L, T, 2) uint32,
    start (L,) int32 -> input bits (L, T) int32."""
    load()
    return jax.ffi.ffi_call(
        "r4w_viterbi_traceback",
        jax.ShapeDtypeStruct(dec.shape[:-1], jnp.int32),
        vmap_method="broadcast_all",
    )(dec, start, half=np.int32(half))


if __name__ == "__main__":
    import sys

    print(build(*sys.argv[1:2]))
