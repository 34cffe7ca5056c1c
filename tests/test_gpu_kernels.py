"""The CUDA kernels on a GPU (skipped elsewhere). Run on a card with:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernels.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from r4w_tpu.fec import convolutional as C

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU: JAX_PLATFORMS=cuda pytest -m gpu")
    from r4w_tpu.kernels import cuda

    cuda.load()
    return cuda


@pytest.mark.parametrize("k, polys", [(7, (0o171, 0o133)), (5, (0o23, 0o35)),
                                      (7, (0o133, 0o171, 0o165))])
def test_forward_and_traceback_kernels_match_reference(gpu, k, polys):
    rng = np.random.default_rng(k)
    rx = jnp.asarray(rng.standard_normal((37, 1000, len(polys))),
                     jnp.float32)
    code_of = C._code_table(k, polys)
    dec, final = gpu.viterbi_forward(rx, code_of)
    want_dec, want_final = C.viterbi_forward_ref(rx, code_of)
    np.testing.assert_array_equal(np.asarray(dec), np.asarray(want_dec))
    np.testing.assert_array_equal(np.asarray(final), np.asarray(want_final))
    half = code_of.shape[0] // 2
    start = jnp.asarray(rng.integers(0, 2 * half, 37), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(gpu.viterbi_traceback(dec, start, half)),
        np.asarray(C.viterbi_traceback_ref(want_dec, start, half)))


@pytest.mark.parametrize("shape", [(70,), (1, 70), (3, 5, 300), (130, 2053)])
def test_decode_on_gpu_matches_scan(gpu, shape):
    rng = np.random.default_rng(len(shape))
    bits = rng.integers(0, 2, shape)
    coded = np.asarray(C.conv_encode(jnp.asarray(bits)))
    soft = (1.0 - 2.0 * coded + 0.6 * rng.standard_normal(coded.shape)
            ).astype(np.float32)
    got = jax.jit(lambda s: C.viterbi_decode(s, soft=True))(soft)
    with jax.default_matmul_precision("highest"):
        want = C.viterbi_decode_scan(soft, soft=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if soft.ndim > 1:
        vm = jax.vmap(lambda s: C.viterbi_decode(s, soft=True))(soft)
        np.testing.assert_array_equal(np.asarray(vm), np.asarray(want))
