"""Polyphase decimating FIR (strided window: only kept outputs are
computed) and the FIR lowering rule, against numpy float64."""

import numpy as np
import pytest

from r4w_tpu.ops import filters as F


@pytest.mark.parametrize("factor", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [31, 64])
def test_decimating_fir_matches_numpy(factor, k):
    rng = np.random.default_rng(factor * 100 + k)
    taps = rng.standard_normal(k).astype(np.float32)
    x = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)).astype(
        np.complex64)
    y, state = F.decimating_fir(taps, x, factor)
    want = np.convolve(x.astype(np.complex128), taps)[: x.size][::factor]
    assert np.asarray(y).shape == want.shape
    np.testing.assert_allclose(np.asarray(y), want, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(state), x[-(k - 1):])


@pytest.mark.parametrize("factor", [1, 3])
def test_decimating_fir_streams_in_blocks(factor):
    """Carrying the state across blocks equals one long call, when each
    block length is a multiple of the factor."""
    rng = np.random.default_rng(5)
    taps = rng.standard_normal(17).astype(np.float32)
    x = rng.standard_normal(6 * 99).astype(np.float32)
    whole, _ = F.decimating_fir(taps, x, factor)
    parts, state = [], None
    for blk in np.split(x, 6):
        y, state = F.decimating_fir(taps, blk, factor, state)
        parts.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(whole),
                               atol=1e-5)


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("dk, n, shift_add", [
    (0, F.SHIFT_ADD_MIN_SAMPLES, True),
    (1, F.SHIFT_ADD_MIN_SAMPLES, False),
    (0, F.SHIFT_ADD_MIN_SAMPLES - 1, False),
])
def test_fir_lowering_rule(platform, dk, n, shift_add):
    k = F.SHIFT_ADD_MAX_TAPS[platform] + dk
    assert F._use_shift_add(k, n, platform) is shift_add
    assert F._use_shift_add(2, 1 << 24, platform)


def test_fir_lowering_rule_defaults():
    """The default backend decides, and an untimed platform keeps the
    conv."""
    import jax

    k = F.SHIFT_ADD_MAX_TAPS[jax.default_backend()]
    assert F._use_shift_add(k, F.SHIFT_ADD_MIN_SAMPLES)
    assert not F._use_shift_add(2, 1 << 24, "untimed")


def test_fir_rule_counts_every_lane(monkeypatch):
    """Many short lanes that add up to a long input take the shift-add
    lowering, as one long stream would."""
    import jax.numpy as jnp

    seen = []
    monkeypatch.setattr(F, "_conv_valid_shift_add",
                        lambda x, t, s=1: seen.append(x.shape) or x)
    lanes = F.SHIFT_ADD_MIN_SAMPLES // 1024
    F._conv_valid(jnp.zeros((lanes, 1024 + 7)), jnp.ones(8))
    assert seen == [(lanes, 1024 + 7)]
    F._conv_valid(jnp.zeros((2, 1024 + 7)), jnp.ones(8))
    assert len(seen) == 1


@pytest.mark.parametrize("k, stride", [(17, 1), (64, 1), (64, 3), (33, 4)])
def test_shift_add_and_conv_lowerings_agree(k, stride):
    """The two lowerings behind the rule compute the same filter."""
    import jax.numpy as jnp

    rng = np.random.default_rng(k + stride)
    taps = jnp.asarray((rng.standard_normal(k) / k).astype(np.float32))
    x = jnp.asarray(rng.standard_normal((2, 2048)).astype(np.float32))
    shift = np.asarray(F._conv_valid_shift_add(x, taps, stride))
    conv = np.asarray(F._conv_valid(x, taps, stride))  # small n: conv
    want = np.stack([np.convolve(np.asarray(r, np.float64),
                                 np.asarray(taps))[k - 1:2048][::stride]
                     for r in np.asarray(x)])
    np.testing.assert_allclose(shift, want, atol=1e-5)
    np.testing.assert_allclose(conv, want, atol=1e-5)
