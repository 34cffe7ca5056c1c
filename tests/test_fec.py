"""FEC stack tests: known answers, roundtrips, correction capability,
coded-BER sanity (SURVEY.md §7 step 5 gates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from r4w_tpu import fec


def test_conv_encode_known_rate():
    bits = jnp.asarray(np.random.default_rng(0).integers(0, 2, 50))
    coded = fec.conv_encode(bits)
    assert coded.shape[-1] == (50 + 6) * 2  # K=7 terminated, rate 1/2


def test_viterbi_corrects_errors():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 200)
    coded = np.asarray(fec.conv_encode(jnp.asarray(bits)))
    bad = coded.copy()
    bad[rng.choice(len(bad), 20, replace=False)] ^= 1
    dec = np.asarray(fec.viterbi_decode(jnp.asarray(bad)))
    assert np.array_equal(dec, bits)


def test_viterbi_soft_beats_hard():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 500)
    coded = np.asarray(fec.conv_encode(jnp.asarray(bits)))
    noisy = (1.0 - 2.0 * coded) + rng.normal(0, 0.9, len(coded))
    hard_in = (noisy < 0).astype(np.int32)
    dec_hard = np.asarray(fec.viterbi_decode(jnp.asarray(hard_in)))
    dec_soft = np.asarray(fec.viterbi_decode(
        jnp.asarray(noisy.astype(np.float32)), soft=True))
    errs_hard = int((dec_hard != bits).sum())
    errs_soft = int((dec_soft != bits).sum())
    assert errs_soft <= errs_hard


def test_viterbi_batched():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (4, 64))
    coded = np.asarray(fec.conv_encode(jnp.asarray(bits)))
    dec = np.asarray(fec.viterbi_decode(jnp.asarray(coded)))
    assert np.array_equal(dec, bits)


def test_puncture_depuncture():
    coded = jnp.arange(12)
    p = fec.puncture(coded, [1, 1, 0])  # drop every third
    assert p.shape[-1] == 8
    d = fec.depuncture(p.astype(jnp.float32), [1, 1, 0], 12, fill=-1.0)
    d = np.asarray(d)
    assert np.all(d[2::3] == -1.0)
    assert d[0] == 0 and d[1] == 1 and d[3] == 3


def test_crc16_ccitt_known_answer():
    # "123456789" -> 0x29B1 for CRC16/CCITT-FALSE
    data = jnp.asarray(list(b"123456789"))
    assert int(fec.crc_compute(data, "crc16-ccitt")) == 0x29B1


def test_crc32_known_answer():
    data = jnp.asarray(list(b"123456789"))
    assert int(fec.crc_compute(data, "crc32")) == 0xCBF43926


def test_crc_detects_corruption():
    data = np.frombuffer(b"hello world", np.uint8).astype(np.int32)
    c = int(fec.crc_compute(jnp.asarray(data), "crc16-ccitt"))
    bad = data.copy(); bad[3] ^= 0x40
    assert not bool(fec.crc_check(jnp.asarray(bad), c, "crc16-ccitt"))


def test_fletcher16():
    # Fletcher16("abcde") = 0xC8F0
    assert int(fec.fletcher16(jnp.asarray(list(b"abcde")))) == 0xC8F0


def test_repetition():
    bits = jnp.asarray([1, 0, 1, 1])
    enc = fec.repetition_encode(bits, 3)
    bad = enc.at[1].set(1).at[9].set(0)
    dec = fec.repetition_decode(bad, 3)
    assert np.array_equal(np.asarray(dec), [1, 0, 1, 1])


def test_golay_corrects_three_errors():
    rng = np.random.default_rng(4)
    data = jnp.asarray(rng.integers(0, 2, (10, 12)))
    cw = np.asarray(fec.golay_encode(data))
    for trial in range(10):
        bad = cw.copy()
        pos = rng.choice(24, 3, replace=False)
        bad[trial % 10, pos] ^= 1
        dec, ncorr = fec.golay_decode(jnp.asarray(bad))
        assert np.array_equal(np.asarray(dec), np.asarray(data))


def test_reed_solomon_full_t():
    rs = fec.ReedSolomon(255, 223)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 223)
    cw = rs.encode(data)
    bad = cw.copy()
    pos = rng.choice(255, 16, replace=False)
    bad[pos] ^= rng.integers(1, 256, 16)
    dec, n = rs.decode(bad)
    assert n == 16 and np.array_equal(dec, data)
    # beyond capability -> detected failure
    bad2 = cw.copy()
    pos2 = rng.choice(255, 20, replace=False)
    bad2[pos2] ^= rng.integers(1, 256, 20)
    _, n2 = rs.decode(bad2)
    assert n2 == -1


def test_bch_roundtrip_and_correction():
    for m, t in [(4, 2), (5, 3)]:
        bch = fec.BCH(m=m, t=t)
        rng = np.random.default_rng(m)
        d = rng.integers(0, 2, bch.k)
        c = bch.encode(d)
        bad = c.copy()
        bad[rng.choice(bch.n, t, replace=False)] ^= 1
        dec, n = bch.decode(bad)
        assert n == t and np.array_equal(dec, d)


def test_ldpc_corrects_awgn():
    hg = fec.make_regular_ldpc(96, 3, 6)
    _, _, k, _ = hg
    rng = np.random.default_rng(6)
    u = rng.integers(0, 2, (4, k))
    c = np.asarray(fec.ldpc_encode(jnp.asarray(u), hg))
    sigma = np.sqrt(1 / (2 * 10 ** (2.0 / 10)))
    y = (1 - 2.0 * c) + rng.normal(0, sigma, c.shape)
    llr = 2 * y / sigma**2
    hard, ok = fec.ldpc_decode(jnp.asarray(llr, jnp.float32), hg)
    assert np.all(np.asarray(ok))
    data = np.asarray(fec.ldpc_extract_data(hard, hg))
    assert np.array_equal(data, u)


def test_turbo_corrects_awgn():
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, 128)
    sys, p1, p2, pi = fec.turbo_encode(bits)
    sigma = np.sqrt(1 / (2 * 10 ** (0.0 / 10)))
    ch = lambda b: (1 - 2.0 * b) + rng.normal(0, sigma, len(b))
    lsys, lp1, lp2 = [2 * ch(x) / sigma**2 for x in (sys, p1, p2)]
    raw = int(((np.asarray(lsys) < 0).astype(int) != bits).sum())
    hard, _ = fec.turbo_decode(jnp.asarray(lsys, jnp.float32),
                               jnp.asarray(lp1, jnp.float32),
                               jnp.asarray(lp2, jnp.float32), pi)
    assert raw > 0
    assert int((np.asarray(hard) != bits).sum()) == 0


def test_polar_roundtrip_and_noise():
    n, k = 128, 64
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, k)
    cw = np.asarray(fec.polar_encode(jnp.asarray(bits), n, k))
    # clean decode
    llr = (1.0 - 2.0 * cw) * 10.0
    dec = fec.polar_decode(llr, n, k)
    assert np.array_equal(dec, bits)
    # mild noise (SC at short block length needs healthy SNR)
    sigma = np.sqrt(1 / (2 * 10 ** (6.0 / 10)))
    y = (1 - 2.0 * cw) + rng.normal(0, sigma, n)
    dec2 = fec.polar_decode(2 * y / sigma**2, n, k)
    assert int((dec2 != bits).sum()) == 0


def test_block_interleaver_roundtrip():
    x = jnp.arange(24)
    y = fec.block_interleave(x, 4, 6)
    assert not np.array_equal(np.asarray(y), np.asarray(x))
    z = fec.block_deinterleave(y, 4, 6)
    assert np.array_equal(np.asarray(z), np.asarray(x))


def test_patterned_interleaver_roundtrip():
    x = jnp.arange(20)
    pat = [3, 1, 4, 0, 2]
    y = fec.patterned_interleave(x, pat)
    z = fec.patterned_deinterleave(y, pat)
    assert np.array_equal(np.asarray(z), np.asarray(x))


def test_coded_ber_improves():
    """Conv-coded BPSK beats uncoded at the same Eb/N0 (coded-BER gate)."""
    rng = np.random.default_rng(9)
    n_bits = 2000
    bits = rng.integers(0, 2, n_bits)
    coded = np.asarray(fec.conv_encode(jnp.asarray(bits)))
    ebn0_db = 3.0
    # rate 1/2: Es/N0 = Eb/N0 - 3dB
    sigma_c = np.sqrt(1 / (2 * 10 ** ((ebn0_db - 3.0) / 10)))
    noisy = (1 - 2.0 * coded) + rng.normal(0, sigma_c, len(coded))
    dec = np.asarray(fec.viterbi_decode(
        jnp.asarray(noisy.astype(np.float32)), soft=True))
    coded_ber = (dec != bits).mean()
    sigma_u = np.sqrt(1 / (2 * 10 ** (ebn0_db / 10)))
    rx_u = (1 - 2.0 * bits) + rng.normal(0, sigma_u, n_bits)
    uncoded_ber = ((rx_u < 0).astype(int) != bits).mean()
    assert coded_ber < uncoded_ber


# ------------------------------------------------------------- TCM


def test_tcm_roundtrip_clean():
    from r4w_tpu.fec import tcm

    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 2000).astype(np.int32)
    idx, tx = tcm.tcm_encode(bits)
    assert idx.shape == (1002,)  # 1000 symbols + 2 flush
    assert np.allclose(np.abs(np.asarray(tx)), 1.0, atol=1e-5)  # 8PSK
    dec = np.asarray(tcm.tcm_decode(tx))
    assert (dec[:2000] == bits).all()


def test_tcm_subset_map_free_distance():
    """The shipped subset map must reach the parallel-transition bound
    d²free = 4.0 (the 3 dB set-partitioning gain over QPSK's 2.0)."""
    import heapq

    from r4w_tpu.fec import tcm

    nxt, out = tcm._trellis()
    m = tcm._SUBSET_MAP
    pts = np.exp(1j * np.pi * np.arange(8) / 4.0)

    def d2(a, b):
        return abs(pts[a] - pts[b]) ** 2

    best = 4.0  # parallel transitions
    for s0 in range(4):
        h = []
        for b1 in (0, 1):
            for b2 in (0, 1):
                if b1 != b2:
                    heapq.heappush(h, (d2(m[out[s0, b1]], m[out[s0, b2]]),
                                       nxt[s0, b1], nxt[s0, b2]))
        seen = {}
        while h:
            d, su, sv = heapq.heappop(h)
            if d >= best:
                break
            if su == sv:
                best = min(best, d)
                continue
            if seen.get((su, sv), 1e9) <= d:
                continue
            seen[(su, sv)] = d
            for bu in (0, 1):
                for bv in (0, 1):
                    dd = d + d2(m[out[su, bu]], m[out[sv, bv]])
                    if dd < best:
                        heapq.heappush(h, (dd, nxt[su, bu], nxt[sv, bv]))
    assert best >= 4.0 - 1e-9


def test_tcm_coding_gain_over_uncoded_qpsk():
    from r4w_tpu.fec import tcm

    tcm_ber, qpsk_ber = tcm.tcm_coding_gain_demo(5.0, 100_000, seed=2)
    # at 5 dB Eb/N0 the 4-state scheme sits well below uncoded QPSK
    assert tcm_ber < 0.5 * qpsk_ber, (tcm_ber, qpsk_ber)
    assert qpsk_ber > 1e-3  # sanity: baseline in its working region


def test_viterbi_mxu_bit_exact_vs_scan():
    """The packed-decision decoder (the CUDA kernels' contract, here in
    its plain-JAX form) is bit-exact against the scan decoder on noisy
    soft input, across batch shapes (viterbi_decoder.rs parity)."""
    import numpy as np

    from r4w_tpu.fec.convolutional import (conv_encode, viterbi_decode_packed,
                                           viterbi_decode_scan)

    rng = np.random.default_rng(7)
    for lanes, n_info in [(3, 250), (130, 505)]:
        bits = rng.integers(0, 2, (lanes, n_info))
        coded = np.asarray(conv_encode(jnp.asarray(bits)))
        soft = (1.0 - 2.0 * coded) + 0.4 * rng.standard_normal(coded.shape)
        ref = np.asarray(viterbi_decode_scan(jnp.asarray(soft), soft=True))
        got = np.asarray(viterbi_decode_packed(jnp.asarray(soft), soft=True))
        assert got.shape == (lanes, n_info)
        assert (got == ref).all()
        assert (got == bits).all()  # noise mild enough to fully correct


def test_viterbi_mxu_other_trellis_and_1d():
    import numpy as np

    from r4w_tpu.fec.convolutional import conv_encode, viterbi_decode_packed

    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, 180)
    coded = np.asarray(conv_encode(jnp.asarray(bits), 5, (0o23, 0o35)))
    got = np.asarray(viterbi_decode_packed(jnp.asarray(coded), 5,
                                           (0o23, 0o35)))
    assert got.shape == (180,)
    assert (got == bits).all()


@pytest.mark.slow
def test_viterbi_mxu_lane_count_beyond_one_block():
    """Many lanes (2100, not a power of two) decode bit-exactly through
    the packed-decision path."""
    import numpy as np

    from r4w_tpu.fec.convolutional import (conv_encode, viterbi_decode_packed,
                                           viterbi_decode_scan)

    rng = np.random.default_rng(11)
    lanes, n_info = 2100, 24
    bits = rng.integers(0, 2, (lanes, n_info))
    coded = np.asarray(conv_encode(jnp.asarray(bits), 5, (0o23, 0o35)))
    soft = (1.0 - 2.0 * coded) + 0.3 * rng.standard_normal(coded.shape)
    got = np.asarray(viterbi_decode_packed(jnp.asarray(soft), 5,
                                           (0o23, 0o35), soft=True))
    ref = np.asarray(viterbi_decode_scan(jnp.asarray(soft), 5, (0o23, 0o35),
                                         soft=True))
    assert got.shape == (lanes, n_info)
    assert (got == ref).all()
