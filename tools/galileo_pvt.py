"""Galileo E1B IQ→PVT position-fix acceptance (signal-only receiver).

The Galileo twin of tools/gps_pvt_fix.py decoded-ephemeris mode: a
6-SV scenario overlays real I/NAV pages on the E1B data channels —
word types 1-4 carrying a Keplerian ephemeris whose decoded position
reproduces each configured SV, word 5 carrying GST WN/TOW
(gnss/inav_words.py) — behind one filler part so the loops settle
before the first ephemeris page. The receiver acquires every PRN from
the IQ (PCPS with sub-sample code bank), refines Doppler with a
squared-prompt FFT over open-loop epochs (data-modulated channel: the
E1C gate's coherent CS25 trick does not apply, but at this C/N0 the
squaring loss is negligible), pre-aligns code with a ±6-subchip
non-coherent sweep (BOC side-peak guard), closes the production
DLL/PLL (Costas — E1B symbols flip per 4 ms epoch), decodes I/NAV
pages from the prompt signs (sync + deinterleave + inverted-G2
Viterbi + CRC-24Q), assembles ephemeris from words 1-4 (IODnav
checked), forms FULL transmit times from decoded word-5 TOW + code
phase (inav.transmit_time_at_block — no supplied milliseconds),
computes satellite positions from the DECODED ephemeris, and solves.

E1B is simpler than GPS LNAV in exactly one way that shows here:
one symbol per code epoch means block index IS symbol index — no
20 ms bit-edge search.

Prints ONE JSON line with the position error in meters.

Run on the GPU:  timeout 1200 python tools/galileo_pvt.py
Reference role: none — the reference generates Galileo E1 signals
(crates/r4w-core/src/waveform/gnss/galileo_e1.rs, boc.rs) but has no
I/NAV word layer, no Galileo nav decode, and no PVT; this gate plus
gnss/inav.py + inav_words.py go beyond reference parity.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

FS = 5_115_000.0          # 5 samples/chip → 20460 samples per epoch
CHIP_RATE = 1_023_000.0
T_EP = 4092 / CHIP_RATE   # 4 ms code epoch = one E1B symbol
WN = 1100
GAL_SHELL_M = 29_600e3    # Galileo orbit radius (a ≈ 29 600 km)


def _geometry(n_sats=6, seed=1):
    """Receiver truth + satellites on the Galileo shell at random
    az/el (the gps_pvt_fix construction, Galileo radius)."""
    from r4w_tpu.gnss.coordinates import lla_to_ecef

    truth = np.asarray(lla_to_ecef(45.0, 7.0, 250.0))
    rng = np.random.default_rng(seed)
    up = truth / np.linalg.norm(truth)
    east = np.cross([0, 0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    sats = []
    for a, e in zip(rng.uniform(0, 2 * np.pi, n_sats),
                    rng.uniform(np.radians(25), np.radians(80),
                                n_sats)):
        los = (np.cos(e) * (np.sin(a) * east + np.cos(a) * north)
               + np.sin(e) * up)
        b = 2 * truth @ los
        c = truth @ truth - GAL_SHELL_M ** 2
        t = (-b + np.sqrt(b * b - 4 * c)) / 2
        sats.append(truth + t * los)
    return truth, np.asarray(sats)


def build_sv_nav_symbols(eph, prn: int, tow_word5: float) -> np.ndarray:
    """One SV's E1B symbol stream: a 250-symbol filler part (loop
    settle + odd grid offset exercise) then the five nominal pages for
    words 1-5. Symbol 0 transmits at tow_page1 − 1.0 s; word 5's page
    starts at symbol 250 + 4·500, transmitting at tow_word5."""
    from r4w_tpu.gnss import inav, inav_words

    words = inav_words.words_for_ephemeris(
        eph, iodnav=prn, svid=prn, wn=WN, tow_word5=tow_word5)
    rng = np.random.default_rng(1000 + prn)
    filler = rng.integers(0, 2, 250).astype(np.int32)
    pages = [inav.encode_page(d112, d16) for d112, d16 in words]
    return np.concatenate([filler] + pages)


def decode_sv_channel(prompt_i: np.ndarray, code_phase: np.ndarray,
                      phase0: float, m_star: int, prn: int,
                      code_len: float):
    """Host back end for one tracked channel: page sync + decode →
    word collection → ephemeris assembly (IODnav-checked) → transmit
    time at block m_star from decoded word-5 TOW. Returns
    (record, eph, t_tx); eph/t_tx None without words 1-5."""
    from r4w_tpu.gnss import inav, inav_words

    soft = np.sign(np.asarray(prompt_i, np.float64))
    pages = inav.decode_stream(soft)
    words: dict[int, dict] = {}
    w5_page = None
    for g in pages:
        if not g["crc_ok"]:
            continue
        w = inav_words.decode_word(g["data112"], g["data16"])
        if w["type"] not in words:
            words[w["type"]] = w
            if w["type"] == 5:
                w5_page = g
    rec = {"prn": prn, "pages_crc_ok": sum(g["crc_ok"] for g in pages),
           "pages_seen": len(pages), "words": sorted(words)}
    if not ({1, 2, 3, 4, 5} <= set(words)) or w5_page is None:
        return rec, None, None
    try:
        eph = inav_words.ephemeris_from_words(words, prn)
    except ValueError as e:
        rec["iodnav_error"] = str(e)
        return rec, None, None
    rec["iodnav"] = int(words[1]["iodnav"])
    rec["wn"] = int(words[5]["wn"])
    cp = np.concatenate([[phase0], np.asarray(code_phase, np.float64)])
    t_tx = inav.transmit_time_at_block(
        m_star, w5_page["sym_index"], words[5]["tow"],
        lambda m: cp[m], code_len, T_EP)
    t_tx -= eph.clock_bias(t_tx)  # unconditional receiver hygiene
    return rec, eph, t_tx


def e1b_receiver(rx, prns) -> dict:
    """Galileo E1B receiver front end on a device-resident capture at
    FS: PCPS acquisition (sub-sample CBOC bank) → open-loop Doppler
    refine (squared-prompt FFT — the data channel precludes the E1C
    gate's coherent CS25 trick, but at the gate C/N0 the squaring loss
    is negligible) → non-coherent ±6-subchip code sweep (BOC side-peak
    guard) → closed production Costas DLL/PLL over the full capture.
    Shared by the Galileo-only gate and tools/dual_pvt.py."""
    import jax
    import jax.numpy as jnp

    from r4w_tpu.gnss import acquisition, tracking
    from r4w_tpu.gnss import scenario as sc
    from r4w_tpu.gnss.scenario import SatelliteConfig

    code_len = 4092 * sc.SUBCHIP
    n_per = int(round(FS * T_EP))
    waves = [sc._spread_waveform(SatelliteConfig(signal="GalileoE1B",
                                                 prn=p)) for p in prns]
    t1 = time.time()
    codes = acquisition.sampled_code_bank(
        waves, CHIP_RATE * sc.SUBCHIP, FS, n_per, n_subphases=4)
    acq = acquisition.acquire(
        rx[: 12 * n_per], codes, prns, FS,
        acquisition.PcpsConfig(doppler_max_hz=400.0,
                               doppler_step_hz=50.0, threshold=1.5,
                               coherent_periods=8))
    acquire_s = time.time() - t1
    det = np.asarray(acq.detected)
    tau = np.asarray(acq.code_phase, np.float64)
    dop = np.asarray(acq.doppler_hz, np.float64)

    # --- open-loop refine: Doppler (squared-prompt FFT) + code sweep --
    t2 = time.time()
    scps = CHIP_RATE * sc.SUBCHIP / FS
    istart = np.floor(tau).astype(np.int32)
    frac = tau - istart
    phase0 = (code_len - frac * scps) % code_len

    common = dict(code_length=code_len, sample_rate=FS,
                  chipping_rate=CHIP_RATE * sc.SUBCHIP, el_spacing=2.0,
                  block_period=T_EP, carrier_hz=sc.GALILEO_E1_HZ)
    cfg_open = tracking.TrackingConfig(
        dll_bandwidth=0.0, pll_bandwidth=0.0, fll_gain=0.0, **common)
    bs = cfg_open.block_size
    codesj = jnp.asarray(np.stack([np.asarray(w, np.float32)
                                   for w in waves]))

    _runners: dict[int, object] = {}

    def open_pass(ph0v, dopv, n_ep):
        if n_ep not in _runners:  # one jit per window length
            _runners[n_ep] = jax.jit(jax.vmap(
                lambda s, cd, i0, x, n=n_ep: tracking.track(
                    cfg_open, s,
                    jax.lax.dynamic_slice(x, (i0,), (n * bs,)), cd),
                in_axes=(0, 0, 0, None)))
        s0 = tracking.init_state(cfg_open, ph0v.astype(np.float32),
                                 dopv.astype(np.float32))
        _, o = _runners[n_ep](s0, codesj, jnp.asarray(istart), rx)
        return (np.asarray(jax.device_get(o.prompt_i))
                + 1j * np.asarray(jax.device_get(o.prompt_q)))

    # squared-prompt Doppler: residual ≤ ±25 Hz (50 Hz grid) doubles
    # to ≤ ±50 Hz, safely inside the ±125 Hz squared-stream Nyquist
    b_ref = 64
    p_o = open_pass(phase0, dop, b_ref)
    nfft = 2048
    z = np.abs(np.fft.fft(p_o * p_o, nfft, axis=1))
    pk = np.argmax(z, axis=1)
    rows = np.arange(len(prns))
    s_m = z[rows, (pk - 1) % nfft]
    s_p = z[rows, (pk + 1) % nfft]
    s_0 = z[rows, pk]
    den = s_m - 2 * s_0 + s_p
    delta = np.clip(0.5 * (s_m - s_p)
                    / np.where(np.abs(den) < 1e-30, -1e-30, den),
                    -0.5, 0.5)
    bins = np.where(pk > nfft // 2, pk - nfft, pk) + delta
    dop_ref = dop + bins / (2.0 * nfft * T_EP)  # /2: squared stream

    # non-coherent ±6-subchip code sweep (BOC side-peak guard +
    # PCPS handover error, the e1c_tracking stage-0 pattern)
    cand = np.arange(-6.0, 7.0)
    mets = np.stack([
        np.mean(np.abs(open_pass((phase0 + off) % code_len, dop_ref,
                                 32)) ** 2, axis=1)
        for off in cand])
    k0 = np.clip(np.argmax(mets, axis=0), 1, len(cand) - 2)
    pm, p0_, pp = mets[k0 - 1, rows], mets[k0, rows], mets[k0 + 1, rows]
    den = pm - 2 * p0_ + pp
    d0 = np.clip(0.5 * (pm - pp)
                 / np.where(np.abs(den) < 1e-30, -1e-30, den),
                 -0.5, 0.5)
    phase_ref = (phase0 + cand[k0] + d0) % code_len

    # --- closed DLL/PLL over the full capture (Costas: data channel) --
    tcfg = tracking.TrackingConfig(
        dll_bandwidth=1.0, pll_bandwidth=10.0, fll_gain=0.0,
        costas=True, **common)
    n_keep = ((rx.shape[0] - int(istart.max())) // bs) * bs
    st0 = tracking.init_state(tcfg,
                              jnp.asarray(phase_ref, jnp.float32),
                              jnp.asarray(dop_ref, jnp.float32))
    run = jax.jit(jax.vmap(
        lambda s, cd, i0, x: tracking.track(
            tcfg, s, jax.lax.dynamic_slice(x, (i0,), (n_keep,)), cd),
        in_axes=(0, 0, 0, None)))
    _fin, outs = run(st0, codesj, jnp.asarray(istart), rx)
    prompt_i = np.asarray(jax.device_get(outs.prompt_i), np.float64)
    code_ph = np.asarray(jax.device_get(outs.code_phase), np.float64)
    cn0_est = float(np.median(np.asarray(
        jax.device_get(outs.cn0_dbhz))[:, -500:]))
    track_s = time.time() - t2
    carr_freq = np.asarray(jax.device_get(outs.carrier_freq),
                           np.float64)
    return {"det": det, "istart": istart, "bs": bs,
            "code_len": code_len, "phase_ref": phase_ref,
            "prompt_i": prompt_i, "code_ph": code_ph,
            "carr_freq": carr_freq, "cn0_est": cn0_est,
            "acquire_s": acquire_s, "track_s": track_s}


def main(cn0_dbhz: float = 48.0) -> dict:
    import jax

    from r4w_tpu.gnss import pvt
    from r4w_tpu.gnss.ephemeris import circular_ephemeris_for_position
    from r4w_tpu.gnss.scenario import (GnssScenario, ReceiverConfig,
                                       SatelliteConfig, ScenarioConfig)

    truth, sat_pos = _geometry()
    prns = list(range(1, len(sat_pos) + 1))
    ranges = np.linalg.norm(sat_pos - truth, axis=1)
    c = pvt.SPEED_OF_LIGHT

    # symbol 0 transmits at t0_sow; word-5 pages start 9 s later
    t0_sow = 345_600.0
    tow_w5 = t0_sow + (250 + 4 * 500) * T_EP
    duration_s = 11.2
    t_eval = t0_sow + duration_s - 0.3  # ≈ transmit epoch at m_star
    ephs = [circular_ephemeris_for_position(
        sat_pos[i], truth, t_eval, prn=p, toe_quantum=60.0)
        for i, p in enumerate(prns)]

    t0 = time.time()
    sats = tuple(
        SatelliteConfig(
            signal="GalileoE1B", prn=p, cn0_dbhz=cn0_dbhz,
            doppler_hz=0.0, range_m=float(ranges[i]), nav_data=True,
            nav_bits=tuple(int(v) for v in
                           1 - 2 * build_sv_nav_symbols(
                               ephs[i], p, tow_w5)))
        for i, p in enumerate(prns))
    cfg = ScenarioConfig(sample_rate=FS, duration_s=duration_s,
                         satellites=sats,
                         receiver=ReceiverConfig(lat_deg=45.0,
                                                 lon_deg=7.0),
                         seed=101)
    rx = GnssScenario(cfg).generate_device(duration_s)
    rx.block_until_ready()
    gen_s = time.time() - t0

    rcv = e1b_receiver(rx, prns)
    det = rcv["det"]
    acquire_s, track_s = rcv["acquire_s"], rcv["track_s"]
    istart, bs, code_len = rcv["istart"], rcv["bs"], rcv["code_len"]
    phase_ref, prompt_i = rcv["phase_ref"], rcv["prompt_i"]
    code_ph, cn0_est = rcv["code_ph"], rcv["cn0_est"]
    # --- nav decode + transmit times + solve (host) ------------------
    n_blocks = prompt_i.shape[1]
    m_star = n_blocks - 10
    recs, sat_ps, rhos, used = [], [], [], []
    for i, p in enumerate(prns):
        rec, eph_dec, t_tx = decode_sv_channel(
            prompt_i[i], code_ph[i, :-1], float(phase_ref[i]), m_star,
            p, code_len)
        recs.append(rec)
        if eph_dec is not None:
            t_rx = t0_sow + (istart[i] + m_star * bs) / FS
            sat_ps.append(np.asarray(eph_dec.position(t_tx)))
            rhos.append(c * (t_rx - t_tx))
            used.append(i)
    decoded = len(used)
    if decoded >= 4:
        sol = pvt.solve_position(np.stack(sat_ps), np.asarray(rhos))
        err = float(np.linalg.norm(np.asarray(sol.position_ecef)
                                   - truth))
        clock_bias = float(sol.clock_bias_m)
        max_resid = float(np.abs(np.asarray(sol.residuals_m)).max())
    else:
        err, clock_bias, max_resid = float("inf"), 0.0, float("inf")
    return {
        "metric": "galileo_pvt_error",
        "value": round(err, 1),
        "unit": "m",
        "mode": "decoded_ephemeris",
        "pass": bool(det.all() and decoded == len(prns)
                     and err < 60.0),
        "acquired": int(det.sum()),
        "decoded": decoded,
        "of": len(prns),
        "clock_bias_m": round(clock_bias, 1),
        "max_residual_m": round(max_resid, 1),
        "cn0_est_dbhz": round(cn0_est, 1),
        "per_sv": recs,
        "device": str(jax.devices()[0]),
        "gen_s": round(gen_s, 1),
        "acquire_s": round(acquire_s, 1),
        "track_s": round(track_s, 1),
    }


if __name__ == "__main__":
    print(json.dumps(main()))
