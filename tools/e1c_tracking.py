"""Galileo E1C acquisition→tracking handoff acceptance gate.

Extends the e1c_gate acquisition north star into the receiver's next
stage: generate the reference's `e1c_8prn_60s_cn34_orbital.yaml`
scenario (8 SVs, orbital Doppler, C/N0 34 dB-Hz), acquire every PRN
with the production PCPS, then seed one DLL/PLL tracking channel per
PRN from the acquisition state and hold lock across the capture.
Prints ONE JSON line with `tracked: n/8` and per-PRN C/N0 estimates.

Design notes:
  - all 8 channels track concurrently via vmap over the lax.scan
    tracking loop (gnss/tracking.py) — one jit, batch axis = channel;
  - fine sync solves the E1C secondary-code phase and the Doppler
    residual JOINTLY and COHERENTLY: one open-loop pass collects B
    per-epoch prompts, then each of the 25 cyclic CS25 shifts is
    wiped and FFT'd across epochs — the (shift, bin) maximum carries
    the full γ·B coherent gain (+17 dB at C/N0 34) where the classic
    squared-prompt method pays ~7 dB squaring loss and was measured
    flipping to noise peaks, stranding channels with 30-50 Hz
    residuals no tracking loop can pull in;
  - code alignment is measured, not assumed: a ±6-subchip coherent
    overlay-wiped sweep with parabolic interpolation both
    resolves the BOC side-peak ambiguity ("bump jump") and lands the
    code phase to a fraction of a subchip — the PCPS handover alone
    was measured up to 4 subchips off, and channels false-locked on
    the −6 dB BOC(1,1) side peak;
  - the closed stage is a single PILOT pass: the known CS25 signs are
    wiped from the raw samples and the loop runs 16 ms coherent
    integrations with the full-quadrant (non-Costas) discriminator —
    4× update SNR, no squaring loss, no cycle slips;
  - tracked verdict per channel: CS25 alignment dominance (an unlocked
    channel cannot read the overlay), pilot-prompt lock indicator
    mean(I²−Q²)/mean(I²+Q²) > 0.5, and the lock-based C/N0 holding a
    lower bound relative to acquisition's own estimate.

Run on the GPU:  timeout 1800 python tools/e1c_tracking.py
Reference role: TrackingChannel::process handoff after PcpsAcquisition
(crates/r4w-core/src/waveform/gnss/tracking.rs:177-446,
 acquisition.rs:104).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

YAML = os.environ.get(
    "R4W_E1C_YAML", "/root/reference/e1c_8prn_60s_cn34_orbital.yaml")


def track_channels(rx, fs, prns, waves, acq, periods,
                   cn0_cfg_dbhz=34.0, e1b_waves=None, n_long=None):
    """Seed one tracking channel per PRN from acquisition and run all
    of them over the capture. Returns (per-PRN dicts, track wall s).

    With e1b_waves (the per-PRN E1B data-channel CBOC waveforms) and
    n_long (epochs of capture available), an additional LONG wiped
    pilot pass runs with the E1B code as the tracking loop's
    auxiliary correlator (tracking.py aux_code): 16 ms pilot blocks,
    four 4 ms E1B sub-prompts each. Returns
    (per, track_s, aux (P, n4) complex per-epoch E1B prompts already
    un-wiped of the CS25 input wipe) — the I/NAV receiver's symbol
    stream (VERDICT r4 #5)."""
    import jax
    import jax.numpy as jnp

    from r4w_tpu.gnss import scenario as sc
    from r4w_tpu.gnss import tracking

    def jnp_i32(a):
        return jnp.asarray(a, jnp.int32)

    code_len = 4092 * sc.SUBCHIP
    # Receiver handoff strategy (see module docstring): one open-loop
    # pass measures prompts; a joint (CS25-shift × Doppler) coherent
    # search and a coherent code sweep land sub-Hz / sub-subchip
    # seeds; the closed stage is a single overlay-wiped pilot loop.
    common = dict(
        code_length=code_len,
        sample_rate=fs,
        chipping_rate=sc.CHIP_RATE * sc.SUBCHIP,
        # E-L spacing in subchips: 2/12 chip keeps the discriminator on
        # the central CBOC correlation peak (a whole-chip spacing would
        # straddle the BOC(1,1) side peaks)
        el_spacing=2.0,
        block_period=4092 / sc.CHIP_RATE,  # one primary code epoch
        carrier_hz=sc.GALILEO_E1_HZ,
        costas=True,
    )
    cfg_open = tracking.TrackingConfig(
        dll_bandwidth=0.0, pll_bandwidth=0.0, fll_gain=0.0, **common)
    scps = cfg_open.chipping_rate / fs  # subchips per sample (nominal)
    tau = np.asarray(acq.code_phase, np.float64)  # samples to chip 0
    dop = np.asarray(acq.doppler_hz, np.float64)
    # Each channel's integration windows must align to ITS code-epoch
    # boundary: the E1C secondary code flips sign at epoch edges, and a
    # block straddling a flip partially cancels its own prompt (seen as
    # ~17 dB C/N0 loss + Costas lock failure). Start each channel at
    # floor(tau) samples and carry only the sub-sample remainder in the
    # initial code phase.
    istart = np.floor(tau).astype(np.int32)
    frac = tau - istart
    phase0 = (code_len - frac * scps) % code_len

    codes = np.stack([np.asarray(w, np.float32) for w in waves])
    bs = cfg_open.block_size
    n_blocks = periods - 1  # one epoch sacrificed to alignment
    n_keep = n_blocks * bs
    t_blk = cfg_open.block_period

    # rx is a jit ARGUMENT, not a closure constant (constants are
    # embedded in the compiled program)
    def _pass(cfg, keep=None):
        nk = n_keep if keep is None else keep

        def run(s, c, i0, x):
            seg = jax.lax.dynamic_slice(x, (i0,), (nk,))
            return tracking.track(cfg, s, seg, c)
        return jax.jit(jax.vmap(run, in_axes=(0, 0, 0, None)))

    def open_pass(ph0v, dopv):
        s0 = tracking.init_state(cfg_open, ph0v.astype(np.float32),
                                 dopv.astype(np.float32))
        _, o = _pass(cfg_open)(s0, codes, jnp_i32(istart), rx)
        p = (np.asarray(jax.device_get(o.prompt_i))
             + 1j * np.asarray(jax.device_get(o.prompt_q)))  # (P, B)
        return p, np.asarray(jax.device_get(o.dll_disc))

    t0 = time.time()
    # ---- fine sync: joint secondary-code × Doppler coherent search ----
    # One open-loop pass at the acquisition seeds collects B complex
    # prompts per channel. The Doppler residual and the CS25 overlay
    # phase are then solved JOINTLY: for each of the 25 cyclic shifts,
    # wipe the candidate sign pattern and FFT across epochs — the
    # (shift, bin) maximum is a fully COHERENT statistic (detection
    # SNR ≈ γ·B, +17 dB at C/N0 34), unlike the classic squared-prompt
    # method whose squaring loss (~7 dB at these block SNRs) was
    # measured flipping to noise peaks on 1-2 channels per run,
    # stranding them with 30-50 Hz residuals no 5 Hz loop can pull in.
    # Range ±125 Hz (the epoch rate) covers the PCPS half-bin (±62.5)
    # with margin.
    # Two rounds: the joint search needs a reasonably aligned code
    # phase to see the signal, and the code sweep needs the Doppler —
    # round 1 fixes the dominant error on every channel (measured: the
    # joint search nails 7/8 channels' quantization residuals to <1 Hz
    # even misaligned, while a channel handed over ~5 subchips off is
    # attenuated into a marginal search), round 2 re-measures both at
    # full coherent strength.
    dop_cur = dop.copy()
    phase_cur = phase0.copy()
    cand = np.arange(-6.0, 7.0)

    # Stage 0: NON-coherent code alignment at the handover Doppler.
    # The joint search needs prompts within ~2 subchips of the peak to
    # see the signal (measured: a 4.7-subchip handover error costs
    # ~7 dB per epoch and degenerates the search into noise); the
    # mean-power profile needs no Doppler or overlay knowledge at all,
    # so it goes first.
    mets0 = []
    for off in cand:
        p_o, _ = open_pass((phase_cur + off) % code_len, dop_cur)
        mets0.append(np.mean(np.abs(p_o) ** 2, axis=1))
    mets0 = np.stack(mets0)
    rows = np.arange(mets0.shape[1])
    k0 = np.clip(np.argmax(mets0, axis=0), 1, len(cand) - 2)
    pm, p0_, pp = mets0[k0 - 1, rows], mets0[k0, rows], mets0[k0 + 1, rows]
    den = pm - 2 * p0_ + pp  # negative at a true peak
    d0 = np.clip(0.5 * (pm - pp)
                 / np.where(np.abs(den) < 1e-30, -1e-30, den), -0.5, 0.5)
    phase_cur = (phase_cur + cand[k0] + d0) % code_len

    shifts = None
    for _round in range(2):
        p_a, _ = open_pass(phase_cur, dop_cur)
        b_ep = p_a.shape[1]
        if shifts is None:
            shifts = np.stack(
                [sc.E1C_SECONDARY[(np.arange(b_ep) + s) % 25]
                 for s in range(25)])  # (25, B)
        nfft = 1024
        z = np.abs(np.fft.fft(p_a[:, None, :] * shifts[None, :, :],
                              nfft, axis=2))  # (P, 25, nfft)
        rows = np.arange(z.shape[0])
        flat = z.reshape(z.shape[0], -1)
        idx = np.argmax(flat, axis=1)
        s_star = (idx // nfft).astype(np.int64)
        pk = idx % nfft
        # dominance: the winning shift peak over every other shift's
        # own best — an unlocked channel cannot prefer one CS25
        # alignment
        per_shift = z.max(axis=2)  # (P, 25)
        best_pk = per_shift[rows, s_star].copy()
        per_shift[rows, s_star] = 0.0
        sec_dom = best_pk / np.maximum(per_shift.max(axis=1), 1e-30)
        row = z[rows, s_star]  # (P, nfft)
        s_m, s_0, s_p = (row[rows, (pk - 1) % nfft], row[rows, pk],
                         row[rows, (pk + 1) % nfft])
        den = s_m - 2 * s_0 + s_p  # negative at a true peak
        delta = np.clip(0.5 * (s_m - s_p)
                        / np.where(np.abs(den) < 1e-30, -1e-30, den),
                        -0.5, 0.5)
        bins = np.where(pk > nfft // 2, pk - nfft, pk) + delta
        dop_cur = dop_cur + bins / (nfft * t_blk)  # nothing was squared
        signs_b = np.stack([shifts[s_star[i]] for i in rows])  # (P, B)

        # ---- code alignment: coherent ±6-subchip sweep ----------------
        # Resolves both the BOC(1,1) side-peak ambiguity (stable false
        # locks at ±0.5 chip = ±6 subchips, ~6 dB down — tracking.rs
        # never handles this; its tests are BPSK C/A) and the PCPS
        # handover error (measured up to 5 subchips). The metric is the
        # overlay-wiped coherent sum at the corrected Doppler (the
        # prompts are rotation-free there, so only the wipe applies);
        # parabolic interpolation lands the code phase to a fraction of
        # a subchip with no S-curve-slope assumption.
        mets = []
        for off in cand:
            p_o, _ = open_pass((phase_cur + off) % code_len, dop_cur)
            mets.append(np.abs(np.sum(p_o * signs_b, axis=1)))
        mets = np.stack(mets)  # (13, P)
        k = np.clip(np.argmax(mets, axis=0), 1, len(cand) - 2)
        pm, p0, pp = mets[k - 1, rows], mets[k, rows], mets[k + 1, rows]
        den = pm - 2 * p0 + pp  # negative at a true peak
        delta = np.clip(0.5 * (pm - pp)
                        / np.where(np.abs(den) < 1e-30, -1e-30, den),
                        -0.5, 0.5)
        jump = cand[k] + delta
        phase_cur = (phase_cur + jump) % code_len

    dop_ref = dop_cur
    phase0_ref = phase_cur
    dop_resid = dop_ref - dop
    jump = (phase_cur - phase0 + code_len / 2) % code_len - code_len / 2

    # carrier-phase seed measured at the final alignment: angle of the
    # wiped, derotated coherent sum of the first few epochs (includes
    # the overlay's global polarity, so the pilot loop starts at its
    # stable point)
    p_c, _ = open_pass(phase0_ref, dop_ref)
    w_c = p_c * signs_b  # measured at dop_ref: wipe only, no derotation
    ph_w = np.angle(w_c[:, :5].sum(axis=1)) / (2.0 * np.pi)

    # ---- pilot pass: input-wiped, 16 ms coherent, full-quadrant -------
    # At ~28-30 dB-Hz effective, a 4 ms Costas loop sits at σ_φ ≈
    # 0.4-0.5 rad per update and cycle-slips (observed: lock swinging
    # 0.27-0.56 across reruns). With the CS25 alignment known, wipe the
    # overlay from the raw samples and track as a clean pilot with
    # 4-epoch (16 ms) integrations: 4× update SNR, atan2 discriminator,
    # no squaring loss — the standard deep-integration payoff of a
    # pilot channel.
    n3 = (n_blocks // 4) * 4
    signs_full = signs_b[:, :n3].astype(np.float32)

    def _wiped_pass(cfg, n_ep):
        def run(s, c, i0, sg, x):
            seg = jax.lax.dynamic_slice(x, (i0,), (n_ep * bs,))
            seg = (seg.reshape(n_ep, bs) * sg[:, None]).reshape(-1)
            return tracking.track(cfg, s, seg, c)
        return jax.jit(jax.vmap(run, in_axes=(0, 0, 0, 0, None)))

    t_ep = 4092 / sc.CHIP_RATE
    cfg_w = tracking.TrackingConfig(
        dll_bandwidth=1.0, pll_bandwidth=4.0, fll_gain=0.0,
        code_length=code_len, sample_rate=fs,
        chipping_rate=sc.CHIP_RATE * sc.SUBCHIP, el_spacing=2.0,
        block_period=4 * t_ep, carrier_hz=sc.GALILEO_E1_HZ,
        costas=False)
    stw = tracking.init_state(cfg_w, phase0_ref.astype(np.float32),
                              dop_ref.astype(np.float32))
    stw = stw._replace(carrier_phase=jnp.asarray(
        ph_w.astype(np.float32), stw.carrier_phase.dtype))
    _, outw = _wiped_pass(cfg_w, n3)(
        stw, codes, jnp_i32(istart), jnp.asarray(signs_full), rx)
    piw = np.asarray(jax.device_get(outw.prompt_i))  # (P, n3/4)
    pqw = np.asarray(jax.device_get(outw.prompt_q))
    # residual code-offset diagnostic (mean pilot DLL disc, 2nd half)
    dllw = np.asarray(jax.device_get(outw.dll_disc))
    el_bias = np.mean(dllw[:, dllw.shape[1] // 2:], axis=1)

    # ---- optional LONG dual pass: E1B symbols off the pilot loop ----
    aux_epochs = None
    if e1b_waves is not None and n_long is not None:
        n4 = ((min(n_long, (rx.shape[0] - int(istart.max()))
                   // bs) - 1) // 4) * 4
        signs_long = np.stack(
            [sc.E1C_SECONDARY[(np.arange(n4) + s_star[i]) % 25]
             for i in range(len(prns))]).astype(np.float32)
        aux_codes = jnp.asarray(np.stack(
            [np.asarray(w, np.float32) for w in e1b_waves]))

        def _dual_pass(cfg, n_ep):
            def run(s, c, a, i0, sg, x):
                seg = jax.lax.dynamic_slice(x, (i0,), (n_ep * bs,))
                seg = (seg.reshape(n_ep, bs) * sg[:, None]).reshape(-1)
                return tracking.track(cfg, s, seg, c, aux_code=a,
                                      aux_per_block=4)
            return jax.jit(jax.vmap(run,
                                    in_axes=(0, 0, 0, 0, 0, None)))

        stl = tracking.init_state(cfg_w, phase0_ref.astype(np.float32),
                                  dop_ref.astype(np.float32))
        stl = stl._replace(carrier_phase=jnp.asarray(
            ph_w.astype(np.float32), stl.carrier_phase.dtype))
        _, outl = _dual_pass(cfg_w, n4)(
            stl, codes, aux_codes, jnp_i32(istart),
            jnp.asarray(signs_long), rx)
        ai = np.asarray(jax.device_get(outl.aux_i))  # (P, n4/4, 4)
        aq = np.asarray(jax.device_get(outl.aux_q))
        aux = (ai + 1j * aq).reshape(ai.shape[0], -1)  # (P, n4)
        # the CS25 input wipe modulated the data component too: undo
        aux_epochs = aux * signs_long[:, : aux.shape[1]]
    track_s = time.time() - t0

    if os.environ.get("R4W_E1C_DEBUG"):
        np.savez("/tmp/e1c_debug.npz",
                 p_a=p_a, w_c=w_c, piw=piw, pqw=pqw,
                 dop_resid=dop_resid, dop_ref=dop_ref,
                 jump=jump, phase0_ref=phase0_ref, mets=mets,
                 cfw=np.asarray(jax.device_get(outw.carrier_freq)),
                 cpw=np.asarray(jax.device_get(outw.code_phase)),
                 dllw=dllw)

    # metrics on the 16 ms pilot prompts (first block dropped: settle)
    k_ext = 4  # epochs per integration (for the C/N0 denominator)
    pe = (piw + 1j * pqw)[:, 1:]
    per = []
    for i, p in enumerate(prns):
        ii, qq = pe[i].real, pe[i].imag
        m = float(np.mean(ii * ii - qq * qq))
        tot = float(np.mean(ii * ii + qq * qq))
        lock = m / max(tot, 1e-30)
        # Lock-based C/N0 on the extended prompts: mean(I²−Q²)
        # estimates A², mean(I²+Q²)−A² estimates 2σ²;
        # C/N0 = (A²/2σ²)/(K·T).
        snr = max(m, 1e-12) / max(tot - m, 1e-12)
        cn0 = float(10.0 * np.log10(snr / (k_ext * t_blk)))
        # Reference C/N0 for the window: acquisition's own estimate —
        # it shares the nearest-subchip front-end quantization loss
        # (~3-4 dB at 5 MS/s), so tracking confirming it is the
        # self-consistent gate; the configured scenario C/N0 is
        # reported alongside for absolute comparison.
        acq_cn0 = float(np.asarray(acq.cn0_estimate)[i])
        ref = acq_cn0 if np.isfinite(acq_cn0) and acq_cn0 > 0 \
            else cn0_cfg_dbhz
        sec_ok = bool(sec_dom[i] > 1.3)
        # asymmetric window: the lower bound catches channels whose
        # signal quality COLLAPSED relative to acquisition; an estimate
        # moderately above acquisition's is evidence of strong lock
        # (the closed loop squelches in-band noise, biasing the
        # lock-based estimator HIGH at high C/N0 — measured +7 dB at
        # 42 dB-Hz with 11 pilot blocks). The generous +15 dB sanity
        # cap exists so a broken estimator cannot pass silently.
        tracked = bool(sec_ok and lock > 0.5
                       and -6.0 < cn0 - ref < 15.0)
        if cn0 - ref >= 15.0:
            print(f"# PRN {int(p)}: cn0 estimate {cn0:.1f} exceeds "
                  f"acquisition ref {ref:.1f} by >=15 dB — estimator "
                  f"suspect", file=sys.stderr)
        per.append({"prn": int(p), "detected": bool(
            np.asarray(acq.detected)[i]),
            "lock": round(lock, 3),
            "sec_dom": round(float(sec_dom[i]), 2),
            "sec_shift": int(s_star[i]),
            "dop_resid_hz": round(float(dop_resid[i]), 2),
            "boc_jump_subchips": float(jump[i]),
            "el_bias": round(float(el_bias[i]), 4),
            "cn0_est_dbhz": round(cn0, 1),
            "cn0_acq_dbhz": round(acq_cn0, 1),
            "tracked": tracked})
    if e1b_waves is not None:
        return per, track_s, aux_epochs
    return per, track_s


def e1b_inav_phase(cfg, periods: int = 50, duration_s: float = 4.35
                   ) -> dict:
    """E1B I/NAV data-channel decode at the gate's C/N0 (VERDICT r4
    #5): regenerate the scenario with BOTH E1 components per SV — the
    E1C pilots exactly as the gate, plus E1B data channels carrying
    real I/NAV pages (gnss/inav.py: sync + rate-1/2 inverted-G2 FEC +
    30×8 interleaver + CRC-24Q) — re-acquire/refine the pilots on the
    dual capture, run the long dual-channel pass (E1B symbols off the
    pilot NCO via tracking.py aux_code), and decode pages per SV.

    Reference: boc.rs:23-142 generates both components;
    satellite_emitter.rs:284-293 overlays data — nothing in the
    reference ever demodulates E1B; this closes that gap."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from r4w_tpu.gnss import acquisition, inav, scenario

    fs = cfg.sample_rate
    n_per = int(round(fs * 4092 / 1.023e6))
    t_ep = 4092 / scenario.CHIP_RATE
    n_long = int(duration_s / t_ep)

    t0 = time.time()
    rng = np.random.default_rng(77)
    sats = list(cfg.satellites)
    truth: dict[int, list] = {}
    e1b_sats = []
    for s in sats:
        pages, datas = [], []
        for _k in range(int(np.ceil(n_long / 500.0)) + 1):
            d112 = rng.integers(0, 2, 112)
            d16 = rng.integers(0, 2, 16)
            datas.append(d112)
            pages.append(inav.encode_page(d112, d16))
        truth[s.prn] = datas
        syms = np.concatenate(pages)
        e1b_sats.append(dataclasses.replace(
            s, signal="GalileoE1B", nav_data=True,
            nav_bits=tuple(int(v) for v in 1 - 2 * syms)))
    cfg2 = dataclasses.replace(
        cfg, satellites=tuple(sats) + tuple(e1b_sats))
    n_total = (n_long + 2) * n_per
    rx = scenario.GnssScenario(cfg2).generate_device(n_total / fs)
    rx = rx[:n_total]
    rx.block_until_ready()
    gen_s = time.time() - t0

    prns = [s.prn for s in sats]
    waves = [scenario._spread_waveform(
        scenario.SatelliteConfig(signal="GalileoE1C", prn=p))
        for p in prns]
    e1b_waves = [scenario._spread_waveform(
        scenario.SatelliteConfig(signal="GalileoE1B", prn=p))
        for p in prns]
    t1 = time.time()
    codes = acquisition.sampled_code_bank(
        waves, scenario.CHIP_RATE * scenario.SUBCHIP, fs, n_per,
        n_subphases=4)
    acq = acquisition.acquire(
        rx[: periods * n_per], codes, prns, fs,
        acquisition.PcpsConfig(doppler_max_hz=5000.0,
                               doppler_step_hz=125.0, threshold=1.0,
                               coherent_periods=periods))
    acquire_s = time.time() - t1

    _per, trk_s, aux = track_channels(
        rx, fs, prns, waves, acq, periods,
        cn0_cfg_dbhz=float(sats[0].cn0_dbhz or 34.0),
        e1b_waves=e1b_waves, n_long=n_long)

    per_sv = []
    svs_ok = 0
    for i, p in enumerate(prns):
        a = aux[i]
        # constant E1B-vs-pilot phase (independent emitter phases in
        # the scenario): squaring estimate, data-invariant
        phi = 0.5 * np.angle(np.mean(a * a))
        soft = (a * np.exp(-1j * phi)).real
        soft = soft / (np.mean(np.abs(soft)) + 1e-12)
        pages = inav.decode_stream(soft)
        n_ok = sum(1 for g in pages if g["crc_ok"])
        want = {tuple(d.tolist()) for d in truth[p]}
        n_match = sum(1 for g in pages if g["crc_ok"]
                      and tuple(g["data112"].tolist()) in want)
        if n_ok >= 1 and n_match == n_ok:
            svs_ok += 1
        per_sv.append({"prn": int(p), "pages_crc_ok": n_ok,
                       "pages_data_match": n_match,
                       "pages_seen": len(pages)})
    return {
        "svs_pages_ok": svs_ok, "of": len(prns),
        "pass": bool(svs_ok >= min(6, len(prns))),
        "per_sv": per_sv,
        "epochs": n_long,
        "gen_s": round(gen_s, 1),
        "acquire_s": round(acquire_s, 1),
        "track_s": round(trk_s, 1),
    }


def main(periods: int = 50, yaml_path: str = YAML) -> dict:
    import jax

    from tools.e1c_common import e1c_capture

    if not os.path.exists(yaml_path):
        return {"metric": "e1c_tracked", "value": None,
                "skipped": f"scenario YAML not found: {yaml_path} "
                           "(set R4W_E1C_YAML)"}
    # generation + acquisition shared with the acquisition gate
    # (memoized per process — bench.py runs both gates in one child)
    cfg, rx, all_prns, n_present, all_waves, acq_all, timings = \
        e1c_capture(yaml_path, periods)
    fs = cfg.sample_rate
    gen_s, acquire_s = timings["gen_s"], timings["acquire_s"]

    # track only the PRESENT PRNs (the absent false-alarm controls
    # have nothing to track); slice the acquisition rows accordingly
    prns = all_prns[:n_present]
    waves = all_waves[:n_present]
    acq = type(acq_all)(*[np.asarray(f)[:n_present]
                          for f in acq_all])

    per, track_s = track_channels(
        rx, fs, prns, waves, acq, periods,
        cn0_cfg_dbhz=float(cfg.satellites[0].cn0_dbhz))
    n_tracked = sum(1 for r in per if r["tracked"])
    cn0s = [r["cn0_est_dbhz"] for r in per if r["tracked"]]
    # E1B I/NAV data-channel phase (VERDICT r4 #5) — its own dual
    # capture so the flagship pilot-only gate numbers stay comparable
    # across rounds; R4W_E1B=0 skips it (budget-constrained runs)
    e1b = None
    if os.environ.get("R4W_E1B", "1") != "0":
        try:
            e1b = e1b_inav_phase(cfg, periods)
        except Exception as e:  # noqa: BLE001 — report, don't fail gate
            e1b = {"error": f"{type(e).__name__}: {e}"[:160]}
    return {
        "metric": "e1c_tracked",
        "value": n_tracked,
        "of": len(prns),
        "acquired": int(np.asarray(acq.detected).sum()),
        "cn0_mean_dbhz": round(float(np.mean(cn0s)), 1) if cn0s else None,
        "device": str(jax.devices()[0]),
        "periods": periods,
        "gen_s": round(gen_s, 1),
        "acquire_s": round(acquire_s, 1),
        "track_s": round(track_s, 1),
        "per_prn": per,
        "e1b": e1b,
    }


if __name__ == "__main__":
    periods = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    print(json.dumps(main(periods)))
