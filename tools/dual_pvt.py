"""Dual-constellation (GPS L1 C/A + Galileo E1B) IQ→PVT from ONE
capture — the combined flagship of the two signal-only receivers.

One scenario synthesizes a single IQ stream at 5.115 MS/s carrying
5 GPS satellites (real ephemeris-bearing LNAV, tools/gps_pvt_fix.py
conventions) AND 5 Galileo satellites (real ephemeris-bearing I/NAV
words 1-5, tools/galileo_pvt.py conventions) over the same receiver,
on a shared GPS/GST time base (bit/symbol 0 of every SV transmits at
t0_sow; the simulated GGTO is zero, but the two front ends carry
different receiver-chain group delays, so the joint solve estimates
an inter-system bias state — exactly as a live dual-constellation
receiver handles GGTO + ISB).

The receiver runs both production front ends on the SAME samples —
L1CA PCPS + Costas DLL/PLL (1 ms blocks) and E1B sub-sample-bank PCPS
+ squared-prompt Doppler refine + BOC code sweep + Costas DLL/PLL
(4 ms blocks) — decodes LNAV subframes 1-3 and I/NAV words 1-5,
forms all ten transmit times from DECODED TOW (no supplied
milliseconds, no truth positions), and solves three fixes from the
same observables: GPS-only, Galileo-only, and the joint
10-satellite solution — plus the velocity/clock-drift solve from the
tracked carrier Dopplers against decoded-ephemeris satellite
velocities (the receiver is static, so the solved speed is the
end-to-end Doppler error budget).

Prints ONE JSON line. Run on the GPU:
  timeout 1800 python tools/dual_pvt.py
Reference role: none — the reference has no nav decode and no PVT
for either constellation (SURVEY §2.4); multi-constellation fusion is
beyond even this repo's single-constellation gates.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

FS = 5_115_000.0  # 5 samples/chip: integer per GPS ms AND E1 epoch
CHIP_RATE = 1_023_000.0
GPS_SHELL_M = 26_560e3
GAL_SHELL_M = 29_600e3


def _geometry(n_gps=5, n_gal=5):
    """One receiver truth; a deterministic well-conditioned sky: each
    constellation's azimuths evenly spread with the two constellations
    interleaved (Galileo offset half a slot), elevations alternating
    low/high. A random draw here once produced a one-quadrant cluster
    with GDOP 128 that turned 17 m pseudorange noise into a 1.1 km
    fix — geometry is part of the gate's spec, not luck."""
    from r4w_tpu.gnss.coordinates import lla_to_ecef

    truth = np.asarray(lla_to_ecef(45.0, 7.0, 250.0))
    up = truth / np.linalg.norm(truth)
    east = np.cross([0, 0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)

    def shell(n, radius, az0_deg, els_deg):
        out = []
        for i in range(n):
            a = np.radians(az0_deg + i * 360.0 / n)
            e = np.radians(els_deg[i % len(els_deg)])
            los = (np.cos(e) * (np.sin(a) * east + np.cos(a) * north)
                   + np.sin(e) * up)
            b = 2 * truth @ los
            c = truth @ truth - radius ** 2
            t = (-b + np.sqrt(b * b - 4 * c)) / 2
            out.append(truth + t * los)
        return np.asarray(out)

    gps = shell(n_gps, GPS_SHELL_M, 0.0, [62.0, 28.0, 47.0, 25.0, 55.0])
    gal = shell(n_gal, GAL_SHELL_M, 180.0 / max(n_gal, 1),
                [33.0, 58.0, 26.0, 50.0, 40.0])
    return truth, gps, gal


def main(cn0_dbhz: float = 48.0, duration_s: float = 24.3) -> dict:
    import jax

    from r4w_tpu.gnss import nav_message as nm
    from r4w_tpu.gnss import pvt
    from r4w_tpu.gnss.ephemeris import circular_ephemeris_for_position
    from r4w_tpu.gnss.scenario import (GnssScenario, ReceiverConfig,
                                       SatelliteConfig, ScenarioConfig)
    from tools import galileo_pvt as gal
    from tools import gps_pvt_fix as gps

    truth, gps_pos, gal_pos = _geometry()
    gps_prns = list(range(1, len(gps_pos) + 1))
    gal_prns = list(range(1, len(gal_pos) + 1))
    c = pvt.SPEED_OF_LIGHT

    # Distinct per-SV range rates (=> Doppler spread): ten satellites
    # at ZERO relative Doppler is the C/A multi-access worst case —
    # the -24 dB cross-correlations are STATIC and bias each DLL by
    # tens of meters (measured ±25 m GPS pseudorange spread in the
    # all-zero-Doppler run); with >=100 Hz relative Doppler the MAI
    # rotates far above the loop bandwidth and averages out. Rates
    # stay inside the acquisition searches (GPS ±500 Hz, E1B ±400 Hz;
    # 5.255 Hz per m/s at L1).
    gps_rdot = [-90.0, -45.0, 0.0, 40.0, 85.0]
    gal_rdot = [-70.0, -30.0, 15.0, 50.0, 75.0]

    # shared time base: every SV's nav bit/symbol 0 transmits at t0_sow
    tow_sf4 = 57_600
    t0_sow = nm.subframe_start_sow(tow_sf4)
    tow_w5 = t0_sow + (250 + 4 * 500) * gal.T_EP
    t_eval = t0_sow + duration_s - 0.3
    t_el_eval = t_eval - t0_sow

    gps_ephs = [circular_ephemeris_for_position(
        gps.eval_pos(gps_pos[i], truth, gps_rdot[i], t_el_eval), truth,
        t_eval, prn=p, range_rate_mps=gps_rdot[i])
        for i, p in enumerate(gps_prns)]
    gal_ephs = [circular_ephemeris_for_position(
        gps.eval_pos(gal_pos[i], truth, gal_rdot[i], t_el_eval), truth,
        t_eval, prn=p, toe_quantum=60.0, range_rate_mps=gal_rdot[i])
        for i, p in enumerate(gal_prns)]

    t0 = time.time()
    sats = tuple(
        SatelliteConfig(
            signal="GpsL1Ca", prn=p, cn0_dbhz=cn0_dbhz, doppler_hz=0.0,
            range_m=float(np.linalg.norm(gps_pos[i] - truth)),
            range_rate_mps=gps_rdot[i],
            nav_data=True,
            nav_bits=tuple(int(v) for v in
                           1 - 2 * gps.build_sv_nav_bits(gps_ephs[i],
                                                         tow_sf4)))
        for i, p in enumerate(gps_prns)) + tuple(
        SatelliteConfig(
            signal="GalileoE1B", prn=p, cn0_dbhz=cn0_dbhz,
            doppler_hz=0.0,
            range_m=float(np.linalg.norm(gal_pos[i] - truth)),
            range_rate_mps=gal_rdot[i],
            nav_data=True,
            nav_bits=tuple(int(v) for v in
                           1 - 2 * gal.build_sv_nav_symbols(
                               gal_ephs[i], p, tow_w5)))
        for i, p in enumerate(gal_prns))
    cfg = ScenarioConfig(sample_rate=FS, duration_s=duration_s,
                         satellites=sats,
                         receiver=ReceiverConfig(lat_deg=45.0,
                                                 lon_deg=7.0),
                         seed=202)
    rx = GnssScenario(cfg).generate_device(duration_s)
    rx.block_until_ready()
    gen_s = time.time() - t0

    # --- both production front ends on the SAME samples --------------
    gr = gps.l1ca_receiver(rx, gps_prns, fs=FS)
    er = gal.e1b_receiver(rx, gal_prns)

    # --- decode + transmit times per channel (host) -------------------
    def _truth_range(pos0, rdot, t_tx):
        return gps.range_at_tx(pos0, truth, rdot, t_tx - t0_sow)

    recs, cons, sat_ps, truth_ps, rhos = [], [], [], [], []
    sat_vs, rrs = [], []
    lam = c / 1_575_420_000.0  # L1/E1 carrier wavelength

    def _channel(front, i, sys_name, pos0, rdot, decode):
        rec, eph_dec, t_tx = decode()
        rec["sys"] = sys_name
        recs.append(rec)
        if eph_dec is None:
            return
        m = front["prompt_i"].shape[1] - 10
        t_rx = t0_sow + (front["istart"][i] + m * front["bs"]) / FS
        sat_ps.append(np.asarray(eph_dec.position(t_tx)))
        rhos.append(c * (t_rx - t_tx))
        rec["rho_err_m"] = round(
            rhos[-1] - _truth_range(pos0, rdot, t_tx), 1)
        los = pos0 - truth
        truth_ps.append(truth + _truth_range(pos0, rdot, t_tx)
                        * los / np.linalg.norm(los))
        # velocity observables: tracked carrier Doppler (median of the
        # last ~2 s of blocks) -> geometric range rate; satellite
        # velocity from the decoded ephemeris (central difference)
        n2s = max(1, int(round(2.0 * FS / front["bs"])))  # blocks in 2 s
        dop_meas = float(np.median(front["carr_freq"][i, max(0, m - n2s):m]))
        rrs.append(-dop_meas * lam)
        sat_vs.append((np.asarray(eph_dec.position(t_tx + 0.5))
                       - np.asarray(eph_dec.position(t_tx - 0.5))))
        rec["rr_err_mps"] = round(rrs[-1] - rdot, 2)
        cons.append(sys_name)

    m_g = gr["prompt_i"].shape[1] - 10
    for i, p in enumerate(gps_prns):
        _channel(gr, i, "gps", gps_pos[i], gps_rdot[i],
                 lambda i=i, p=p: gps.decode_sv_channel(
                     gr["prompt_i"][i], gr["code_ph"][i, :-1],
                     float(gr["phase0"][i]), m_g, p))
    m_e = er["prompt_i"].shape[1] - 10
    for i, p in enumerate(gal_prns):
        _channel(er, i, "gal", gal_pos[i], gal_rdot[i],
                 lambda i=i, p=p: gal.decode_sv_channel(
                     er["prompt_i"][i], er["code_ph"][i, :-1],
                     float(er["phase_ref"][i]), m_e, p,
                     er["code_len"]))

    cons = np.asarray(cons)
    sat_ps = np.stack(sat_ps) if len(sat_ps) else np.zeros((0, 3))
    truth_ps = (np.stack(truth_ps) if len(truth_ps)
                else np.zeros((0, 3)))
    rhos = np.asarray(rhos)
    sat_vs = np.stack(sat_vs) if len(sat_vs) else np.zeros((0, 3))
    rrs = np.asarray(rrs)

    def _solve(mask):
        if int(mask.sum()) < 4:
            return None
        sol = pvt.solve_position(sat_ps[mask], rhos[mask])
        return {
            "error_m": round(float(np.linalg.norm(
                np.asarray(sol.position_ecef) - truth)), 1),
            "n_sats": int(mask.sum()),
            "clock_bias_m": round(float(sol.clock_bias_m), 1),
            "gdop": round(sol.gdop, 1),
            "max_residual_m": round(float(np.abs(
                np.asarray(sol.residuals_m)).max()), 1),
        }

    # joint fix: 3 position states + one clock state per system — the
    # two front ends carry different receiver-chain group delays, so a
    # single shared bias would alias the ~hundred-metre inter-system
    # offset into position (measured before ISB: +133 m GPS vs +7 m
    # Galileo common biases)
    joint = None
    velocity = None
    if len(cons) >= 5 and len(set(cons.tolist())) == 2:
        sol = pvt.solve_position_multi(sat_ps, rhos, cons.tolist())
        # velocity/clock-drift solve from the tracked carrier Doppler:
        # the receiver is static, so the solved velocity magnitude IS
        # the end-to-end Doppler-chain error budget
        vsol = pvt.solve_velocity(sol, sat_ps, sat_vs, rrs)
        speed = float(np.linalg.norm(np.asarray(vsol.velocity_ecef)))
        velocity = {
            "speed_mps": round(speed, 3),
            "clock_drift_mps": round(float(vsol.clock_drift_mps), 3),
            "pass": bool(speed < 1.0),
        }
        joint = {
            "error_m": round(float(np.linalg.norm(
                np.asarray(sol.position_ecef) - truth)), 1),
            "n_sats": len(cons),
            "gdop": round(sol.gdop, 1),
            "isb_m": round(sol.system_biases_m["gps"]
                           - sol.system_biases_m["gal"], 1),
            "system_biases_m": {kk: round(vv, 1) for kk, vv in
                                sol.system_biases_m.items()},
            "max_residual_m": round(float(np.abs(
                np.asarray(sol.residuals_m)).max()), 1),
        }
    elif len(cons) >= 4:
        joint = _solve(np.ones(len(cons), bool))
    gps_only = _solve(cons == "gps")
    gal_only = _solve(cons == "gal")

    # control: same rhos against TRUTH satellite positions (on the
    # truth range trajectory at each decoded t_tx) — separates
    # decoded-ephemeris position error from pseudorange error
    ctrl = None
    if len(rhos) >= 5 and len(set(cons.tolist())) == 2:
        sol = pvt.solve_position_multi(truth_ps, rhos, cons.tolist())
        ctrl = {"error_m": round(float(np.linalg.norm(
            np.asarray(sol.position_ecef) - truth)), 1),
            "system_biases_m": {kk: round(vv, 1) for kk, vv in
                                sol.system_biases_m.items()}}

    decoded = len(cons)
    n_total = len(gps_prns) + len(gal_prns)
    err = joint["error_m"] if joint else float("inf")
    return {
        "metric": "dual_pvt_error",
        "value": err,
        "unit": "m",
        "mode": "decoded_ephemeris_joint",
        "pass": bool(decoded == n_total and joint is not None
                     and err < 60.0),
        "acquired": int(gr["det"].sum() + er["det"].sum()),
        "decoded": decoded,
        "of": n_total,
        "joint": joint,
        "velocity": velocity,
        "gps_only": gps_only,
        "galileo_only": gal_only,
        "truth_pos_control": ctrl,
        "cn0_est_gps_dbhz": round(gr["cn0_est"], 1),
        "cn0_est_gal_dbhz": round(er["cn0_est"], 1),
        "per_sv": recs,
        "device": str(jax.devices()[0]),
        "gen_s": round(gen_s, 1),
        "acquire_s": round(gr["acquire_s"] + er["acquire_s"], 1),
        "track_s": round(gr["track_s"] + er["track_s"], 1),
    }


if __name__ == "__main__":
    print(json.dumps(main()))
