"""r4w_tpu command-line interface.

Mirrors the reference CLI surface (crates/r4w-cli/src/main.rs:48-546):
tx, rx, simulate, chirp, info, analyze, waveform, benchmark, gnss
(info/code/generate/simulate/scenario), compare, record, playback,
convert, metrics, config. `python -m r4w_tpu ...` or the `r4w-tpu`
entry point.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from r4w_tpu.core.hostio import to_device, to_host


def _jax():
    import jax

    return jax


# ---------------------------------------------------------------- helpers


def _load_waveform(name: str, sample_rate: float):
    from r4w_tpu.waveforms import create_waveform

    wf = create_waveform(name, sample_rate)
    if wf is None:
        from r4w_tpu.waveforms import list_waveforms

        sys.exit(f"error: unknown waveform '{name}'. "
                 f"Available: {', '.join(list_waveforms())}")
    return wf


def _parse_payload(args) -> bytes:
    if getattr(args, "message", None) is not None:
        return args.message.encode()
    if getattr(args, "hex", None):
        return bytes.fromhex(args.hex)
    return b"Hello, World!"


def _read_iq(path: str, fmt: str, max_samples=None) -> np.ndarray:
    from r4w_tpu.io import read_iq_file, sigmf

    if path.endswith((".sigmf-data", ".sigmf-meta", ".sigmf")) or \
            sigmf.sigmf_exists(path):
        samples, _ = sigmf.read_sigmf(path, max_samples)
        return samples
    return read_iq_file(path, fmt, max_samples)


def _read_iq_device(path: str, fmt: str, max_samples=None):
    """Read an IQ file straight onto the device (complex-safe transfer)."""
    return to_device(_read_iq(path, fmt, max_samples))


# ------------------------------------------------------------- subcommands


def cmd_tx(args):
    """Modulate a payload to an IQ file (cmd_tx, main.rs:1164)."""
    wf = _load_waveform(args.waveform, args.sample_rate)
    payload = _parse_payload(args)
    samples = to_host(wf.modulate(payload))
    from r4w_tpu.io import write_iq_file, sigmf

    if args.output.endswith(".sigmf-data") or args.sigmf:
        sigmf.write_sigmf(args.output, samples, args.sample_rate,
                          fmt=args.format,
                          description=f"{args.waveform} tx")
    else:
        write_iq_file(args.output, samples, args.format)
    print(f"wrote {len(samples)} samples ({args.format}) to {args.output}")


def cmd_rx(args):
    """Demodulate an IQ file (cmd_rx, main.rs:1200)."""
    wf = _load_waveform(args.waveform, args.sample_rate)
    samples = _read_iq_device(args.input, args.format)
    res = wf.demodulate(samples)
    data = bytes(np.asarray(res.bits).astype(np.uint8))
    print(f"demodulated {len(samples)} samples -> {len(data)} bytes")
    print("hex:", data.hex())
    try:
        print("text:", data.decode("utf-8", errors="replace"))
    except Exception:
        pass
    if res.snr_estimate is not None:
        print(f"snr estimate: {res.snr_estimate:.1f} dB")


def cmd_simulate(args):
    """Full loopback: modulate → channel → demodulate → BER
    (cmd_simulate, main.rs:1252)."""
    jax = _jax()
    from r4w_tpu.channel import ChannelConfig, apply_channel

    wf = _load_waveform(args.waveform, args.sample_rate)
    payload = _parse_payload(args)
    tx = wf.modulate(payload)
    cfg = ChannelConfig(model=args.channel, snr_db=args.snr,
                        sample_rate=args.sample_rate, cfo_hz=args.cfo)
    rx = apply_channel(jax.random.key(args.seed), tx, cfg)
    res = wf.demodulate(rx)
    if not wf.info().carries_data:
        from r4w_tpu.channel import measure_snr

        print(f"waveform:  {wf.info().name} (carries no data)")
        print(f"channel:   {args.channel} @ {args.snr:.1f} dB SNR")
        print(f"measured SNR: {float(measure_snr(tx, rx)):.1f} dB")
        for k, v in res.metadata.items():
            print(f"{k}: {v}")
        return
    got = bytes(np.asarray(res.bits).astype(np.uint8))[: len(payload)]
    tx_bits = np.unpackbits(np.frombuffer(payload, np.uint8))
    rx_bits = np.unpackbits(np.frombuffer(got.ljust(len(payload), b"\0"),
                                          np.uint8))
    ber = float(np.mean(tx_bits != rx_bits[: len(tx_bits)]))
    print(f"waveform:  {wf.info().name}")
    print(f"channel:   {args.channel} @ {args.snr:.1f} dB SNR")
    print(f"payload:   {payload.hex()} ({len(payload)} bytes)")
    print(f"received:  {got.hex()}")
    print(f"BER:       {ber:.4f}")
    print(f"match:     {'YES' if got == payload else 'no'}")


def cmd_chirp(args):
    """Generate LoRa chirps (cmd_chirp, main.rs:1395)."""
    from r4w_tpu.waveforms import lora
    from r4w_tpu.io import write_iq_file

    p = lora.LoRaParams(sf=args.sf, bw_hz=args.bandwidth)
    from r4w_tpu.waveforms.lora import chirp as chirp_mod

    if args.symbol is not None:
        samples = to_host(
            chirp_mod.symbol_chirps(p, np.array([args.symbol]))
        ).reshape(-1)
    elif args.down:
        samples = to_host(chirp_mod.base_downchirp(p))
    else:
        samples = to_host(chirp_mod.base_upchirp(p))
    if args.output:
        write_iq_file(args.output, samples, args.format)
        print(f"wrote {len(samples)} chirp samples to {args.output}")
    else:
        print(f"chirp: SF{args.sf} BW{args.bandwidth} "
              f"{len(samples)} samples")


def cmd_info(args):
    """Waveform info card (cmd_info, main.rs:1430)."""
    wf = _load_waveform(args.waveform, args.sample_rate)
    info = wf.info()
    print(f"{info.name} — {info.full_name}")
    print(f"  {info.description}")
    print(f"  complexity:       {info.complexity}/5")
    print(f"  bits/symbol:      {info.bits_per_symbol}")
    print(f"  samples/symbol:   {wf.samples_per_symbol()}")
    print(f"  carries data:     {info.carries_data}")
    for c in info.characteristics:
        print(f"  - {c}")
    if info.history:
        print(f"  history: {info.history}")
    if info.modern_usage:
        print(f"  usage:   {info.modern_usage}")


def cmd_analyze(args):
    """Spectrum analysis of an IQ file (cmd_analyze, main.rs:1505)."""
    from r4w_tpu.ops import measure

    samples = _read_iq(args.input, args.format, max_samples=args.max_samples)
    psd = np.asarray(measure.welch_psd(to_device(samples),
                                       nperseg=args.fft_size,
                                       sample_rate=args.sample_rate))
    psd_db = 10 * np.log10(np.maximum(psd, 1e-20))
    freqs = np.fft.fftshift(np.fft.fftfreq(args.fft_size,
                                           1.0 / args.sample_rate))
    peak = int(np.argmax(psd_db))
    power = float(np.mean(np.abs(samples) ** 2))
    print(f"samples:     {len(samples)}")
    print(f"power:       {10*np.log10(max(power,1e-20)):.1f} dBFS")
    print(f"peak:        {freqs[peak]/1e3:+.1f} kHz @ {psd_db[peak]:.1f} dB")
    # 3 dB bandwidth around the peak
    above = psd_db >= psd_db[peak] - 3.0
    bw = float(np.sum(above)) * args.sample_rate / args.fft_size
    print(f"3dB width:   {bw/1e3:.1f} kHz")
    if args.ascii:
        _ascii_spectrum(freqs, psd_db, width=70, height=12)
    if args.json:
        print(json.dumps({"freqs_hz": freqs.tolist()[::args.fft_size // 64],
                          "psd_db": psd_db.tolist()[::args.fft_size // 64]}))


def _ascii_spectrum(freqs, psd_db, width=70, height=12):
    n = len(psd_db)
    step = max(1, n // width)
    cols = [float(np.max(psd_db[i:i+step])) for i in range(0, n, step)][:width]
    lo, hi = min(cols), max(cols)
    rng = max(hi - lo, 1e-9)
    for row in range(height, 0, -1):
        level = lo + rng * row / height
        print("".join("#" if c >= level else " " for c in cols))
    print(f"{freqs[0]/1e3:+.0f}k{' ' * (width-12)}{freqs[-1]/1e3:+.0f}k")


def cmd_waveform(args):
    """--list / --demo (cmd_waveform, main.rs:1710)."""
    from r4w_tpu.waveforms import list_waveforms

    if args.demo:
        wf = _load_waveform(args.demo, args.sample_rate)
        demo = np.asarray(wf.generate_demo(args.duration_ms))
        print(f"{args.demo}: {len(demo)} demo samples, "
              f"peak {np.max(np.abs(demo)):.2f}")
        return
    print(f"{len(list_waveforms())} waveforms:")
    for name in list_waveforms():
        print(f"  {name}")


def cmd_benchmark(args):
    """Waveform throughput benchmark (cmd_benchmark, main.rs:1895)."""
    jax = _jax()
    wf = _load_waveform(args.waveform, args.sample_rate)
    payload = bytes(range(args.payload_bytes % 256)) or b"\x00"
    tx = wf.modulate(payload)
    n = tx.shape[-1]
    # throughput: repeated demodulation of the modulated burst
    t0 = time.perf_counter()
    iters = 0
    total_samples = 0
    lat = []
    while time.perf_counter() - t0 < args.duration:
        t1 = time.perf_counter()
        res = wf.demodulate(tx)
        jax.block_until_ready(res.symbols)
        lat.append(time.perf_counter() - t1)
        iters += 1
        total_samples += n
    dt = time.perf_counter() - t0
    lat_ms = np.array(lat) * 1e3
    print(f"waveform:    {wf.info().name}")
    print(f"iterations:  {iters} in {dt:.2f}s")
    print(f"throughput:  {total_samples/dt/1e6:.2f} Msamples/s")
    print(f"latency:     avg {lat_ms.mean():.2f} ms  min {lat_ms.min():.2f}"
          f"  max {lat_ms.max():.2f}  p99 {np.percentile(lat_ms, 99):.2f}")


def cmd_compare(args):
    """Side-by-side waveform comparison (cmd_compare, main.rs:4635)."""
    jax = _jax()
    from r4w_tpu.channel import awgn

    payload = _parse_payload(args)
    names = args.waveforms.split(",")
    print(f"{'waveform':<14}{'samples':>9}{'sps':>6}{'BER@' + str(args.snr) + 'dB':>12}")
    for name in names:
        wf = _load_waveform(name.strip(), args.sample_rate)
        tx = wf.modulate(payload)
        rx = awgn(jax.random.key(0), tx, args.snr)
        res = wf.demodulate(rx)
        got = np.asarray(res.bits).astype(np.uint8)[: len(payload)]
        tx_bits = np.unpackbits(np.frombuffer(payload, np.uint8))
        rx_bits = np.unpackbits(got)[: len(tx_bits)]
        nbits = min(len(tx_bits), len(rx_bits))
        ber = float(np.mean(tx_bits[:nbits] != rx_bits[:nbits])) if nbits else 1.0
        print(f"{wf.info().name:<14}{tx.shape[-1]:>9}"
              f"{wf.samples_per_symbol():>6}{ber:>12.4f}")


def cmd_record(args):
    """Record from the simulator device to SigMF (cmd_record)."""
    from r4w_tpu.sim import Simulator, SimulatorConfig
    from r4w_tpu.io import sigmf

    sim = Simulator(SimulatorConfig(sample_rate=args.sample_rate,
                                    noise_floor_db=args.noise_floor))
    if args.inject:
        wf = _load_waveform(args.inject, args.sample_rate)
        sim.inject_signal(to_host(wf.modulate(_parse_payload(args))))
    samples = sim.receive(int(args.duration * args.sample_rate))
    sigmf.write_sigmf(args.output, samples, args.sample_rate,
                      fmt=args.format, description="r4w-tpu recording")
    print(f"recorded {len(samples)} samples to {args.output}")


def cmd_playback(args):
    """Replay a recording through a demodulator (cmd_playback)."""
    samples = _read_iq_device(args.input, args.format)
    print(f"loaded {len(samples)} samples")
    if args.waveform:
        wf = _load_waveform(args.waveform, args.sample_rate)
        res = wf.demodulate(samples)
        data = bytes(np.asarray(res.bits).astype(np.uint8))
        print(f"decoded {len(data)} bytes: {data[:64].hex()}")


def cmd_convert(args):
    """IQ format conversion (cmd_convert, main.rs:5073)."""
    from r4w_tpu.io import convert_iq_file

    convert_iq_file(args.input, args.output, args.from_format,
                    args.to_format)
    print(f"converted {args.input} ({args.from_format}) -> "
          f"{args.output} ({args.to_format})")


def cmd_metrics(args):
    """Prometheus metrics dump/serve (cmd_metrics, main.rs:5227)."""
    from r4w_tpu.observe import REGISTRY, serve_metrics

    REGISTRY.gauge("r4w_up", "process alive").set(1)
    if args.serve:
        print(f"serving metrics on :{args.port}/metrics (ctrl-c to stop)")
        serve_metrics(args.port, blocking=True)
    else:
        print(REGISTRY.to_prometheus())


def cmd_config(args):
    """Show / validate / generate config (R4wConfig surface)."""
    from r4w_tpu.config import R4wConfig

    if args.example:
        print(R4wConfig.example_yaml())
        return
    cfg = R4wConfig.load_from(args.file) if args.file else R4wConfig.load()
    if args.profile:
        cfg = cfg.with_profile(args.profile)
    errs = cfg.validate()
    if errs:
        print("INVALID configuration:")
        for e in errs:
            print(f"  - {e}")
        sys.exit(1)
    print(cfg.to_yaml())


# ----------------------------------------------------------------- gnss


def cmd_gnss(args):
    if args.gnss_cmd == "info":
        print("GNSS signals: GPS-L1CA (1023-chip Gold, BPSK), GPS-L5 "
              "(10230-chip), GLONASS-L1OF (511-chip m-seq, FDMA), "
              "Galileo-E1 (4092-chip CBOC(6,1,1/11))")
        return
    if args.gnss_cmd == "code":
        from r4w_tpu.gnss import prn

        code = {
            "gps": lambda: prn.gps_ca_code(args.prn),
            "glonass": lambda: prn.glonass_l1of_code(),
            "galileo": lambda: prn.galileo_e1_code(args.prn),
            "l5": lambda: prn.gps_l5_code(args.prn),
        }[args.system]()
        bits = "".join("1" if c < 0 else "0" for c in code[:32])
        print(f"{args.system} PRN {args.prn}: {len(code)} chips, "
              f"first 32: {bits}")
        print(f"balance: {int(np.sum(code))}")
        return
    if args.gnss_cmd == "scenario":
        from r4w_tpu.gnss import GnssScenario, load_scenario_yaml
        from r4w_tpu.io import sigmf

        cfg = load_scenario_yaml(args.config)
        dur = args.duration if args.duration else cfg.duration_s
        gen = GnssScenario(cfg)
        out = args.output or "scenario.sigmf-data"
        t0 = time.perf_counter()
        samples = gen.generate(dur)
        sigmf.write_sigmf(out, samples, cfg.sample_rate, fmt=cfg.format
                          if cfg.format in ("cf32", "ci16", "ci8", "cu8",
                                            "cf64") else "cf32",
                          description="r4w-tpu GNSS scenario")
        dt = time.perf_counter() - t0
        print(f"{len(cfg.satellites)} SVs x {dur}s @ {cfg.sample_rate/1e6}"
              f" MS/s -> {out} in {dt:.1f}s "
              f"({len(samples)/dt/1e6:.1f} Msamples/s)")
        return
    if args.gnss_cmd == "simulate":
        jax = _jax()
        from r4w_tpu.gnss import acquisition, prn
        from r4w_tpu.channel import awgn

        fs = 1_023_000.0
        code = prn.gps_ca_code(args.prn).astype(np.float32)
        x = np.roll(code, args.code_phase).astype(np.complex64)
        t = np.arange(len(x)) / fs
        x = x * np.exp(2j * np.pi * args.doppler * t)
        rx = awgn(jax.random.key(0), x, args.snr)
        res = acquisition.acquire(rx, prn.code_bank([args.prn]),
                                  [args.prn], fs)
        print(f"PRN {args.prn}: detected={bool(res.detected[0])} "
              f"code_phase={float(res.code_phase[0]):.0f} "
              f"doppler={float(res.doppler_hz[0]):+.0f} Hz "
              f"metric={float(res.peak_metric[0]):.1f}")
        return
    if args.gnss_cmd == "fix":
        from r4w_tpu.gnss import pvt

        rows = np.loadtxt(args.file, delimiter=",", ndmin=2)
        sol = pvt.solve_position(rows[:, :3], rows[:, 3])
        lla = sol.lla
        print(f"position ECEF: {sol.position_ecef[0]:.1f} "
              f"{sol.position_ecef[1]:.1f} {sol.position_ecef[2]:.1f} m")
        print(f"lat/lon/alt:   {lla[0]:.6f}°, {lla[1]:.6f}°, "
              f"{lla[2]:.1f} m")
        print(f"clock bias:    {sol.clock_bias_m:.1f} m "
              f"({sol.clock_bias_m / 299792458.0 * 1e6:.3f} µs)")
        print(f"GDOP {sol.gdop:.2f}  PDOP {sol.pdop:.2f}  "
              f"HDOP {sol.hdop:.2f}  VDOP {sol.vdop:.2f}")
        print(f"residual RMS:  "
              f"{float(np.sqrt(np.mean(sol.residuals_m ** 2))):.2f} m "
              f"({sol.iterations} iterations)")
        return
    if args.gnss_cmd == "ephemeris":
        from r4w_tpu.gnss import ephemeris as eph

        if args.eph_cmd == "fetch":
            sys.exit("error: CDDIS fetch needs network access; pass a "
                     "local RINEX/SP3/IONEX file to `ephemeris info`")
        if args.eph_cmd == "info":
            kind, data = eph.load_ephemeris_file(args.file)
            if kind == "rinex_nav":
                n_eph = sum(len(v) for v in data.values())
                toes = [e.toe for v in data.values() for e in v]
                print("=== RINEX Ephemeris Summary ===")
                if toes:
                    print(f"Time span:    GPS {min(toes):.0f} - "
                          f"{max(toes):.0f} "
                          f"({(max(toes) - min(toes)) / 3600:.1f} hours)")
                print(f"GPS satellites: {len(data)} ({n_eph} ephemerides)")
                for prn in sorted(data):
                    e = data[prn][0]
                    x, y, z = e.position(e.toe)
                    r = np.sqrt(x * x + y * y + z * z)
                    print(f"  G{prn:02d}: toe={e.toe:.0f} "
                          f"|r|={r / 1e3:.0f} km af0={e.af0:.2e}")
            elif kind == "sp3":
                epochs, records = data
                svs = sorted({r.prn for r in records})
                print("=== SP3 Precise Ephemeris Summary ===")
                print(f"Epoch count:   {len(epochs)}")
                if len(epochs) > 1:
                    print(f"Interval:      {epochs[1] - epochs[0]:.0f} "
                          "seconds")
                print(f"Satellites:    {len(svs)} "
                      f"({', '.join(svs[:12])}{'...' if len(svs) > 12 else ''})")
            else:
                maps, lats, lons = data
                print("=== IONEX TEC Summary ===")
                print(f"Maps:          {len(maps)}")
                if lats is not None:
                    print(f"Grid:          {len(lats)} lats x "
                          f"{len(lons)} lons")
                if maps:
                    first = maps[min(maps)]
                    print(f"TEC range:     {first.min():.1f} - "
                          f"{first.max():.1f} TECU")
            return
        sys.exit(f"unknown ephemeris subcommand {args.eph_cmd}")
    sys.exit(f"unknown gnss subcommand {args.gnss_cmd}")


def cmd_adsb(args):
    """ADS-B tools (cmd_adsb: decode/generate, main.rs)."""
    from r4w_tpu import adsb

    if args.adsb_cmd == "generate":
        msg = adsb.AdsbMessage(icao=int(args.icao, 16), type_code=4,
                               callsign=args.callsign)
        iq = adsb.transmit_over_ppm(msg, args.sample_rate)
        if args.output:
            from r4w_tpu.io import write_iq_file

            write_iq_file(args.output, iq, "cf32")
            print(f"wrote {iq.shape[-1]} samples to {args.output}")
        else:
            frame = msg.to_bits()
            data = np.packbits(np.asarray(frame).astype(np.uint8))
            print("frame hex:", bytes(data).hex())
        return
    if args.adsb_cmd == "decode":
        if args.hex_frame:
            raw = bytes.fromhex(args.hex_frame)
            msg = adsb.decode_frame_bytes(raw)
        else:
            samples = _read_iq_device(args.input, "cf32")
            msg = adsb.receive_over_ppm(samples, args.sample_rate)
        if msg is None:
            sys.exit("error: not a DF17 frame")
        print(f"ICAO:     {msg.icao:06X}")
        print(f"type:     TC{msg.type_code}")
        print(f"CRC:      {'OK' if msg.crc_ok else 'FAILED'}")
        if msg.callsign:
            print(f"callsign: {msg.callsign}")
        if msg.altitude_ft is not None:
            print(f"altitude: {msg.altitude_ft} ft")
        return
    sys.exit(f"unknown adsb subcommand {args.adsb_cmd}")


def cmd_udp_send(args):
    """Stream an IQ file or generated waveform over UDP (cmd_udp_send,
    main.rs:2040)."""
    from r4w_tpu.net import UdpSink

    if args.input:
        samples = _read_iq(args.input, args.format)
    else:
        wf = _load_waveform(args.waveform, args.sample_rate)
        samples = to_host(wf.modulate(_parse_payload(args)))
    sink = UdpSink(args.host, args.port)
    reps = max(1, args.repeat)
    total = 0
    for _ in range(reps):
        total += sink.send(samples)
        if args.interval > 0:
            time.sleep(args.interval)
    print(f"sent {len(samples) * reps} samples in {total} packets to "
          f"{args.host}:{args.port}")


def cmd_agent(args):
    """Run the remote-control agent daemon (cmd_agent, main.rs:2201)."""
    from r4w_tpu.agent import AgentServer

    server = AgentServer(args.bind, args.port)
    print(f"agent listening on {args.bind}:{server.port} "
          "(ping/status/start_tx/stop_tx/list_waveforms/shutdown)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("agent stopped")


def cmd_remote(args):
    """Drive a remote agent (cmd_remote start-tx/start-rx, main.rs:4536)."""
    from r4w_tpu.agent import AgentClient

    client = AgentClient(args.host, args.port)
    try:
        if args.remote_cmd == "ping":
            t0 = time.perf_counter()
            client.ping()
            print(f"pong in {1e3 * (time.perf_counter() - t0):.1f} ms")
        elif args.remote_cmd == "status":
            print(json.dumps(client.status(), indent=2))
        elif args.remote_cmd == "start-tx":
            r = client.start_tx(
                f"{args.target_host}:{args.target_port}",
                waveform=args.waveform, message=args.message,
                sample_rate=args.sample_rate)
            print(json.dumps(r))
        elif args.remote_cmd == "stop-tx":
            print(json.dumps(client.stop_tx()))
        elif args.remote_cmd == "shutdown":
            print(json.dumps(client.shutdown()))
        else:
            sys.exit(f"unknown remote subcommand {args.remote_cmd}")
    finally:
        client.close()


def cmd_ber_gate(args):
    """BER-vs-theory acceptance gate (ber_tool.rs role)."""
    import dataclasses as _dc
    import json as _json

    from r4w_tpu import ber

    points = (ber.DEFAULT_GATE_POINTS if not args.scheme
              else {args.scheme: tuple(
                  float(x) for x in args.points.split(","))})
    results = ber.ber_acceptance_report(points, n_bits=args.bits)
    worst = max(r.deviation for r in results)
    print(_json.dumps({
        "gates": [_dc.asdict(r) for r in results],
        "worst_deviation": worst,
        "pass": worst < 0.10,
    }, indent=1))


def cmd_plugin(args):
    """Plugin tools (plugin/manager.rs role): list/load Python and
    C-ABI waveform plugins."""
    from r4w_tpu.registry import PluginManager

    pm = PluginManager(search_paths=args.path.split(os.pathsep)
                       if args.path else None)
    if args.plugin_cmd == "discover":
        for p in pm.discover_plugins():
            print(p)
        return
    if args.plugin_cmd == "load":
        if args.file.endswith((".so", ".dylib", ".dll")):
            info = pm.load_native_plugin(args.file)
        else:
            info = pm.load_plugin(args.file)
        if info is None:
            print(f"load failed: {pm.errors}")
            raise SystemExit(1)
        print(f"loaded {info.name} v{info.version}: "
              f"waveforms {list(info.waveforms)}")
        from r4w_tpu.waveforms import create_waveform

        for w in info.waveforms:
            wf = create_waveform(w)
            print(f"  {w}: {wf.info().description}")


def cmd_completions(args):
    """Emit a bash completion script (cmd_completions role)."""
    p = build_parser()
    subs = sorted(
        a.choices for a in p._subparsers._group_actions)[0]
    names = " ".join(subs)
    print(f"""_r4w_tpu() {{
  local cur=${{COMP_WORDS[COMP_CWORD]}}
  if [ $COMP_CWORD -eq 1 ]; then
    COMPREPLY=( $(compgen -W "{names}" -- "$cur") )
  fi
}}
complete -F _r4w_tpu r4w-tpu
complete -F _r4w_tpu "python -m r4w_tpu.cli" 2>/dev/null || true""")


def cmd_explore(args):
    """Serve the interactive waveform explorer (GUI role, app.rs:231)."""
    from r4w_tpu.explorer import serve

    serve(args.host, args.port)


def cmd_gallery(args):
    """Regenerate the PNG gallery (reference gallery/ directory)."""
    from r4w_tpu import viz

    names = args.waveforms.split(",") if args.waveforms else None
    made = viz.generate_gallery(args.output, names, args.sample_rate)
    made += viz.generate_channel_gallery(args.output, args.sample_rate)
    print(f"wrote {len(made)} figures under {args.output}")


def cmd_mesh(args):
    """Mesh tools (cmd_mesh, main.rs:2223-2489)."""
    from r4w_tpu import mesh

    if args.mesh_cmd == "simulate":
        sim = mesh.MeshSimulation(seed=args.seed)
        n = args.nodes
        for i in range(1, n + 1):
            sim.add_node(i)
        # ring + a chord topology
        for i in range(1, n + 1):
            sim.connect(i, i % n + 1, snr_db=8.0, loss=args.loss)
        if n > 3:
            sim.connect(1, n // 2 + 1, snr_db=5.0, loss=args.loss)
        src, dst = 1, n // 2 + 1
        sim.nodes[src].send(dst, args.message.encode(), want_ack=True)
        moved = sim.run()
        ok = any(p.payload == args.message.encode()
                 for p in sim.nodes[dst].inbox)
        print(f"{n}-node mesh, {moved} transmissions over {sim.round} rounds")
        print(f"delivery {src} -> {dst}: {'OK' if ok else 'FAILED'}")
        for nid, st in sim.status().items():
            print(f"  node {nid}: neighbors={st['neighbors']} "
                  f"sent={st['sent']} relayed={st['relayed']} "
                  f"received={st['received']}")
        return
    if args.mesh_cmd == "status":
        node = mesh.MeshNode(args.node_id)
        print(f"node {node.node_id}: neighbors={sorted(node.neighbors)} "
              f"routes={node.routes} stats={node.stats}")
        return
    sys.exit(f"unknown mesh subcommand {args.mesh_cmd}")


def cmd_blocks(args):
    """Browse the block registry (block_gateway.rs catalog surface —
    the CLI face of the GUI pipeline wizard's block list)."""
    import json as _json

    from r4w_tpu.registry import BlockCategory, default_registry

    reg = default_registry()
    cat = BlockCategory(args.category) if args.category else None
    if getattr(args, "schema", None):
        info = reg.get(args.schema)
        if info is None:
            print(f"unknown block {args.schema!r}")
            return 1
        rows = reg.param_schema(args.schema)
        if args.json:
            print(_json.dumps({"name": info.name, "schema": rows},
                              indent=1))
            return
        print(f"{info.name} [{info.category.value}] — {info.description}")
        if not rows:
            print("  (no introspectable parameters)")
        for r in rows:
            req = "required" if r["required"] else f"= {r['default']!r}"
            print(f"  {r['name']:<18} {r['type']:<10} {r['role']:<6} "
                  f"{req}")
            if r.get("doc"):
                print(f"      {r['doc']}")
        return
    blocks = reg.list(cat)
    if args.search:
        q = args.search.lower()
        blocks = [b for b in blocks
                  if q in b.name.lower() or q in b.description.lower()]
    tags = {}
    if getattr(args, "jit", False):
        tags = {b.name: reg.jit_safety(b.name) for b in blocks}
    if args.json:
        rows = []
        for b in blocks:
            row = {"name": b.name, "category": b.category.value,
                   "description": b.description, "params": list(b.params)}
            if tags:
                row["jit_safe"] = tags[b.name][0]
                if tags[b.name][1]:
                    row["jit_reason"] = tags[b.name][1]
            rows.append(row)
        print(_json.dumps(rows, indent=1))
        return
    counts = reg.categories()
    # --jit falls through to the per-block listing (so the probed tags
    # are actually shown); the bare command prints the category summary
    if not args.search and not args.category and not tags:
        total = sum(counts.values())
        print(f"{total} blocks in {len(counts)} categories "
              f"(use --category/--search to filter):")
        for c in sorted(counts, key=lambda c: -counts[c]):
            print(f"  {c.value:<12} {counts[c]}")
        return
    for b in blocks:
        params = f" ({', '.join(b.params)})" if b.params else ""
        tag = f" <{tags[b.name][0]}>" if tags else ""
        print(f"{b.name:<34} [{b.category.value}]{params}{tag}")
        print(f"    {b.description}")


def cmd_spec(args):
    """Waveform-spec YAML tools (specs/*.yaml, waveform wizard path)."""
    from r4w_tpu.waveform_spec import WaveformSpec

    spec = WaveformSpec.load(args.file)
    print(f"{spec.name} — {spec.full_name}")
    print(f"  scheme: {spec.scheme} order {spec.order} "
          f"({spec.bits_per_symbol} bits/symbol)")
    print(f"  timing: {spec.symbol_rate:.0f} Bd @ {spec.sample_rate:.0f} S/s"
          f" ({spec.samples_per_symbol} sps)")
    if spec.pulse_type:
        print(f"  pulse:  {spec.pulse_type} rolloff {spec.rolloff}")
    if args.check:
        from r4w_tpu.waveforms import create_waveform

        wf = create_waveform(spec.name, spec.sample_rate)
        if wf is None or not hasattr(wf, "constellation_points"):
            print("  check: no comparable built-in waveform")
        else:
            ok, err = spec.check_constellation(wf)
            print(f"  constellation vs built-in {spec.name}: "
                  f"{'MATCH' if ok else 'MISMATCH'} (max err {err:.3f})")
    if args.roundtrip:
        wf = spec.build_waveform()
        data = b"spec!"
        res = wf.demodulate(wf.modulate(data))
        got = bytes(np.asarray(res.bits[: len(data)]).astype(np.uint8))
        print(f"  spec-built waveform roundtrip: "
              f"{'OK' if got == data else 'FAILED'}")


# ----------------------------------------------------------------- parser


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="r4w-tpu",
        description="batch-first SDR waveform framework "
                    "(r4w capabilities, JAX/XLA implementation)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def add_common(sp, waveform=True):
        if waveform:
            sp.add_argument("-w", "--waveform", default="BPSK")
        sp.add_argument("-s", "--sample-rate", type=float, default=125_000.0)
        sp.add_argument("-m", "--message", default=None)
        sp.add_argument("--hex", default=None)

    sp = sub.add_parser("tx", help="modulate payload to IQ file")
    add_common(sp)
    sp.add_argument("-o", "--output", required=True)
    sp.add_argument("-f", "--format", default="cf32")
    sp.add_argument("--sigmf", action="store_true")
    sp.set_defaults(fn=cmd_tx)

    sp = sub.add_parser("rx", help="demodulate IQ file")
    add_common(sp)
    sp.add_argument("-i", "--input", required=True)
    sp.add_argument("-f", "--format", default="cf32")
    sp.set_defaults(fn=cmd_rx)

    sp = sub.add_parser("simulate", help="loopback through a channel")
    add_common(sp)
    sp.add_argument("--channel", default="awgn")
    sp.add_argument("--snr", type=float, default=20.0)
    sp.add_argument("--cfo", type=float, default=0.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("chirp", help="generate LoRa chirps")
    sp.add_argument("--sf", type=int, default=7)
    sp.add_argument("--bandwidth", type=int, default=125_000)
    sp.add_argument("--symbol", type=int, default=None)
    sp.add_argument("--down", action="store_true")
    sp.add_argument("-o", "--output", default=None)
    sp.add_argument("-f", "--format", default="cf32")
    sp.set_defaults(fn=cmd_chirp)

    sp = sub.add_parser("info", help="waveform info")
    add_common(sp)
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("analyze", help="spectrum analysis of an IQ file")
    sp.add_argument("-i", "--input", required=True)
    sp.add_argument("-f", "--format", default="cf32")
    sp.add_argument("-s", "--sample-rate", type=float, default=125_000.0)
    sp.add_argument("--fft-size", type=int, default=1024)
    sp.add_argument("--max-samples", type=int, default=1 << 20)
    sp.add_argument("--ascii", action="store_true")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_analyze)

    sp = sub.add_parser("waveform", help="list waveforms / generate demo")
    sp.add_argument("--list", action="store_true")
    sp.add_argument("--demo", default=None)
    sp.add_argument("--duration-ms", type=float, default=10.0)
    sp.add_argument("-s", "--sample-rate", type=float, default=125_000.0)
    sp.set_defaults(fn=cmd_waveform)

    sp = sub.add_parser("benchmark", help="waveform throughput benchmark")
    add_common(sp)
    sp.add_argument("--duration", type=float, default=2.0)
    sp.add_argument("--payload-bytes", type=int, default=64)
    sp.set_defaults(fn=cmd_benchmark)

    sp = sub.add_parser("compare", help="side-by-side waveform comparison")
    sp.add_argument("waveforms", help="comma-separated names")
    sp.add_argument("-s", "--sample-rate", type=float, default=125_000.0)
    sp.add_argument("-m", "--message", default=None)
    sp.add_argument("--hex", default=None)
    sp.add_argument("--snr", type=float, default=15.0)
    sp.set_defaults(fn=cmd_compare)

    sp = sub.add_parser("record", help="record from the simulator")
    sp.add_argument("-o", "--output", required=True)
    sp.add_argument("-s", "--sample-rate", type=float, default=125_000.0)
    sp.add_argument("--duration", type=float, default=1.0)
    sp.add_argument("--noise-floor", type=float, default=-90.0)
    sp.add_argument("--inject", default=None,
                    help="waveform to inject into the recording")
    sp.add_argument("-m", "--message", default=None)
    sp.add_argument("--hex", default=None)
    sp.add_argument("-f", "--format", default="cf32")
    sp.set_defaults(fn=cmd_record)

    sp = sub.add_parser("playback", help="replay a recording")
    sp.add_argument("-i", "--input", required=True)
    sp.add_argument("-w", "--waveform", default=None)
    sp.add_argument("-s", "--sample-rate", type=float, default=125_000.0)
    sp.add_argument("-f", "--format", default="cf32")
    sp.set_defaults(fn=cmd_playback)

    sp = sub.add_parser("convert", help="convert IQ file formats")
    sp.add_argument("-i", "--input", required=True)
    sp.add_argument("-o", "--output", required=True)
    sp.add_argument("--from-format", required=True)
    sp.add_argument("--to-format", required=True)
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser("metrics", help="Prometheus metrics")
    sp.add_argument("--serve", action="store_true")
    sp.add_argument("--port", type=int, default=9090)
    sp.set_defaults(fn=cmd_metrics)

    sp = sub.add_parser("config", help="show/validate configuration")
    sp.add_argument("--file", default=None)
    sp.add_argument("--profile", default=None)
    sp.add_argument("--example", action="store_true")
    sp.set_defaults(fn=cmd_config)

    sp = sub.add_parser("adsb", help="ADS-B Mode-S tools")
    asb = sp.add_subparsers(dest="adsb_cmd", required=True)
    a = asb.add_parser("generate")
    a.add_argument("--icao", default="4840D6")
    a.add_argument("--callsign", default="R4WTPU")
    a.add_argument("-o", "--output", default=None)
    a.add_argument("-s", "--sample-rate", type=float, default=8e6)
    a.set_defaults(fn=cmd_adsb)
    a = asb.add_parser("decode")
    a.add_argument("-i", "--input", default=None)
    a.add_argument("--hex-frame", default=None)
    a.add_argument("-s", "--sample-rate", type=float, default=8e6)
    a.set_defaults(fn=cmd_adsb)

    sp = sub.add_parser("udp-send", help="stream IQ samples over UDP")
    sp.add_argument("-i", "--input", default=None)
    sp.add_argument("-f", "--format", default="cf32")
    sp.add_argument("-w", "--waveform", default="BPSK")
    sp.add_argument("-m", "--message", default="hello")
    sp.add_argument("--hex", default=None)
    sp.add_argument("-s", "--sample-rate", type=float, default=125e3)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("-p", "--port", type=int, default=5000)
    sp.add_argument("-r", "--repeat", type=int, default=1)
    sp.add_argument("--interval", type=float, default=0.0)
    sp.set_defaults(fn=cmd_udp_send)

    sp = sub.add_parser("agent", help="run the remote-control agent")
    sp.add_argument(
        "--bind", default="127.0.0.1",
        help="interface to bind (0.0.0.0 exposes the unauthenticated "
        "control plane to the network)")
    sp.add_argument("-p", "--port", type=int, default=6000)
    sp.set_defaults(fn=cmd_agent)

    sp = sub.add_parser("remote", help="control a remote agent")
    rc = sp.add_subparsers(dest="remote_cmd", required=True)
    for name in ("ping", "status", "stop-tx", "shutdown"):
        r = rc.add_parser(name)
        r.add_argument("--host", default="127.0.0.1")
        r.add_argument("-p", "--port", type=int, default=6000)
        r.set_defaults(fn=cmd_remote)
    r = rc.add_parser("start-tx")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("-p", "--port", type=int, default=6000)
    r.add_argument("-w", "--waveform", default="BPSK")
    r.add_argument("-m", "--message", default="hello")
    r.add_argument("--target-host", default="127.0.0.1")
    r.add_argument("--target-port", type=int, default=5000)
    r.add_argument("-s", "--sample-rate", type=float, default=125e3)
    r.set_defaults(fn=cmd_remote)

    sp = sub.add_parser("completions", help="emit bash completions")
    sp.set_defaults(fn=cmd_completions)

    sp = sub.add_parser("gallery", help="regenerate the PNG figure gallery")
    sp.add_argument("-o", "--output", default="gallery")
    sp.add_argument("--waveforms", default=None,
                    help="comma-separated subset (default: all)")
    sp.add_argument("-s", "--sample-rate", type=float, default=48000.0)
    sp.set_defaults(fn=cmd_gallery)

    sp = sub.add_parser("explore",
                        help="interactive web waveform explorer")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8080)
    sp.set_defaults(fn=cmd_explore)

    sp = sub.add_parser("mesh", help="mesh networking tools")
    ms = sp.add_subparsers(dest="mesh_cmd", required=True)
    m = ms.add_parser("simulate")
    m.add_argument("--nodes", type=int, default=6)
    m.add_argument("--loss", type=float, default=0.0)
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("-m", "--message", default="mesh hello")
    m.set_defaults(fn=cmd_mesh)
    m = ms.add_parser("status")
    m.add_argument("--node-id", type=int, default=1)
    m.set_defaults(fn=cmd_mesh)

    sp = sub.add_parser("ber-gate",
                        help="BER-vs-theory acceptance sweep")
    sp.add_argument("--scheme", default=None,
                    help="single scheme (default: full gate table)")
    sp.add_argument("--points", default="4.0,6.0",
                    help="comma-separated Eb/N0 dB points")
    sp.add_argument("--bits", type=int, default=200_000)
    sp.set_defaults(fn=cmd_ber_gate)

    sp = sub.add_parser("plugin", help="waveform plugin tools")
    sp.add_argument("plugin_cmd", choices=["discover", "load"])
    sp.add_argument("file", nargs="?", default=None,
                    help="plugin .py or .so for 'load'")
    sp.add_argument("--path", default=None,
                    help="plugin search paths (os.pathsep separated)")
    sp.set_defaults(fn=cmd_plugin)

    sp = sub.add_parser("blocks", help="browse the DSP block registry")
    sp.add_argument("--category", default=None,
                    help="filter by category (filter/sync/fec/...)")
    sp.add_argument("--search", default=None,
                    help="substring match on name/description")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--jit", action="store_true",
                    help="probe + tag each block's jit-safety "
                         "(jit/host/unknown; abstract trace, no device)")
    sp.add_argument("--schema", metavar="BLOCK", default=None,
                    help="print the typed parameter schema of one "
                         "block (name/type/default/role/doc)")
    sp.set_defaults(fn=cmd_blocks)

    sp = sub.add_parser("spec", help="waveform-spec YAML tools")
    sp.add_argument("file")
    sp.add_argument("--check", action="store_true",
                    help="compare against the built-in waveform")
    sp.add_argument("--roundtrip", action="store_true",
                    help="build a waveform from the spec and roundtrip it")
    sp.set_defaults(fn=cmd_spec)

    sp = sub.add_parser("gnss", help="GNSS tools")
    gs = sp.add_subparsers(dest="gnss_cmd", required=True)
    g = gs.add_parser("info")
    g.set_defaults(fn=cmd_gnss)
    g = gs.add_parser("code")
    g.add_argument("--system", default="gps",
                   choices=["gps", "glonass", "galileo", "l5"])
    g.add_argument("--prn", type=int, default=1)
    g.set_defaults(fn=cmd_gnss)
    g = gs.add_parser("scenario")
    g.add_argument("--config", required=True)
    g.add_argument("--duration", type=float, default=None)
    g.add_argument("-o", "--output", default=None)
    g.set_defaults(fn=cmd_gnss)
    g = gs.add_parser("simulate")
    g.add_argument("--prn", type=int, default=1)
    g.add_argument("--doppler", type=float, default=1000.0)
    g.add_argument("--code-phase", type=int, default=200)
    g.add_argument("--snr", type=float, default=-15.0)
    g.set_defaults(fn=cmd_gnss)
    g = gs.add_parser("fix", help="PVT least-squares from a CSV of "
                      "sat_x,sat_y,sat_z,pseudorange rows (m)")
    g.add_argument("file")
    g.set_defaults(fn=cmd_gnss)
    g = gs.add_parser("ephemeris",
                      help="RINEX/SP3/IONEX ephemeris tools")
    ge = g.add_subparsers(dest="eph_cmd", required=True)
    e = ge.add_parser("info")
    e.add_argument("file")
    e.set_defaults(fn=cmd_gnss)
    e = ge.add_parser("fetch")
    e.add_argument("-d", "--date", default=None)
    e.set_defaults(fn=cmd_gnss)

    return p


def main(argv=None):
    from r4w_tpu import compile_cache

    compile_cache.configure()
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except BrokenPipeError:
        # output piped to head etc. — exit quietly
        try:
            sys.stdout.close()
        except Exception:
            pass
        sys.exit(0)
    except (FileNotFoundError, ValueError, KeyError) as e:
        sys.exit(f"error: {e}")
    except Exception as e:  # yaml errors etc. — never dump a traceback
        if type(e).__module__.startswith("yaml"):
            sys.exit(f"error: invalid YAML: {e}")
        raise


if __name__ == "__main__":
    main()
