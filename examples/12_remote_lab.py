"""Remote lab, headless: agent -> UDP -> live waterfall rows.

The same loop the explorer's "live stream" tab drives from the
browser (crates/r4w-gui/src/views/remote_lab.rs + views/streaming/
roles): start the live waterfall, point a running `r4w-tpu agent`'s
transmitter at it over the standard [seq u32][f32 I/Q] wire format,
and tail spectrum rows as they arrive.

Run: python examples/12_remote_lab.py
"""

import time

import examples_env  # noqa: F401  (CPU unless R4W_DEVICE=accelerator)

from r4w_tpu import explorer
from r4w_tpu.agent import AgentServer

agent = AgentServer(port=0)
agent.serve_in_thread()
info = explorer.stream_start(fs=125_000.0, fft_size=128)
print(f"waterfall listening on udp://127.0.0.1:{info['port']}")

try:
    r = explorer.remote_call({
        "agent_host": "127.0.0.1", "agent_port": agent.port,
        "command": "start_tx", "target": "stream",
        "waveform": "QPSK", "message": "remote lab demo",
        "repeat": True, "pps": 20})
    assert r["response"] == "ok", r
    print(f"agent tx: {r['message']}")

    rows = []
    for _ in range(80):  # up to 20 s for jit warm + first packets
        out = explorer._stream.rows_since(0)
        rows = out["rows"]
        if len(rows) >= 8:
            break
        time.sleep(0.25)
    assert rows, "no waterfall rows arrived"
    stats = out["stats"]
    print(f"{out['next']} spectrum rows ({len(rows[0])} bins), "
          f"{stats['packets']} packets, {stats['dropped']} dropped")

    # crude ASCII render of the last few rows
    chars = " .:-=+*#%@"
    for row in rows[-6:]:
        lo, hi = min(row), max(row)
        rng = max(hi - lo, 1e-9)
        line = "".join(
            chars[min(int((v - lo) / rng * (len(chars) - 1)),
                      len(chars) - 1)]
            for v in row[::2])
        print(line)

    stop = explorer.remote_call({
        "agent_host": "127.0.0.1", "agent_port": agent.port,
        "command": "stop_tx"})
    assert stop["response"] == "ok"
finally:
    explorer.stream_stop()
    agent._running = False

print("remote lab loop complete")
