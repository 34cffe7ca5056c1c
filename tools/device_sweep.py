#!/usr/bin/env python
"""Per-waveform device smoke sweep: modulate -> host transfer ->
demodulate for every factory waveform, each in its own subprocess,
one at a time (a JAX process reserves most of the card's memory, so
the parent stays off the GPU; failures are retested once before being
reported).

Usage: python tools/device_sweep.py [--skip NAME,NAME] [--timeout S]
Exit code = number of confirmed failures.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

PROBE = """import sys; sys.path.insert(0, {root!r})
import numpy as np
from r4w_tpu.waveforms import create_waveform
from r4w_tpu.core.hostio import to_host, to_device
wf = create_waveform({name!r}, 48000.0)
iq = to_host(wf.modulate(b"device-sweep"))
res = wf.demodulate(to_device(iq))
print("SWEEPOK", len(iq))
"""


def run_one(root: str, name: str, timeout_s: float) -> tuple[bool, str]:
    try:
        r = subprocess.run(
            [sys.executable, "-c", PROBE.format(root=root, name=name)],
            capture_output=True, text=True, timeout=timeout_s)
        if "SWEEPOK" in r.stdout:
            return True, r.stdout.strip().split()[-1]
        tail = [l for l in (r.stdout + r.stderr).splitlines()
                if "Error" in l][-1:]
        return False, (tail[0] if tail else "no output")[:120]
    except subprocess.TimeoutExpired:
        return False, "timeout"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip", default="")
    ap.add_argument("--timeout", type=float, default=420.0)
    ap.add_argument("--cooldown", type=float, default=45.0)
    args = ap.parse_args()
    import pathlib

    root = str(pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    import jax

    jax.config.update("jax_platforms", "cpu")  # listing only
    from r4w_tpu.waveforms import list_waveforms

    skip = set(filter(None, args.skip.split(",")))
    names = [n for n in sorted(list_waveforms()) if n not in skip]
    failures = []
    for n in names:
        t0 = time.time()
        ok, info = run_one(root, n, args.timeout)
        if not ok:
            # wedge suspicion: cool down, retest once
            time.sleep(args.cooldown)
            ok, info = run_one(root, n, args.timeout)
        status = "OK  " if ok else "FAIL"
        print(f"{n:18s} {status} {info} ({time.time() - t0:.0f}s)",
              flush=True)
        if not ok:
            failures.append(n)
    print(f"\n{len(names) - len(failures)}/{len(names)} OK"
          + (f"; failures: {failures}" if failures else ""))
    return len(failures)


if __name__ == "__main__":
    raise SystemExit(main())
