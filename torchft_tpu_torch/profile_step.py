"""Device-time breakdown of one replica group's training step on the card.

    python -m torchft_tpu_torch.profile_step [--out DIR]

Runs ``train_hsdp`` alone (``--min-replicas 1``) at the path's shape
(``llama_small``, flash attention, B=8, S=1024, 8 steps) under the trainer's
torch.profiler window (``TORCHFT_TRACE_DIR``) over steps 4-6, then sums
device time by kernel from the Chrome trace and the device's busy share of
the window. Prints one ``profile: {...}`` JSON line and writes
``summary.json`` under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
TRAINER_ARGS = [
    "--model", "small", "--attn", "flash", "--batch", "8", "--seq", "1024",
    "--steps", "8", "--device", "cuda", "--min-replicas", "1",
]
TRACE_START, TRACE_STEPS = 4, 3


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile(out: Path) -> dict:
    from torchft_tpu_torch.coordination import LighthouseServer

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=1)
    try:
        env = dict(
            os.environ, TORCHFT_LIGHTHOUSE=lighthouse.address(),
            REPLICA_GROUP_ID="0", PYTHONPATH=str(_REPO),
            TORCHFT_TRACE_DIR=str(out / "trace"),
            TORCHFT_TRACE_START=str(TRACE_START),
            TORCHFT_TRACE_COUNT=str(TRACE_STEPS),
        )
        proc = subprocess.run(
            [sys.executable, "-m", "torchft_tpu_torch.train_hsdp",
             *TRAINER_ARGS, "--result-dir", str(out)],
            cwd=str(_REPO), env=env, capture_output=True, text=True,
            timeout=600,
        )
        (out / "train.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"profiled trainer exited {proc.returncode}")
    finally:
        lighthouse.shutdown()
    (trace_file,) = (out / "trace").glob("*.json")
    events = [
        e for e in json.loads(trace_file.read_text())["traceEvents"]
        if e.get("ph") == "X" and "dur" in e
    ]
    device = [
        e for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    ]
    if not device:
        raise AssertionError("the profiler recorded no device activity")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    by_name: dict = {}
    for e in device:
        rec = by_name.setdefault(e["name"], [0, 0.0])
        rec[0] += 1
        rec[1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    result = json.loads((out / "group0.json").read_text())
    result.pop("step_ms", None)
    summary = {
        "window_ms": (t1 - t0) / 1e3,
        "device_busy_ms": _union_us(
            (e["ts"], e["ts"] + e["dur"]) for e in device
        ) / 1e3,
        "device_sum_ms_per_step": sum(e["dur"] for e in device) / 1e3 / TRACE_STEPS,
        "top_per_step": [
            {"name": n[:90], "calls": c / TRACE_STEPS, "ms": us / 1e3 / TRACE_STEPS}
            for n, (c, us) in top
        ],
        "result": result,
    }
    summary["device_busy_share"] = summary["device_busy_ms"] / summary["window_ms"]
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    return summary


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", default=str(_REPO / "chiprun_out" / "profile_step"),
        help="directory for the trace, the trainer's log and summary.json",
    )
    args = parser.parse_args()
    print("profile: " + json.dumps(profile(Path(args.out))), flush=True)


if __name__ == "__main__":
    main()
