"""The smallest reproduction of the profiler fault that ``chip_smoke.py``
met after the transformer phase: after a long stretch of device work,
``torch.profiler`` drops device records as out of its capture window.

    python -m repro_torch.launch.profiler_fault

On the card: a profiled session of two device operations (one kernel,
one device-to-host copy), eight times; then 2M tiny kernels (an ``add_``
on 256 floats); then the same sessions again, plain and with
one second of host time inside each end, and ``obs.trace.device_trace``
on those two operations and on 2,000 tiny kernels.  Prints one line a
battery and, last, one JSON object of them all.  It reads how many
records a session kept, and checks only that a session ``device_trace``
calls whole holds every one.
"""
from __future__ import annotations

import json
import time

import torch

from repro_torch.obs.trace import device_trace
from repro_torch.runtime import resolve_device


def _kept(fn, pad_s: float) -> int:
    """The device records a plain profiled session of ``fn`` kept."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _traced(fn, want: int) -> list:
    """``device_trace`` of ``fn`` -> [operations, attempt, whole], or
    ["raised"] where ten sessions in a row dropped records."""
    try:
        rows, _, attempt, whole = device_trace(fn, need_all=False)
    except RuntimeError:
        return ["raised"]
    got = sum(e.count for e in rows)
    assert not whole or got == want, (got, want)
    return [got, attempt, whole]


LAUNCHES = 2_000_000


def main() -> dict:
    resolve_device("cuda")
    x = torch.ones(1 << 20, device="cuda")
    small = torch.ones(256, device="cuda")

    def two():
        x.add_(1)
        x.cpu()

    def many():
        for _ in range(2000):
            small.add_(1)

    out = {"device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda}

    def battery(name, value):
        out[name] = value
        print(f"{name}: {value}", flush=True)

    battery("before: records kept of 2, plain sessions",
            [_kept(two, 0.0) for _ in range(8)])
    t0 = time.perf_counter()
    for _ in range(LAUNCHES):
        small.add_(1)
    torch.cuda.synchronize()
    battery(f"{LAUNCHES} tiny launches, s", time.perf_counter() - t0)
    battery("after: records kept of 2, plain sessions",
            [_kept(two, 0.0) for _ in range(8)])
    battery("after: records kept of 2, 1 s inside each end",
            [_kept(two, 1.0) for _ in range(8)])
    battery("after: device_trace of 2 [operations, attempt, whole]",
            [_traced(two, 2) for _ in range(6)])
    battery("after: device_trace of 2000 [operations, attempt, whole]",
            [_traced(many, 2000) for _ in range(4)])
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
