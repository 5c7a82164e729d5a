#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port with ``nvcc`` (one process each,
   all started together), timed, with ``-Xptxas -v`` output;
3. kernel phase: each kernel against its plain PyTorch version on the
   card, bitwise on q and scales, at the main path's shapes and at ragged
   ones, on random inputs;
4. slice phase at full width: the paper's ``vgg11_thinned`` on 6,400
   synthetic CIFAR-like images over 8 clients, FSFL, cohorts of 4:
   2 rounds of ``device_encode_int8`` and 1 of ``codec_int8_k4`` through
   ``run_scenario``, with the launch counters set to 0 before and read
   after each path.  The first buffer each kernel is given there (a
   copy) is kept: recon deltas on the quantization grid, where the int8
   rounding meets exact ties.  Each kernel is held bitwise against its
   plain version on that buffer and timed on it with CUDA events (median
   of 50 launches after warm-up, L2 flushed before each) beside the plain
   version and the memory bound.  Then a small-input check that the tiny
   scenario VGG, 2 rounds with 3 local steps per client, gives the same
   bytes and nearly the same model on the card as the plain path on the
   CPU;
5. a JSON summary of the run (build, rounds, profile), a JSON line with
   every ported kernel's launches and times, the device line, and the
   final ``{"ok": true, ...}`` line: the figures a reader needs sit in the
   last lines of the output.

Between 4 and 5 one more ``device_encode_int8`` round runs under
``torch.profiler`` to print where a round's time goes (device-busy share
and the kernels that take the most device time); the profiler's own host
overhead makes that round slower than the unprofiled ones.

It imports nothing of the JAX package.  Without CUDA, or without the
repository's ``src/`` beside it, it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense): HBM3 rate, float32 outside the
# tensor cores.  Rated at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# per element: |d|, compare, select, |kept|, max, divide, round, clip
OPS_PER_ELEMENT = 8

MAIN_K, MAIN_N = 4, 850_304      # the cohort buffer of vgg11_thinned
PAYLOAD_BYTES = 880_956          # one client's v1 int8-blockscale payload
RAGGED_N = (0, 5, 127, 128, 777, 1000)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(k: int, n: int, block: int) -> tuple[float, str]:
    """Least time for one call: each input byte read once, each output
    byte written once, against the element-wise float32 operations."""
    nblk = -(-n // block)
    nbytes = k * n * 4 + 4 + k * n + k * nblk * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = k * n * OPS_PER_ELEMENT / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int = 50, warmup: int = 5,
            host_ahead: bool = True) -> float:
    """Median CUDA-event time of one ``fn`` call, the 50 MB L2 flushed
    before each.  With ``host_ahead`` a spin kernel holds the card while
    the host enqueues the call, so the events time the device work alone;
    without it they also take in the wrapper's host time."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if host_ahead:
            torch.cuda._sleep(2_000_000)  # about 1 ms of spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, dc, d, theta: float, block: int, batched: bool) -> float:
    """Kernel vs plain on the card; returns the max |difference| (must be 0)."""
    if batched:
        q, s = dc.delta_compress_batch(d, theta, block=block)
        pq, ps = dc.delta_compress_batch_plain(d, theta, block)
    else:
        q, s = dc.delta_compress(d, theta, block=block)
        pq, ps = dc.delta_compress_plain(d, theta, block)
    torch.cuda.synchronize()
    if q.shape != pq.shape or s.shape != ps.shape:
        fail(f"shape mismatch {tuple(q.shape)} vs {tuple(pq.shape)}")
    if not (torch.equal(q, pq) and torch.equal(s, ps)):
        err = max(float((q.int() - pq.int()).abs().max()),
                  float((s - ps).abs().max()))
        fail(f"kernel disagrees with its plain version (shape "
             f"{tuple(d.shape)}, theta {theta}, block {block}): {err}")
    return 0.0


def kernel_phase(torch, dc) -> int:
    """Kernel vs plain on random inputs; returns the number of checks."""
    gen = torch.Generator().manual_seed(0)
    checks = 0
    for n in RAGGED_N:
        for k in (1, 4, 8):
            for theta in (0.0, 0.05):
                for block in (128, 1024):
                    d = (0.05 * torch.randn((k, n), generator=gen)).cuda()
                    compare(torch, dc, d, theta, block, batched=True)
                    compare(torch, dc, d[0], theta, block, batched=False)
                    checks += 2
    # the main path's shapes: a 90%-sparse delta
    dense = 1e-3 * torch.randn((MAIN_K, MAIN_N), generator=gen)
    main = (dense * (torch.rand((MAIN_K, MAIN_N), generator=gen) < 0.1)).cuda()
    compare(torch, dc, main, 0.0, 128, batched=True)
    compare(torch, dc, main[0].contiguous(), 0.0, 128, batched=False)
    checks += 2
    print(f"kernel phase: {checks} kernel-vs-plain comparisons, all bitwise")
    return checks


def capture_buffers(device_mod) -> tuple[dict, dict]:
    """Wrap the uplink's two kernel entry points so that a copy of the first
    buffer each is given is kept; returns (captured, originals)."""
    captured, originals = {}, {}
    for name in ("delta_compress_batch", "delta_compress"):
        fn = originals[name] = getattr(device_mod, name)

        def keep(d, theta, *, block, _fn=fn, _name=name):
            if _name not in captured:
                captured[_name] = (d.clone(), theta, block)
            return _fn(d, theta, block=block)
        setattr(device_mod, name, keep)
    return captured, originals


def main_path_kernels(torch, dc, captured) -> dict:
    """Each kernel against its plain version on the buffer the main path
    gave it, bitwise, then timed on it beside its plain version."""
    timings = {}
    for name, batched in (("delta_compress_batch", True),
                          ("delta_compress", False)):
        if name not in captured:
            fail(f"the main path gave {name} no buffer")
        d, theta, block = captured[name]
        err = compare(torch, dc, d, theta, block, batched=batched)
        rows = d if batched else d[None]
        kept = torch.where(rows.abs() >= theta, rows, 0.0)
        _, scale = dc.delta_compress_batch_plain(rows, theta, block)
        x = (kept.reshape(rows.shape[0], -1, block)
             / scale[..., None]).reshape(rows.shape)
        ties = int((x - x.floor() == 0.5).sum())
        nkept = int((kept != 0).sum())
        if batched:
            kernel = lambda: dc.delta_compress_batch(d, theta, block=block)
            plain = lambda: dc.delta_compress_batch_plain(d, theta, block)
        else:
            kernel = lambda: dc.delta_compress(d, theta, block=block)
            plain = lambda: dc.delta_compress_plain(d, theta, block)
        k, n = rows.shape
        t = timings[name] = dict(
            ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain),
            call_ms=time_ms(torch, kernel, host_ahead=False),
            bound=bound_ms(k, n, block), max_abs_err=err,
            shape=list(d.shape), kept=nkept, ties=ties)
        print(f"  {name} {t['shape']} block {block} on the main path's "
              f"buffer: bitwise, {nkept} kept elements, "
              f"{ties} exact half-way ties; kernel {t['ms']:.4f} ms (whole "
              f"wrapper call {t['call_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]})")
    return timings


def slice_phase(torch, dc, fl, models, data):
    task = data.synthetic.CIFAR_LIKE
    x, y = data.synthetic.make_image_dataset(
        torch.Generator().manual_seed(0), task, 6400)
    splits = data.federated.split_federated(torch.Generator().manual_seed(1),
                                            x, y, 8)
    print(f"slice phase: vgg11_thinned, {splits.num_clients} clients x "
          f"{splits.n_train} training images, test set {len(splits.test_y)}")
    launches, rounds_out = {}, []
    for scenario, rounds, kernel, per_round in (
            ("device_encode_int8", 2, "delta_compress_batch", 1),
            ("codec_int8_k4", 1, "delta_compress", 4)):
        dc.reset_counters()
        res = fl.run_scenario(scenario, rounds=rounds,
                              model=models.vgg11_thinned(), splits=splits,
                              device="cuda")
        torch.cuda.synchronize()
        counts = dict(dc.LAUNCHES)
        for rec in res.records:
            print(f"  {scenario} round {rec.round}: test_acc={rec.test_acc:.4f}"
                  f" train_loss={rec.train_loss:.4f} up_bytes={rec.up_bytes}"
                  f" wall_s={rec.wall_s:.3f}")
            rounds_out.append([scenario, rec.round, rec.test_acc,
                               rec.train_loss, rec.up_bytes, rec.wall_s])
            if rec.up_bytes != 4 * PAYLOAD_BYTES:
                fail(f"{scenario}: up_bytes {rec.up_bytes} != "
                     f"{4 * PAYLOAD_BYTES}")
            if not (math.isfinite(rec.train_loss)
                    and 0.0 <= rec.test_acc <= 1.0):
                fail(f"{scenario}: non-finite loss or accuracy {rec}")
        print(f"  {scenario} launches: {counts}")
        if counts[kernel] != per_round * rounds:
            fail(f"{scenario}: {kernel} launched {counts[kernel]} times, "
                 f"expected {per_round * rounds}")
        other = sum(v for k, v in counts.items() if k != kernel)
        if other:
            fail(f"{scenario}: unexpected launches {counts}")
        for name, leaf in [(f"{m}/{n}", v) for m, d in res.server.params.items()
                           for n, v in d.items()]:
            if not torch.isfinite(leaf).all():
                fail(f"{scenario}: non-finite server param {name}")
        launches[kernel] = counts[kernel]
    return launches, splits, rounds_out


def small_input_check(torch, fl) -> dict:
    """The tiny scenario VGG with 1,280 samples (3 local steps per client),
    2 rounds from the same seed, on the card and on the CPU's plain path:
    equal bytes and nearly the same model.

    Convolutions sum in another order in cuDNN than on the CPU, so an
    element of one client's update may cross a rounding boundary (the
    server's mean moves by at most one quantization step) or the top-k
    threshold (it moves by that client's whole update).  So, as
    tests/test_torch_slice.py holds the port against the reference: every
    server param within one quantization step except at most 5 flips, at
    most 34 (0.5%) params off by more than 1e-6, every scale within one
    fine step per round, and test accuracy within one of the 192 images."""
    name, rounds = "device_encode_int8", 2
    s = fl.get_scenario(name)
    cfg = fl.build_protocol(s, rounds)
    runs = {}
    for dev in ("cpu", "cuda"):
        model, splits = fl.default_setting(s.num_clients, n_samples=1280)
        runs[dev] = fl.run_scenario(name, rounds=rounds, model=model,
                                    splits=splits, device=dev)
    cpu, gpu = runs["cpu"], runs["cuda"]
    n_test = len(splits.test_y)
    for rc, rg in zip(cpu.records, gpu.records):
        if rc.up_bytes != rg.up_bytes:
            fail(f"small input: round {rc.round} up_bytes differ between "
                 f"card and CPU")
        if abs(rc.test_acc - rg.test_acc) > 1 / n_test + 1e-6:
            fail(f"small input: round {rc.round} test_acc {rg.test_acc} on "
                 f"the card, {rc.test_acc} on the CPU")

    def diffs(attr):
        return torch.cat([(getattr(gpu.server, attr)[m][n].cpu() - v)
                          .abs().reshape(-1)
                          for m, d in getattr(cpu.server, attr).items()
                          for n, v in d.items()])
    dp, ds = diffs("params"), diffs("scales")
    flips = int((dp > cfg.step_size * 1.01).sum())
    off = int((dp > 1e-6).sum())
    print(f"small input: {rounds} rounds, up_bytes {gpu.records[-1].up_bytes}"
          f" on both; max |param diff| {dp.max().item():.3g}, {off} of "
          f"{dp.numel()} params off by > 1e-6, {flips} flips; max |scale "
          f"diff| {ds.max().item():.3g} (bound "
          f"{rounds * cfg.fine_step_size:.3g})")
    if (flips > 5 or off > 34
            or ds.max().item() > rounds * cfg.fine_step_size * 1.01):
        fail("small input: the card's model is off the CPU plain path")
    return {"max_param_diff": dp.max().item(), "params_off": off,
            "flips": flips, "max_scale_diff": ds.max().item()}


def profile_round(torch, fl, models, splits) -> dict:
    """One more full-width device_encode_int8 round under torch.profiler:
    device-busy share of the round and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fl.run_scenario("device_encode_int8", rounds=1,
                        model=models.vgg11_thinned(), splits=splits,
                        device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the kernels themselves: an operator's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if not events:
        print("profile: the profiler saw no device time (not measured)")
        return {"wall_ms": wall_ms, "busy_ms": None}
    print(f"profile: one profiled round {wall_ms:.1f} ms wall, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}")
    mine = [e for e in events if "delta_compress" in e.key]
    mine_ms = sum(dev_us(e) for e in mine) / 1e3
    print(f"  delta_compress kernels: {mine_ms:.3f} ms in "
          f"{sum(e.count for e in mine)} launch(es)")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "delta_compress_ms": mine_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import data, fl, models
    from repro_torch.comms import device as device_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import delta_compress as dc

    dev = device_line()
    print(f"device: {dev}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    logs = build.build_all()
    build_s = time.time() - t0
    print(f"build: {len(build.SOURCES)} source(s) in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    checks = kernel_phase(torch, dc)
    t1 = time.time()
    captured, originals = capture_buffers(device_mod)
    launches, splits, rounds_out = slice_phase(torch, dc, fl, models, data)
    for name, fn in originals.items():
        setattr(device_mod, name, fn)
    print(f"slice phase: {time.time() - t1:.1f} s")
    timings = main_path_kernels(torch, dc, captured)
    small = small_input_check(torch, fl)
    prof = profile_round(torch, fl, models, splits)

    replaces = {"delta_compress": "src/repro/kernels/delta_compress.py:47",
                "delta_compress_batch":
                    "src/repro/kernels/delta_compress.py:102"}
    kernels = []
    for name in ("delta_compress_batch", "delta_compress"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/delta_compress.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": None,
            "call_ms": t["call_ms"], "shape": t["shape"]})
        if launches[name] < 1:
            fail(f"{name} was not launched on the main path")
    print(json.dumps({"summary": {
        "build_s": build_s, "random_input_checks": checks,
        "rounds [scenario, round, test_acc, train_loss, up_bytes, wall_s]":
            rounds_out,
        "main_path_buffers": {n: {"kept": t["kept"], "ties": t["ties"]}
                              for n, t in timings.items()},
        "small_input_card_vs_cpu": small, "profiled_round": prof}}))
    print(json.dumps({"kernels": kernels}))
    print(f"device: {dev}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
