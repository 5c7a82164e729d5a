#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port with ``nvcc`` (one process each,
   all started together), timed, with ``-Xptxas -v`` output;
3. kernel phase: each kernel against its plain PyTorch version on the
   card on random inputs, bitwise: ``delta_compress`` on q and scales at
   the main path's shapes and ragged ones; ``level_assign`` on levels and
   carry (bit patterns) at every ``vgg11_thinned`` leaf shape (K = 1) and
   at (8, 849,834), with exact half-step and threshold ties;
4. slice phase at full width: the paper's ``vgg11_thinned`` on 6,400
   synthetic CIFAR-like images over 8 clients, FSFL (fixed sparsity 0.9).
   The paper's main path first: 2 rounds of ``sync_full_fedavg_fsfl``
   through ``run_federated`` (all 8 clients, FedAvg, nnc-cabac), whose
   clients run ``level_assign`` once per leaf (224 launches a round), then
   1 round of ``device_encode_cabac``, whose device-encoded payloads are
   held byte for byte against the host encode of the same levels.  Then
   the int8 uplink: 1 round each of ``device_encode_int8`` and
   ``codec_int8_k4`` (cohorts of 4) through ``run_scenario``.  The launch
   counters are set to 0 before and read after each path.  The first
   buffer each kernel is given there (a copy) is kept (for
   ``level_assign`` the first client's 28 leaves): each kernel is held
   bitwise against its plain version on it and timed on it with CUDA
   events (median of 50 launches after warm-up, L2 flushed before each)
   beside the plain version and the memory bound.  Then a small-input
   check, per uplink, that the tiny scenario VGG, 2 rounds with 3 local
   steps per client, gives the same bytes and nearly the same model on
   the card as the plain path on the CPU;
5. a JSON summary of the run (build, rounds, profiles), a JSON line with
   every ported kernel's launches and times, the device line, and the
   final ``{"ok": true, ...}`` line: the figures a reader needs sit in the
   last lines of the output.

Between 4 and 5 one more round of ``sync_full_fedavg_fsfl`` and one of
``device_encode_int8`` run under ``torch.profiler`` to print where a
round's time goes (device-busy share, the kernels that take the most
device time, and the host time in the CABAC coder's spans); the
profiler's own host overhead makes those rounds slower than the
unprofiled ones.

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
VGG_PARAMS, VGG_LEAVES = 849_834, 28
# level_assign per element: add, |.|, compare, select, divide, round,
# clip (2), multiply, subtract (about 8 to 10); bytes: d and r read,
# level and carry written
LA_OPS_PER_ELEMENT = 10
LA_BYTES_PER_ELEMENT = 16
# host spans of the coding stack (repro_torch.runtime.span)
SPANS = ("codec.encode_batch", "codec.decode_batch", "nnc.encode",
         "nnc.decode", "cabac.pass1.state_scan", "cabac.pass2.range_encode")


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


def la_bound_ms(elements: int) -> tuple[float, str]:
    """Least time for ``level_assign`` over ``elements``: 16 bytes each
    (plus theta and step) against its float32 operations."""
    t_bytes = (elements * LA_BYTES_PER_ELEMENT + 8) / HBM_BYTES_PER_S * 1e3
    t_ops = elements * LA_OPS_PER_ELEMENT / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int = 50, warmup: int = 5,
            host_ahead: bool = True, spin: int = 2_000_000) -> float:
    """Median CUDA-event time of one ``fn`` call, the 50 MB L2 flushed
    before each.  With ``host_ahead`` a spin kernel of ``spin`` cycles
    (2,000,000 is about 1 ms) holds the card while the host enqueues the
    call, so the events time the device work alone; without it they also
    take in the wrapper's host time."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if host_ahead:
            torch.cuda._sleep(spin)
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


def la_inputs(torch, gen, k: int, n: int, step: float):
    """(d, r, theta) on the card: random values, exact half-steps of a
    power-of-two step (r = 0 there), and values equal to +-theta, theta
    itself one of the |d + r|."""
    d = 1e-2 * torch.randn((k, n), generator=gen)
    r = 1e-3 * torch.randn((k, n), generator=gen)
    m = torch.randint(-40, 40, (k, n), generator=gen).to(torch.float32)
    half = torch.rand((k, n), generator=gen) < 0.3
    d = torch.where(half, (m + 0.5) * step, d)
    r = torch.where(half, 0.0, r)
    theta = (d + r).abs().reshape(-1)[(7 * n) % (k * n)].clone()
    ties = torch.rand((k, n), generator=gen) < 0.05
    sign = torch.where(torch.rand((k, n), generator=gen) < 0.5, -1.0, 1.0)
    d = torch.where(ties, sign * theta, d)
    r = torch.where(ties, 0.0, r)
    return d.cuda(), r.cuda(), theta.cuda()


def la_compare(torch, la, d, r, theta, step) -> float:
    """level_assign kernel vs plain on the card, levels and carry bit
    patterns; returns the max |carry difference| (must be 0)."""
    lv, c = la.level_assign(d, r, theta, step)
    pl, pc = la.level_assign_plain(d, r, theta, step)
    torch.cuda.synchronize()
    if lv.shape != pl.shape or c.shape != pc.shape:
        fail(f"level_assign shape mismatch {tuple(lv.shape)} vs "
             f"{tuple(pl.shape)}")
    if not (torch.equal(lv, pl)
            and torch.equal(c.view(torch.int32), pc.view(torch.int32))):
        err = max(float((lv - pl).abs().max()), float((c - pc).abs().max()))
        fail(f"level_assign disagrees with its plain version (shape "
             f"{tuple(d.shape)}): {err}")
    return 0.0


def la_kernel_phase(torch, la, models) -> int:
    """level_assign vs plain at every vgg11_thinned leaf shape (K = 1) and
    at the (8, 849,834) cohort; returns the number of checks."""
    gen = torch.Generator().manual_seed(1)
    params, _ = models.vgg11_thinned().init(torch.Generator().manual_seed(0))
    sizes = sorted({v.numel() for d in params.values() for v in d.values()})
    checks = 0
    step = 2.0 ** -11     # half-steps of a power-of-two step are exact
    for n in sizes:
        d, r, theta = la_inputs(torch, gen, 1, n, step)
        for th in (theta, torch.zeros_like(theta)):
            la_compare(torch, la, d, r, th, step)
            la_compare(torch, la, d, r, th, 4.88e-4)
            checks += 2
    d, r, theta = la_inputs(torch, gen, 8, VGG_PARAMS, step)
    la_compare(torch, la, d, r, theta, step)
    la_compare(torch, la, d[:, 1:], r[:, 1:], theta, 4.88e-4)  # n % 4 = 1
    la_compare(torch, la, d[3:4, 5:], r[3:4, 5:], theta, step)  # unaligned
    checks += 3
    print(f"kernel phase: {checks} level_assign-vs-plain comparisons at "
          f"{len(sizes)} leaf sizes and (8, {VGG_PARAMS}), all bitwise")
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


def full_width_splits(torch, data):
    task = data.synthetic.CIFAR_LIKE
    x, y = data.synthetic.make_image_dataset(
        torch.Generator().manual_seed(0), task, 6400)
    splits = data.federated.split_federated(torch.Generator().manual_seed(1),
                                            x, y, 8)
    print(f"slice phase: vgg11_thinned, {splits.num_clients} clients x "
          f"{splits.n_train} training images, test set {len(splits.test_y)}")
    return splits


def check_server(torch, name, server) -> None:
    for tree in (server.params, server.scales):
        for m, d in tree.items():
            for n, v in d.items():
                if not torch.isfinite(v).all():
                    fail(f"{name}: non-finite server value {m}/{n}")


def int8_slice_phase(torch, dc, la, fl, models, splits, rounds_out):
    launches = {}
    for scenario, rounds, kernel, per_round in (
            ("device_encode_int8", 1, "delta_compress_batch", 1),
            ("codec_int8_k4", 1, "delta_compress", 4)):
        dc.reset_counters()
        la.reset_counters()
        res = fl.run_scenario(scenario, rounds=rounds,
                              model=models.vgg11_thinned(), splits=splits,
                              device="cuda")
        torch.cuda.synchronize()
        counts = dict(dc.LAUNCHES)
        la_count = la.LAUNCHES["level_assign"]
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
        print(f"  {scenario} launches: {counts}, level_assign {la_count}")
        if counts[kernel] != per_round * rounds:
            fail(f"{scenario}: {kernel} launched {counts[kernel]} times, "
                 f"expected {per_round * rounds}")
        other = sum(v for k, v in counts.items() if k != kernel)
        if other:
            fail(f"{scenario}: unexpected launches {counts}")
        if la_count != VGG_LEAVES * 4 * rounds:
            fail(f"{scenario}: level_assign launched {la_count} times, "
                 f"expected {VGG_LEAVES * 4 * rounds}")
        check_server(torch, scenario, res.server)
        launches[kernel] = counts[kernel]
    return launches


def capture_level_assign(stages_mod, keep: int) -> list:
    """Wrap the fused stage chain's kernel entry point so that copies of
    the first ``keep`` calls' inputs are kept; returns the list."""
    captured = []
    fn = stages_mod.level_assign

    def wrapped(d, r, theta, step, *, max_level):
        if len(captured) < keep:
            captured.append((d.clone(), r.clone(), theta.clone(),
                             step.clone()))
        return fn(d, r, theta, step, max_level=max_level)

    stages_mod.level_assign = wrapped
    return captured


def checked_cohort_encode(torch, codecs_mod, comms, tree_row, tree_map,
                          checked: list):
    """Wrap ``NncCabacCodec.encode_cohort``: each device-encoded payload is
    held byte for byte against the host ``encode_batch`` of the same
    levels.  Returns the original method."""
    orig = codecs_mod.NncCabacCodec.encode_cohort

    def encode_cohort(self, out, spec, *, clients=None):
        rows = orig(self, out, spec, clients=clients)
        lv_p, lv_s = tree_map(torch.Tensor.cpu, (out.levels_params,
                                                 out.levels_scales))
        host = self.encode_batch([comms.ClientUpdate(
            tree_row(lv_p, i), tree_row(lv_s, i),
            tree_row(out.recon_delta_params, i),
            tree_row(out.recon_delta_scales, i))
            for i in range(len(rows))], spec)
        if rows != host:
            bad = [i for i, (a, b) in enumerate(zip(rows, host)) if a != b]
            fail(f"device-encoded nnc payloads differ from the host "
                 f"encode for cohort rows {bad}")
        checked.append([len(p) for p in rows])
        return rows

    codecs_mod.NncCabacCodec.encode_cohort = encode_cohort
    return orig


def nnc_slice_phase(torch, la, fl, fsfl, models, splits, rounds_out,
                    checked: list):
    """The paper's main path: 2 rounds of sync_full_fedavg_fsfl through
    run_federated, then 1 round of device_encode_cabac."""
    launches = {}
    for scenario, rounds in (("sync_full_fedavg_fsfl", 2),
                             ("device_encode_cabac", 1)):
        s = fl.get_scenario(scenario)
        cfg = fl.build_protocol(s, rounds)
        la.reset_counters()
        if scenario == "sync_full_fedavg_fsfl":
            res = fsfl.run_federated(models.vgg11_thinned(), cfg, splits,
                                     rounds, device="cuda")
        else:
            res = fl.run_scenario(scenario, rounds=rounds,
                                  model=models.vgg11_thinned(),
                                  splits=splits, device="cuda")
        torch.cuda.synchronize()
        count = la.LAUNCHES["level_assign"]
        for rec in res.records:
            print(f"  {scenario} round {rec.round}: "
                  f"test_acc={rec.test_acc:.4f} "
                  f"train_loss={rec.train_loss:.4f} "
                  f"up_bytes={rec.up_bytes} "
                  f"sparsity={rec.update_sparsity:.4f} "
                  f"wall_s={rec.wall_s:.3f}")
            rounds_out.append([scenario, rec.round, rec.test_acc,
                               rec.train_loss, rec.up_bytes, rec.wall_s])
            if not (math.isfinite(rec.train_loss)
                    and 0.0 <= rec.test_acc <= 1.0 and rec.up_bytes > 0):
                fail(f"{scenario}: bad round record {rec}")
            if len(rec.participants) != splits.num_clients:
                fail(f"{scenario}: {len(rec.participants)} participants")
        print(f"  {scenario} launches: level_assign {count} "
              f"({count / rounds:.0f} a round)")
        if count != VGG_LEAVES * splits.num_clients * rounds:
            fail(f"{scenario}: level_assign launched {count} times, "
                 f"expected {VGG_LEAVES * splits.num_clients * rounds}")
        check_server(torch, scenario, res.server)
        launches[scenario] = count
    if not checked:
        fail("device_encode_cabac encoded no cohort on the device")
    print(f"  device_encode_cabac: {sum(len(c) for c in checked)} "
          f"device-encoded payloads byte-equal to the host encode")
    return launches


def la_main_path(torch, la, captured) -> dict:
    """level_assign against its plain version on the buffers the main path
    gave it (the first client's 28 leaves), bitwise, then timed: the first
    buffer, the largest, and the client's whole chain of 28 launches."""
    if len(captured) != VGG_LEAVES:
        fail(f"the main path gave level_assign {len(captured)} buffers, "
             f"expected {VGG_LEAVES}")
    kept = ties = 0
    for d, r, theta, step in captured:
        la_compare(torch, la, d, r, theta, step)
        carried = d + r
        x = torch.where(carried.abs() >= theta, carried, 0.0) / step
        kept += int((x != 0).sum())
        ties += int((x - x.floor() == 0.5).sum())
    first = captured[0]
    largest = max(captured, key=lambda c: c[0].numel())

    def one(c):
        return lambda: la.level_assign(*c)

    def one_plain(c):
        return lambda: la.level_assign_plain(*c)

    def chain(fn):
        return lambda: [fn(*c) for c in captured]

    # the client's chain enqueues 28 wrapper calls (about 2 ms of host
    # time): a 20 ms spin keeps the card waiting until all are queued
    out = {}
    for label, kernel, plain, n, spin in (
            ("first", one(first), one_plain(first), first[0].numel(),
             2_000_000),
            ("largest", one(largest), one_plain(largest),
             largest[0].numel(), 2_000_000),
            ("client", chain(la.level_assign), chain(la.level_assign_plain),
             sum(c[0].numel() for c in captured), 40_000_000)):
        out[label] = dict(
            ms=time_ms(torch, kernel, spin=spin),
            plain_ms=time_ms(torch, plain, spin=spin),
            call_ms=time_ms(torch, kernel, host_ahead=False),
            bound=la_bound_ms(n), elements=n)
        o = out[label]
        print(f"  level_assign {label} ({n} elements) on the main path's "
              f"buffer: bitwise; kernel {o['ms']:.4f} ms (whole wrapper "
              f"call {o['call_ms']:.4f} ms), plain {o['plain_ms']:.4f} ms, "
              f"bound {o['bound'][0]:.5f} ms ({o['bound'][1]})")
    out["first"]["shape"] = list(first[0].shape)
    out["largest"]["shape"] = list(largest[0].shape)
    out["kept"], out["ties"] = kept, ties
    print(f"  level_assign main-path buffers: {kept} kept elements with a "
          f"nonzero quotient, {ties} exact half-way ties")
    return out


def capture_levels(rounds_mod) -> tuple[list, object]:
    """Wrap ``Uplink.intake`` so that each round's stacked params levels
    are kept on the host; returns (log, original)."""
    log = []
    orig = rounds_mod.Uplink.intake

    def intake(self, out, clients):
        log.append({f"{m}/{n}": v.cpu() for m, d in out.levels_params.items()
                    for n, v in d.items()})
        return orig(self, out, clients)

    rounds_mod.Uplink.intake = intake
    return log, orig


def small_input_check(torch, fl, rounds_mod, name: str) -> dict:
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
    fine step per round, and test accuracy within one of the 192 images.
    Bytes: the int8 payload's length is fixed, so equal; an nnc-cabac
    payload is equal where every client's levels are, else within 0.5%."""
    rounds = 2
    s = fl.get_scenario(name)
    cfg = fl.build_protocol(s, rounds)
    runs, levels = {}, {}
    for dev in ("cpu", "cuda"):
        model, splits = fl.default_setting(s.num_clients, n_samples=1280)
        levels[dev], orig = capture_levels(rounds_mod)
        runs[dev] = fl.run_scenario(name, rounds=rounds, model=model,
                                    splits=splits, device=dev)
        rounds_mod.Uplink.intake = orig
    cpu, gpu = runs["cpu"], runs["cuda"]
    n_test = len(splits.test_y)
    differing = []
    for rc, rg, lc, lg in zip(cpu.records, gpu.records, levels["cpu"],
                              levels["cuda"]):
        diff = sum(int((lc[k] != lg[k]).sum()) for k in lc)
        differing.append(diff)
        exact = diff == 0 or name.endswith("int8")
        if (rc.up_bytes != rg.up_bytes if exact
                else abs(rc.up_bytes - rg.up_bytes) > 0.005 * rc.up_bytes):
            fail(f"small input {name}: round {rc.round} up_bytes "
                 f"{rg.up_bytes} on the card, {rc.up_bytes} on the CPU "
                 f"({diff} differing levels)")
        if abs(rc.test_acc - rg.test_acc) > 1 / n_test + 1e-6:
            fail(f"small input {name}: round {rc.round} test_acc "
                 f"{rg.test_acc} on the card, {rc.test_acc} on the CPU")

    def diffs(attr):
        return torch.cat([(getattr(gpu.server, attr)[m][n].cpu() - v)
                          .abs().reshape(-1)
                          for m, d in getattr(cpu.server, attr).items()
                          for n, v in d.items()])
    dp, ds = diffs("params"), diffs("scales")
    flips = int((dp > cfg.step_size * 1.01).sum())
    off = int((dp > 1e-6).sum())
    print(f"small input {name}: {rounds} rounds, up_bytes "
          f"{[r.up_bytes for r in gpu.records]} on the card, "
          f"{[r.up_bytes for r in cpu.records]} on the CPU; differing levels "
          f"{differing}; max |param diff| {dp.max().item():.3g}, {off} of "
          f"{dp.numel()} params off by > 1e-6, {flips} flips; max |scale "
          f"diff| {ds.max().item():.3g} (bound "
          f"{rounds * cfg.fine_step_size:.3g})")
    if (flips > 5 or off > 34
            or ds.max().item() > rounds * cfg.fine_step_size * 1.01):
        fail(f"small input {name}: the card's model is off the CPU plain "
             f"path")
    return {"max_param_diff": dp.max().item(), "params_off": off,
            "flips": flips, "max_scale_diff": ds.max().item(),
            "differing_levels": differing,
            "up_bytes_card": [r.up_bytes for r in gpu.records],
            "up_bytes_cpu": [r.up_bytes for r in cpu.records]}


def profile_round(torch, run, label: str, mine: str) -> dict:
    """One more full-width round under torch.profiler: device-busy share,
    the top kernels by device time, the kernels whose name holds ``mine``,
    and the host time in the coding stack's spans."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    averages = prof.key_averages()
    spans = {e.key: e.cpu_time_total / 1e3 for e in averages
             if e.key in SPANS}
    # the kernels themselves: an operator's entry repeats its kernels' time
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if not events:
        print(f"profile {label}: the profiler saw no device time "
              f"(not measured)")
        return {"wall_ms": wall_ms, "busy_ms": None, "host_spans_ms": spans}
    print(f"profile {label}: one profiled round {wall_ms:.1f} ms wall, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}")
    ours = [e for e in events if mine in e.key]
    ours_ms = sum(dev_us(e) for e in ours) / 1e3
    print(f"  {mine} kernels: {ours_ms:.3f} ms in "
          f"{sum(e.count for e in ours)} launch(es)")
    for key in SPANS:
        if key in spans:
            print(f"  host span {key}: {spans[key]:.1f} ms")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, f"{mine}_ms": ours_ms,
            f"{mine}_launches": sum(e.count for e in ours),
            "host_spans_ms": spans}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import comms, data, fl, models
    from repro_torch.comms import codecs as codecs_mod
    from repro_torch.comms import device as device_mod
    from repro_torch.comms import stages as stages_mod
    from repro_torch.core import fsfl
    from repro_torch.fl import rounds as rounds_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import delta_compress as dc
    from repro_torch.kernels import level_assign as la
    from repro_torch.tree import row, tree_map

    t_start = time.time()
    phases = {}

    def phase(name, since):
        phases[name] = time.time() - since
        print(f"[{time.time() - t_start:7.1f} s] {name} took "
              f"{phases[name]:.1f} s")
        return time.time()

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

    t1 = phase("build", t0)
    checks = kernel_phase(torch, dc) + la_kernel_phase(torch, la, models)
    t1 = phase("kernel phase", t1)
    splits = full_width_splits(torch, data)
    rounds_out = []

    # the paper's main path: nnc-cabac, all 8 clients, level_assign
    la_captured = capture_level_assign(stages_mod, VGG_LEAVES)
    cohorts = []
    orig_cohort = checked_cohort_encode(torch, codecs_mod, comms, row,
                                        tree_map, cohorts)
    la_launches = nnc_slice_phase(torch, la, fl, fsfl, models, splits,
                                  rounds_out, cohorts)
    codecs_mod.NncCabacCodec.encode_cohort = orig_cohort
    stages_mod.level_assign = la.level_assign
    t1 = phase("nnc slice phase", t1)

    # the int8 uplink
    captured, originals = capture_buffers(device_mod)
    launches = int8_slice_phase(torch, dc, la, fl, models, splits,
                                rounds_out)
    for name, fn in originals.items():
        setattr(device_mod, name, fn)
    t1 = phase("int8 slice phase", t1)

    timings = main_path_kernels(torch, dc, captured)
    la_timing = la_main_path(torch, la, la_captured)
    t1 = phase("main-path buffers", t1)
    small = {name: small_input_check(torch, fl, rounds_mod, name)
             for name in ("sync_full_fedavg_fsfl", "device_encode_int8")}
    t1 = phase("small-input checks", t1)
    prof = {
        "sync_full_fedavg_fsfl": profile_round(
            torch, lambda: fl.run_scenario(
                "sync_full_fedavg_fsfl", rounds=1,
                model=models.vgg11_thinned(), splits=splits, device="cuda"),
            "sync_full_fedavg_fsfl", "level_assign"),
        "device_encode_int8": profile_round(
            torch, lambda: fl.run_scenario(
                "device_encode_int8", rounds=1,
                model=models.vgg11_thinned(), splits=splits, device="cuda"),
            "device_encode_int8", "delta_compress")}
    phase("profiled rounds", t1)

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
    first = la_timing["first"]
    kernels.append({
        "name": "level_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/level_assign.cu",
        "replaces": "src/repro/kernels/level_assign.py:46",
        "launches": la_launches["sync_full_fedavg_fsfl"], "max_abs_err": 0.0,
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound"][0], "bound_by": first["bound"][1],
        "library_ms": None, "call_ms": first["call_ms"],
        "shape": first["shape"],
        "largest": {k: la_timing["largest"][k] for k in
                    ("shape", "ms", "plain_ms", "call_ms", "bound")},
        "client_28_leaves": {k: la_timing["client"][k] for k in
                             ("elements", "ms", "plain_ms", "call_ms",
                              "bound")}})
    if la_launches["sync_full_fedavg_fsfl"] < 1:
        fail("level_assign was not launched on the main path")
    print(json.dumps({"summary": {
        "build_s": build_s, "phase_s": phases,
        "total_s": time.time() - t_start, "random_input_checks": checks,
        "rounds [scenario, round, test_acc, train_loss, up_bytes, wall_s]":
            rounds_out,
        "main_path_buffers": {
            **{n: {"kept": t["kept"], "ties": t["ties"]}
               for n, t in timings.items()},
            "level_assign": {"kept": la_timing["kept"],
                             "ties": la_timing["ties"]}},
        "device_encoded_nnc_payloads": cohorts,
        "small_input_card_vs_cpu": small, "profiled_rounds": prof}}))
    print(json.dumps({"kernels": kernels}))
    print(f"device: {dev}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
