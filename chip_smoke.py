#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port with ``nvcc`` (one process each,
   all started together), timed, with ``-Xptxas -v`` output;
3. kernel phase: each kernel against its plain PyTorch version on the
   card on random inputs: ``delta_compress`` bitwise on q and scales at
   the main path's shapes and ragged ones, and its grouped entry
   ``int8_encode_leaves`` (the int8 wire body in one launch) on a
   client's and a cohort of 4's ``vgg11_thinned`` leaves and on leaf
   views at every 4-byte offset mod 16; ``level_assign`` bitwise on
   levels and carry (bit patterns) at every ``vgg11_thinned`` leaf shape
   (K = 1) and at (8, 849,834), with exact half-step and threshold ties,
   and its grouped entry ``level_assign_leaves`` on the 28 leaves of a
   client, on unaligned leaf views and on more leaves than one launch
   takes;
   ``delta_apply`` bitwise at every leaf size and 849,834 with coef +1,
   -1 and 0.5 and on unaligned views, and its grouped entry
   ``delta_apply_leaves`` on the 28 leaves of a broadcast with the levels
   at every byte offset mod 16, the values views into one flat buffer,
   and on more leaves than one launch takes; ``row_stats`` at rtol 1e-6
   at the six (M, N) views of the weight leaves and ragged shapes, and its
   grouped entry ``row_stats_leaves`` on the 10 weight views of a client
   and on unaligned views, bitwise equal to one-view launches;
   ``scaled_matmul``'s forward, dx, dw and ds within the float32 error
   bound at the dense layers' shapes (M = 32, 120, 960) and ragged ones,
   and its one-launch backward for every subset of (dx, dw, ds) there,
   each run twice to the same bits; and every grouped kernel on the
   leaves of ``resnet18_small(20, 3)`` and ``vgg16_tiny(2, 1)``: the int8
   encode in two launches (110, 68 and 4 x 110 entries, and the split
   inside the params and at the scales), ``level_assign_leaves`` on 55
   and 34 leaves, ``delta_apply_leaves`` on 55, ``row_stats_leaves`` on
   20 and 12 views (rows of 9), ``scaled_matmul`` at N = 20 and 2; and on
   the leaves of ``mobilenetv2_small(20, 3)``: the int8 encode of its 124
   entries in two launches (a message under the default and the
   projection-only scale predicate, a cohort of 4), ``level_assign_leaves``
   and ``delta_apply_leaves`` on 62 leaves, ``row_stats_leaves`` on its 21
   views (six depthwise ones, rows of 9); and the two kernels that take a
   cohort in one launch: ``scaled_matmul`` at K = 8 rows of (32, 128,
   128), (32, 10, 128), (32, 20, 128) and (120, 128, 128), every direction
   and backward subset within the error bound, ``level_assign_leaves`` on
   8 rows of the 28, 55 and 62 leaves of the three models, bitwise; each
   row bitwise its own launch, each timed beside its plain version, the
   bound and (``scaled_matmul``) ``torch.bmm`` and a multiply;
4. slice phase at full width: the paper's ``vgg11_thinned`` on 6,400
   synthetic CIFAR-like images over 8 clients, FSFL (fixed sparsity 0.9),
   batch 32 (17 local steps).  The launch counters are set to 0 before
   and read after each path, and a path whose kernel was not launched
   the expected number of times fails.  Every path runs the engine's
   default executor, the batched one, which trains a cohort (or an async
   window) in one call: its dense layers take one ``scaled_matmul``
   launch a step for the cohort, 110 forward and 102 backward launches a
   round whatever its size (55 and 51 with one dense layer), the backward
   computing dx, dw, ds 816, 272, 544 times over 8 clients, and its
   stage chain one ``level_assign`` launch over every client's leaves:

   * the paper's main path: 2 rounds of ``sync_full_fedavg_fsfl`` through
     ``run_federated`` (all 8 clients, FedAvg, nnc-cabac; ``level_assign``
     once a round over the 8 clients' 28 leaves), then 1
     round of
     ``device_encode_cabac``, whose device-encoded payloads are held byte
     for byte against the host encode of the same levels;
   * the int8 uplink: 1 round each of ``device_encode_int8`` and
     ``codec_int8_k4`` (cohorts of 4) through ``run_scenario``;
   * bidirectional compression (§5.2).  Path A: 2 rounds of
     ``run_federated(bidirectional=True)`` and 1 of ``bidi_sync_full``
     (nnc-cabac both legs, ``level_assign`` on both: 2 a round).  Path
     B: 2 rounds of the adaptive Eqs. 2+3 setting ``fsfl_dyn``,
     bidirectional (``row_stats`` once per client and once on the
     downlink, each launch over the 10 weight views: 9 a round).  Path C:
     2 rounds with int8-blockscale on both legs, cohorts of 4
     (``delta_apply`` 2 a round: the downlink's residual and the server's
     apply, each one launch over the 28 leaves), the server's params after
     each apply held bitwise against the host decode of the broadcast plus
     the old params;
   * partial updates, wire schema v2 and the channel.  Path D: 2 rounds
     of ``partial_fc_k4`` (nnc-cabac, cohorts of 4, only ``fc*`` trains
     and goes on the wire; 1 ``level_assign`` a round), the frozen server
     leaves bitwise unchanged after each round, the decoded payloads zero
     there, each payload shorter than its levels sent unmasked.  Path E:
     an ad-hoc ``partial_int8_v2_lossy_k4`` (D's partial updates with
     int8-blockscale, the device cohort encode, schema v2 and
     ``chan_lossy_k4``'s channel), 2 rounds and a third only if no drop
     fell on a cohort: 29,473-byte payloads with header 2 and the
     client's BN rows as tail, one ``int8_encode_leaves`` launch a cohort
     over 32 entries (bitwise to plain on a copy of the first cohort's
     leaves, and timed there), a dropped client's residual bitwise its
     carry plus its decoded delta, the survivors as participants,
     ``sim_time_s`` the channel's ``round_time`` summed.  One round of
     ``bnwire_v2_full``: each payload its v1 encode + 6,913 bytes, the
     server's BN state bitwise the mean of the survivors' device rows;
   * the FedOpt engine and buffered async.  Path F: 2 aggregations of
     ``async_b4_fsfl`` (FedBuff, buffer 4, 4 concurrent clients, one
     completion a window: 4 ``level_assign`` and 434/408
     ``scaled_matmul`` launches an aggregation, one call of the batched
     round a window), the buffer's clients the
     participants, arrivals and ``sim_time_s`` never going backwards,
     staleness within the aggregations before it, the FedBuff weights.
     Path G: 2 rounds of ``noniid_dir1_k4_fedyogi`` (a dirichlet(1.0)
     label partition of the 6,400 images, cohorts of 4, FedYogi; 1
     ``level_assign`` and 110/102 ``scaled_matmul`` a round), the server
     and FedYogi's moments finite.  Path H: 1 aggregation of
     ``async_windowed_b4`` (clients finishing within 0.5 s train in one
     executor call), the counts those of the recorded window sizes;
   * the paper's ResNet and VGG16 settings, each round's launches read at
     its evaluation and held to the prediction.  Path I:
     ``resnet18_small(20, 3)`` on VOC-like data, 2 rounds of
     ``run_federated`` (1 ``level_assign`` and 55/51 ``scaled_matmul``
     a round: one dense layer).  Path J: ``vgg16_tiny(2, 1)`` on X-ray-like
     data (one channel), 2 rounds.  Path K: the ResNet with
     int8-blockscale on both legs, cohorts of 4, the device cohort encode,
     1 round (the cohort's 110 entries in 2 launches, the broadcast's 55
     in 1; 1,337,044-byte payloads up, 1,330,296 down; the server's
     params bitwise the host decode plus add).  Path L: the ResNet with
     ``fsfl_dyn``, bidirectional, 1 round (9 ``row_stats`` launches of 20
     views);
   * MobileNetV2 and the host uplink.  Path M: ``mobilenetv2_small(20,
     3)`` on VOC-like data, 2 rounds of ``run_federated`` (1
     ``level_assign`` and 55/51 ``scaled_matmul`` a round).  Path N: the
     MobileNet with the paper's projection-only scales, int8-blockscale on
     both legs, cohorts of 4, the device encode, 1 round (the cohort's 124
     entries in 2 launches, the broadcast's 62 in 1, the codec's payload
     sizes, the server's params bitwise the host decode plus add).  Path
     O: ``cabac_fast_pool_k8`` (the batched uplink on a forkserver pool of
     2) and ``stream_ingest_k8`` at ``vgg11_thinned`` width, 1 round each,
     their up bytes those of ``sync_full_fedavg_fsfl``'s first round, the
     pool's 2 tasks, the streaming aggregate bitwise the CPU's float64
     fold of the same payloads and within the float32 error bound of the
     gather's mean of them;
   * the executors, 1 round each: held to the reference's executor
     contract (decoded deltas within 1.5 steps, scales within 1.5 fine
     steps, BN within rtol 1e-5, bytes within 2%, accuracy within 0.02)
     on the reference's tiny setting (serial, vmap, and sharded over a
     two-entry mesh of the card) and ``exec_serial_k4`` on the scenario
     VGG with 1,280 images (serial and vmap); read, beside the control
     of the serial round with its params one ulp up, ``exec_serial_k4``
     at full width (one client at a time: 4 ``level_assign`` and 434/408
     ``scaled_matmul``; batched 1 and 110/102; bytes within 2%) and on
     640 images; ``sharded_cohort_full`` on the mesh of every visible
     device, one block of the cohort a device, beside
     ``sync_full_fedavg_fsfl`` through the batched executor: bit for bit
     on one card;
   * the step check (``step_check``): in ``exec_serial_k4``'s full-width
     setting, one local step at a time from each of the serial round's
     17 W-step and 34 S-step states, the cohort route against the serial
     route and the control (params one ulp up), with and without their
     ReLU and max-pool routing forced to the serial forward's: every
     step within ``STEP_FACTOR`` of the control once the routing is
     forced, and every step that breaks the rule as it runs explained by
     flipped decisions within ``TIE_NOISE`` of a tie;
   * the population axis (``population_paths``): the two cohort kernels
     at K = 32 against their plain versions (VGG11's shapes);
     ``pop_100k_diurnal`` at full width, 32 of 10^5 virtual clients a
     round through the sharded store (launches as any batched round, the
     store's counters and spill, load and materialize host ms); the
     memory store against the sharded one bit for bit at full width with
     spills and loads; ``pop_1m_lazy_k32`` and ``churn_midround_async``
     on the scenarios' tiny VGG (churn count, adaptive window sizes);

   Each kernel is then held against its plain version on copies of the
   first buffers its path gave it (``int8_encode_leaves``: the first
   message's and the first cohort's leaves, each copy at its leaf's
   offset mod 16, the bodies also held against the pad/cat/assemble
   route on the one-entry launch: pad, concatenate, one single-buffer
   launch of the same kernel, assemble; timed at every ``per_warp``,
   with that route on the device, its one-entry launch alone, the whole
   ``int8_rows`` call of both routes on the host's clock, and the device operations of one encode of each, from a
   ``torch.profiler`` trace, one kernel and one copy required of the
   grouped route; ``level_assign``: the first cohort's 8 x 28 leaves, in
   one launch and in the 8 one-client launches it replaces;
   ``delta_apply``: the first downlink's residual (coef -1) and the
   server's apply (+1), each over the 28 leaves in one grouped launch and
   in the 28 one-leaf launches it replaces; ``row_stats``: the first
   client's 10 weight views, in one grouped launch and in 10 one-view
   launches (bitwise equal), with the Eq. 3 keep masks and 50%
   ``topk_rows`` indices compared and any flip away from a near-tie
   failing, and ``torch.linalg.vector_norm`` (the row sum of ``|w|``) as
   its library yardstick; ``scaled_matmul``: the forward at each shape
   and the backward at each shape and subset of gradients the main path
   gave it, the cohort's (8, M, K) and the server evaluation's (960,
   K), each run twice to the same bits) and timed there with CUDA
   events (median of 50 launches after warm-up, L2 flushed before each, a
   spin kernel ahead) beside the plain version, the bound and, for
   ``scaled_matmul``, ``torch.bmm`` (``torch.mm`` for the server's) and a
   multiply (the backward: the sum of those of its gradients, and each
   gradient alone).  Then a
   small-input check per uplink and for ``bidi_sync_full``: the tiny
   scenario VGG, 2 rounds with 3 local
   steps per client, with cuDNN's deterministic algorithms, gives the
   same bytes and nearly the same model on the card as the plain path on
   the CPU, with the clients' discrete decisions counted apart
   (``compare_small_runs``, which records each client's steps through the
   serial executor; ``async_b4_fsfl`` and ``sync_k4_fedadam``
   too, the params' step scaled by the server optimizer's gain); and two
   card runs each of ``bidi_sync_full``, ``async_b4_fsfl`` and
   ``sync_k4_fedadam`` through the batched executor with the port's own
   cuDNN selection give the same payloads and server state, bit for bit
   (``repeat_small_runs``).  The
   reduced ResNet (``[8, 16, 32, 32]``, 1,280 VOC-like images): its
   forward and gradients on the card against the CPU
   (``resnet_model_check``), its engine on the card fed the CPU's client
   outputs and server (``resnet_engine_check``), two bit-equal card runs,
   and its own client training on the card against the CPU with round 2
   started from the CPU's state (``resnet_own_training``): a client that
   parts is counted apart only for a discrete cause found in its record,
   and the rest of each round's server stays within the bounds of
   ``compare_small_runs``.  The reduced MobileNet (``[16, 24]`` blocks,
   expansion 1, the same images) the same way, and its two card runs
   bit-equal (depthwise convolutions included);
5. a JSON summary of the run (build, rounds, profiles), a JSON line with
   every ported kernel's launches and times, the device line, and the
   final ``{"ok": true, ...}`` line: the figures a reader needs sit in the
   last lines of the output.

Between 4 and 5 one more round of path C (4 clients, host and device
activity) runs under ``torch.profiler`` to print where a round's time
goes: device-busy share, the kernels that take the most device time,
and the host time in the coder's spans.  The profiler's own host
overhead makes that round slower than the unprofiled ones, and its
processing takes a minute or more.

It imports nothing of the JAX package.  Without CUDA, or without the
repository's ``src/repro_torch`` beside it, it exits 1 and its last line
is ``{"ok": false, "error": ...}`` naming what is missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
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
# delta_apply per element: w and q read, out written; q * s, coef *, +
DA_BYTES_PER_ELEMENT = 9
DA_OPS_PER_ELEMENT = 3
DOWN_PAYLOAD_BYTES = 876_876     # the v1 int8 broadcast: params only
# row_stats per element: |w| and + ; held to its plain version at rtol
RS_OPS_PER_ELEMENT = 2
RS_RTOL = 1e-6
VGG_WEIGHTS = 10                 # leaves of two or more dimensions
STEPS = 17                       # local steps a round: 560 images, batch 32
SCALE_SUBEPOCHS = 2
# host spans of the coding stack (repro_torch.obs.trace.span)
SPANS = ("codec.encode_batch", "codec.decode_batch", "nnc.encode",
         "nnc.decode", "cabac.pass1.state_scan", "cabac.pass2.range_encode")
PORT_SPANS = SPANS + ("downlink", "downlink.compress")


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


def kernel_times(torch, kernel, plain, spin: int = 2_000_000) -> dict:
    """Device times of the kernel and of its plain version, and the time
    of a whole wrapper call (host included), in ms."""
    return dict(ms=time_ms(torch, kernel, spin=spin),
                plain_ms=time_ms(torch, plain, spin=spin),
                call_ms=time_ms(torch, kernel, host_ahead=False))


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


def encode_compare(torch, dc, p, s, batched: bool, what: str) -> int:
    """The grouped int8 encode against its plain version, bitwise."""
    body = dc.int8_encode_leaves(p, s, 0.0, 128, batched=batched)
    plain = dc.int8_encode_leaves_plain(p, s, 0.0, 128)
    torch.cuda.synchronize()
    if body.shape != plain.shape or not torch.equal(body, plain):
        fail(f"int8_encode_leaves disagrees with its plain version on "
             f"{what}")
    return 1


def encode_kernel_phase(torch, dc, models) -> int:
    """``int8_encode_leaves`` against its plain version on a client's and
    a cohort of 4's ``vgg11_thinned`` leaves (90%-sparse deltas, and the
    scales leaves raw), and on one message's leaves as views of one buffer
    at every 4-byte offset mod 16; returns the number of checks."""
    gen = torch.Generator().manual_seed(3)
    params, _ = models.vgg11_thinned().init(gen)
    shapes = [tuple(v.shape) for d in params.values() for v in d.values()]
    checks = 0
    for k, batched in ((1, False), (4, True)):
        p = [(1e-3 * torch.randn((k,) + sh, generator=gen)
              * (torch.rand((k,) + sh, generator=gen) < 0.1)).cuda()
             for sh in shapes]
        s = [(1e-5 * torch.randn((k,) + sh[:1] if len(sh) >= 2 else (k,),
                                 generator=gen)).cuda() for sh in shapes]
        checks += encode_compare(torch, dc, p, s, batched,
                                 f"{k} x {VGG_LEAVES} vgg11_thinned leaves")
    sizes = [math.prod(sh) for sh in shapes]
    for shift in range(4):
        flat = (1e-3 * torch.randn(sum(sizes) + 4 * len(sizes),
                                   generator=gen)).cuda()
        p, off = [], 0
        for i, (n, sh) in enumerate(zip(sizes, shapes)):
            off += (shift + i - off) % 4
            p.append(flat[off:off + n].view((1,) + sh))
            off += n
        checks += encode_compare(torch, dc, p, [], False,
                                 f"leaf views at shift {shift}")
    print(f"kernel phase: {checks} grouped int8_encode_leaves bodies "
          f"bitwise to plain")
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
    # the grouped entry: a client's 28 leaves, leaf views 4 bytes past an
    # alignment boundary, and more leaves than one launch takes
    shapes = [tuple(v.shape) for d in params.values() for v in d.values()]
    over = [(n,) for n in range(1, 3000, 19)]
    for shp, unaligned in ((shapes, False), (shapes + [(5,), (1027,)], True),
                           (over, False)):
        d, r, th, steps = la_leaf_inputs(torch, gen, shp)
        if unaligned:
            d = [x.reshape(-1)[1:] for x in d]
            r = [x.reshape(-1)[1:] for x in r]
        la_group_compare(torch, la, d, r, th, steps)
        checks += 1
    print(f"kernel phase: {checks} level_assign-vs-plain comparisons at "
          f"{len(sizes)} leaf sizes and (8, {VGG_PARAMS}), and grouped on "
          f"28, 30 unaligned and {len(over)} leaves, all bitwise")
    return checks


def la_leaf_inputs(torch, gen, shapes):
    """Per leaf ``la_inputs`` of its size (half-steps and theta ties), its
    own theta, and steps alternating between a power of two and the
    uniform step; returns (deltas, residuals, thetas, steps)."""
    ds, rs, ths, steps = [], [], [], []
    for i, sh in enumerate(shapes):
        step = (2.0 ** -11, 4.88e-4)[i % 2]
        d, r, theta = la_inputs(torch, gen, 1, math.prod(sh), step)
        ds.append(d.reshape(sh))
        rs.append(r.reshape(sh))
        ths.append(theta if i % 5 else torch.zeros_like(theta))
        steps.append(step)
    return ds, rs, torch.stack(ths), steps


def la_group_compare(torch, la, d, r, th, steps) -> None:
    """The grouped kernel against its plain version, bit patterns of the
    levels and the carry of every leaf, and its launches counted."""
    before = la.LAUNCHES["level_assign"]
    lvs, cs = la.level_assign_leaves(d, r, th, steps)
    launches = la.LAUNCHES["level_assign"] - before
    pls, pcs = la.level_assign_leaves_plain(d, r, th, steps)
    torch.cuda.synchronize()
    if launches != -(-len(d) // la.MAX_LEAVES):
        fail(f"level_assign_leaves made {launches} launches for {len(d)} "
             f"leaves")
    for i, (lv, c, pl, pc) in enumerate(zip(lvs, cs, pls, pcs)):
        if lv.shape != pl.shape or not (
                torch.equal(lv, pl)
                and torch.equal(c.view(torch.int32), pc.view(torch.int32))):
            fail(f"level_assign_leaves disagrees with its plain version at "
                 f"leaf {i} of {len(d)} (shape {tuple(d[i].shape)})")


def clone_at_offset(torch, t):
    """A copy of float32 ``t`` whose data pointer has ``t``'s offset mod
    16, so that the copy takes the kernel's load path that ``t`` took."""
    shift = (t.data_ptr() % 16) // 4
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[shift:shift + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def capture_encodes(torch, device_mod):
    """Wrap the uplink's grouped int8 encode so that copies of the first
    message's leaves (``delta_compress``) and of the first cohort's
    (``delta_compress_batch``) are kept; returns (captured, original)."""
    captured = {}
    fn = device_mod.int8_encode_leaves

    def keep(p, s, theta, block, *, batched=True):
        name = "delta_compress_batch" if batched else "delta_compress"
        if name not in captured:
            captured[name] = ([clone_at_offset(torch, t) for t in p],
                              [clone_at_offset(torch, t) for t in s],
                              theta, block, batched)
        return fn(p, s, theta, block, batched=batched)

    device_mod.int8_encode_leaves = keep
    return captured, fn


def pad_cat_body(torch, dc, p_leaves, s_leaves, theta: float, block: int,
                 batched: bool):
    """The int8 body by the pad/cat/assemble route on the one-entry
    launch: pad the ragged params leaves, concatenate them into one
    buffer, one launch of the single-buffer entry (the grouped kernel with
    one entry), then the level and scale sections and the scales leaves
    concatenated.  Returns (body, the padded buffer)."""
    import torch.nn.functional as F
    k = p_leaves[0].shape[0]
    flats, meta = [], []
    for leaf in p_leaves:
        flat = leaf.reshape(k, -1)
        pad = (-flat.shape[1]) % block
        meta.append((flat.shape[1] + pad, (flat.shape[1] + pad) // block))
        flats.append(F.pad(flat, (0, pad)) if pad else flat)
    buf = torch.cat(flats, dim=1)
    if batched:
        q, s = dc.delta_compress_batch(buf, theta, block=block)
    else:
        q, s = dc.delta_compress(buf[0], theta, block=block)
        q, s = q[None], s[None]
    chunks, qo, so = [], 0, 0
    for padded, nblk in meta:
        chunks.append(q[:, qo:qo + padded].view(torch.uint8))
        chunks.append(s[:, so:so + nblk].contiguous().view(torch.uint8))
        qo += padded
        so += nblk
    for leaf in s_leaves:
        chunks.append(leaf.reshape(k, -1).contiguous().view(torch.uint8))
    return torch.cat(chunks, dim=1), buf


def encode_bound_ms(p_sizes, s_sizes, k: int,
                    block: int) -> tuple[float, str]:
    """Least time for one grouped encode of ``k`` rows: the unpadded
    leaves read once and the bodies written once, against the params'
    element-wise float32 operations."""
    padded = sum(-(-n // block) * block for n in p_sizes)
    body = padded + 4 * (padded // block) + 4 * sum(s_sizes)
    nbytes = k * (4 * sum(p_sizes) + 4 * sum(s_sizes) + body)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = k * sum(p_sizes) * OPS_PER_ELEMENT / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Median host wall time of one ``fn`` call that ends on the host (a
    device-to-host copy), in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ops(torch, fn) -> dict:
    """The device operations of one ``fn`` call, from a torch.profiler
    trace of the card's activity: kernels, and copies and fills."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key: e.count for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)}
    copies = sum(c for n, c in names.items()
                 if n.startswith(("Memcpy", "Memset")))
    return {"kernels": sum(names.values()) - copies, "copies": copies,
            "names": names}


def per_warp_ms(torch, dc, fn, per_warp: int) -> float:
    """``time_ms`` of ``fn`` with the grouped encode's slots a warp held
    at ``per_warp`` in place of the wrapper's pick."""
    pick = dc.pick_per_warp
    dc.pick_per_warp = lambda *args: per_warp
    try:
        return time_ms(torch, fn)
    finally:
        dc.pick_per_warp = pick


def main_path_kernels(torch, dc, device_mod, captured) -> dict:
    """The grouped int8 encode on the leaves the main path gave it (the
    first message's and the first cohort's): its bodies against its plain
    version and against the pad/cat/assemble route on the one-entry
    launch, bitwise; then timed on them beside its plain version, at every
    ``per_warp``, with that route (its device time, its one-entry launch
    alone, and the whole ``int8_rows`` call of both routes on the host's
    clock) and the device operations of one encode of each route.  The
    pad/cat route runs this kernel too: what ties its bytes to the kernel
    before the grouped design is the ``gpu`` tests' sha256 digests."""
    timings = {}
    for name in ("delta_compress_batch", "delta_compress"):
        if name not in captured:
            fail(f"the main path gave {name} no leaves")
        p, s, theta, block, batched = captured[name]
        k = p[0].shape[0]
        new = dc.int8_encode_leaves(p, s, theta, block, batched=batched)
        plain = dc.int8_encode_leaves_plain(p, s, theta, block)
        old, buf = pad_cat_body(torch, dc, p, s, theta, block, batched)
        torch.cuda.synchronize()
        for other, what in ((plain, "its plain version"),
                            (old, "the pad/cat/assemble route")):
            if other.shape != new.shape or not torch.equal(new, other):
                fail(f"{name}: the grouped body differs from {what} on "
                     f"the main path's leaves")
        kept = torch.where(buf.abs() >= theta, buf, 0.0)
        _, scale = dc.delta_compress_batch_plain(buf, theta, block)
        x = (kept.reshape(k, -1, block) / scale[..., None]).reshape(k, -1)
        ties = int((x - x.floor() == 0.5).sum())
        nkept = int((kept != 0).sum())
        p_sizes = [t[0].numel() for t in p]
        s_sizes = [t[0].numel() for t in s]
        unaligned = sum(t.data_ptr() % 16 != 0 for t in p)

        grouped = lambda: dc.int8_encode_leaves(p, s, theta, block,
                                                batched=batched)

        if batched:
            one = lambda: dc.delta_compress_batch(buf, theta, block=block)
        else:
            one = lambda: dc.delta_compress(buf[0], theta, block=block)
        new_rows = lambda: device_mod.int8_rows(p, s, block, batched=batched)
        old_rows = lambda: pad_cat_body(torch, dc, p, s, theta, block,
                                        batched)[0].cpu().numpy()
        plain_fn = lambda: dc.int8_encode_leaves_plain(p, s, theta, block)
        t = timings[name] = dict(
            **kernel_times(torch, grouped, plain_fn, spin=10_000_000),
            per_warp_ms={w: per_warp_ms(torch, dc, grouped, w)
                          for w in dc.PER_WARP},
            per_warp=dc.pick_per_warp(
                p_sizes + s_sizes, k, block,
                torch.cuda.get_device_properties(0).multi_processor_count),
            one_buffer_ms=time_ms(torch, one),
            old_route_ms=time_ms(torch, lambda: pad_cat_body(
                torch, dc, p, s, theta, block, batched), spin=10_000_000),
            one_buffer_bound=bound_ms(k, buf.shape[1], block),
            rows_host_ms=host_ms(torch, new_rows),
            old_rows_host_ms=host_ms(torch, old_rows),
            ops=device_ops(torch, new_rows), old_ops=device_ops(torch,
                                                              old_rows),
            bound=encode_bound_ms(p_sizes, s_sizes, k, block),
            max_abs_err=0.0, shape=[k, sum(p_sizes)], body=new.shape[1],
            entries=len(p) + len(s), unaligned=unaligned, kept=nkept,
            ties=ties)
        if t["ops"]["kernels"] != 1 or t["ops"]["copies"] != 1:
            fail(f"{name}: one int8_rows call made {t['ops']['names']}, "
                 f"expected one kernel and one copy")
        print(f"  {name} on the main path's {t['entries']} leaves "
              f"({k} x {sum(p_sizes)} params, {unaligned} params leaves "
              f"not 16-byte aligned), body {t['body']} bytes a row: "
              f"bitwise to plain and to the pad/cat/assemble route, "
              f"{nkept} kept "
              f"elements, {ties} exact half-way ties; grouped kernel "
              f"{t['ms']:.4f} ms at per_warp {t['per_warp']} ("
              + ", ".join(f"{w}: {v:.4f}" for w, v in t["per_warp_ms"].items())
              + f"; whole wrapper call {t['call_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
              f"({t['bound'][1]}); the pad/cat/assemble route "
              f"{t['old_route_ms']:.4f} ms on the device, its one-entry "
              f"launch alone on the padded buffer {t['one_buffer_ms']:.4f} "
              f"ms (bound {t['one_buffer_bound'][0]:.5f} ms)")
        print(f"  {name}: int8_rows host time {t['rows_host_ms']:.4f} ms "
              f"with {t['ops']['kernels']} kernel and "
              f"{t['ops']['copies']} copy, the pad/cat/assemble route "
              f"{t['old_rows_host_ms']:.4f} ms with "
              f"{t['old_ops']['kernels']} kernels and "
              f"{t['old_ops']['copies']} copies or fills "
              f"{t['old_ops']['names']}")
    return timings


def full_width_splits(torch, data, task=None):
    """6,400 synthetic images of ``task`` (CIFAR-like unless given) over 8
    clients: 560 training and 120 validation images each, 960 to test."""
    task = task or data.synthetic.CIFAR_LIKE
    x, y = data.synthetic.make_image_dataset(
        torch.Generator().manual_seed(0), task, 6400)
    splits = data.federated.split_federated(torch.Generator().manual_seed(1),
                                            x, y, 8)
    print(f"slice phase: {task.name}, {splits.num_clients} clients x "
          f"{splits.n_train} training images, test set {len(splits.test_y)}")
    return splits


def check_server(torch, name, server) -> None:
    for tree in (server.params, server.scales):
        for m, d in tree.items():
            for n, v in d.items():
                if not torch.isfinite(v).all():
                    fail(f"{name}: non-finite server value {m}/{n}")


def int8_slice_phase(torch, mods, rounds_mod, fl, models, splits,
                     rounds_out):
    """The int8 uplink: 1 round each of ``device_encode_int8`` (one
    ``delta_compress_batch`` launch a cohort) and ``codec_int8_k4`` (one
    ``delta_compress`` launch a client), cohorts of 4."""
    launches = {}
    for scenario, kernel, per_round in (
            ("device_encode_int8", "delta_compress_batch", 1),
            ("codec_int8_k4", "delta_compress", 4)):
        out = run_path(
            torch, mods, rounds_mod, scenario,
            lambda: fl.run_scenario(scenario, rounds=1,
                                    model=models.vgg11_thinned(),
                                    splits=splits, device="cuda"),
            {kernel: per_round, "level_assign": 1, **sm_per_round(4)}, 4,
            2, rounds_out, up=4 * PAYLOAD_BYTES)
        launches[kernel] = path_total(out, kernel)
    return launches


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


def nnc_slice_phase(torch, mods, rounds_mod, fl, fsfl, models, splits,
                    rounds_out, checked: list):
    """The paper's main path: 2 rounds of sync_full_fedavg_fsfl through
    run_federated, then 1 round of device_encode_cabac; one
    ``level_assign`` launch a round for the whole cohort."""
    n = splits.num_clients
    cfg = fl.build_protocol(fl.get_scenario("sync_full_fedavg_fsfl"), 2)
    want = {"level_assign": 1, **sm_per_round(n)}
    launches = {}
    for scenario, run in (
            ("sync_full_fedavg_fsfl",
             lambda: fsfl.run_federated(models.vgg11_thinned(), cfg, splits,
                                        2, device="cuda")),
            ("device_encode_cabac",
             lambda: fl.run_scenario("device_encode_cabac", rounds=1,
                                     model=models.vgg11_thinned(),
                                     splits=splits, device="cuda"))):
        out = run_path(torch, mods, rounds_mod, scenario, run, want, n, 2,
                       rounds_out)
        launches[scenario] = path_total(out, "level_assign")
    if not checked:
        fail("device_encode_cabac encoded no cohort on the device")
    print(f"  device_encode_cabac: {sum(len(c) for c in checked)} "
          f"device-encoded payloads byte-equal to the host encode")
    return launches


def la_main_path(torch, la, captured) -> dict:
    """level_assign against its plain version on the buffers the main path
    gave it (the first cohort's 8 clients over their 28 leaves), bitwise,
    then timed: the one launch of this design for the cohort, and the 8
    grouped launches, one a client, that it replaces."""
    if len(captured) != 1 or len(captured[0][0]) != VGG_LEAVES:
        fail(f"the main path gave level_assign_leaves {len(captured)} "
             f"calls, expected one of {VGG_LEAVES} leaves")
    d, r, th, steps = captured[0]
    if th.shape != (COHORT, VGG_LEAVES):
        fail(f"the main path gave level_assign_leaves thetas "
             f"{tuple(th.shape)}, expected a cohort's ({COHORT}, "
             f"{VGG_LEAVES})")
    la_group_compare(torch, la, d, r, th, steps)
    kept = ties = 0
    for i, (dd, rr, step) in enumerate(zip(d, r, steps)):
        carried = dd + rr
        theta = th[:, i].reshape((-1,) + (1,) * (dd.ndim - 1))
        x = torch.where(carried.abs() >= theta, carried, 0.0) / step
        kept += int((x != 0).sum())
        ties += int((x - x.floor() == 0.5).sum())
    n = sum(x.numel() for x in d)
    # the design before: one grouped launch a client
    per_client = [([x[k] for x in d], [x[k] for x in r], th[k].contiguous())
                  for k in range(COHORT)]

    def chain():
        return [la.level_assign_leaves(a, b, c, steps)
                for a, b, c in per_client]

    out = dict(**kernel_times(torch,
                              lambda: la.level_assign_leaves(d, r, th, steps),
                              lambda: la.level_assign_leaves_plain(
                                  d, r, th, steps)),
               bound=la_bound_ms(n), elements=n, kept=kept, ties=ties,
               per_client_ms=time_ms(torch, chain, spin=20_000_000),
               per_client_call_ms=time_ms(torch, chain, host_ahead=False))
    print(f"  level_assign on the main path's cohort, {COHORT} x "
          f"{VGG_LEAVES} leaves ({n} elements): bitwise, {kept} kept "
          f"elements with a nonzero quotient, {ties} exact half-way ties; "
          f"one launch {out['ms']:.4f} ms (whole wrapper call "
          f"{out['call_ms']:.4f} ms), {COHORT} launches as before "
          f"{out['per_client_ms']:.4f} ms (wrapper calls "
          f"{out['per_client_call_ms']:.4f} ms), plain {out['plain_ms']:.4f} "
          f"ms, bound {out['bound'][0]:.5f} ms ({out['bound'][1]})")
    return out


SMALL_ROUNDS = 2
SMALL_SAMPLES = 1280     # 3 local steps per client on the tiny VGG
SMALL_SCENARIOS = ("sync_full_fedavg_fsfl", "device_encode_int8",
                   "bidi_sync_full", "async_b4_fsfl", "sync_k4_fedadam")
REPEATED = ("bidi_sync_full", "async_b4_fsfl", "sync_k4_fedadam")
MAX_FLIPS = 5            # params off by more than one quantization step
MAX_OFF = 34             # params off by more than 1e-6 (0.5% of 6,786)
MAX_COUNTED = 1          # clients a round whose scales are counted apart
# float32 noise keeps the two devices' scale gradients within about 1e-6
# of their norm in a step; a max-pool or ReLU that routes the backward
# another way parts them by 1e-5 to 1e-2 (PERF.md §2)
GRAD_EVENT = 1e-4


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms, and no autotuning, for the
    duration; the previous settings are restored after."""
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def record_small_run(torch, fl, rounds_mod, name: str, device: str,
                     model=None, splits=None, forced=None, init_state=None,
                     plan=None):
    """One run of scenario ``name`` through the serial executor on the
    tiny scenario VGG with 1,280
    samples (3 local steps per client), or on ``model`` and ``splits``,
    for 2 rounds on ``device``, with
    each round's discrete decisions kept on the host: per client its params
    and scale levels, the kept Eq. 4 sub-epoch (``scale_epoch``, 0 for
    none), its decoded scale delta as the server aggregates it, and the
    gradient and update of each of its weight and scale steps; the
    clients' persistent state after the round; the broadcast's
    reconstruction where there is a downlink; the server's state after the
    round.  With ``forced``, the log of another run of the same
    synchronous scenario, every round after the first starts from that
    run's server state and clients' persistent state after the round
    before, so the two runs' clients train each round from the same
    start.  ``init_state`` and ``plan`` go to ``run_scenario``.  Returns
    (RunResult, the per-round log, the number of test images)."""
    from repro_torch.core import protocol as protocol_mod
    from repro_torch.fl import executors
    from repro_torch.tree import items, tree_map

    def host(tree):
        return {path: torch.as_tensor(v).detach().cpu()
                for path, v in items(tree)}

    def kept(tree):
        return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)

    def start(r: int):
        """The server state and clients' persistent state round ``r``
        (0-based) is forced to start from, on ``device``."""
        entry = forced[r - 1]
        return tuple(tree_map(lambda t: t.to(device, copy=True), entry[part])
                     for part in ("server", "persistent"))

    def is_scales(tree):
        return all(v.ndim <= 1 for _, v in items(tree))

    if model is None:
        model, splits = fl.default_setting(fl.get_scenario(name).num_clients,
                                           n_samples=SMALL_SAMPLES)
    log, steps = [], []     # steps: per client trained, its steps
    train0 = rounds_mod.LocalTrain.train_cohort
    intake0 = rounds_mod.Uplink.intake
    agg0 = rounds_mod.Aggregate.__call__
    step0 = rounds_mod.ServerStep.__call__
    compress0 = rounds_mod.Downlink.compress
    bind0 = executors.SerialExecutor.bind
    grad0 = protocol_mod._grad_tree
    apply0 = protocol_mod.apply_updates

    def train_cohort(self, idx, batch_idx, server):
        if forced is not None and log:
            if list(idx) != list(range(self.splits.num_clients)):
                raise RuntimeError(f"forced rounds need every client in "
                                   f"order, not {list(idx)}")
            server, self.state = start(len(log))
        return train0(self, idx, batch_idx, server)

    def bind(self, client_round):
        def traced(*args):
            steps.append({"weight": [], "scale": []})
            return client_round(*args)
        bind0(self, traced)

    def grad_tree(loss, tree):
        grads = grad0(loss, tree)
        steps[-1]["scale" if is_scales(tree) else "weight"].append(
            {"grad": host(grads)})
        return grads

    def apply_updates(params, updates):
        steps[-1]["scale" if is_scales(params) else "weight"][-1][
            "update"] = host(updates)
        return apply0(params, updates)

    def intake(self, out, clients):
        contribs = intake0(self, out, clients)
        if len(steps) != len(clients):
            raise RuntimeError(f"{len(steps)} clients trained, "
                               f"{len(clients)} in the cohort")
        decoded = [host(c.delta_scales) for c in contribs]
        decoded_p = [host(c.delta_params) for c in contribs]
        entry = {"clients": list(clients),
                 "params": host(out.levels_params),
                 "scales": host(out.levels_scales),
                 "scale_epoch": out.metrics["scale_epoch"].cpu(),
                 "scale_delta": {p: torch.stack([d[p] for d in decoded])
                                 for p in decoded[0]},
                 "params_delta": {p: torch.stack([d[p] for d in decoded_p])
                                  for p in decoded_p[0]},
                 "scale_steps": [c["scale"] for c in steps],
                 "weight_steps": [c["weight"] for c in steps],
                 "persistent": kept(out.persistent), "down": {},
                 "weights": None}
        steps.clear()
        if log and "server_params" not in log[-1]:
            # an async dispatch window of an aggregation still filling:
            # one entry an aggregation, its windows' clients in order
            last = log[-1]
            last["clients"] += entry["clients"]
            last["scale_steps"] += entry["scale_steps"]
            last["weight_steps"] += entry["weight_steps"]
            last["scale_epoch"] = torch.cat([last["scale_epoch"],
                                             entry["scale_epoch"]])
            for part in ("params", "scales", "scale_delta", "params_delta"):
                last[part] = {p: torch.cat([v, entry[part][p]])
                              for p, v in last[part].items()}
        else:
            log.append(entry)
        return contribs

    def aggregate(self, contribs, weights=None):
        # the buffer's contributions are in arrival order, the log's
        # clients in training order: the weights follow the log
        if weights is not None:
            at = {}
            for c, w in zip(contribs, weights):
                at.setdefault(c.client, []).append(float(w))
            # a client in the buffer twice arrived first from its first
            # training
            log[-1]["weights"] = [at[c].pop(0) for c in log[-1]["clients"]]
        return agg0(self, contribs, weights)

    def server_step(self, server, agg, downlink, receivers, transmit):
        if forced is not None and len(log) > 1:
            server = start(len(log) - 1)[0]
        new, down = step0(self, server, agg, downlink, receivers, transmit)
        log[-1]["server"] = kept(new)
        log[-1]["server_params"] = host(new.params)
        log[-1]["server_scales"] = host(new.scales)
        return new, down

    def compress(self, updates, receivers, transmit):
        broadcast, down = compress0(self, updates, receivers, transmit)
        if broadcast.recon is not None:
            log[-1]["down"] = host(broadcast.recon)
        return broadcast, down

    patches = [(rounds_mod.LocalTrain, "train_cohort", train_cohort, train0),
               (rounds_mod.Uplink, "intake", intake, intake0),
               (rounds_mod.Aggregate, "__call__", aggregate, agg0),
               (rounds_mod.ServerStep, "__call__", server_step, step0),
               (rounds_mod.Downlink, "compress", compress, compress0),
               (executors.SerialExecutor, "bind", bind, bind0),
               (protocol_mod, "_grad_tree", grad_tree, grad0),
               (protocol_mod, "apply_updates", apply_updates, apply0)]
    for owner, attr, new, _ in patches:
        setattr(owner, attr, new)
    try:
        # the serial executor: its bind is where a client's steps are
        # recorded, one client at a time
        scenario = (fl.get_scenario(name) if isinstance(name, str)
                    else name)
        res = fl.run_scenario(dataclasses.replace(scenario,
                                                  executor="serial"),
                              rounds=SMALL_ROUNDS, model=model,
                              splits=splits, init_state=init_state,
                              plan=plan, device=device)
    finally:
        for owner, attr, _, old in patches:
            setattr(owner, attr, old)
    return res, log, len(splits.test_y)


def scale_event(base_steps, run_steps, weights: bool = False
                ) -> tuple[int | None, list[float]]:
    """The first scale step (0-based) at which the two runs' scale
    gradients part by more than ``GRAD_EVENT`` of their norm in some leaf,
    or None; and that ratio at every step.  With ``weights``, the same of
    weight steps, over every leaf whose gradient is not 0."""
    ratios = []
    for a, b in zip(base_steps, run_steps, strict=True):
        ratios.append(max(
            (float((b["grad"][path] - g).norm() / g.norm().clamp_min(1e-30))
             for path, g in a["grad"].items()
             if ((g.ndim >= 1 and bool(g.any())) if weights
                 else g.ndim == 1)),
            default=0.0))
    event = next((t for t, r in enumerate(ratios) if r > GRAD_EVENT), None)
    return event, ratios


def scale_cap(base_steps, run_steps, start: int) -> dict:
    """Per scale leaf, how far apart the two runs' scale steps can move a
    client's scale delta when they part at step ``start``: the difference
    of their updates before it, both updates whole from it on."""
    cap = {}
    for t, (a, b) in enumerate(zip(base_steps, run_steps, strict=True)):
        for path, u in a["update"].items():
            v = b["update"][path]
            cap[path] = cap.get(path, 0.0) + (
                (v - u).abs() if t < start else u.abs() + v.abs())
    return cap


def level_diffs(lb, lr, i: int) -> tuple[int, int, int, tuple[int, int]]:
    """Client ``i``'s levels in two runs' logs of one round: params levels
    zero in one run only (top-k flips) and non-zero in both but unequal
    (rounding crossings), the widest scale level difference, and the kept
    sub-epochs."""
    topk = rounding = 0
    for path, v in lb["params"].items():
        a, b = v[i], lr["params"][path][i]
        topk += int(((a == 0) != (b == 0)).sum())
        rounding += int(((a != b) & (a != 0) & (b != 0)).sum())
    widest = int(max(float((v[i] - lr["scales"][path][i]).abs().max())
                     for path, v in lb["scales"].items()))
    return topk, rounding, widest, (int(lb["scale_epoch"][i]),
                                    int(lr["scale_epoch"][i]))


def compare_small_runs(torch, cfg, name: str, base, base_log, run, run_log,
                       n_test: int, gain: float = 1.0
                       ) -> tuple[dict, list[str]]:
    """Hold ``run`` and its recorded decisions (``record_small_run``)
    against ``base`` and its own; returns (counts, failures).

    Convolutions sum in another order in cuDNN than on the CPU, and a
    client's training may then take another discrete decision.  Those are
    counted apart, per round and per client, and bounded by what they move:

    * a params level that crosses a rounding boundary moves the server's
      mean by at most one quantization step, a top-k flip by that client's
      whole update (``flips``): every server param within one quantization
      step (times ``gain``, the most the server optimizer moves its update
      per unit of mean delta: 1 for FedAvg) except at most 5 flips, and at
      most 34 (0.5%) params off by more than 1e-6;
    * a client whose scale levels lie more than one level apart is counted
      apart only for a discrete cause found in its record: another kept
      sub-epoch (the Eq. 4 accept decision), a top-k flip in its params, or
      a scale step at which the two runs' scale gradients part by more than
      ``GRAD_EVENT`` of their norm (a max-pool or ReLU routing the backward
      another way).  At most 1 such client a round.  Its two decoded scale
      deltas may lie apart by no more than its scale steps can move them
      from the cause on (``scale_cap``, plus one fine step), and that
      difference times its aggregation weight (1 over the cohort size, or
      the async buffer's staleness weight) is taken out of the server's
      scales;
      every scale must then lie within one fine step a round (a client's
      scale level may cross one rounding boundary);
    * test accuracy within one image; bytes equal where every client's
      params levels are (int8 payloads always), else within 0.5%.

    Differing downlink levels are counted and printed; they move server
    params by one downlink step, which the params bounds hold."""
    failures, rounds = [], []
    fine = cfg.fine_step_size
    d_scales = {path: run_log[-1]["server_scales"][path] - v
                for path, v in base_log[-1]["server_scales"].items()}
    raw = max(float(d.abs().max()) for d in d_scales.values())
    for r, (rb, rr, lb, lr) in enumerate(zip(base.records, run.records,
                                             base_log, run_log), 1):
        if lb["clients"] != lr["clients"]:
            failures.append(f"round {r}: cohorts {lr['clients']} and "
                            f"{lb['clients']}")
            continue
        k = len(lb["clients"])
        per_client = []
        for i, c in enumerate(lb["clients"]):
            topk, rounding, widest, epochs = level_diffs(lb, lr, i)
            level_diff = [(v[i] - lr["scales"][path][i]).abs()
                          for path, v in lb["scales"].items()]
            event, ratios = scale_event(lb["scale_steps"][i],
                                        lr["scale_steps"][i])
            causes = (["kept sub-epoch"] if epochs[0] != epochs[1] else []) + (
                ["top-k flip"] if topk else []) + (
                [f"scale step {event + 1}"] if event is not None else [])
            counted = bool(causes) and widest > 1
            diff = {p: lr["scale_delta"][p][i] - v[i]
                    for p, v in lb["scale_delta"].items()}
            moved = max(float(d.abs().max()) for d in diff.values()) / k
            over = 0.0
            if counted:
                start = 0 if epochs[0] != epochs[1] or topk else event
                cap = scale_cap(lb["scale_steps"][i], lr["scale_steps"][i],
                                start)
                over = max(float((d.abs() - cap[p] - fine * 1.01).max())
                           for p, d in diff.items())
                if over > 0:
                    failures.append(
                        f"round {r}: client {c}'s scale delta moved "
                        f"{over:.3g} more than its scale steps can from its "
                        f"{', '.join(causes)} on")
                w = 1.0 / k if lb["weights"] is None else lb["weights"][i]
                for p, d in diff.items():
                    d_scales[p] = d_scales[p] - d * w
            per_client.append({
                "client": c, "scale_epoch": epochs, "topk_flips": topk,
                "rounding": rounding, "grad_ratios": ratios,
                "causes": causes, "counted": counted,
                "scale_levels": sum(int((d != 0).sum()) for d in level_diff),
                "max_scale_level_diff": widest, "moves_server_scale": moved,
                "over_cap": max(over, 0.0)})
        counted = sum(p["counted"] for p in per_client)
        down = sum(int((v != lr["down"][path]).sum())
                   for path, v in lb["down"].items())
        levels = sum(p["topk_flips"] + p["rounding"] for p in per_client)
        rounds.append({"round": r, "counted": counted,
                       "params_levels": levels, "down_levels": down,
                       "clients": [p for p in per_client if p["causes"]
                                   or p["topk_flips"] or p["rounding"]
                                   or p["scale_levels"]]})
        if counted > MAX_COUNTED:
            failures.append(f"round {r}: the scales of {counted} clients "
                            f"counted apart (at most {MAX_COUNTED})")
        exact = levels == 0 or name.endswith("int8")
        for leg in ("up_bytes", "down_bytes"):
            b, g = getattr(rb, leg), getattr(rr, leg)
            if b != g if exact else abs(b - g) > 0.005 * b:
                failures.append(f"round {r}: {leg} {g} against {b} "
                                f"({levels} differing levels)")
        if abs(rb.test_acc - rr.test_acc) > 1 / n_test + 1e-6:
            failures.append(f"round {r}: test_acc {rr.test_acc} against "
                            f"{rb.test_acc}")

    dp = torch.cat([(run_log[-1]["server_params"][path] - v).abs().reshape(-1)
                    for path, v in base_log[-1]["server_params"].items()])
    flips = int((dp > gain * cfg.step_size * 1.01).sum())
    off = int((dp > 1e-6).sum())
    rest = max(float(d.abs().max()) for d in d_scales.values())
    bound = SMALL_ROUNDS * fine
    if flips > MAX_FLIPS:
        failures.append(f"{flips} server params off by more than one "
                        f"quantization step (at most {MAX_FLIPS})")
    if off > MAX_OFF:
        failures.append(f"{off} server params off by more than 1e-6 (at "
                        f"most {MAX_OFF})")
    if rest > bound * 1.01:
        failures.append(f"server scales {rest:.3g} apart where no counted "
                        f"client moved them (bound {bound:.3g}; "
                        f"{raw:.3g} in all)")
    report = {"max_param_diff": float(dp.max()), "params_off": off,
              "flips": flips, "max_scale_diff": raw,
              "max_scale_diff_others": rest, "scale_bound": bound,
              "counted": [x["counted"] for x in rounds],
              "differing_levels": [x["params_levels"] for x in rounds],
              "differing_down_levels": [x["down_levels"] for x in rounds],
              "rounds": rounds,
              "up_bytes": [[x.up_bytes for x in base.records],
                           [x.up_bytes for x in run.records]],
              "down_bytes": [[x.down_bytes for x in base.records],
                             [x.down_bytes for x in run.records]]}
    return report, failures


def sign_step(base_steps, run_steps) -> int | None:
    """The first step (0-based) at which some element's update has one
    sign in one run and the other sign in the other, or None: Adam steps
    by about its rate whatever the size of the gradient, so a gradient
    within float noise of 0 moves the element a whole step either way."""
    return next((t for t, (a, b) in enumerate(zip(base_steps, run_steps,
                                                  strict=True))
                 if any(bool((u * b["update"][path] < 0).any())
                        for path, u in a["update"].items())), None)


def client_causes(lb, lr, i: int) -> dict:
    """What client ``i``'s records in two runs' logs of one round show:
    how its levels differ, and the discrete decisions that explain it.
    Its params part by a top-k flip; its causes there are a weight step
    at which its gradients part by more than ``GRAD_EVENT`` of their norm
    (a ReLU or max-pool input within float noise of zero, routed the other
    way) or at which an update element takes the other sign (Adam steps
    by about its rate whatever the size of the gradient, so a gradient
    within float noise of zero moves the element a whole step either
    way).  Its scales part by more than one level, or by another kept
    sub-epoch; their causes are those of its params, a top-k flip (the
    scale steps then start from another model), another kept sub-epoch,
    and the same two events in a scale step."""
    topk, rounding, widest, epochs = level_diffs(lb, lr, i)
    found = {}
    for kind in ("weight", "scale"):
        a, b = lb[f"{kind}_steps"][i], lr[f"{kind}_steps"][i]
        event, found[kind] = scale_event(a, b, weights=kind == "weight")
        found[f"{kind} event"] = event
        sign = sign_step(a, b)
        found[f"{kind} causes"] = (
            [f"{kind} step {event + 1}"] if event is not None else []) + (
            [f"sign at {kind} step {sign + 1}"] if sign is not None else [])
    weight_causes = found["weight causes"]
    scale_causes = weight_causes + (["top-k flip"] if topk else []) + (
        ["kept sub-epoch"] if epochs[0] != epochs[1] else []) + found[
        "scale causes"]
    return {"topk_flips": topk, "rounding": rounding,
            "max_scale_level_diff": widest, "scale_epoch": epochs,
            "params_apart": topk > 0 and bool(weight_causes),
            "scales_apart": ((widest > 1 or epochs[0] != epochs[1])
                             and bool(scale_causes)),
            "causes": list(dict.fromkeys(weight_causes + scale_causes)),
            "scale_event": found["scale event"],
            "weight_ratios": found["weight"], "scale_ratios": found["scale"]}


TIE_ULPS = 4             # "equal" magnitudes at a top-k boundary: ulps


def boundary_tie(torch, cfg, lb, lr, i: int) -> bool:
    """Whether every top-k flip of client ``i`` between two runs' logs of
    one round is a tie at the top-k boundary of ``lb``'s own record: in
    each leaf with a flip, the k-th and (k+1)-th largest carried
    magnitudes (decoded delta plus new residual, the Eq. 5 sum that top-k
    ranks) are equal within ``TIE_ULPS`` ulps of the record's float type,
    and so is every flipped element's magnitude with the k-th.  Only a
    fixed-rate top-k has such a boundary; a client with no flip has no
    tie.  Nothing here reads a leaf's name."""
    from repro_torch.tree import items

    if cfg.fixed_sparsity is None:
        return False
    residual = dict(items(lb["persistent"].residual))
    flips = 0
    for path, v in lb["params"].items():
        flipped = ((v[i] == 0) != (lr["params"][path][i] == 0)).reshape(-1)
        if not bool(flipped.any()):
            continue
        flips += int(flipped.sum())
        res = residual[path][i]
        m = (lb["params_delta"][path][i].to(res.dtype) + res).abs().reshape(-1)
        n = m.numel()
        k = max(1, int(round(n * (1.0 - cfg.fixed_sparsity))))
        if k >= n:
            return False
        ranked = torch.sort(m, descending=True).values
        theta = ranked[k - 1]
        tol = TIE_ULPS * torch.finfo(m.dtype).eps * theta
        if not (bool(theta - ranked[k] <= tol)
                and bool(((m[flipped] - theta).abs() <= tol).all())):
            return False
    return flips > 0


def forced_round_check(torch, cfg, base_log, run_log
                       ) -> tuple[list[dict], list[str]]:
    """Two runs' logs (``record_small_run``), each round of the second
    started from the first's server and clients' state, so that every
    round holds only that round's training apart.  The bounds of
    ``compare_small_runs``, each round on its own:

    * a client whose params part by a top-k flip, or whose scales part by
      more than one level or by another kept sub-epoch, is counted apart
      only for a discrete cause found in its record (``client_causes``);
      ``compare_small_runs`` allows ``MAX_COUNTED`` a round, which the
      caller holds or reports from the returned rounds; a counted
      client's scale delta may
      move no more than its scale steps can from its first cause on
      (``scale_cap``, plus one fine step);
    * a client that parts only at ties is listed apart from the counted
      ones (``ties``), not counted: its params part by top-k flips, each
      a tie at the top-k boundary of the base run's own record
      (``boundary_tie``), with no weight step whose gradients part by
      ``GRAD_EVENT`` of their norm.  A two-class head gives the two rows
      of its last layer gradients that are exact negatives, so which of
      two equal magnitudes top-k keeps is decided by the last bit of each
      implementation's sums; its scale delta is held as a counted one's;
    * with the counted and tied clients' decoded deltas taken out (times
      1 over the cohort size), the round's server params lie within one
      quantization step but for at most ``MAX_FLIPS`` and within 1e-6 but
      for at most ``MAX_OFF``, and its scales within one fine step: a
      client that parts without a cause must fit in these.

    Returns (per round: the counted clients, the tied ones and the rest's
    worst, the failures)."""
    failures, rounds = [], []
    fine = cfg.fine_step_size
    for r, (lb, lr) in enumerate(zip(base_log, run_log, strict=True), 1):
        if lb["clients"] != lr["clients"]:
            failures.append(f"round {r}: cohorts {lr['clients']} and "
                            f"{lb['clients']}")
            continue
        k = len(lb["clients"])
        dp = {p: lr["server_params"][p] - v
              for p, v in lb["server_params"].items()}
        ds = {p: lr["server_scales"][p] - v
              for p, v in lb["server_scales"].items()}
        counted, ties = [], []
        for i, c in enumerate(lb["clients"]):
            found = client_causes(lb, lr, i)
            if not (found["params_apart"] or found["scales_apart"]):
                continue
            tie = (max(found["weight_ratios"], default=0.0) < GRAD_EVENT
                   and boundary_tie(torch, cfg, lb, lr, i))
            (ties if tie else counted).append({"client": c, **found})
            for p in dp:
                dp[p] = dp[p] - (lr["params_delta"][p][i]
                                 - lb["params_delta"][p][i]) / k
            diff = {p: lr["scale_delta"][p][i] - v[i]
                    for p, v in lb["scale_delta"].items()}
            for p in ds:
                ds[p] = ds[p] - diff[p] / k
            event = found["scale_event"]
            start = (0 if found["params_apart"] or found["scale_epoch"][0]
                     != found["scale_epoch"][1] or event is None else event)
            cap = scale_cap(lb["scale_steps"][i], lr["scale_steps"][i], start)
            over = max(float((d.abs() - cap[p] - fine * 1.01).max())
                       for p, d in diff.items())
            if over > 0:
                failures.append(f"round {r}: client {c}'s scale delta "
                                f"moved {over:.3g} more than its scale steps "
                                f"can from step {start + 1} on")
        flat = torch.cat([d.abs().reshape(-1) for d in dp.values()])
        flips = int((flat > cfg.step_size * 1.01).sum())
        off = int((flat > 1e-6).sum())
        rest = max(float(d.abs().max()) for d in ds.values())
        rounds.append({"round": r, "counted": counted, "ties": ties,
                       "flips": flips, "params_off": off,
                       "max_scale_diff_others": rest})
        if flips > MAX_FLIPS or off > MAX_OFF:
            failures.append(f"round {r}: without the counted clients, "
                            f"{flips} server params off by more than one "
                            f"quantization step (at most {MAX_FLIPS}) and "
                            f"{off} by more than 1e-6 (at most {MAX_OFF})")
        if rest > fine * 1.01:
            failures.append(f"round {r}: without the counted clients, "
                            f"server scales {rest:.3g} apart (bound "
                            f"{fine:.3g})")
    return rounds, failures


def print_forced(label: str, rounds: list[dict]) -> None:
    for rnd in rounds:
        print(f"  {label} round {rnd['round']}: {len(rnd['counted'])} "
              f"clients counted apart, {len(rnd['ties'])} apart at top-k "
              f"ties; without them {rnd['flips']} server "
              f"params off by more than one quantization step, "
              f"{rnd['params_off']} by more than 1e-6, scales "
              f"{rnd['max_scale_diff_others']:.3g} apart")
        for c, tied in ([(c, "") for c in rnd["counted"]]
                        + [(c, " (ties)") for c in rnd["ties"]]):
            print(f"    client {c['client']}{tied}: {c['topk_flips']} top-k "
                  f"flips, "
                  f"{c['rounding']} rounding crossings, scale levels up to "
                  f"{c['max_scale_level_diff']} apart, kept sub-epochs "
                  f"{c['scale_epoch']}; gradients apart by at most "
                  f"{max(c['weight_ratios'], default=0):.2g} (weights) and "
                  f"{max(c['scale_ratios'], default=0):.2g} (scales) of "
                  f"their norm; causes: {', '.join(c['causes'])}")


def small_input_check(torch, fl, rounds_mod, name: str,
                      cpu_runs: dict) -> dict:
    """Scenario ``name`` on the tiny VGG, 2 rounds from the same seed on
    the card and on the CPU's plain path, held together by
    ``compare_small_runs``; fails on any failure it reports.  The card's
    run uses cuDNN's deterministic algorithms, so the verdict can be
    reproduced; the CPU run is kept in ``cpu_runs``."""
    cfg = fl.build_protocol(fl.get_scenario(name), SMALL_ROUNDS)
    if name not in cpu_runs:
        cpu_runs[name] = record_small_run(torch, fl, rounds_mod, name, "cpu")
    cpu, cpu_log, n_test = cpu_runs[name]
    with deterministic_cudnn(torch):
        card, card_log, _ = record_small_run(torch, fl, rounds_mod, name,
                                             "cuda")
    report, failures = compare_small_runs(torch, cfg, name, cpu, cpu_log,
                                          card, card_log, n_test,
                                          server_gain(fl, name))
    print(f"small input {name}: {SMALL_ROUNDS} rounds, up_bytes "
          f"{report['up_bytes'][1]} on the card, {report['up_bytes'][0]} on "
          f"the CPU; down_bytes {report['down_bytes'][1]} on the card, "
          f"{report['down_bytes'][0]} on the CPU; counted apart: "
          f"{report['flips']} flips, clients' scales {report['counted']} a "
          f"round; differing levels {report['differing_levels']}, downlink "
          f"{report['differing_down_levels']}; max |param diff| "
          f"{report['max_param_diff']:.3g}, {report['params_off']} params "
          f"off by > 1e-6; max |scale diff| {report['max_scale_diff']:.3g}, "
          f"{report['max_scale_diff_others']:.3g} without the counted "
          f"clients (bound {report['scale_bound']:.3g}); cuDNN "
          f"deterministic")
    for rnd in report["rounds"]:
        for c in rnd["clients"]:
            worst = max(c["grad_ratios"], default=0.0)
            apart = (f" (counted apart for {', '.join(c['causes'])}: moves a "
                     f"server scale by {c['moves_server_scale']:.3g})"
                     if c["counted"] else
                     f" (causes found: {', '.join(c['causes'])})"
                     if c["causes"] else "")
            print(f"  round {rnd['round']} client {c['client']}: kept "
                  f"sub-epoch {c['scale_epoch'][1]} on the card, "
                  f"{c['scale_epoch'][0]} on the CPU; params levels: "
                  f"{c['topk_flips']} top-k flips, {c['rounding']} rounding "
                  f"crossings; scale gradients apart by at most {worst:.2g} "
                  f"of their norm; {c['scale_levels']} scale levels differ, "
                  f"by at most {c['max_scale_level_diff']}{apart}")
    if failures:
        fail(f"small input {name}: the card's model is off the CPU plain "
             f"path: " + "; ".join(failures))
    return report


def profile_round(torch, run, label: str, mine: tuple,
                  host: bool = True) -> dict:
    """One more full-width round under torch.profiler: device-busy share,
    the top kernels by device time, the kernels whose name holds one of
    ``mine`` and those of ``scaled_matmul``, and, with ``host``, the host
    time in the coding stack's spans.  Without ``host`` only device activity is
    traced, which the profiler processes in a fraction of the time."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    t_end = None
    with profile(activities=activities) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
        t_end = time.time()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    averages = prof.key_averages()
    processing_s = time.time() - t_end
    spans = {e.key: e.cpu_time_total / 1e3 for e in averages
             if e.key in SPANS}
    # the kernels themselves: an operator's entry repeats its kernels'
    # time, and so does a span's device-side annotation (a span that
    # encloses kernels, such as downlink.compress, is listed on the device)
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0 and e.key not in PORT_SPANS
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if not events:
        print(f"profile {label}: the profiler saw no device time "
              f"(not measured)")
        return {"wall_ms": wall_ms, "busy_ms": None, "host_spans_ms": spans}
    print(f"profile {label}: one profiled round {wall_ms:.1f} ms wall, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%); "
          f"the profiler's processing took {processing_s:.1f} s")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}")
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms,
           "busy_share": busy_ms / wall_ms, "processing_s": processing_s,
           "host_spans_ms": spans}
    for name in (*mine, "scaled_matmul"):
        ours = [e for e in events if name in e.key]
        out[f"{name}_ms"] = sum(dev_us(e) for e in ours) / 1e3
        out[f"{name}_launches"] = sum(e.count for e in ours)
        print(f"  {name} kernels: {out[f'{name}_ms']:.3f} ms in "
              f"{out[f'{name}_launches']} launch(es)")
    for key in SPANS:
        if key in spans:
            print(f"  host span {key}: {spans[key]:.1f} ms")
    return out


# ------------------------------------------------------------ slice 4

def sm_expected(clients: int, rounds: int, steps: int = STEPS,
                sub: int = SCALE_SUBEPOCHS, dense: int = 2,
                calls: int | None = None) -> tuple[dict, dict]:
    """``scaled_matmul`` launches (forward, backward) and products per
    direction of ``rounds`` FSFL rounds over ``clients`` clients: each of
    the ``dense`` dense layers (2 in the VGGs, 1 in the ResNet) runs
    forward in every weight step, scale step and validation pass (``sub``
    + 1) and in the server's evaluation, and one backward launch in every
    step computing dx, with dw in the weight steps and ds in the scale
    steps.  The products count every client; the launches count every
    call of the batched round (``calls``, by default one a round: the
    cohort's rows in one launch a step) and the server's evaluations."""
    per = {"forward": dense * (steps + sub * steps + sub + 1),
           "dx": dense * (steps + sub * steps), "dw": dense * steps,
           "ds": dense * sub * steps}
    products = {d: rounds * (clients * n + (dense if d == "forward" else 0))
                for d, n in per.items()}
    calls = rounds if calls is None else calls
    return {"forward": calls * per["forward"] + rounds * dense,
            "backward": calls * per["dx"]}, products


SM_RUNS: dict[str, dict] = {}    # scaled_matmul launches per path run


def check_sm(sm, label: str, clients: int, rounds: int,
             dense: int = 2, calls: int | None = None) -> dict:
    """The path's ``scaled_matmul`` launches and products per direction,
    read after it ran, against ``sm_expected``; kept in ``SM_RUNS``."""
    got, products = dict(sm.LAUNCHES), dict(sm.CALLS)
    want, want_products = sm_expected(clients, rounds, dense=dense,
                                      calls=calls)
    SM_RUNS[label] = got
    print(f"  {label} launches: scaled_matmul {got} "
          f"({ {d: n // rounds for d, n in got.items()} } a round), "
          f"products {products}")
    if got != want or products != want_products:
        fail(f"{label}: scaled_matmul launched {got} computing {products}, "
             f"expected {want} computing {want_products}")
    return got


LAUNCH_KEYS = ("level_assign", "row_stats", "delta_apply", "delta_compress",
               "delta_compress_batch", "scaled_matmul forward",
               "scaled_matmul backward")


def launch_counts(la, rs, da, dc, sm) -> dict:
    return {"level_assign": la.LAUNCHES["level_assign"],
            "row_stats": rs.LAUNCHES["row_stats"],
            "delta_apply": da.LAUNCHES["delta_apply"],
            "delta_compress": dc.LAUNCHES["delta_compress"],
            "delta_compress_batch": dc.LAUNCHES["delta_compress_batch"],
            "scaled_matmul forward": sm.LAUNCHES["forward"],
            "scaled_matmul backward": sm.LAUNCHES["backward"]}


def run_path(torch, mods, rounds_mod, label: str, run, want: dict,
             clients: int, dense: int, rounds_out, up=None, down=None,
             bidirectional: bool = False, calls: int = 1,
             trained: int | None = None):
    """Run one path (``run()`` returns its RunResult) with every launch
    counter set to 0, read the counters at the end of each round (its
    evaluation), and fail unless each round's launches are ``want``
    (absent keys: none), its ``clients`` participants, its
    ``scaled_matmul`` products those of ``dense`` dense layers, its bytes
    up and down ``up`` and ``down`` where given, and its bytes down more
    than 0 where ``bidirectional``.  ``calls``: the executor's calls of
    the client round a round (1: the batched round; the serial executor's
    one a client), ``trained``: the rows they train a round (the sharded
    executor's padded ones too; by default ``clients``).  Prints each
    round's wall, bytes and launches; returns them a round."""
    la, rs, da, dc, sm = mods
    per_round = []
    evaluate0 = rounds_mod.Evaluate.__call__

    def evaluate(self, server):
        acc = evaluate0(self, server)
        torch.cuda.synchronize()
        per_round.append(launch_counts(*mods))
        return acc

    for mod in mods:
        mod.reset_counters()
    rounds_mod.Evaluate.__call__ = evaluate
    try:
        res = run()
    finally:
        rounds_mod.Evaluate.__call__ = evaluate0
    torch.cuda.synchronize()
    rounds = len(res.records)
    check_sm(sm, label, clients if trained is None else trained, rounds,
             dense, calls * rounds)
    if len(per_round) != rounds:
        fail(f"{label}: {len(per_round)} evaluations in {rounds} rounds")
    expect = {k: want.get(k, 0) for k in LAUNCH_KEYS}
    before = dict.fromkeys(LAUNCH_KEYS, 0)
    out = {"walls_s": [], "up_bytes": [], "down_bytes": [], "launches": []}
    for rec, counts in zip(res.records, per_round):
        got = {k: counts[k] - before[k] for k in LAUNCH_KEYS}
        before = counts
        print(f"  {label} round {rec.round}: wall_s={rec.wall_s:.3f} "
              f"up_bytes={rec.up_bytes} down_bytes={rec.down_bytes} "
              f"test_acc={rec.test_acc:.4f} train_loss={rec.train_loss:.4f} "
              f"launches { {k: v for k, v in got.items() if v} }")
        rounds_out.append([label, rec.round, rec.test_acc, rec.train_loss,
                           rec.up_bytes, rec.wall_s, rec.down_bytes])
        if not (math.isfinite(rec.train_loss) and 0.0 <= rec.test_acc <= 1.0
                and rec.up_bytes > 0):
            fail(f"{label}: bad round record {rec}")
        if len(rec.participants) != clients:
            fail(f"{label}: {len(rec.participants)} participants")
        if got != expect:
            fail(f"{label} round {rec.round}: launches {got}, expected "
                 f"{expect}")
        if up is not None and rec.up_bytes != up:
            fail(f"{label}: up_bytes {rec.up_bytes} != {up}")
        if down is not None and rec.down_bytes != down:
            fail(f"{label}: down_bytes {rec.down_bytes} != {down}")
        if bidirectional and rec.down_bytes <= 0:
            fail(f"{label}: no bytes down in round {rec.round}")
        for k, v in (("walls_s", rec.wall_s), ("up_bytes", rec.up_bytes),
                     ("down_bytes", rec.down_bytes), ("launches", got)):
            out[k].append(v)
    check_server(torch, label, res.server)
    return out


def sm_per_round(clients: int, dense: int = 2, calls: int = 1) -> dict:
    """``run_path``'s ``want`` of ``scaled_matmul`` for one round of
    ``calls`` executor calls (1: the batched round)."""
    want = sm_expected(clients, 1, dense=dense, calls=calls)[0]
    return {"scaled_matmul forward": want["forward"],
            "scaled_matmul backward": want["backward"]}


def path_total(out: dict, key: str) -> int:
    """A kernel's launches over every round of a ``run_path`` run."""
    return sum(r[key] for r in out["launches"])


# what each direction reads, of x (M, K), w (N, K), s (N,) and dy (M, N)
SM_READS = {"forward": ("x", "w", "s"), "dx": ("dy", "w", "s"),
            "dw": ("dy", "x", "s"), "ds": ("dy", "x", "w")}


def sm_bound_ms(directions, m: int, n: int, k: int,
                batch: int = 1) -> tuple[float, str]:
    """Least time of one ``scaled_matmul`` launch computing ``directions``
    for ``batch`` cohort rows: the operands they read, each once, and
    their outputs written once (float32), against 2 M N K multiply-adds a
    direction and its scaling a row, over the card's float32 rate outside
    the tensor cores."""
    sizes = {"x": m * k, "w": n * k, "s": n, "dy": m * n}
    outputs = {"forward": m * n, "dx": m * k, "dw": n * k, "ds": n}
    extra = {"forward": m * n, "dx": m * n, "dw": n * k, "ds": 2 * m * n}
    reads = set().union(*(SM_READS[d] for d in directions))
    t_bytes = 4 * batch * (sum(sizes[r] for r in reads) + sum(
        outputs[d] for d in directions)) / HBM_BYTES_PER_S * 1e3
    t_ops = batch * sum(2 * m * n * k + extra[d] for d in directions) / (
        F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_dims(direction: str, a, b) -> tuple[int, int, int]:
    """(M, N, K) of a direction's first two operands: x (M, K) and w (N, K)
    for the forward, else dy (M, N) and w (N, K) or x (M, K); a cohort's
    lead with its rows (``sm_batch``)."""
    if direction == "forward":
        return a.shape[-2], b.shape[-2], a.shape[-1]
    return a.shape[-2], a.shape[-1], b.shape[-1]


def sm_batch(a) -> int:
    """Cohort rows of a ``scaled_matmul`` operand: 1 for a 2-D one."""
    return a.shape[0] if a.ndim == 3 else 1


SM_PLAIN = {"forward": "scaled_matmul_plain", "dx": "dx_plain",
            "dw": "dw_plain", "ds": "ds_plain"}


def sm_err_bound(torch, direction: str, a, b, c):
    """The float32 error bound of kernel against plain, 2 (R + 2) u times
    the sum of the absolute products, computed in float64: R is the depth
    of the sums, K or M products, and M + K for ds, a sum over M of dy
    times a sum over K."""
    a, b, c = (t.double().abs() for t in (a, b, c))
    u = 2.0 ** -24

    def t(v):
        return v.transpose(-1, -2)

    if direction == "forward":       # x, w, s
        return 2 * (a.shape[-1] + 2) * u * (a @ t(b * c[..., None]))
    if direction == "dx":            # dy, w, s
        return 2 * (a.shape[-1] + 2) * u * ((a * c[..., None, :]) @ b)
    if direction == "dw":            # dy, x, s
        return 2 * (a.shape[-2] + 2) * u * (t(a * c[..., None, :]) @ b)
    return 2 * (a.shape[-2] + b.shape[-1] + 2) * u * torch.sum(
        a * (b @ t(c)), dim=-2)      # dy, x, w


def sm_compare(torch, sm, direction: str, a, b, c,
               got=None) -> tuple[float, float]:
    """One direction's kernel (or ``got``, its result from a launch made
    before) against its plain version on the card; fails beyond the
    float32 error bound.  Returns (max |difference|, largest share of the
    bound used)."""
    if got is None:
        got = getattr(sm, direction)(a, b, c)
    want = getattr(sm, SM_PLAIN[direction])(a, b, c)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"scaled_matmul {direction}: shape {tuple(got.shape)} against "
             f"{tuple(want.shape)}")
    err = (got.double() - want.double()).abs()
    bound = sm_err_bound(torch, direction, a, b, c)
    share = float((err / bound.clamp_min(1e-300)).max()) if err.numel() else 0.0
    if not bool((err <= bound).all()):
        fail(f"scaled_matmul {direction} at {tuple(a.shape)} x "
             f"{tuple(b.shape)}: {float(err.max()):.3g} off its plain "
             f"version, {share:.3g} of the float32 error bound")
    return float(err.max()) if err.numel() else 0.0, share


SM_GRADS = ("dx", "dw", "ds")
# every non-empty subset of the backward's gradients
SM_SUBSETS = [f for f in itertools.product((False, True), repeat=3)
              if any(f)]


def sm_backward_check(torch, sm, dy, x, w, s, flags) -> tuple[float, float]:
    """One backward launch computing the gradients ``flags`` asks for,
    each against its plain version within the float32 error bound, and a
    second launch giving the same bits.  Returns (max |difference|,
    largest share of the bound used)."""
    first = sm.backward(dy, x, w, s, *flags)
    again = sm.backward(dy, x, w, s, *flags)
    args = {"dx": (dy, w, s), "dw": (dy, x, s), "ds": (dy, x, w)}
    err = share = 0.0
    for d, f, g, g2 in zip(SM_GRADS, flags, first, again):
        if (g is None) == f:
            fail(f"scaled_matmul backward {flags}: {d} is {g}")
        if not f:
            continue
        e, sh = sm_compare(torch, sm, d, *args[d], got=g)
        err, share = max(err, e), max(share, sh)
        if not torch.equal(g.view(torch.int32), g2.view(torch.int32)):
            fail(f"scaled_matmul backward {flags} at {tuple(dy.shape)}: "
                 f"{d} differs between two launches")
    return err, share


def sm_check_shape(torch, sm, gen, m: int, n: int, k: int, worst: dict,
                   batch: int | None = None):
    """Every direction and backward subset of ``scaled_matmul`` against its
    plain version at (M, N, K) on random inputs, the backward twice, for
    one product or a cohort of ``batch``; ``worst`` keeps the largest
    share of the error bound per direction.  Returns (the checks, the
    inputs x, w, s, dy)."""
    lead = () if batch is None else (batch,)
    x = torch.randn(lead + (m, k), generator=gen).cuda()
    w = (torch.randn(lead + (n, k), generator=gen) / math.sqrt(k)).cuda()
    s = (0.8 + 0.4 * torch.rand(lead + (n,), generator=gen)).cuda()
    dy = torch.randn(lead + (m, n), generator=gen).cuda()
    for d, args in (("forward", (x, w, s)), ("dx", (dy, w, s)),
                    ("dw", (dy, x, s)), ("ds", (dy, x, w))):
        worst[d] = max(worst[d], sm_compare(torch, sm, d, *args)[1])
    for flags in SM_SUBSETS:
        worst["backward"] = max(worst["backward"], sm_backward_check(
            torch, sm, dy, x, w, s, flags)[1])
    return 4 + len(SM_SUBSETS), (x, w, s, dy)


def sm_kernel_phase(torch, sm) -> int:
    """Each direction of ``scaled_matmul`` against its plain version on
    random inputs at the main path's shapes (M = 32, 120, 960 against the
    (128, 128) and (10, 128) dense weights) and ragged ones, and the
    backward for every subset of its gradients there, each twice; returns
    the number of checks."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(m, n, 128) for m in (32, 120, 960) for n in (128, 10)] + [
        (1, 1, 1), (5, 3, 7), (33, 129, 130), (17, 16, 32), (70, 33, 65)]
    worst = dict.fromkeys(sm.DIRECTIONS + ("backward",), 0.0)
    checks = sum(sm_check_shape(torch, sm, gen, *shape, worst)[0]
                 for shape in shapes)
    print(f"kernel phase: {checks} scaled_matmul-vs-plain comparisons (4 "
          f"directions and the backward for {len(SM_SUBSETS)} subsets of "
          f"its gradients, twice to the same bits, at {len(shapes)} "
          f"shapes), within the float32 error bound; largest share of it "
          f"used: { {d: round(v, 4) for d, v in worst.items()} }")
    return checks


# ------------------------------------------------------------ slice 12

COHORT = 8                       # clients a full-width round trains at once
COHORT_SM_SHAPES = ((32, 128, 128), (32, 10, 128), (32, 20, 128),
                    (120, 128, 128))
COHORT_LA_MODELS = (("vgg11_thinned", 28), ("resnet18_small", 55),
                    ("mobilenetv2_small", 62))


def cohort_kernel_phase(torch, sm, la, models, cohort: int = COHORT,
                        sm_shapes=COHORT_SM_SHAPES,
                        la_models=COHORT_LA_MODELS) -> tuple[int, dict]:
    """The two kernels that take a cohort in one launch, against their
    plain versions on random inputs: ``scaled_matmul`` at K = ``cohort``
    (8; 32 for the population path) rows of the main paths' dense shapes
    (``sm_shapes``), every direction and backward subset within the
    float32 error bound (the backward twice to the same bits), each row
    bitwise the launch over that row alone; ``level_assign_leaves`` over
    ``cohort`` rows of every leaf of VGG11, the ResNet and the MobileNet
    (``la_models``), in one launch, bitwise the plain version and each
    row's own launch.  Each timed beside its plain version, the bound
    and, for ``scaled_matmul``, ``torch.bmm`` and a multiply.  Returns
    (checks, timings)."""
    gen = torch.Generator().manual_seed(12)
    worst = dict.fromkeys(sm.DIRECTIONS + ("backward",), 0.0)
    checks, sm_t = 0, []
    for m, n, k in sm_shapes:
        c, (x, w, s, dy) = sm_check_shape(torch, sm, gen, m, n, k, worst,
                                          cohort)
        checks += c
        rows = sm.backward(dy, x, w, s, True, True, True)
        y = sm.forward(x, w, s)
        for i in range(cohort):
            one = sm.backward(dy[i], x[i], w[i], s[i], True, True, True)
            if not (torch.equal(y[i], sm.forward(x[i], w[i], s[i]))
                    and all(torch.equal(a[i], b) for a, b in zip(rows, one))):
                fail(f"scaled_matmul at K = {cohort}, ({m}, {n}, {k}): row "
                     f"{i} differs from its own launch")
        checks += 1
        before = dict(sm.LAUNCHES)
        sm.forward(x, w, s)
        sm.backward(dy, x, w, s, True, True, False)
        if (sm.LAUNCHES["forward"] - before["forward"],
                sm.LAUNCHES["backward"] - before["backward"]) != (1, 1):
            fail("scaled_matmul took a cohort in more than one launch")
        fwd = dict(kernel_times(torch, lambda: sm.forward(x, w, s),
                                lambda: sm.scaled_matmul_plain(x, w, s)),
                   library_ms=time_ms(torch, lambda: SM_LIBRARY["forward"](
                       torch, x, w, s)),
                   bound=sm_bound_ms(("forward",), m, n, k, cohort))
        bwd = dict(kernel_times(
            torch, lambda: sm.backward(dy, x, w, s, True, True, False),
            lambda: (sm.dx_plain(dy, w, s), sm.dw_plain(dy, x, s))),
            library_ms=time_ms(torch, lambda: [
                SM_LIBRARY[d](torch, dy, x, w, s) for d in ("dx", "dw")]),
            bound=sm_bound_ms(("dx", "dw"), m, n, k, cohort))
        sm_t.append({"k_mnk": [cohort, m, n, k], "forward": fwd,
                     "backward_dx_dw": bwd})
        print(f"  cohort scaled_matmul K={cohort} ({m}, {n}, {k}): forward "
              f"{fwd['ms']:.4f} ms (plain {fwd['plain_ms']:.4f}, torch.bmm "
              f"and a multiply {fwd['library_ms']:.4f}, bound "
              f"{fwd['bound'][0]:.6f} {fwd['bound'][1]}); backward dx + dw "
              f"{bwd['ms']:.4f} ms (plain {bwd['plain_ms']:.4f}, torch.bmm "
              f"{bwd['library_ms']:.4f}, bound {bwd['bound'][0]:.6f})")
    la_t = {}
    for name, leaves in la_models:
        params, _ = getattr(models, name)().init(
            torch.Generator().manual_seed(0))
        shapes = [tuple(v.shape) for d in params.values()
                  for v in d.values()]
        if len(shapes) != leaves:
            fail(f"{name} has {len(shapes)} leaves, not {leaves}")
        rows = [la_leaf_inputs(torch, gen, shapes) for _ in range(cohort)]
        d = [torch.stack([r[0][i] for r in rows]) for i in range(leaves)]
        r = [torch.stack([r[1][i] for r in rows]) for i in range(leaves)]
        th = torch.stack([r_[2] for r_ in rows])
        steps = rows[0][3]
        la_group_compare(torch, la, d, r, th, steps)
        lvs, cs = la.level_assign_leaves(d, r, th, steps)
        for i in range(cohort):
            one_l, one_c = la.level_assign_leaves(
                [t[i] for t in d], [t[i] for t in r], th[i].contiguous(),
                steps)
            if not all(torch.equal(a[i], b) for a, b in zip(lvs, one_l)) or \
                    not all(torch.equal(a[i].view(torch.int32),
                                        b.view(torch.int32))
                            for a, b in zip(cs, one_c)):
                fail(f"level_assign_leaves on {name}'s cohort: row {i} "
                     f"differs from its own launch")
        checks += 2
        n = sum(t.numel() for t in d)
        per_client = [([t[i] for t in d], [t[i] for t in r],
                       th[i].contiguous()) for i in range(cohort)]
        la_t[name] = dict(
            kernel_times(torch, lambda: la.level_assign_leaves(d, r, th,
                                                               steps),
                         lambda: la.level_assign_leaves_plain(d, r, th,
                                                              steps)),
            per_client_launches_ms=time_ms(torch, lambda: [
                la.level_assign_leaves(a, b, c, steps)
                for a, b, c in per_client], spin=20_000_000),
            bound=la_bound_ms(n), elements=n, leaves=leaves, rows=cohort)
        t = la_t[name]
        print(f"  cohort level_assign {cohort} x {leaves} leaves of {name} "
              f"({n} elements): bitwise, one launch {t['ms']:.4f} ms "
              f"(whole call {t['call_ms']:.4f} ms), {cohort} per-client "
              f"launches {t['per_client_launches_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.6f} ms "
              f"({t['bound'][1]})")
    print(f"kernel phase: {checks} cohort comparisons (scaled_matmul at K = "
          f"{cohort} within the float32 error bound, largest share "
          f"{ {d: round(v, 4) for d, v in worst.items()} }; level_assign "
          f"bitwise), each row bitwise its own launch")
    return checks, {"scaled_matmul": sm_t, "level_assign": la_t,
                    "sm_bound_share": worst}


STEP_UNI, STEP_FINE = 4.88e-4, 2.38e-6     # the uniform and fine steps


def spy_contributions(eng) -> list:
    """The engine's aggregated contributions, in order."""
    seen = []
    agg0 = eng.aggregate

    def aggregate(contribs, weights=None):
        seen.extend(contribs)
        return agg0(contribs, weights)

    eng.aggregate = aggregate
    return seen


def executor_contract(torch, label: str, seen, rec, base, base_rec,
                      exact: bool = False) -> dict:
    """Two backends' contributions of one round under the reference's
    executor contract (``tests/test_executors.py``): the same clients,
    decoded params deltas within 1.5 uniform steps, scale deltas within
    1.5 fine steps, BN within rtol 1e-5 (atol 1e-6), bytes within 2% and
    test accuracy within 0.02 (``executor_gaps``); with ``exact``, every
    decoded tree and the bytes equal bit for bit.  Returns the gaps."""
    if [c.client for c in seen] != [c.client for c in base]:
        fail(f"{label}: clients {[c.client for c in seen]} against "
             f"{[c.client for c in base]}")
    gaps = executor_gaps(torch, seen, rec, base, base_rec)
    parts = ("delta_params", "delta_scales", "bn_state")
    if any(gaps[p]["beyond_contract"] for p in parts):
        fail(f"{label}: outside the executor contract: {gaps}")
    if abs(rec.up_bytes - base_rec.up_bytes) > 0.02 * base_rec.up_bytes:
        fail(f"{label}: up_bytes {rec.up_bytes} against {base_rec.up_bytes}")
    if abs(rec.test_acc - base_rec.test_acc) > 0.02:
        fail(f"{label}: test_acc {rec.test_acc} against {base_rec.test_acc}")
    gaps["bitwise"] = (rec.up_bytes == base_rec.up_bytes
                       and all(gaps[p]["max_abs"] == 0 for p in parts))
    if exact and not gaps["bitwise"]:
        fail(f"{label}: not bit for bit its batched twin ({gaps})")
    return gaps


GRAD_FLOOR = 1e-4     # a gradient leaf is held against at least this share of the largest


def cohort_model_check(torch, models, splits) -> dict:
    """The card's cohort route (grouped cuDNN convolutions, one BatchNorm
    call a layer, batched dense products) against each client's own
    forward and gradients on the card: ``vgg11_thinned`` and
    ``mobilenetv2_small``, 8 clients with their own weights and scales, 32
    of their own images each, in training and in evaluation.  In float32
    (the dense layers through ``scaled_matmul``) the logits within 1e-5 of
    the client's largest, the gradients read and printed: a ReLU or
    max-pool input within float32 noise of zero routes the backward
    another way and parts a leaf by 1e-5 to 1e-2 (PERF.md §2), whichever
    route is right.  In float64 (every scale folded into its leaf, the
    dense layers as plain batched products, since the kernel takes float32
    only) no input lies that close to a tie, so the route is held there:
    logits within 1e-12 of the largest, each gradient leaf within 1e-10 of
    its norm or of ``GRAD_FLOOR`` times the client's largest leaf norm,
    whichever is larger (a BatchNorm shift whose output the next
    BatchNorm centres has a gradient that is zero but for rounding).
    Returns the worst of each."""
    from repro_torch.core import scaling
    from repro_torch.tree import items, row, tree_map
    import torch.nn.functional as F

    bounds = {"float64 logits": 1e-12, "float64 grads": 1e-10,
              "float32 logits": 1e-5}
    out = {}
    for name in ("vgg11_thinned", "mobilenetv2_small"):
        model = getattr(models, name)()
        clients = [model.init(torch.Generator().manual_seed(c))
                   for c in range(COHORT)]
        params, state = (tree_map(lambda *v: torch.stack(v).cuda(), *trees)
                         for trees in zip(*clients))
        gen = torch.Generator().manual_seed(9)
        base = scaling.init_scales(clients[0][0])
        scales = tree_map(lambda *v: torch.stack(v).cuda(), *[
            tree_map(lambda s: s + 0.05 * torch.randn(s.shape, generator=gen),
                     base) for _ in range(COHORT)])
        images = splits.client_x.cuda()[:, :32]   # the engine's layout
        y = splits.client_y[:, :32].cuda()
        worst = {k: 0.0 for k in ("float32 logits", "float32 grads",
                                  "float64 logits", "float64 grads")}
        for dtype, train in itertools.product(("float32", "float64"),
                                              (True, False)):
            wide = getattr(torch, dtype)

            def grads(p, s, st, xb, yb, cohort):
                p = tree_map(lambda t: t.detach().to(wide).requires_grad_(
                    True), p)
                st = tree_map(lambda t: t.to(wide), st)
                if dtype == "float32":
                    logits, _ = model.apply(
                        scaling.apply_scales_tree(p, s, cohort), st, xb,
                        train=train, scales=s)
                else:
                    logits, _ = model.apply(
                        tree_map(scaling.apply_scale, p, s), st, xb,
                        train=train)
                lp = F.log_softmax(logits, -1)
                loss = torch.mean(-lp.gather(-1, yb[..., None])[..., 0],
                                  dim=-1)
                leaves = [v for _, v in items(p)]
                g = torch.autograd.grad(torch.sum(loss), leaves)
                return logits.detach(), dict(zip(
                    [k for k, _ in items(p)], g))

            x = images.to(wide)
            lc, gc = grads(params, scales, state, x, y, True)
            for k in range(COHORT):
                lk, gk = grads(row(params, k), row(scales, k), row(state, k),
                               x[k], y[k], False)
                worst[f"{dtype} logits"] = max(
                    worst[f"{dtype} logits"],
                    float((lc[k] - lk).abs().max() / lk.abs().max()))
                floor = GRAD_FLOOR * max(float(g.norm()) for g in gk.values())
                worst[f"{dtype} grads"] = max(worst[f"{dtype} grads"], max(
                    float((gc[p][k] - g).norm()) / max(float(g.norm()), floor)
                    for p, g in gk.items()))
        out[name] = worst
        print(f"  cohort route against each client's own on the card, "
              f"{name}, {COHORT} clients: " + ", ".join(
                  f"{k} within {v:.3g}" for k, v in worst.items())
              + " (logits of the largest, gradients of their norm)")
        over = {k: worst[k] for k, b in bounds.items() if worst[k] > b}
        if over:
            fail(f"{name}: the cohort route is off each client's own by "
                 f"{over} (bounds {bounds})")
    return out


def grouped_layout_times(torch, models, splits) -> dict:
    """Each grouped convolution of a ``vgg11_thinned`` cohort (8 clients,
    32 images each; the shapes of one cohort forward), forward and
    backward under deterministic cuDNN, with its input channels-first and
    channels-last in memory: the sums of their median times (CUDA
    events), the reading behind ``cnn.to_nchw``'s channels-last layout."""
    from repro_torch.models import cnn
    from repro_torch.tree import tree_map

    model = models.vgg11_thinned()
    params, state = (tree_map(lambda *v: torch.stack(v).cuda(), *trees)
                     for trees in zip(*[model.init(
                         torch.Generator().manual_seed(c))
                         for c in range(COHORT)]))
    shapes = []
    conv0 = cnn.conv_apply

    def spy(p, x, stride=1, groups=1):
        shapes.append((tuple(x.shape), tuple(p["w"].shape), stride, groups))
        return conv0(p, x, stride, groups)

    cnn.conv_apply = spy
    try:
        with torch.no_grad():
            model.apply(params, state, splits.client_x.cuda()[:, :32])
    finally:
        cnn.conv_apply = conv0
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    with deterministic_cudnn(torch):
        for fmt in ("channels_first", "channels_last"):
            memory = (torch.channels_last if fmt == "channels_last"
                      else torch.contiguous_format)
            total = 0.0
            for xs, ws, stride, groups in shapes:
                x = torch.randn(xs, device="cuda", generator=gen).contiguous(
                    memory_format=memory).requires_grad_(True)
                w = torch.randn(ws, device="cuda", generator=gen,
                                requires_grad=True)
                dy = torch.randn_like(conv0({"w": w}, x, stride, groups))

                def step():
                    y = conv0({"w": w}, x, stride, groups)
                    torch.autograd.grad(y, (x, w), dy)

                total += time_ms(torch, step, iters=20)
            out[fmt] = total
    print(f"  grouped convolutions of a vgg11_thinned cohort ({len(shapes)} "
          f"layers, forward and backward): channels-first "
          f"{out['channels_first']:.4f} ms, channels-last "
          f"{out['channels_last']:.4f} ms")
    return out


def executor_gaps(torch, seen, rec, base, base_rec) -> dict:
    """How far two backends' contributions of one round lie apart: per
    part, the elements beyond the executor contract's bound and the
    largest gap; the bytes and accuracies."""
    from repro_torch.tree import sorted_items

    out = {"up_bytes": [rec.up_bytes, base_rec.up_bytes],
           "test_acc": [rec.test_acc, base_rec.test_acc]}
    for part, tol in (("delta_params", 1.5 * STEP_UNI),
                      ("delta_scales", 1.5 * STEP_FINE), ("bn_state", None)):
        over = total = 0
        worst = 0.0
        for a, b in zip(seen, base):
            fa = dict(sorted_items(getattr(a, part)))
            for p, v in sorted_items(getattr(b, part)):
                v = torch.as_tensor(v).double().cpu()
                d = (torch.as_tensor(fa[p]).double().cpu() - v).abs()
                bound = (1e-6 + 1e-5 * v.abs()) if tol is None else tol
                over += int((d > bound).sum())
                total += d.numel()
                worst = max(worst, float(d.max()))
        out[part] = {"beyond_contract": over, "elements": total,
                     "max_abs": worst}
    return out


def nudged(torch, eng):
    """``eng`` with every server param one ulp up (toward +inf): run
    beside the same engine unnudged, a control of how far a round moves
    when only its float32 rounding changes."""
    from repro_torch.tree import tree_map

    eng.server = eng.server._replace(params=tree_map(
        lambda t: torch.nextafter(t, torch.full_like(t, math.inf)),
        eng.server.params))
    return eng


# the step check: a cohort step's gap may be STEP_FACTOR times the
# control's; a stepped value STEP_PARAM_TOL apart is counted; a routing
# decision within TIE_NOISE of a tie (of its layer's largest input) is
# float32 noise
STEP_FACTOR = 8.0
STEP_PARAM_TOL = 1e-6
TIE_NOISE = 1e-5


class Routing:
    """``torch.nn.functional`` for ``models.cnn`` with ``relu`` and
    ``max_pool2d`` that record each routing decision of a forward (the
    ReLU's ``x > 0`` mask, the pool's argmax indices) beside its input,
    or, given ``forced`` (one decision a call, in call order), route by
    those decisions instead: ``where(mask, x, 0)`` and a gather at the
    indices, so the backward takes the forced routes.  Everything else is
    ``torch.nn.functional`` itself."""

    def __init__(self, torch, forced=None):
        import torch.nn.functional as F
        self._torch, self._F, self.forced = torch, F, forced
        self.calls: list = []

    def __getattr__(self, name):
        return getattr(self._F, name)

    def relu(self, x):
        j = len(self.calls)
        if self.forced is None:
            self.calls.append(("relu", x.detach(), x.detach() > 0))
            return self._F.relu(x)
        mask = self.forced[j]
        self.calls.append(("relu", x.detach(), mask))
        return self._torch.where(mask, x, self._torch.zeros_like(x))

    def max_pool2d(self, x, kernel, stride):
        j = len(self.calls)
        out, idx = self._F.max_pool2d(x, kernel, stride, return_indices=True)
        if self.forced is not None:
            idx = self.forced[j]
            out = x.flatten(2).gather(2, idx.flatten(2)).reshape(idx.shape)
        self.calls.append(("pool", x.detach(), idx))
        return out


def _client_part(t, i: int, k: int):
    """Client ``i``'s part of a cohort forward's tensor: its channel block
    of the grouped layout (B, K*C, ...), or its row of (K, B, N)."""
    if t.ndim == 3:
        return t[i]
    c = t.shape[1] // k
    return t[:, i * c:(i + 1) * c]


def _cohort_of(parts: list):
    """The cohort forward's decision from its clients' (the inverse of
    ``_client_part``)."""
    import torch
    return (torch.stack(parts) if parts[0].ndim == 2
            else torch.cat(parts, dim=1))


def route_flips(serial_calls, cohort_calls, i: int, k: int) -> list[float]:
    """Where the cohort forward routed client ``i`` otherwise than the
    serial forward: for each such ReLU or max-pool decision, its margin
    in the serial forward's own input (``|x|`` at a ReLU, the chosen
    maximum less the cohort's choice at a pool) over the layer's largest
    ``|x|``."""
    margins = []
    for (kind, xs, ds), (_, _, dc) in zip(serial_calls, cohort_calls):
        dc = _client_part(dc, i, k)
        scale = float(xs.abs().max()) or 1.0
        flip = ds != dc
        if not bool(flip.any()):
            continue
        if kind == "relu":
            margins += (xs[flip].abs() / scale).tolist()
        else:
            plane = xs.flatten(2)
            chosen = plane.gather(2, ds.flatten(2)).reshape(ds.shape)
            other = plane.gather(2, dc.flatten(2)).reshape(dc.shape)
            margins += ((chosen - other)[flip].abs() / scale).tolist()
    return margins


def step_gaps(torch, eng, k: int) -> list[dict]:
    """The cohort route against the serial route one local step at a
    time, teacher-forced from the serial route's own states.

    ``eng`` is an engine on the serial executor.  Its first ``k`` clients
    train one round one after another through ``client_round`` against
    the server, and every state a W-step or an S-step starts from
    (params, scales, BN state, optimizer state, the batch) is recorded
    through ``client_round.steps``.  From each recorded state one step is
    taken three ways: the cohort route (the ``k`` clients' states stacked
    into one call of the same step, as ``client_round.cohort`` takes it),
    the serial route, and the control: the serial route with that
    state's params one ulp up (toward +inf), a step that differs only by
    float32 rounding.  Per step, against the serial step: the largest
    gradient gap of any client's leaf relative to the leaf's norm,
    floored at ``GRAD_FLOOR`` times that client's largest leaf norm
    (``gap``), and the count of stepped params (W-steps) or scales
    (S-steps) apart by more than ``STEP_PARAM_TOL`` (``apart``).

    Each step also records (the VGG family: ``models.cnn``'s ``F.relu``
    and ``F.max_pool2d`` through :class:`Routing`) every ReLU and max-pool
    decision of the serial and the cohort
    forwards, lists the margins of the decisions the cohort route took
    otherwise (``flips``, see ``route_flips``), and takes the cohort and
    the control steps once more with their routing forced to the serial
    forward's (``cohort_forced``, ``control_forced``): what is left of the
    gap then is rounding alone.  Returns one dict a step, W-steps first,
    in order."""
    from repro_torch.models import cnn
    from repro_torch.tree import items, row, stack, tree_map

    lt = eng.local_train
    cr = lt.executor.round
    steps = cr.steps
    w0, s0 = steps.w_step, steps.s_step
    recorded = {"w": [[] for _ in range(k)], "s": [[] for _ in range(k)]}
    who = [0]

    def keep(tree):
        return tree_map(lambda x: x.detach().clone()
                        if isinstance(x, torch.Tensor) else x, tree)

    def w_rec(*args):
        recorded["w"][who[0]].append(keep(args))
        return w0(*args)

    def s_rec(*args):
        recorded["s"][who[0]].append(keep(args))
        return s0(*args)

    s = lt.splits
    bidx = lt.batches(torch.Generator().manual_seed(11), k).to(
        s.client_x.device)
    steps.w_step, steps.s_step = w_rec, s_rec
    try:
        for i in range(k):
            who[0] = i
            cr(eng.server, row(lt.state, i), s.client_x[i], s.client_y[i],
               s.client_val_x[i], s.client_val_y[i], bidx[i])
    finally:
        steps.w_step, steps.s_step = w0, s0

    def up_one(tree):
        return tree_map(lambda t: torch.nextafter(
            t, torch.full_like(t, math.inf)), tree)

    f0 = cnn.F

    def routed(call, forced=None):
        """``call()`` with ``cnn.F`` a :class:`Routing` -> (its result,
        the routing's calls)."""
        cnn.F = Routing(torch, forced)
        try:
            return call(), cnn.F.calls
        finally:
            cnn.F = f0

    out = []
    for kind, fn in (("w", w0), ("s", s0)):
        for t in range(len(recorded[kind][0])):
            states = [recorded[kind][i][t] for i in range(k)]
            mask = states[0][6]
            args = [stack([st[j] for st in states]) for j in range(6)]
            cohort, c_calls = routed(lambda: fn(*args, mask))
            runs = {"cohort": [], "control": [], "cohort_forced": [],
                    "control_forced": []}
            serials, flips = [], []
            for i, st in enumerate(states):
                serial, s_calls = routed(lambda: fn(*st))
                serials.append(serial)
                runs["cohort"].append(cohort)
                runs["control"].append(fn(up_one(st[0]), *st[1:]))
                flips += route_flips(s_calls, c_calls, i, k)
                runs["control_forced"].append(routed(
                    lambda: fn(up_one(st[0]), *st[1:]),
                    [d for _, _, d in s_calls])[0])
                states[i] = (st, s_calls)
            forced = [_cohort_of([states[i][1][j][2] for i in range(k)])
                      for j in range(len(c_calls))]
            runs["cohort_forced"] = [routed(lambda: fn(*args, mask),
                                            forced)[0]] * k
            rec = {"kind": kind, "step": t, "gap": {}, "apart": {},
                   "flips": len(flips),
                   "flip_margin": max(flips, default=0.0)}
            for route, res in runs.items():
                gap, apart = 0.0, 0
                for i, (serial, got) in enumerate(zip(serials, res)):
                    stepped, grads = got[0], got[-1]
                    if route.startswith("cohort"):
                        stepped, grads = row(stepped, i), row(grads, i)
                    g_ser = dict(items(serial[-1]))
                    g_got = dict(items(grads))
                    floor = GRAD_FLOOR * max(float(g.norm())
                                             for g in g_ser.values())
                    gap = max(gap, max(float((g_got[p] - g).norm())
                                       / max(float(g.norm()), floor)
                                       for p, g in g_ser.items()))
                    apart += sum(int(((a - b).abs() > STEP_PARAM_TOL).sum())
                                 for (_, a), (_, b) in zip(
                                     items(stepped), items(serial[0])))
                rec["gap"][route], rec["apart"][route] = gap, apart
            out.append(rec)
    return out


def step_rule(gaps: list[dict], route: str = "cohort",
              control: str = "control") -> tuple[list[dict], dict]:
    """The step check's rule: at every step the cohort route's largest
    gradient gap at most ``STEP_FACTOR`` times the control's, and its
    count of stepped values apart at most ``STEP_FACTOR`` times the
    control's (a count of 0 taken as 1).  ``route``/``control`` name the
    two compared (the forced-routing pair: ``cohort_forced``,
    ``control_forced``).  -> (the steps that break it, the worst ratio of
    each metric and where)."""
    broken, worst = [], {"gap": (0.0, None), "apart": (0.0, None)}
    for g in gaps:
        where = f"{g['kind']}{g['step']}"
        ratios = {"gap": g["gap"][route] / max(g["gap"][control], 1e-30),
                  "apart": g["apart"][route] / max(g["apart"][control], 1)}
        for m, r in ratios.items():
            if r > worst[m][0]:
                worst[m] = (r, where)
        if any(r > STEP_FACTOR for r in ratios.values()):
            broken.append(g)
    return broken, worst


def step_verdict(gaps: list[dict]) -> dict:
    """``step_rule`` on the routes as they run and with their routing
    forced, and the causes: a step that breaks the rule as it runs is
    explained when the cohort route routed some ReLU or max-pool decision
    otherwise than the serial route and every such decision lay within
    ``TIE_NOISE`` of a tie; the forced pair must hold the rule at every
    step.  -> the broken steps, the worst ratios and what is unexplained
    (empty when the check holds)."""
    broken, worst = step_rule(gaps)
    broken_f, worst_f = step_rule(gaps, "cohort_forced", "control_forced")
    wide = [f"{g['kind']}{g['step']}" for g in gaps
            if g["flip_margin"] > TIE_NOISE]
    unexplained = [f"{g['kind']}{g['step']}" for g in broken
                   if g["flips"] == 0]
    return {"broken": [f"{g['kind']}{g['step']}" for g in broken],
            "worst": worst, "broken_forced": [
                f"{g['kind']}{g['step']}" for g in broken_f],
            "worst_forced": worst_f, "flips_beyond_noise": wide,
            "unexplained": unexplained,
            "worst_flip_margin": max(g["flip_margin"] for g in gaps)}


def step_check(torch, fl, models, splits) -> dict:
    """``step_gaps`` at full width in ``exec_serial_k4``'s setting
    (``vgg11_thinned``, 4 clients of 560 images, batch 32: 17 W-steps and
    2 x 17 S-steps) on the card, judged by ``step_verdict``: it fails on
    a step the forced pair breaks, a flipped decision beyond
    ``TIE_NOISE``, or a broken step without a flip."""
    s = fl.get_scenario("exec_serial_k4")
    eng = fl.FederatedEngine(models.vgg11_thinned(), fl.build_protocol(s, 1),
                             splits, engine_cfg=fl.build_engine(s),
                             device="cuda")
    gaps = step_gaps(torch, eng, 4)
    verdict = step_verdict(gaps)
    for g in gaps:
        print(f"  step_check {g['kind']}-step {g['step']:2d}: gradient gap "
              + ", ".join(f"{r} {v:.3g}" for r, v in g["gap"].items())
              + f"; apart by > {STEP_PARAM_TOL:g}: " + ", ".join(
                  f"{r} {v}" for r, v in g["apart"].items())
              + f"; cohort routing flips {g['flips']} (largest margin "
              f"{g['flip_margin']:.3g})")
    print(f"  step_check: {len(gaps)} steps, {verdict} (rule: at most "
          f"{STEP_FACTOR:g} times the control's; ties within "
          f"{TIE_NOISE:g})")
    if (verdict["broken_forced"] or verdict["flips_beyond_noise"]
            or verdict["unexplained"]):
        fail(f"step_check: {verdict}")
    return {"steps": gaps, "verdict": verdict, "factor": STEP_FACTOR}


POP_COHORT = 32      # pop_100k_diurnal's cohort


def span_ms(res, names) -> dict:
    """Host ms and count of each span ``names`` recorded in a run with
    ``telemetry="trace"``."""
    out = {n: {"ms": 0.0, "count": 0} for n in names}
    for sp in res.telemetry.recorder.snapshot():
        if sp.name in out:
            out[sp.name]["ms"] += sp.dur_ns / 1e6
            out[sp.name]["count"] += 1
    return out


def population_paths(torch, mods, rounds_mod, fl, models, splits,
                     rounds_out) -> dict:
    """The population axis on the card (slice 13):

    * (a) ``pop_100k_diurnal`` through ``run_scenario`` on
      ``vgg11_thinned`` with the full-width split as its 8 base shards:
      10^5 virtual clients, cohorts of 32 streamed under diurnal
      availability, their state in the sharded store (16 clients a shard,
      8 hot, spilled with zlib since the card's machine has no
      zstandard), 1 round: one ``level_assign`` and 110/102
      ``scaled_matmul`` launches as for any batched round; its wall,
      bytes, the store's counters and the host ms of the spans
      ``store.spill``, ``store.load`` and ``store.materialize``;
    * (b) the memory store against the sharded one at full width: 64
      virtual clients, cohorts of 8, 4 clients a shard, 2 hot, 2 rounds
      (spills and loads required): records, bytes and server bit for bit;
    * (c) ``pop_1m_lazy_k32`` and ``churn_midround_async`` on the
      scenarios' tiny VGG (a depth cut), 2 rounds each: the churn count
      and the adaptive windows' sizes."""
    out = {}

    # (a)
    s = dataclasses.replace(fl.get_scenario("pop_100k_diurnal"),
                            telemetry="trace")
    holder = {}

    def go():
        holder["res"] = fl.run_scenario(s, rounds=1,
                                        model=models.vgg11_thinned(),
                                        splits=splits, device="cuda")
        return holder["res"]

    engines = []
    init0 = fl.FederatedEngine.__init__

    def init(self, *a, **kw):
        init0(self, *a, **kw)
        engines.append(self)

    fl.FederatedEngine.__init__ = init
    try:
        out["pop_100k_diurnal"] = run_path(
            torch, mods, rounds_mod, "pop_100k_diurnal", go,
            {"level_assign": 1, **sm_per_round(POP_COHORT)}, POP_COHORT, 2,
            rounds_out)
    finally:
        fl.FederatedEngine.__init__ = init0
    res = holder["res"]
    stats = engines[0].local_train.store.stats()
    spans = span_ms(res, ("store.spill", "store.load", "store.materialize",
                          "uplink.intake", "local_train.cohort"))
    rec = res.records[0]
    out["pop_100k_diurnal"].update(store=stats, spans=spans,
                                   sim_time_s=rec.sim_time_s,
                                   participants=list(rec.participants))
    print(f"  pop_100k_diurnal at full width, K = {POP_COHORT}: wall "
          f"{rec.wall_s:.3f} s, up_bytes {rec.up_bytes}, sim_time_s "
          f"{rec.sim_time_s:.3f}, store {stats}, host spans "
          + ", ".join(f"{k} {v['ms']:.1f} ms in {v['count']}"
                      for k, v in spans.items()))
    if (stats["materializations"] < 1 or stats["spills"] < 1
            or max(rec.participants) < splits.num_clients):
        fail(f"pop_100k_diurnal: store {stats}, participants "
             f"{rec.participants}")

    # (b)
    runs = {}
    for backend in ("memory", "sharded"):
        sb = dataclasses.replace(
            fl.get_scenario("pop_100k_diurnal"), population=64,
            cohort_size=8, store=backend, store_shard_size=4,
            store_hot_shards=2)
        eng = fl.FederatedEngine(models.vgg11_thinned(),
                                 fl.build_protocol(sb, 2), splits,
                                 engine_cfg=fl.build_engine(sb),
                                 device="cuda")
        runs[backend] = (eng, eng.run(2))
    (em, rm), (es, rs_) = runs["memory"], runs["sharded"]
    st = es.local_train.store.stats()
    same = [(r.up_bytes, r.test_acc, r.participants, r.sim_time_s)
            for r in rm.records] == [
        (r.up_bytes, r.test_acc, r.participants, r.sim_time_s)
        for r in rs_.records]
    from repro_torch.tree import sorted_items
    for part in ("params", "scales", "bn_state"):
        for (p, a), (_, b) in zip(sorted_items(getattr(em.server, part)),
                                  sorted_items(getattr(es.server, part))):
            same = same and bits_equal(torch, a, b)
    out["memory_vs_sharded"] = {
        "store": st, "bitwise": same,
        "records": [[r.round, r.up_bytes, r.test_acc, list(r.participants)]
                    for r in rs_.records],
        "walls_s": {b: [r.wall_s for r in runs[b][1].records]
                    for b in runs}}
    print(f"  memory against sharded store at full width (64 clients, "
          f"cohorts of 8, 4 a shard, 2 hot, 2 rounds): bit for bit {same}, "
          f"store {st}, walls {out['memory_vs_sharded']['walls_s']}")
    if not same or st["spills"] < 1 or st["loads"] < 1:
        fail(f"memory against sharded store: {out['memory_vs_sharded']}")

    # (c)
    for name in ("pop_1m_lazy_k32", "churn_midround_async"):
        sc = fl.get_scenario(name)
        model, data = fl.default_setting(sc.num_clients)
        eng = fl.FederatedEngine(model, fl.build_protocol(sc, 2), data,
                                 engine_cfg=fl.build_engine(sc),
                                 device="cuda")
        for mod in mods:
            mod.reset_counters()
        res = eng.run(2)
        torch.cuda.synchronize()
        sch = eng.scheduler
        got = {"records": [[r.round, r.up_bytes, r.test_acc, r.sim_time_s,
                            list(r.participants)] for r in res.records],
               "store": eng.local_train.store.stats(),
               "churned_total": getattr(sch, "churned_total", 0),
               "window_sizes": getattr(sch, "batch_sizes", None),
               "launches": launch_counts(*mods)}
        out[name] = got
        print(f"  {name} (the scenario's tiny VGG): {got}")
        for r in res.records:
            rounds_out.append([name, r.round, r.test_acc, r.train_loss,
                               r.up_bytes, r.wall_s, r.down_bytes])
            if not (math.isfinite(r.train_loss) and r.up_bytes > 0
                    and r.participants):
                fail(f"{name}: bad round record {r}")
        if got["launches"]["level_assign"] < 1:
            fail(f"{name}: no level_assign launch")
    if out["churn_midround_async"]["churned_total"] < 1:
        fail("churn_midround_async: no client churned")
    return out


def reference_tiny(torch):
    """``tests/test_executors.py``'s tiny setting, drawn with torch
    generators: a 2-conv VGG (widths 8, 16, dense 16, 4 classes) on 480
    images over 4 clients (2 local steps a client), and its protocol."""
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.data import federated, synthetic
    from repro_torch.models import cnn

    task = synthetic.ImageTask("t", num_classes=4, channels=3, size=32,
                               prototypes_per_class=2, noise=0.25)
    x, y = synthetic.make_image_dataset(torch.Generator().manual_seed(0),
                                        task, 480)
    splits = federated.split_federated(torch.Generator().manual_seed(1), x,
                                       y, num_clients=4)
    model = cnn.make_vgg("vgg_tiny_exec", [8, 16], 4, 3, dense_width=16,
                         pool_after=(0, 1))
    cfg = ProtocolConfig(name="exec", method="sparse", fixed_sparsity=0.9,
                         batch_size=32, local_lr=2e-3)
    return model, splits, cfg


def slice12_paths(torch, mods, rounds_mod, fl, models, splits,
                  rounds_out) -> dict:
    """The executors, one round each from one seed, serial beside batched:

    * held to the reference's executor contract: its own tiny setting
      (``reference_tiny``, cohorts of 3 of 4) through serial, vmap and
      sharded over a two-entry mesh of the card (the ragged cohort padded
      to 4, blocks of 2), and ``exec_serial_k4`` on the scenario VGG with
      1,280 images (3 local steps) through serial and vmap;
    * read, not held: ``exec_serial_k4`` at full width (``vgg11_thinned``,
      17 local steps; 4 ``level_assign`` and 434/408 ``scaled_matmul``
      launches serial, 1 and 110/102 batched) and on the scenario VGG with
      640 images (1 local step), each beside the control of the serial
      round against itself with its server params one ulp up
      (``nudged``); at full width bytes within 2%.  There float32
      rounding alone parts the round: at 1 step the top-k boundary lies
      in a plateau of equal Adam first steps, and at 17 the two part as
      far as the control does (PERF.md §6); in float64 the batched round
      is the serial one bit for bit
      (``tests/test_torch_executors.py::test_backends_bitwise_in_float64``);
    * ``sharded_cohort_full`` on the mesh of every visible device (one
      block a device, each one call of the batched round) beside
      ``sync_full_fedavg_fsfl`` through the batched executor, bit for bit
      on one device (the same computation) and under the contract on
      more."""
    from repro_torch.fl.executors import ShardedExecutor

    out = {"cohort_route": cohort_model_check(torch, models, splits),
           "grouped_layout_ms": grouped_layout_times(torch, models, splits)}
    mesh = torch.cuda.device_count()
    per = -(-splits.num_clients // mesh)

    def engine(name, model=None, data=None, **over):
        s = dataclasses.replace(fl.get_scenario(name), **over)
        return fl.FederatedEngine(
            model or models.vgg11_thinned(), fl.build_protocol(s, 1),
            data or splits, engine_cfg=fl.build_engine(s), device="cuda")

    def run(label, eng, want, clients, **kw):
        seen = spy_contributions(eng)
        holder = {}

        def go():
            holder["res"] = eng.run(1)
            return holder["res"]

        out[label] = run_path(torch, mods, rounds_mod, label, go, want,
                              clients, 2, rounds_out, **kw)
        return seen, holder["res"].records[0]

    def once(eng):
        seen = spy_contributions(eng)
        return seen, eng.run(1).records[0]

    serial = run("exec_serial_k4", engine("exec_serial_k4"),
                 {"level_assign": 4, **sm_per_round(4, calls=4)}, 4,
                 calls=4)
    batched = run("exec_serial_k4 batched",
                  engine("exec_serial_k4", executor="vmap"),
                  {"level_assign": 1, **sm_per_round(4)}, 4)
    control = once(nudged(torch, engine("exec_serial_k4")))
    out["gaps_k4_full_width"] = {
        "batched": executor_gaps(torch, *batched, *serial),
        "serial_nudged": executor_gaps(torch, *control, *serial)}
    print(f"  exec_serial_k4 at full width against its serial round (a "
          f"reading): {out['gaps_k4_full_width']}")
    if abs(serial[1].up_bytes - batched[1].up_bytes) > 0.02 * (
            serial[1].up_bytes):
        fail(f"exec_serial_k4: up_bytes {batched[1].up_bytes} against "
             f"{serial[1].up_bytes}")

    model, data, cfg = reference_tiny(torch)
    tiny = {}
    for ex in ("serial", "vmap", "sharded"):
        eng = fl.FederatedEngine(
            model, cfg, data, seed=5, device="cuda",
            engine_cfg=fl.EngineConfig(
                executor="serial" if ex == "sharded" else ex,
                sampling=fl.SamplingConfig(cohort_size=3)))
        if ex == "sharded":
            sh = ShardedExecutor(mesh=[torch.device("cuda")] * 2)
            sh.bind(eng.local_train.executor.round)
            eng.local_train.executor = sh
        tiny[ex] = once(eng)
    for ex in ("serial", "sharded"):
        out[f"contract_tiny_{ex}"] = executor_contract(
            torch, f"reference's tiny setting, {ex} against vmap",
            *tiny[ex], *tiny["vmap"])
    for n in (SMALL_SAMPLES, 640):
        small = {}
        for ex in ("serial", "vmap", "nudged"):
            model, data = fl.default_setting(8, n_samples=n)
            eng = engine("exec_serial_k4", model, data,
                         executor="vmap" if ex == "vmap" else "serial")
            small[ex] = once(nudged(torch, eng) if ex == "nudged" else eng)
        if n == SMALL_SAMPLES:
            out["contract_k4"] = executor_contract(
                torch, "exec_serial_k4 small", *small["vmap"],
                *small["serial"])
        else:
            out["gaps_k4_640"] = {
                "batched": executor_gaps(torch, *small["vmap"],
                                         *small["serial"]),
                "serial_nudged": executor_gaps(torch, *small["nudged"],
                                               *small["serial"])}
            print(f"  exec_serial_k4 on 640 images against its serial "
                  f"round (a reading): {out['gaps_k4_640']}")
    full = run("sync_full_fedavg_fsfl batched",
               engine("sync_full_fedavg_fsfl"),
               {"level_assign": 1, **sm_per_round(8)}, 8)
    eng = engine("sharded_cohort_full")
    if [d.type for d in eng.local_train.executor.mesh] != ["cuda"] * mesh:
        fail(f"sharded_cohort_full's mesh {eng.local_train.executor.mesh}")
    sharded = run("sharded_cohort_full", eng,
                  {"level_assign": mesh, **sm_per_round(8, calls=mesh)}, 8,
                  calls=mesh, trained=per * mesh)
    out["contract_sharded"] = executor_contract(
        torch, "sharded_cohort_full", *sharded, *full, exact=mesh == 1)
    out["mesh"] = mesh
    for key in ("contract_tiny_serial", "contract_tiny_sharded",
                "contract_k4", "contract_sharded"):
        print(f"  executor contract {key}: {out[key]}")
    return out


def capture_sm(sm) -> tuple[dict, dict]:
    """Wrap ``scaled_matmul``'s forward and backward so that a copy of the
    first call at each distinct set of shapes (and, for the backward,
    gradients asked for) is kept; returns (captured per kernel,
    originals)."""
    captured = {k: {} for k in sm.KERNELS}
    originals = {k: getattr(sm, k) for k in sm.KERNELS}

    def clone(t):
        return None if t is None else t.clone()

    def forward(x, w, s):
        key = (tuple(x.shape), tuple(w.shape))
        captured["forward"].setdefault(key, (x.clone(), w.clone(), s.clone()))
        return originals["forward"](x, w, s)

    def backward(dy, x, w, s, *flags):
        key = (tuple(dy.shape), tuple(w.shape), tuple(flags))
        if key not in captured["backward"]:
            captured["backward"][key] = (dy.clone(), clone(x), clone(w),
                                         clone(s), tuple(flags))
        return originals["backward"](dy, x, w, s, *flags)

    sm.forward, sm.backward = forward, backward
    return captured, originals


def _mm(torch, a, b):
    """``torch.mm``, or ``torch.bmm`` for a cohort's operands."""
    return torch.bmm(a, b) if a.ndim == 3 else torch.mm(a, b)


SM_LIBRARY = {   # one PyTorch call for each function, timed beside
    "forward": lambda torch, x, w, s: _mm(
        torch, x, w.transpose(-1, -2)).mul_(s[..., None, :]),
    "dx": lambda torch, dy, x, w, s: _mm(torch, dy * s[..., None, :], w),
    "dw": lambda torch, dy, x, w, s: _mm(
        torch, dy.transpose(-1, -2), x).mul_(s[..., None]),
    "ds": lambda torch, dy, x, w, s: _mm(
        torch, x, w.transpose(-1, -2)).mul_(dy).sum(-2)}


def sm_main_path(torch, sm, captured) -> dict:
    """The forward at every shape the main path gave it, and the backward
    at every shape and subset of gradients, against the plain versions
    (twice to the same bits), then timed there beside the plain versions,
    the library's ``torch.mm`` and a multiply (for the backward the sum of
    its gradients' calls, and each gradient alone in its own launch), and
    the bound."""
    for k in sm.KERNELS:
        if not captured[k]:
            fail(f"the main path gave scaled_matmul {k} no buffer")
    fwd = []
    for (sa, sb), (x, w, s) in captured["forward"].items():
        err, share = sm_compare(torch, sm, "forward", x, w, s)
        if not torch.equal(sm.forward(x, w, s), sm.forward(x, w, s)):
            fail(f"scaled_matmul forward at {sa} differs between launches")
        m, n, k = sm_dims("forward", x, w)
        b = sm_batch(x)
        t = kernel_times(torch, lambda: sm.forward(x, w, s),
                         lambda: sm.scaled_matmul_plain(x, w, s))
        t["library_ms"] = time_ms(
            torch, lambda: SM_LIBRARY["forward"](torch, x, w, s))
        fwd.append(dict(shapes=[list(sa), list(sb)], mnk=[m, n, k],
                        batch=b, max_abs_err=err, bound_share=share,
                        bound=sm_bound_ms(("forward",), m, n, k, b), **t))
        r = fwd[-1]
        print(f"  scaled_matmul forward {sa} x {sb} on the main path's "
              f"buffer: {err:.3g} off its plain version ({share:.3f} of "
              f"the float32 error bound); kernel {r['ms']:.4f} ms (whole "
              f"wrapper call {r['call_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, torch.{'bmm' if b > 1 else 'mm'} "
              f"and a multiply {r['library_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.6f} ms ({r['bound'][1]})")
    bwd = []
    plains = {"dx": lambda dy, x, w, s: sm.dx_plain(dy, w, s),
              "dw": lambda dy, x, w, s: sm.dw_plain(dy, x, s),
              "ds": lambda dy, x, w, s: sm.ds_plain(dy, x, w)}
    for (sdy, sw, flags), (dy, x, w, s, _) in captured["backward"].items():
        err, share = sm_backward_check(torch, sm, dy, x, w, s, flags)
        asked = [d for d, f in zip(SM_GRADS, flags) if f]
        m, n, k = dy.shape[-2], dy.shape[-1], w.shape[-1]
        b = sm_batch(dy)
        t = kernel_times(torch, lambda: sm.backward(dy, x, w, s, *flags),
                         lambda: [plains[d](dy, x, w, s) for d in asked])
        t["library_ms"] = time_ms(torch, lambda: [
            SM_LIBRARY[d](torch, dy, x, w, s) for d in asked])
        alone = {}
        for d in asked:
            one = tuple(g == d for g in SM_GRADS)
            alone[d] = dict(
                ms=time_ms(torch, lambda: sm.backward(dy, x, w, s, *one)),
                plain_ms=time_ms(torch, lambda: plains[d](dy, x, w, s)),
                library_ms=time_ms(
                    torch, lambda: SM_LIBRARY[d](torch, dy, x, w, s)),
                bound=sm_bound_ms((d,), m, n, k, b))
        bwd.append(dict(shapes=[list(sdy), list(sw)], mnk=[m, n, k],
                        batch=b, grads=asked, max_abs_err=err,
                        bound_share=share,
                        bound=sm_bound_ms(asked, m, n, k, b), alone=alone,
                        **t))
        r = bwd[-1]
        print(f"  scaled_matmul backward {'+'.join(asked)} dy {sdy}, w {sw} "
              f"on the main path's buffers: {err:.3g} off the plain "
              f"versions ({share:.3f} of the float32 error bound); one "
              f"launch {r['ms']:.4f} ms (whole wrapper call "
              f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"torch.{'bmm' if b > 1 else 'mm'} calls "
              f"{r['library_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.6f} ms ({r['bound'][1]}); alone: " + ", ".join(
                  f"{d} {a['ms']:.4f} ms (library {a['library_ms']:.4f})"
                  for d, a in alone.items()))
    return {"forward": fwd, "backward": bwd}


# ------------------------------------------------------------ slice 3

def da_bound_ms(n: int, block: int = 128) -> tuple[float, str]:
    """Least time for ``delta_apply`` over ``n`` elements: w and q read,
    out written (9 bytes each), one scale per block, against 3 float32
    operations each."""
    nbytes = n * DA_BYTES_PER_ELEMENT + 4 * -(-n // block)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * DA_OPS_PER_ELEMENT / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rs_bound_ms(m: int, n: int) -> tuple[float, str]:
    """Least time for ``row_stats`` on (m, n): every element read once and
    one score per row written, against |.| and + per element."""
    t_bytes = (4 * m * n + 4 * m) / HBM_BYTES_PER_S * 1e3
    t_ops = m * n * RS_OPS_PER_ELEMENT / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def da_compare(torch, da, w, q, s, coef: float, block: int = 128) -> float:
    """delta_apply kernel vs plain on the card, bit patterns; returns 0."""
    out = da.delta_apply(w, q, s, coef, block=block)
    want = da.delta_apply_plain(w, q, s, coef, block)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
        fail(f"delta_apply disagrees with its plain version (n "
             f"{w.shape[0]}, coef {coef}, block {block}): "
             f"{float((out - want).abs().max())}")
    return 0.0


def rs_compare(torch, rs, w) -> float:
    """row_stats kernel vs plain on the card at rtol 1e-6; returns the max
    relative difference."""
    got = rs.row_stats(w)
    want = rs.row_stats_plain(w)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    if not rel <= RS_RTOL:
        fail(f"row_stats is {rel:.3g} (relative) off its plain version at "
             f"{tuple(w.shape)}")
    return rel


def slice3_kernel_phase(torch, da, rs, models) -> int:
    """delta_apply (bitwise) and row_stats (rtol 1e-6) against their plain
    versions on random inputs at every vgg11_thinned leaf; returns the
    number of checks."""
    gen = torch.Generator().manual_seed(2)
    params, _ = models.vgg11_thinned().init(torch.Generator().manual_seed(0))
    leaves = [v for d in params.values() for v in d.values()]
    checks = 0
    for n in sorted({v.numel() for v in leaves}) + [VGG_PARAMS, 5, 129]:
        w = (0.1 * torch.randn(n, generator=gen)).cuda()
        q = torch.randint(-127, 128, (n,), generator=gen,
                          dtype=torch.int8).cuda()
        s = (1e-3 * torch.rand(-(-n // 128), generator=gen) + 1e-6).cuda()
        for coef in (1.0, -1.0, 0.5):
            da_compare(torch, da, w, q, s, coef)
            checks += 1
        if n > 8:       # views off a 16-byte boundary: the scalar pass
            m = n - 3
            da_compare(torch, da, w[3:], q[:m], s[:-(-m // 128)], -1.0)
            checks += 1
    worst = 0.0
    views = sorted({(v.shape[0], v.numel() // v.shape[0]) for v in leaves
                    if v.ndim >= 2})
    for m, n in views + [(1, 1), (7, 1000), (130, 513)]:
        rows = torch.rand((m, 1), generator=gen) + 0.2
        w = (1e-3 * rows * torch.randn((m, n), generator=gen)).cuda()
        worst = max(worst, rs_compare(torch, rs, w))
        checks += 1
    print(f"kernel phase: {checks} delta_apply (bitwise) and row_stats "
          f"(max relative difference {worst:.3g}) comparisons at the "
          f"{len(views)} weight views and every leaf size")
    return checks


def bits_equal(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def slice6_kernel_phase(torch, da, rs, models) -> int:
    """The grouped entries on random inputs: ``row_stats_leaves`` on the
    10 weight views and on views that start anywhere in one buffer (more
    than one launch takes), bitwise equal to one-view launches and within
    rtol 1e-6 of the plain version; ``delta_apply_leaves`` on the 28 leaves
    with the levels at every byte offset mod 16 and the values views into
    one flat buffer, and on 70 leaves, bitwise equal to its plain version
    for coef +1 and -1.  Returns the number of checks."""
    gen = torch.Generator().manual_seed(6)
    params, _ = models.vgg11_thinned().init(torch.Generator().manual_seed(0))
    leaves = [v for d in params.values() for v in d.values()]
    checks = 0
    shapes = [(v.shape[0], v.numel() // v.shape[0]) for v in leaves
              if v.ndim >= 2]
    odd = [(3, 27), (5, 1152), (2, 1281), (7, 5), (1, 4000)] * 14
    for group in (shapes, odd):
        flat = (1e-3 * torch.randn(sum(m * n + 1 for m, n in group) + 1,
                                   generator=gen)).cuda()
        views, o = [], 1 if group is odd else 0
        for m, n in group:
            views.append(flat[o:o + m * n].view(m, n))
            o += m * n + (1 if group is odd else 0)
        rs.reset_counters()
        got = rs.row_stats_leaves(views)
        if rs.LAUNCHES["row_stats"] != -(-len(views) // 64):
            fail(f"row_stats_leaves made {rs.LAUNCHES['row_stats']} "
                 f"launches for {len(views)} views")
        for v, g in zip(views, got):
            if not bits_equal(torch, g, rs.row_stats(v)):
                fail(f"row_stats_leaves differs from a one-view launch at "
                     f"{tuple(v.shape)}")
            rs_compare(torch, rs, v)
            checks += 1
    sizes = [v.numel() for v in leaves]
    wbuf = (0.1 * torch.randn(sum(sizes) + 3 * len(sizes),
                              generator=gen)).cuda()
    qbuf = torch.randint(-127, 128, (16 + sum(sizes) + 128,), generator=gen,
                         dtype=torch.int8).cuda()
    scales = [(1e-3 * torch.rand(-(-n // 128), generator=gen)
               + 1e-6).cuda() for n in sizes]
    for q_off in range(16):
        ws, qs, o, qo = [], [], 0, q_off
        for i, (v, n) in enumerate(zip(leaves, sizes)):
            o += i % 4                 # w at element offsets 0 to 3 mod 4
            ws.append(wbuf[o:o + n].view(v.shape))
            qs.append(qbuf[qo:qo + n])
            o, qo = o + n, qo + n
        for coef in (1.0, -1.0):
            da.reset_counters()
            got = da.delta_apply_leaves(ws, qs, scales, coef)
            if da.LAUNCHES["delta_apply"] != 1:
                fail(f"delta_apply_leaves made {da.LAUNCHES['delta_apply']} "
                     f"launches for {len(ws)} leaves")
            want = da.delta_apply_leaves_plain(ws, qs, scales, coef, 128)
            torch.cuda.synchronize()
            for g, p in zip(got, want):
                if not bits_equal(torch, g, p):
                    fail(f"delta_apply_leaves disagrees with its plain "
                         f"version (q at offset {q_off} mod 16, coef {coef})")
            checks += 1
    reps = (ws + ws + ws)[:70], (qs + qs + qs)[:70], (scales * 3)[:70]
    da.reset_counters()
    got = da.delta_apply_leaves(*reps, -1.0)
    if da.LAUNCHES["delta_apply"] != 2:
        fail(f"delta_apply_leaves made {da.LAUNCHES['delta_apply']} launches "
             f"for 70 leaves")
    for g, p in zip(got, da.delta_apply_leaves_plain(*reps, -1.0, 128)):
        if not bits_equal(torch, g, p):
            fail("delta_apply_leaves disagrees with its plain version on "
                 "70 leaves")
    checks += 1
    print(f"kernel phase: {checks} grouped row_stats_leaves (bitwise to "
          f"one-view launches) and delta_apply_leaves (bitwise to plain, "
          f"levels at every offset mod 16) comparisons")
    return checks


def capture_calls(module, name: str, keep: int, clone) -> list:
    """Wrap ``module.name`` so that ``clone(args, kwargs)`` of the first
    ``keep`` calls is kept; returns the list.  The caller puts the
    original back."""
    captured = []
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        if len(captured) < keep:
            captured.append(clone(args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, wrapped)
    return captured


def path_a(torch, mods, rounds_mod, fl, fsfl, models, splits,
           rounds_out) -> dict:
    """Path A, the paper's bidirectional setting: 2 rounds of
    run_federated(bidirectional=True) with fsfl, then 1 round of
    bidi_sync_full; nnc-cabac on both legs, level_assign on both: one
    launch a client and one on the downlink."""
    n = splits.num_clients
    cfg = fl.build_protocol(fl.get_scenario("bidi_sync_full"), 2)
    want = {"level_assign": 2, **sm_per_round(n)}
    launches = {}
    for scenario, run in (
            ("run_federated bidirectional",
             lambda: fsfl.run_federated(models.vgg11_thinned(), cfg, splits,
                                        2, bidirectional=True,
                                        device="cuda")),
            ("bidi_sync_full",
             lambda: fl.run_scenario("bidi_sync_full", rounds=1,
                                     model=models.vgg11_thinned(),
                                     splits=splits, device="cuda"))):
        out = run_path(torch, mods, rounds_mod, scenario, run, want, n, 2,
                       rounds_out, bidirectional=True)
        launches[scenario] = path_total(out, "level_assign")
    return launches


def fsfl_dyn_config(protocol_mod, rounds: int):
    """The reference's Fig. 4 setting (benchmarks/compression.py,
    ``fsfl_dyn``): Eqs. 2+3 thresholds, no fixed rate, error feedback,
    scaling."""
    return protocol_mod.ProtocolConfig(
        name="fsfl_dyn", method="sparse", delta=1.0, gamma=1.0,
        batch_size=32, local_lr=2e-3, error_feedback=True, scaling=True,
        scale_lr=2e-2, scale_subepochs=2, total_rounds=rounds)


def path_b(torch, mods, rounds_mod, sparsify_mod, protocol_mod, fsfl,
           models, splits, rounds_out):
    """Path B, the adaptive Eqs. 2+3 setting, bidirectional: 2 rounds of
    run_federated(bidirectional=True) with fsfl_dyn; row_stats once per
    client and on the downlink, each launch over the 10 weight views.
    Returns (launches, the first client's captured row_stats views)."""
    rs = mods[1]
    n = splits.num_clients
    captured = capture_calls(sparsify_mod, "row_stats_leaves", 1,
                             lambda a, k: [w.clone() for w in a[0]])
    try:
        out = run_path(
            torch, mods, rounds_mod, "fsfl_dyn bidirectional",
            lambda: fsfl.run_federated(
                models.vgg11_thinned(), fsfl_dyn_config(protocol_mod, 2),
                splits, 2, bidirectional=True, device="cuda"),
            {"row_stats": n + 1, **sm_per_round(n)}, n, 2, rounds_out,
            bidirectional=True)
    finally:
        sparsify_mod.row_stats_leaves = rs.row_stats_leaves
    return path_total(out, "row_stats"), captured


def path_c(torch, mods, rounds_mod, fl, codecs_mod, models, splits,
           rounds_out):
    """Path C, the int8 broadcast: cohorts of 4, int8-blockscale on both
    legs, 2 rounds; ``delta_apply`` twice a round (the downlink's residual
    and the server's apply), the server's params after each apply held
    bitwise against the host decode of the broadcast payload plus the old
    params.  Returns (delta_apply launches, the first downlink's captured
    residual and apply calls, checked leaves)."""
    da = mods[2]
    rounds = 2
    captured = capture_calls(rounds_mod, "delta_apply_leaves", 2,
                             lambda a, k: tuple([x.clone() for x in col]
                                                for col in a[:3]) + (a[3],))
    payloads, applied, restore = spy_broadcasts(codecs_mod, rounds_mod)
    try:
        out = run_path(
            torch, mods, rounds_mod, "int8 bidirectional k4",
            lambda: fl.run_simulation(
                models.vgg11_thinned(),
                fl.build_protocol(fl.get_scenario("codec_int8_k4"), rounds),
                splits, rounds, engine=fl.EngineConfig(
                    sampling=fl.SamplingConfig(cohort_size=4),
                    codec="int8-blockscale", bidirectional=True),
                device="cuda"),
            {"delta_apply": 2, "delta_compress": 5, "level_assign": 2,
             **sm_per_round(4)}, 4, 2, rounds_out, up=4 * PAYLOAD_BYTES,
            down=4 * DOWN_PAYLOAD_BYTES)
    finally:
        restore()
        rounds_mod.delta_apply_leaves = da.delta_apply_leaves
    checked = check_broadcast_applies(codecs_mod, "int8 bidirectional",
                                      payloads, applied, rounds)
    return path_total(out, "delta_apply"), captured, checked


def spy_broadcasts(codecs_mod, rounds_mod):
    """Keep each int8 broadcast payload as the clients' device sections
    read it, and the server's params before and after each int8 apply, on
    the host; returns (payloads, applies, a function that restores)."""
    from repro_torch.tree import items
    payloads, applied = [], []
    orig_sections = codecs_mod.Int8BlockScaleCodec.device_sections
    orig_apply = rounds_mod.Broadcast.apply

    def device_sections(self, payload, spec, device):
        payloads.append((payload, spec))
        return orig_sections(self, payload, spec, device)

    def apply(self, params):
        out = orig_apply(self, params)
        if self.int8 is not None:
            applied.append(({k: v.cpu() for k, v in items(params)},
                            {k: v.cpu() for k, v in items(out)}))
        return out

    def restore():
        codecs_mod.Int8BlockScaleCodec.device_sections = orig_sections
        rounds_mod.Broadcast.apply = orig_apply

    codecs_mod.Int8BlockScaleCodec.device_sections = device_sections
    rounds_mod.Broadcast.apply = apply
    return payloads, applied, restore


def check_broadcast_applies(codecs_mod, label: str, payloads, applied,
                            rounds: int) -> int:
    """The server's params after each int8 apply, bitwise the host decode
    of that round's broadcast plus the params before; returns the leaves
    checked."""
    from repro_torch.tree import sorted_items
    if len(applied) != rounds or len(payloads) != rounds:
        fail(f"{label}: {len(applied)} applies and {len(payloads)} "
             f"broadcast payloads in {rounds} rounds")
    checked = 0
    for (before, after), (payload, spec) in zip(applied, payloads):
        decoded = dict(sorted_items(codecs_mod.Int8BlockScaleCodec()
                                    ._decode_body(payload, spec).params))
        for path, w in before.items():
            want_np = w.numpy() + decoded[path]
            if not (after[path].numpy().view("int32")
                    == want_np.view("int32")).all():
                fail(f"{label}: server param {path} is not the host decode "
                     f"plus add")
            checked += 1
    print(f"  {label}: the server's params after {rounds} applies bitwise "
          f"equal to the host decode plus add ({checked} leaves)")
    return checked


def da_main_path(torch, da, captured) -> dict:
    """delta_apply against its plain version on the calls path C gave it
    (the first downlink's residual over the 28 leaves, coef -1, and the
    server's apply, +1), bitwise, then timed on the residual call: the one
    grouped launch of this design, the 28 one-leaf launches it replaces,
    and the plain version."""
    if len(captured) != 2 or any(len(c[0]) != VGG_LEAVES for c in captured):
        fail(f"path C gave delta_apply_leaves {len(captured)} calls, "
             f"expected 2 of {VGG_LEAVES} leaves")
    for ws, qs, ss, coef in captured:
        got = da.delta_apply_leaves(ws, qs, ss, coef)
        want = da.delta_apply_leaves_plain(ws, qs, ss, coef, 128)
        torch.cuda.synchronize()
        if not all(bits_equal(torch, g, p) for g, p in zip(got, want)):
            fail(f"delta_apply_leaves disagrees with its plain version on "
                 f"path C's buffers (coef {coef})")
    ws, qs, ss, coef = captured[0]
    n = sum(w.numel() for w in ws)
    # the design before: one launch a leaf on the flat leaf and its levels
    per_leaf = [(w.reshape(-1), q[:w.numel()], s, coef)
                for w, q, s in zip(ws, qs, ss)]

    def chain():
        return [da.delta_apply(*c) for c in per_leaf]

    out = dict(**kernel_times(
        torch, lambda: da.delta_apply_leaves(ws, qs, ss, coef),
        lambda: da.delta_apply_leaves_plain(ws, qs, ss, coef, 128)),
        bound=da_bound_ms(n), elements=n,
        per_leaf_ms=time_ms(torch, chain, spin=40_000_000),
        per_leaf_call_ms=time_ms(torch, chain, host_ahead=False))
    print(f"  delta_apply on path C's {VGG_LEAVES} leaves ({n} elements): "
          f"bitwise for coef {captured[0][3]} and {captured[1][3]}; one "
          f"grouped launch {out['ms']:.4f} ms (whole wrapper call "
          f"{out['call_ms']:.4f} ms), {VGG_LEAVES} launches as before "
          f"{out['per_leaf_ms']:.4f} ms (wrapper calls "
          f"{out['per_leaf_call_ms']:.4f} ms), plain {out['plain_ms']:.4f} "
          f"ms, bound {out['bound'][0]:.5f} ms ({out['bound'][1]})")
    return out


def rs_main_path(torch, rs, captured) -> dict:
    """row_stats against its plain version on the views path B gave it
    (the first client's 10 weight views) at rtol 1e-6, and bitwise against
    one-view launches; the Eq. 3 keep masks and topk_rows indices from the
    kernel and the plain version, flipped rows counted only where the score
    is within rtol of the threshold; then timed: the one grouped launch,
    the 10 one-view launches it replaces, the plain version, and
    ``torch.linalg.vector_norm(w, 1, dim=1)`` (the row sum of |w|, one call
    a view) as the library yardstick."""
    if len(captured) != 1 or len(captured[0]) != VGG_WEIGHTS:
        fail(f"path B gave row_stats_leaves {len(captured)} calls, "
             f"expected one of {VGG_WEIGHTS} views")
    views = captured[0]
    grouped = rs.row_stats_leaves(views)
    worst, worst_abs, flips, topk_flips, kept = 0.0, 0.0, 0, 0, 0
    for w, sk in zip(views, grouped):
        sp = rs.row_stats_plain(w)
        if not bits_equal(torch, sk, rs.row_stats(w)):
            fail(f"row_stats_leaves differs from a one-view launch on path "
                 f"B's view {tuple(w.shape)}")
        rel = float(((sk - sp).abs() / sp.abs().clamp_min(1e-30)).max())
        if not rel <= RS_RTOL:
            fail(f"row_stats is {rel:.3g} (relative) off its plain version "
                 f"at {tuple(w.shape)}")
        worst = max(worst, rel)
        worst_abs = max(worst_abs, float((sk - sp).abs().max()))
        tk, tp = torch.mean(sk), torch.mean(sp)
        mk, mp = sk >= tk, sp >= tp
        kept += int(mk.sum())
        bad = mk != mp
        if bad.any():
            near = (sp[bad] - tp).abs() <= RS_RTOL * tp
            if not near.all():
                fail(f"row_stats: an Eq. 3 keep mask flips at a row away "
                     f"from its threshold ({tuple(w.shape)})")
            flips += int(bad.sum())
        k = max(1, round(w.shape[0] * 0.5))
        ik = torch.sort(torch.sort(sk, descending=True,
                                   stable=True).indices[:k]).values
        ip = torch.sort(torch.sort(sp, descending=True,
                                   stable=True).indices[:k]).values
        if not torch.equal(ik, ip):
            kth = torch.sort(sp, descending=True).values[k - 1]
            if (sp[ik[~torch.isin(ik, ip)]] - kth).abs().max() > (
                    RS_RTOL * kth):
                fail(f"row_stats: topk_rows indices differ away from a tie "
                     f"({tuple(w.shape)})")
            topk_flips += 1
    print(f"  row_stats on path B's {len(views)} views: one grouped launch "
          f"bitwise equal to one-view launches; max relative difference "
          f"from plain {worst:.3g}; Eq. 3 keep masks equal but for {flips} "
          f"near-tie rows ({kept} rows kept); topk_rows (50%) indices equal "
          f"but for {topk_flips} near-tie leaves")

    def chain(fn):
        return lambda: [fn(w) for w in views]

    def norm1(w):
        return torch.linalg.vector_norm(w, 1, dim=1)

    bound = sum(rs_bound_ms(*w.shape)[0] for w in views)
    out = dict(**kernel_times(torch, lambda: rs.row_stats_leaves(views),
                              lambda: rs.row_stats_leaves_plain(views)),
               bound=(bound, rs_bound_ms(*views[0].shape)[1]),
               shapes=[list(w.shape) for w in views],
               per_leaf_ms=time_ms(torch, chain(rs.row_stats),
                                   spin=20_000_000),
               per_leaf_call_ms=time_ms(torch, chain(rs.row_stats),
                                        host_ahead=False),
               library_ms=time_ms(torch, chain(norm1), spin=20_000_000),
               library_per_view_ms=[time_ms(torch, lambda w=w: norm1(w))
                                    for w in views],
               flips=flips, topk_flips=topk_flips, max_rel=worst,
               max_abs_err=worst_abs)
    print(f"  row_stats on path B's {len(views)} views: one grouped launch "
          f"{out['ms']:.4f} ms (whole wrapper call {out['call_ms']:.4f} "
          f"ms), {len(views)} launches as before {out['per_leaf_ms']:.4f} "
          f"ms (wrapper calls {out['per_leaf_call_ms']:.4f} ms), plain "
          f"{out['plain_ms']:.4f} ms, vector_norm {out['library_ms']:.4f} "
          f"ms in {len(views)} calls (per view "
          f"{', '.join(f'{t:.4f}' for t in out['library_per_view_ms'])}), "
          f"bound {out['bound'][0]:.6f} ms ({out['bound'][1]})")
    return out


# ------------------------------------------------------------ slice 8

FC_INT8_V1_BYTES = 22_560    # v1 int8 body of the 4 fc leaves + 1,020 scales
BN_TAIL_BYTES = 6_912        # vgg11_thinned's 1,728 BN scalars, raw float32
FC_INT8_V2_BYTES = 1 + FC_INT8_V1_BYTES + BN_TAIL_BYTES      # 29,473
PATH_E_ENTRIES = 32          # 4 fc params leaves + 28 scales leaves
RAW_MODEL_BYTES = 4 * VGG_PARAMS     # the broadcast a client downloads


def is_fc(path: str) -> bool:
    return path.startswith("fc")


def frozen_unchanged(torch, label: str, params0: dict, server) -> int:
    """Fails unless every server params leaf outside ``fc*`` is bitwise its
    initial value and some ``fc*`` leaf moved; returns the frozen count."""
    from repro_torch.tree import sorted_items
    frozen, moved = 0, 0
    for path, v in sorted_items(server.params):
        same = torch.equal(v.view(torch.int32), params0[path].view(
            torch.int32))
        if is_fc(path):
            moved += not same
        elif not same:
            fail(f"{label}: the frozen server leaf {path} moved")
        else:
            frozen += 1
    if not moved:
        fail(f"{label}: no classifier leaf moved")
    return frozen


def round_line(label: str, rnd: int, rec, rounds_out) -> None:
    print(f"  {label} round {rnd}: test_acc={rec.test_acc:.4f} "
          f"train_loss={rec.train_loss:.4f} up_bytes={rec.up_bytes} "
          f"participants={list(rec.participants)} "
          f"sim_time_s={rec.sim_time_s!r} wall_s={rec.wall_s:.3f}")
    rounds_out.append([label, rnd, rec.test_acc, rec.train_loss,
                       rec.up_bytes, rec.wall_s])
    if not (math.isfinite(rec.train_loss) and 0.0 <= rec.test_acc <= 1.0
            and rec.up_bytes > 0):
        fail(f"{label}: bad round record {rec}")


def path_d(torch, la, sm, fl, codecs_mod, models, splits,
           rounds_out) -> dict:
    """Path D, partial updates: 2 rounds of ``partial_fc_k4`` (nnc-cabac,
    cohorts of 4; only ``fc*`` trains and goes on the wire).  After each
    round the server's params outside ``fc*`` are bitwise their initial
    values; every decoded payload is zero there; each payload is shorter
    than the same levels encoded under the spec without a send mask."""
    import dataclasses
    from repro_torch.tree import sorted_items
    rounds, label = 2, "partial_fc_k4"
    s = fl.get_scenario(label)
    eng = fl.FederatedEngine(models.vgg11_thinned(),
                             fl.build_protocol(s, rounds), splits,
                             engine_cfg=fl.build_engine(s), device="cuda")
    params0 = {p: v.clone() for p, v in sorted_items(eng.server.params)}
    sizes, zeros = [], [0]
    cls = codecs_mod.NncCabacCodec
    enc0, dec0 = cls.encode_batch, cls.decode_batch

    def encode_batch(self, upds, spec, *, clients=None):
        out = enc0(self, upds, spec, clients=clients)
        full = enc0(self, upds, dataclasses.replace(spec, send_mask=None))
        sizes.append([(len(a), len(b)) for a, b in zip(out, full)])
        return out

    def decode_batch(self, payloads, spec, *, clients=None):
        decs = dec0(self, payloads, spec, clients=clients)
        for dec in decs:
            for path, v in sorted_items(dec.params):
                if not is_fc(path):
                    if v.any():
                        fail(f"{label}: a decoded payload is not zero at "
                             f"the frozen leaf {path}")
                    zeros[0] += 1
        return decs

    cls.encode_batch, cls.decode_batch = encode_batch, decode_batch
    la.reset_counters()
    sm.reset_counters()
    recs, frozen = [], 0
    try:
        for rnd in range(1, rounds + 1):
            rec = eng.run(1).records[0]
            torch.cuda.synchronize()
            frozen = frozen_unchanged(torch, f"{label} round {rnd}", params0,
                                      eng.server)
            round_line(label, rnd, rec, rounds_out)
            recs.append(rec)
            if len(rec.participants) != 4:
                fail(f"{label}: {len(rec.participants)} participants")
    finally:
        cls.encode_batch, cls.decode_batch = enc0, dec0
    count = la.LAUNCHES["level_assign"]
    check_sm(sm, label, 4, rounds)
    if count != rounds:
        fail(f"{label}: level_assign launched {count} times, expected "
             f"{rounds}")
    pairs = [p for cohort in sizes for p in cohort]
    if len(pairs) != 4 * rounds or not all(a < b for a, b in pairs):
        fail(f"{label}: payloads vs the unmasked re-encode {pairs}")
    print(f"  {label}: level_assign {count} launches ({count // rounds} a "
          f"round); the server's {frozen} frozen params leaves bitwise "
          f"their initial values after each round; {zeros[0]} frozen "
          f"leaves of decoded payloads all zero; payload vs the unmasked "
          f"re-encode of the same levels (bytes): {pairs}")
    return {"level_assign": count, "walls_s": [r.wall_s for r in recs],
            "up_bytes": [r.up_bytes for r in recs], "payload_vs_unmasked":
                pairs, "frozen_leaves": frozen}


def path_e(torch, dc, la, sm, fl, codecs_mod, device_mod, models, splits,
           rounds_out) -> dict:
    """Path E: partial updates, int8-blockscale, the device cohort encode,
    wire schema v2 and ``chan_lossy_k4``'s channel (drops), cohorts of 4.
    2 rounds, a third only if no drop fell on a cohort in them.  Every
    payload is 29,473 bytes, header 2, BN tail the client's device BN rows
    bitwise; one ``int8_encode_leaves`` launch a cohort over 32 entries;
    the first cohort's bodies bitwise the plain version's on a copy of its
    leaves; a dropped client's residual is bitwise its carry plus its
    decoded delta; the participants are the survivors; ``sim_time_s`` is
    the channel's ``round_time`` of the round's payload sizes, summed."""
    from repro_torch.comms.channel import ChannelModel
    from repro_torch.tree import sorted_items
    label = "partial_int8_v2_lossy_k4"
    chan_cfg = fl.get_scenario("chan_lossy_k4").channel
    s = fl.Scenario(label, cohort_size=4, partial_updates=True,
                    codec="int8-blockscale", device_encode=True,
                    wire_schema=2, channel=chan_cfg)
    eng = fl.FederatedEngine(models.vgg11_thinned(), fl.build_protocol(s, 3),
                             splits, engine_cfg=fl.build_engine(s),
                             device="cuda")
    params0 = {p: v.clone() for p, v in sorted_items(eng.server.params)}
    chan = ChannelModel(chan_cfg)
    seen, entries, first = {}, [], {}
    train, intake = eng.local_train.train_cohort, eng.uplink.intake
    enc0 = device_mod.int8_encode_leaves
    cohort0 = codecs_mod.Int8BlockScaleCodec.encode_cohort

    def spy_train(idx, *args):
        out = train(idx, *args)
        seen["carry"] = {int(c): [(p, v[i].clone()) for p, v in
                                  sorted_items(out.persistent.residual)]
                         for i, c in enumerate(idx)}
        return out

    def spy_intake(out, clients):
        seen["contribs"] = intake(out, clients)
        return seen["contribs"]

    def spy_encode(p, s_leaves, theta, block, *, batched=True):
        entries.append(len(p) + len(s_leaves))
        if "leaves" not in first:
            first["leaves"] = ([clone_at_offset(torch, t) for t in p],
                               [clone_at_offset(torch, t) for t in s_leaves],
                               theta, block)
        return enc0(p, s_leaves, theta, block, batched=batched)

    def spy_cohort(self, out, spec, *, clients=None):
        rows = cohort0(self, out, spec, clients=clients)
        bn = device_mod.bn_stack(out.bn_state, spec, len(rows)).cpu()
        seen["rows"], seen["bn"] = rows, bn.numpy()
        first.setdefault("rows", rows)
        return rows

    eng.local_train.train_cohort = spy_train
    eng.uplink.intake = spy_intake
    device_mod.int8_encode_leaves = spy_encode
    codecs_mod.Int8BlockScaleCodec.encode_cohort = spy_cohort
    for mod in (dc, la, sm):
        mod.reset_counters()
    clock, lost_all, kept_all, recs, checked = 0.0, [], [], [], 0
    try:
        for rnd in range(1, 4):
            if rnd == 3 and lost_all:
                break
            rec = eng.run(1).records[0]
            torch.cuda.synchronize()
            recs.append(rec)
            round_line(label, rnd, rec, rounds_out)
            clients = [c.client for c in seen["contribs"]]
            rows, bn = seen["rows"], seen["bn"]
            for i, row in enumerate(rows):
                if (len(row) != FC_INT8_V2_BYTES or row[0] != 2
                        or row[-BN_TAIL_BYTES:] != bn[i].astype(
                            "<f4").tobytes()):
                    fail(f"{label}: client {clients[i]}'s payload is "
                         f"{len(row)} bytes, header {row[0]}, or its tail "
                         f"is not its BN rows")
            lost = [c for c in clients if chan.dropped(rnd, c)]
            kept = [c for c in clients if c not in lost]
            lost_all += lost
            kept_all += kept
            if list(rec.participants) != kept:
                fail(f"{label}: participants {rec.participants}, survivors "
                     f"{kept}")
            sizes = [c.payload_bytes for c in seen["contribs"]]
            clock += chan.round_time(clients, sizes, RAW_MODEL_BYTES, rnd)
            if (eng.broadcast_ref_bytes() != RAW_MODEL_BYTES
                    or rec.sim_time_s != clock):
                fail(f"{label}: sim_time_s {rec.sim_time_s!r}, recomputed "
                     f"{clock!r}")
            residual = dict(sorted_items(eng.local_train.state.residual))
            for c in seen["contribs"]:
                if c.client not in lost:
                    continue
                decoded = dict(sorted_items(c.delta_params))
                for path, carry in seen["carry"][c.client]:
                    want = carry + torch.tensor(decoded[path],
                                                device=carry.device)
                    got = residual[path][c.client]
                    if not torch.equal(got.view(torch.int32),
                                       want.view(torch.int32)):
                        fail(f"{label}: client {c.client}'s residual at "
                             f"{path} is not carry + decoded")
                    checked += 1
            frozen = frozen_unchanged(torch, f"{label} round {rnd}", params0,
                                      eng.server)
    finally:
        device_mod.int8_encode_leaves = enc0
        codecs_mod.Int8BlockScaleCodec.encode_cohort = cohort0
    rounds = len(recs)
    counts = {**dc.LAUNCHES, "level_assign": la.LAUNCHES["level_assign"]}
    check_sm(sm, label, 4, rounds)
    want = {"delta_compress": 0, "delta_compress_batch": rounds,
            "level_assign": rounds}
    if counts != want or entries != [PATH_E_ENTRIES] * rounds:
        fail(f"{label}: launches {counts}, tables {entries}; expected "
             f"{want}, {[PATH_E_ENTRIES] * rounds}")
    if not lost_all or not kept_all:
        fail(f"{label}: {len(lost_all)} drops and {len(kept_all)} survivors "
             f"in {rounds} rounds")
    # the first cohort's bodies against the plain version on a copy
    p, s_leaves, theta, block = first["leaves"]
    k = p[0].shape[0]
    body = dc.int8_encode_leaves(p, s_leaves, theta, block, batched=True)
    plain = dc.int8_encode_leaves_plain(p, s_leaves, theta, block)
    torch.cuda.synchronize()
    wire = [row[1:1 + FC_INT8_V1_BYTES] for row in first["rows"]]
    if (not torch.equal(body, plain)
            or [bytes(r) for r in body.cpu().numpy()] != wire):
        fail(f"{label}: the first cohort's bodies differ from the plain "
             f"version or from the wire")
    p_sizes = [t[0].numel() for t in p]
    s_sizes = [t[0].numel() for t in s_leaves]
    t = kernel_times(
        torch, lambda: dc.int8_encode_leaves(p, s_leaves, theta, block,
                                             batched=True),
        lambda: dc.int8_encode_leaves_plain(p, s_leaves, theta, block),
        spin=10_000_000)
    t["bound"] = encode_bound_ms(p_sizes, s_sizes, k, block)
    print(f"  {label}: {rounds} rounds, drops {lost_all}, survivors "
          f"{kept_all}; launches {counts}, {entries} entries a table; every "
          f"payload {FC_INT8_V2_BYTES} bytes, header 2, BN tail bitwise the "
          f"device rows; {checked} residual leaves of dropped clients "
          f"bitwise carry + decoded; {frozen} frozen leaves unchanged; "
          f"sim_time_s {[r.sim_time_s for r in recs]}")
    print(f"  {label}: the grouped int8 encode on the first cohort's "
          f"{len(p) + len(s_leaves)} entries ({k} x {sum(p_sizes)} params), "
          f"bitwise to plain and to the wire bodies: {t['ms']:.4f} ms "
          f"(whole wrapper call {t['call_ms']:.4f} ms), plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.6f} ms "
          f"({t['bound'][1]})")
    return {"launches": counts, "entries": entries, "drops": lost_all,
            "survivors": kept_all, "walls_s": [r.wall_s for r in recs],
            "up_bytes": [r.up_bytes for r in recs],
            "sim_time_s": [r.sim_time_s for r in recs],
            "residual_leaves_checked": checked, "kernel": t,
            "shape": [k, sum(p_sizes)]}


def bnwire_round(torch, la, sm, fl, codecs_mod, models, splits,
                 rounds_out) -> dict:
    """One round of ``bnwire_v2_full`` (8 clients, nnc-cabac, schema v2):
    each payload is its v1 encode under a v1 spec with the header before
    and the 6,912-byte BN tail after; the server's BN state is bitwise the
    mean of the survivors' device BN rows."""
    import dataclasses
    from repro_torch.tree import sorted_items
    label = "bnwire_v2_full"
    s = fl.get_scenario(label)
    eng = fl.FederatedEngine(models.vgg11_thinned(), fl.build_protocol(s, 1),
                             splits, engine_cfg=fl.build_engine(s),
                             device="cuda")
    cls = codecs_mod.NncCabacCodec
    enc0 = cls.encode_batch
    train = eng.local_train.train_cohort
    seen = {}

    def encode_batch(self, upds, spec, *, clients=None):
        out = enc0(self, upds, spec, clients=clients)
        v1 = enc0(self, upds, dataclasses.replace(spec, bn=None, version=1))
        seen["pairs"] = list(zip(out, v1))
        return out

    def spy_train(idx, *args):
        out = train(idx, *args)
        seen["idx"] = [int(c) for c in idx]
        seen["bn"] = {p: v.clone() for p, v in sorted_items(out.bn_state)}
        return out

    cls.encode_batch = encode_batch
    eng.local_train.train_cohort = spy_train
    la.reset_counters()
    sm.reset_counters()
    try:
        rec = eng.run(1).records[0]
        torch.cuda.synchronize()
    finally:
        cls.encode_batch = enc0
    round_line(label, 1, rec, rounds_out)
    check_sm(sm, label, splits.num_clients, 1)
    if la.LAUNCHES["level_assign"] != 1:
        fail(f"{label}: level_assign launched "
             f"{la.LAUNCHES['level_assign']} times")
    for v2, v1 in seen["pairs"]:
        if (len(v2) != len(v1) + 1 + BN_TAIL_BYTES or v2[0] != 2
                or v2[1:1 + len(v1)] != v1):
            fail(f"{label}: a payload of {len(v2)} bytes is not its v1 "
                 f"encode ({len(v1)}) + {1 + BN_TAIL_BYTES}")
    idx = torch.tensor([seen["idx"].index(c) for c in rec.participants],
                       device="cuda")
    for path, v in sorted_items(eng.server.bn_state):
        want = torch.mean(seen["bn"][path][idx], dim=0)
        if not torch.equal(v.view(torch.int32), want.view(torch.int32)):
            fail(f"{label}: the server's {path} is not the mean of the "
                 f"survivors' device BN rows")
    print(f"  {label}: {len(seen['pairs'])} payloads each its v1 encode + "
          f"{1 + BN_TAIL_BYTES} bytes ({[len(a) for a, _ in seen['pairs']]}"
          f"); the server's BN state bitwise the mean of the survivors' "
          f"device BN rows")
    return {"wall_s": rec.wall_s, "up_bytes": rec.up_bytes,
            "payload_bytes": [len(a) for a, _ in seen["pairs"]],
            "v1_bytes": [len(b) for _, b in seen["pairs"]]}


# ------------------------------------------------------------ slice 9


def spy_aggregations(eng) -> list:
    """Log each aggregation's contributions (in buffer order) and weights
    as the engine hands them to ``Aggregate``."""
    log = []
    agg = eng.aggregate

    def spy(contribs, weights=None):
        log.append((list(contribs), weights))
        return agg(contribs, weights)

    eng.aggregate = spy
    return log


def async_path(torch, la, sm, fl, models, splits, rounds_out, label: str,
               rounds: int) -> dict:
    """``rounds`` aggregations of the async scenario ``label`` at full
    width.  Every client training launches ``level_assign`` once and the
    dense layers' ``scaled_matmul`` 108 forward and 102 backward times,
    each evaluation 2 forward: the expected counts are the scheduler's
    recorded window sizes times those.  The buffer's clients are the
    round's participants, in (arrival, client) order; arrival times and
    ``sim_time_s`` never go backwards; a contribution's staleness is at
    most the aggregations before it (0 in the first); the weights are the
    normalised FedBuff staleness weights; the server stays finite."""
    s = fl.get_scenario(label)
    eng = fl.FederatedEngine(models.vgg11_thinned(),
                             fl.build_protocol(s, rounds), splits,
                             engine_cfg=fl.build_engine(s), device="cuda")
    log = spy_aggregations(eng)
    la.reset_counters()
    sm.reset_counters()
    recs = []
    for rnd in range(1, rounds + 1):
        rec = eng.run(1).records[0]
        torch.cuda.synchronize()
        round_line(label, rnd, rec, rounds_out)
        recs.append(rec)
    windows = list(eng.scheduler.batch_sizes)
    trained = sum(windows)
    arrivals, staleness = [], []
    for rnd, ((contribs, weights), rec) in enumerate(zip(log, recs)):
        clients = tuple(c.client for c in contribs)
        if rec.participants != clients:
            fail(f"{label}: participants {rec.participants}, buffer "
                 f"{clients}")
        keys = [(c.arrival_time, c.client) for c in contribs]
        if keys != sorted(keys) or len(contribs) < s.buffer_size:
            fail(f"{label}: buffer {keys} out of order or short")
        st = [c.staleness for c in contribs]
        if min(st) < 0 or max(st) > rnd:
            fail(f"{label}: staleness {st} in aggregation {rnd + 1}")
        raw = [1.0 / (1.0 + t) ** s.staleness_exponent for t in st]
        if not all(math.isclose(float(w), r / sum(raw), rel_tol=1e-12)
                   for w, r in zip(weights, raw)):
            fail(f"{label}: weights {weights} for staleness {st}")
        arrivals += [c.arrival_time for c in contribs]
        staleness.append(st)
    sim = [r.sim_time_s for r in recs]
    if arrivals != sorted(arrivals) or sim != sorted(sim) or sim[-1] <= 0:
        fail(f"{label}: arrivals {arrivals}, sim_time_s {sim}")
    if sum(len(c) for c, _ in log) != trained or eng.version != rounds:
        fail(f"{label}: {trained} trainings in windows {windows}, "
             f"{sum(len(c) for c, _ in log)} contributions, version "
             f"{eng.version}")
    check_server(torch, label, eng.server)
    count = la.LAUNCHES["level_assign"]
    if count != len(windows):
        fail(f"{label}: level_assign launched {count} times for "
             f"{len(windows)} windows")
    got, calls = dict(sm.LAUNCHES), dict(sm.CALLS)
    # each window trains in one call of the batched round
    want, want_calls = sm_expected(trained, 1, calls=len(windows))
    # one evaluation an aggregation, 2 forward launches each
    want["forward"] += 2 * (rounds - 1)
    want_calls["forward"] += 2 * (rounds - 1)
    SM_RUNS[label] = got
    if got != want or calls != want_calls:
        fail(f"{label}: scaled_matmul launched {got} computing {calls}, "
             f"expected {want} computing {want_calls} for {trained} "
             f"trainings and {rounds} evaluations")
    print(f"  {label}: windows {windows} ({trained} trainings), level_assign "
          f"{count} launches, scaled_matmul {got}; staleness {staleness}; "
          f"sim_time_s {sim}")
    return {"level_assign": count, "scaled_matmul": got, "windows": windows,
            "staleness": staleness, "sim_time_s": sim,
            "walls_s": [r.wall_s for r in recs],
            "up_bytes": [r.up_bytes for r in recs],
            "participants": [list(r.participants) for r in recs]}


def full_width_dirichlet_splits(torch, data, alpha: float):
    """The 6,400 images of ``full_width_splits`` partitioned by label with
    dirichlet(``alpha``)."""
    x, y = data.synthetic.make_image_dataset(
        torch.Generator().manual_seed(0), data.synthetic.CIFAR_LIKE, 6400)
    return data.federated.split_federated(torch.Generator().manual_seed(1),
                                          x, y, 8, dirichlet_alpha=alpha)


def path_g(torch, la, sm, fl, data, models, rounds_out) -> dict:
    """Path G: 2 rounds of ``noniid_dir1_k4_fedyogi`` (dirichlet(1.0)
    label partition of the 6,400 images, cohorts of 4, FedYogi): 1
    ``level_assign`` a round and 110/102 ``scaled_matmul`` launches a
    round; the server and FedYogi's moments finite, its step 2."""
    from repro_torch.tree import items
    rounds, label = 2, "noniid_dir1_k4_fedyogi"
    s = fl.get_scenario(label)
    splits = full_width_dirichlet_splits(torch, data, s.dirichlet_alpha)
    share = max(float(torch.bincount(c, minlength=10).max()) / len(c)
                for c in splits.client_y)
    eng = fl.FederatedEngine(models.vgg11_thinned(),
                             fl.build_protocol(s, rounds), splits,
                             engine_cfg=fl.build_engine(s), device="cuda")
    la.reset_counters()
    sm.reset_counters()
    recs = []
    for rnd in range(1, rounds + 1):
        rec = eng.run(1).records[0]
        torch.cuda.synchronize()
        round_line(label, rnd, rec, rounds_out)
        recs.append(rec)
        if len(rec.participants) != 4:
            fail(f"{label}: {len(rec.participants)} participants")
    check_server(torch, label, eng.server)
    state = eng.server_step.state
    if int(state.step) != rounds or not all(
            bool(torch.isfinite(v).all()) for _, v in
            items(state.mu) + items(state.nu)):
        fail(f"{label}: FedYogi's state is not finite after {rounds} steps")
    count = la.LAUNCHES["level_assign"]
    got = check_sm(sm, label, 4, rounds)
    if count != rounds:
        fail(f"{label}: level_assign launched {count} times, expected "
             f"{rounds}")
    print(f"  {label}: {splits.n_train} training images a client, largest "
          f"label share {share:.3f}; level_assign {count} launches; FedYogi "
          f"step {int(state.step)}, moments finite")
    return {"level_assign": count, "scaled_matmul": got,
            "largest_label_share": share,
            "walls_s": [r.wall_s for r in recs],
            "up_bytes": [r.up_bytes for r in recs],
            "participants": [list(r.participants) for r in recs]}


def server_gain(fl, name: str) -> float:
    """The most the scenario's server optimizer moves its update per unit
    of mean delta: lr for FedAvg, lr / (1 - momentum) for FedAvgM, lr /
    eps for the adaptive ones."""
    opt = fl.build_engine(fl.get_scenario(name)).server_opt
    if opt.name == "fedavg":
        return opt.lr
    if opt.name == "fedavgm":
        return opt.lr / (1.0 - opt.momentum)
    return opt.lr / opt.eps


def repeat_small_runs(torch, fl, rounds_mod, name: str, model=None,
                      splits=None):
    """Two runs of scenario ``name``, through its own executor (the
    batched one where it names none), on the tiny VGG with 1,280 samples
    (or on ``model`` and ``splits``) on the card, with the algorithms the
    port selects (no context of this script's around them): every payload
    put on the wire, up and down, and the server's params, scales and BN
    state must be equal bit for bit.  Returns (report, failures)."""
    from repro_torch.comms import codec as codec_mod
    from repro_torch.comms import codecs as codecs_mod
    from repro_torch.tree import sorted_items

    runs = []
    for _ in range(2):
        payloads = []
        dec0 = codec_mod.Codec.decode
        nnc0 = codecs_mod.NncCabacCodec.decode_batch
        sec0 = codecs_mod.Int8BlockScaleCodec.device_sections

        def decode(self, payload, spec):
            payloads.append(bytes(payload))
            return dec0(self, payload, spec)

        def decode_batch(self, batch, spec, *, clients=None):
            payloads.extend(bytes(p) for p in batch)
            return nnc0(self, batch, spec, clients=clients)

        def device_sections(self, payload, spec, device):
            payloads.append(bytes(payload))
            return sec0(self, payload, spec, device)

        codec_mod.Codec.decode = decode
        codecs_mod.NncCabacCodec.decode_batch = decode_batch
        codecs_mod.Int8BlockScaleCodec.device_sections = device_sections
        try:
            m, sp = model, splits
            if m is None:
                m, sp = fl.default_setting(
                    fl.get_scenario(name).num_clients,
                    n_samples=SMALL_SAMPLES)
            res = fl.run_scenario(name, rounds=SMALL_ROUNDS, model=m,
                                  splits=sp, device="cuda")
        finally:
            codec_mod.Codec.decode = dec0
            codecs_mod.NncCabacCodec.decode_batch = nnc0
            codecs_mod.Int8BlockScaleCodec.device_sections = sec0
        state = {f"{part}/{p}": v.cpu() for part in ("params", "scales",
                                                     "bn_state")
                 for p, v in sorted_items(getattr(res.server, part))}
        runs.append((payloads, [(r.up_bytes, r.down_bytes)
                                for r in res.records], state))
    (pay_a, bytes_a, state_a), (pay_b, bytes_b, state_b) = runs
    failures = []
    if not pay_a or pay_a != pay_b:
        diff = sum(a != b for a, b in zip(pay_a, pay_b))
        failures.append(f"{name}: payloads differ between two runs "
                        f"({len(pay_a)} and {len(pay_b)}, {diff} unequal)")
    if bytes_a != bytes_b:
        failures.append(f"{name}: bytes {bytes_a} then {bytes_b}")
    off = [p for p, v in state_a.items()
           if not torch.equal(v.view(torch.int32),
                              state_b[p].view(torch.int32))]
    if off:
        failures.append(f"{name}: server leaves differ between two runs: "
                        f"{off}")
    report = {"executor": fl.get_scenario(name).executor,
              "payloads": len(pay_a), "payload_bytes": sum(map(len, pay_a)),
              "bytes": bytes_a, "server_leaves": len(state_a),
              "cudnn_deterministic": torch.backends.cudnn.deterministic,
              "cudnn_benchmark": torch.backends.cudnn.benchmark}
    return report, failures


# ------------------------------------------------------------ slice 10

RESNET_LEAVES, RESNET_WEIGHTS = 55, 20   # resnet18_small(20, 3)
VGG16_LEAVES, VGG16_WEIGHTS = 34, 12     # vgg16_tiny(2, 1)
RESNET_INT8_BYTES = 1_337_044    # resnet18_small's v1 int8 payload
RESNET_DOWN_BYTES = 1_330_296    # its v1 int8 broadcast: params only
SLICE10_N = (20, 2)              # the ResNet's fc, vgg16_tiny's fc1


def leaf_shapes(torch, model) -> list[tuple]:
    params, _ = model.init(torch.Generator().manual_seed(0))
    return [tuple(v.shape) for d in params.values() for v in d.values()]


def int8_leaves(torch, gen, p_shapes, s_shapes, k: int):
    """(k, ...) params leaves on the card, 90%-sparse deltas, and scales
    leaves: (k, M) of a weight of M rows, (k,) of a placeholder."""
    p = [(1e-3 * torch.randn((k,) + sh, generator=gen)
          * (torch.rand((k,) + sh, generator=gen) < 0.1)).cuda()
         for sh in p_shapes]
    s = [(1e-5 * torch.randn((k,) + sh[:1] if len(sh) >= 2 else (k,),
                             generator=gen)).cuda() for sh in s_shapes]
    return p, s


def slice10_kernel_phase(torch, dc, la, da, rs, sm, models):
    """Every grouped kernel against its plain version on the leaves of
    ``resnet18_small(20, 3)`` and ``vgg16_tiny(2, 1)``: the int8 encode of a
    ResNet message (110 entries), a VGG16 message (68) and a ResNet cohort
    of 4, each in two launches, and of 70 and 64 params entries (the split
    inside the params and at the scales) bitwise; ``level_assign_leaves``
    on the 55 and 34 leaves of a client, bitwise; ``delta_apply_leaves`` on
    a ResNet broadcast's 55 leaves, bitwise; ``row_stats_leaves`` on the 20
    and 12 weight views (rows of 9 in VGG16's first convolution) within
    rtol 1e-6 and bitwise to one-view launches, one launch each; and
    ``scaled_matmul`` at N = 20 and 2 (K = 128, M = 32, 120, 960), every
    direction and backward subset within the float32 error bound, twice to
    the same bits.  Each kernel is then timed on the ResNet's inputs.
    Returns (checks, timings)."""
    gen = torch.Generator().manual_seed(10)
    resnet = leaf_shapes(torch, models.resnet18_small(20, 3))
    vgg16 = leaf_shapes(torch, models.vgg16_tiny(2, 1))
    if len(resnet) != RESNET_LEAVES or len(vgg16) != VGG16_LEAVES:
        fail(f"{len(resnet)} resnet18_small and {len(vgg16)} vgg16_tiny "
             f"leaves")
    checks, timings = 0, {}
    cases = (("a resnet18_small message", resnet, resnet, 1, "message"),
             ("a vgg16_tiny message", vgg16, vgg16, 1, None),
             ("a resnet18_small cohort of 4", resnet, resnet, 4, "cohort"),
             ("70 params entries (the split inside them)",
              (resnet * 2)[:70], resnet[:6], 1, None),
             ("64 params entries (the split at the scales)",
              (resnet * 2)[:64], resnet[:20], 1, None))
    for what, p_shapes, s_shapes, k, timed in cases:
        p, s = int8_leaves(torch, gen, p_shapes, s_shapes, k)
        dc.reset_counters()
        checks += encode_compare(torch, dc, p, s, k > 1, what)
        launches, entries = sum(dc.LAUNCHES.values()), len(p) + len(s)
        if launches != 2:
            fail(f"int8_encode_leaves made {launches} launches for {what} "
                 f"({entries} entries)")
        if timed:
            sizes = [math.prod(sh) for sh in p_shapes]
            s_sizes = [t.shape[1] if t.ndim > 1 else 1 for t in s]
            timings[f"int8_encode_{timed}"] = dict(
                **kernel_times(torch, lambda p=p, s=s, k=k:
                               dc.int8_encode_leaves(p, s, 0.0, 128,
                                                     batched=k > 1),
                               lambda p=p, s=s: dc.int8_encode_leaves_plain(
                                   p, s, 0.0, 128)),
                bound=encode_bound_ms(sizes, s_sizes, k, 128),
                entries=entries, rows=k, launches=launches)
    print(f"kernel phase: {checks} int8_encode_leaves bodies on the "
          f"resnet18_small and vgg16_tiny leaves, bitwise to plain, two "
          f"launches each")
    for name, shapes in (("resnet18_small", resnet), ("vgg16_tiny", vgg16)):
        d, r, th, steps = la_leaf_inputs(torch, gen, shapes)
        la_group_compare(torch, la, d, r, th, steps)
        checks += 1
        if name == "resnet18_small":
            n = sum(x.numel() for x in d)
            timings["level_assign"] = dict(
                **kernel_times(torch,
                               lambda: la.level_assign_leaves(d, r, th, steps),
                               lambda: la.level_assign_leaves_plain(
                                   d, r, th, steps)),
                bound=la_bound_ms(n), elements=n, leaves=len(d))
    sizes = [math.prod(sh) for sh in resnet]
    ws = [(0.1 * torch.randn(sh, generator=gen)).cuda() for sh in resnet]
    qs = [torch.randint(-127, 128, (n,), generator=gen,
                        dtype=torch.int8).cuda() for n in sizes]
    ss = [(1e-3 * torch.rand(-(-n // 128), generator=gen) + 1e-6).cuda()
          for n in sizes]
    for coef in (1.0, -1.0):
        da.reset_counters()
        got = da.delta_apply_leaves(ws, qs, ss, coef)
        if da.LAUNCHES["delta_apply"] != 1:
            fail(f"delta_apply_leaves made {da.LAUNCHES['delta_apply']} "
                 f"launches for {len(ws)} leaves")
        want = da.delta_apply_leaves_plain(ws, qs, ss, coef, 128)
        torch.cuda.synchronize()
        if not all(bits_equal(torch, g, w) for g, w in zip(got, want)):
            fail(f"delta_apply_leaves disagrees with its plain version on "
                 f"the resnet18_small leaves (coef {coef})")
        checks += 1
    timings["delta_apply"] = dict(
        **kernel_times(torch, lambda: da.delta_apply_leaves(ws, qs, ss, -1.0),
                       lambda: da.delta_apply_leaves_plain(ws, qs, ss, -1.0,
                                                           128)),
        bound=da_bound_ms(sum(sizes)), elements=sum(sizes), leaves=len(ws))
    worst = 0.0
    for name, shapes, n_views in (("resnet18_small", resnet, RESNET_WEIGHTS),
                                  ("vgg16_tiny", vgg16, VGG16_WEIGHTS)):
        views = [(1e-3 * torch.randn((sh[0], math.prod(sh[1:])),
                                     generator=gen)).cuda()
                 for sh in shapes if len(sh) >= 2]
        if len(views) != n_views:
            fail(f"{name} has {len(views)} weight views, not {n_views}")
        rs.reset_counters()
        got = rs.row_stats_leaves(views)
        if rs.LAUNCHES["row_stats"] != 1:
            fail(f"row_stats_leaves made {rs.LAUNCHES['row_stats']} launches "
                 f"for the {len(views)} {name} views")
        for v, g in zip(views, got):
            if not bits_equal(torch, g, rs.row_stats(v)):
                fail(f"row_stats_leaves differs from a one-view launch at "
                     f"{tuple(v.shape)}")
            worst = max(worst, rs_compare(torch, rs, v))
            checks += 1
        if name == "resnet18_small":
            timings["row_stats"] = dict(
                **kernel_times(torch, lambda: rs.row_stats_leaves(views),
                               lambda: rs.row_stats_leaves_plain(views)),
                bound=(sum(rs_bound_ms(*v.shape)[0] for v in views),
                       rs_bound_ms(*views[0].shape)[1]),
                views=len(views))
        else:
            rows9 = [tuple(v.shape) for v in views if v.shape[1] == 9]
            if rows9 != [(32, 9)]:
                fail(f"vgg16_tiny's views of rows of 9: {rows9}")
    print(f"kernel phase: level_assign_leaves on {RESNET_LEAVES} and "
          f"{VGG16_LEAVES} leaves and delta_apply_leaves on "
          f"{RESNET_LEAVES} leaves bitwise in one launch; row_stats_leaves "
          f"on {RESNET_WEIGHTS} and {VGG16_WEIGHTS} views (the (32, 9) view "
          f"too) in one launch, max relative difference {worst:.3g}")
    worst = dict.fromkeys(sm.DIRECTIONS + ("backward",), 0.0)
    for m in (32, 120, 960):
        for n in SLICE10_N:
            count, (x, w, s, dy) = sm_check_shape(torch, sm, gen, m, n, 128,
                                                  worst)
            checks += count
            if (m, n) == (32, 20):
                timings["scaled_matmul"] = dict(
                    **kernel_times(torch, lambda: sm.forward(x, w, s),
                                   lambda: sm.scaled_matmul_plain(x, w, s)),
                    library_ms=time_ms(torch, lambda: SM_LIBRARY["forward"](
                        torch, x, w, s)),
                    bound=sm_bound_ms(("forward",), m, n, 128),
                    mnk=[m, n, 128])
                flags = (True, True, False)
                timings["scaled_matmul_backward"] = dict(
                    **kernel_times(
                        torch, lambda: sm.backward(dy, x, w, s, *flags),
                        lambda: [sm.dx_plain(dy, w, s), sm.dw_plain(dy, x, s)]),
                    library_ms=time_ms(torch, lambda: [
                        SM_LIBRARY[d](torch, dy, x, w, s) for d in ("dx",
                                                                    "dw")]),
                    bound=sm_bound_ms(("dx", "dw"), m, n, 128),
                    mnk=[m, n, 128], grads=["dx", "dw"])
    print(f"kernel phase: scaled_matmul at N = {SLICE10_N} (M = 32, 120, "
          f"960; K = 128) within the float32 error bound, twice to the same "
          f"bits; largest share of it used: "
          f"{ {d: round(v, 4) for d, v in worst.items()} }")
    for name, t in timings.items():
        print(f"  {name} on resnet18_small's inputs: kernel {t['ms']:.4f} ms "
              f"(whole wrapper call {t['call_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms"
              + (f", library {t['library_ms']:.4f} ms"
                 if "library_ms" in t else "")
              + f", bound {t['bound'][0]:.6f} ms ({t['bound'][1]})")
    return checks, timings


def slice10_paths(torch, mods, fl, fsfl, rounds_mod, codecs_mod,
                  sparsify_mod, protocol_mod, data, models, rounds_out):
    """Paths I to L at full width, 6,400 images over 8 clients (560
    training and 120 validation images a client, 960 to test), batch 32:

    * I: ``resnet18_small(20, 3)`` on VOC-like data, 2 rounds of
      ``run_federated`` (fsfl, FedAvg, nnc-cabac): 1 ``level_assign`` and
      55/51 ``scaled_matmul`` launches a round (one dense layer);
    * J: ``vgg16_tiny(2, 1)`` on X-ray-like data, 2 rounds likewise: 1
      ``level_assign`` and 110/102 ``scaled_matmul`` a round;
    * K: the ResNet with int8-blockscale on both legs, cohorts of 4, the
      device cohort encode, 1 round: the cohort's 110 entries in 2
      ``int8_encode_leaves`` launches, the broadcast's 55 in 1, 2
      ``delta_apply``, 2 ``level_assign``, 55/51 ``scaled_matmul``;
      payloads of 1,337,044 bytes up and 1,330,296 down, and the server's
      params bitwise the host decode of the broadcast plus the params
      before;
    * L: the ResNet with ``fsfl_dyn``, bidirectional, 1 round: 9
      ``row_stats`` launches (one a client and one on the downlink), each
      over the 20 weight views, and 55/51 ``scaled_matmul``."""
    la, rs, da, dc, sm = mods
    voc = full_width_splits(torch, data, data.synthetic.VOC_LIKE)
    xray = full_width_splits(torch, data, data.synthetic.XRAY_LIKE)
    out = {}
    cfg = fl.build_protocol(fl.get_scenario("sync_full_fedavg_fsfl"), 2)

    out["I"] = run_path(
        torch, mods, rounds_mod, "path I resnet18_small voc_like",
        lambda: fsfl.run_federated(models.resnet18_small(20, 3), cfg, voc, 2,
                                   device="cuda"),
        {"level_assign": 1, **sm_per_round(8, 1)}, 8, 1, rounds_out)
    out["J"] = run_path(
        torch, mods, rounds_mod, "path J vgg16_tiny xray_like",
        lambda: fsfl.run_federated(models.vgg16_tiny(2, 1), cfg, xray, 2,
                                   device="cuda"),
        {"level_assign": 1, **sm_per_round(8, 2)}, 8, 2, rounds_out)

    launch0 = dc._launch
    tables = capture_calls(dc, "_launch", 100,
                           lambda a, k: (len(a[0]), a[0][0].shape[0]))
    payloads, applied, restore = spy_broadcasts(codecs_mod, rounds_mod)
    try:
        out["K"] = run_path(
            torch, mods, rounds_mod, "path K resnet18_small int8 both legs",
            lambda: fl.run_simulation(
                models.resnet18_small(20, 3),
                fl.build_protocol(fl.get_scenario("codec_int8_k4"), 1), voc,
                1, engine=fl.EngineConfig(
                    sampling=fl.SamplingConfig(cohort_size=4),
                    codec="int8-blockscale", device_encode=True,
                    bidirectional=True), device="cuda"),
            {"level_assign": 2, "delta_apply": 2, "delta_compress": 1,
             "delta_compress_batch": 2, **sm_per_round(4, 1)}, 4, 1, rounds_out,
            up=4 * RESNET_INT8_BYTES, down=4 * RESNET_DOWN_BYTES)
    finally:
        restore()
        dc._launch = launch0
    if tables != [(2 * RESNET_LEAVES, 4), (RESNET_LEAVES, 1)]:
        fail(f"path K: int8 encodes (entries, rows) {tables}, expected the "
             f"cohort's {2 * RESNET_LEAVES} entries over 4 rows and the "
             f"broadcast's {RESNET_LEAVES} over 1")
    out["K"]["encodes"] = tables
    out["K"]["leaves_checked"] = check_broadcast_applies(
        codecs_mod, "path K", payloads, applied, 1)

    views = capture_calls(sparsify_mod, "row_stats_leaves", 100,
                          lambda a, k: len(a[0]))
    try:
        out["L"] = run_path(
            torch, mods, rounds_mod, "path L resnet18_small fsfl_dyn bidi",
            lambda: fsfl.run_federated(
                models.resnet18_small(20, 3),
                fsfl_dyn_config(protocol_mod, 1), voc, 1,
                bidirectional=True, device="cuda"),
            {"row_stats": 9, **sm_per_round(8, 1)}, 8, 1, rounds_out)
    finally:
        sparsify_mod.row_stats_leaves = rs.row_stats_leaves
    if views != [RESNET_WEIGHTS] * 9:
        fail(f"path L: row_stats_leaves took {views} views a call, expected "
             f"{RESNET_WEIGHTS} in each of 9")
    return out


def small_resnet_setting(torch, data, models):
    """The reduced ResNet ``make_resnet("resnet_t", [8, 16, 32, 32], 1,
    20)`` (a projection shortcut in stages 1 and 2, a strided one in stage
    3) and 1,280 VOC-like images over 8 clients (3 local steps a client)."""
    x, y = data.synthetic.make_image_dataset(
        torch.Generator().manual_seed(0), data.synthetic.VOC_LIKE,
        SMALL_SAMPLES)
    splits = data.federated.split_federated(torch.Generator().manual_seed(1),
                                            x, y, 8)
    return models.make_resnet("resnet_t", [8, 16, 32, 32], 1, 20), splits


def small_model_check(torch, model, splits, label: str = "resnet_t",
                      floor_share: float = 0.0) -> dict:
    """A reduced model (the ResNet, ``label``) on the card against the CPU
    on the first 32
    training images of client 0, from one init with scales off 1: logits
    and new BN state in training and evaluation mode within rtol and atol
    1e-5 of the CPU's (float32 sums in another order); the gradients of a
    weight step (params, training mode) and of a scale step (params and
    scales, evaluation mode, ``fc``'s scale inside its product on
    ``scaled_matmul``) each within ``GRAD_EVENT`` of its norm of the CPU's
    float64 evaluation: float32 sums stay far inside it, a wrong padding,
    shortcut or scale far outside, as would a ReLU input within float
    noise of zero routing the backward another way (none on this batch).
    With ``floor_share`` a leaf may also part by that share of the tree's
    largest leaf norm: the MobileNet's BN parameters that a ReLU6 bound or
    a following training-mode BN nearly cancel have gradients 1e-5 to
    1e-16 of the others', which float32 sums part by percents.  Returns
    the largest shares used."""
    import torch.nn.functional as F
    from repro_torch.core import scaling
    from repro_torch.tree import sorted_items, tree_map
    params, state = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    scales = tree_map(lambda s: s + 0.05 * torch.randn(s.shape, generator=gen)
                      if s.ndim else s, scaling.init_scales(params))
    x, y = splits.client_x[0][:32], splits.client_y[0][:32]

    def on(tree, device, dtype=torch.float32):
        return tree_map(lambda t: t.to(device, dtype, copy=True), tree)

    def run(device, dtype, train, grads):
        p, s, st = (on(t, device, dtype) for t in (params, scales, state))
        if grads:
            p, s = (tree_map(lambda t: t.requires_grad_(True), t)
                    for t in (p, s))
        if dtype == torch.float32:    # fc's scale inside its product
            logits, new = model.apply(scaling.apply_scales_tree(p, s), st,
                                      x.to(device, dtype), train=train,
                                      scales=s)
        else:                         # every leaf scaled first
            logits, new = model.apply(tree_map(scaling.apply_scale, p, s), st,
                                      x.to(device, dtype), train=train)
        if not grads:
            return {"logits": logits, **dict(sorted_items(new))}
        F.cross_entropy(logits, y.to(device)).backward()
        out = {f"params/{k}": v.grad for k, v in sorted_items(p)}
        if not train:
            out.update({f"scales/{k}": v.grad for k, v in sorted_items(s)
                        if v.ndim})
        return out

    report = {}
    for train in (True, False):
        card, cpu = run("cuda", torch.float32, train, False), run(
            "cpu", torch.float32, train, False)
        worst = 0.0
        for k, v in cpu.items():
            got = card[k].detach().cpu()
            err = (got - v).abs() - 1e-5 * v.abs()
            worst = max(worst, float(((got - v).abs() / (
                1e-5 + 1e-5 * v.abs())).max()))
            if float(err.max()) > 1e-5:
                fail(f"{label} forward (train={train}): {k} off the CPU's "
                     f"by {float((got - v).abs().max()):.3g}")
        report[f"forward train={train}"] = worst
        card, exact = run("cuda", torch.float32, train, True), run(
            "cpu", torch.float64, train, True)
        worst = largest = 0.0
        floor = floor_share * max(float(v.norm()) for v in exact.values())
        for k, v in exact.items():
            diff = card[k].cpu().double() - v
            # the share of the leaf's norm, or of the floor over GRAD_EVENT
            # where that is larger
            share = float(diff.norm() / max(float(v.norm()),
                                            floor / GRAD_EVENT, 1e-300))
            largest = max(largest, float(diff.abs().max()
                                         / v.abs().max().clamp_min(1e-300)))
            worst = max(worst, share)
            if share > GRAD_EVENT:
                fail(f"{label} {'weight' if train else 'scale'} step: the "
                     f"card's gradient of {k} is {share:.3g} of its norm "
                     f"off the CPU's float64 one")
        report[f"gradients train={train} (of the norm)"] = worst
        report[f"gradients train={train} (of the largest)"] = largest
    print(f"  {label} on the card against the CPU: forward within rtol and "
          f"atol 1e-5, gradients within {GRAD_EVENT} of each leaf's norm "
          f"of the float64 ones (or {floor_share} of the largest leaf "
          f"norm); largest shares "
          f"{ {k: float(f'{v:.3g}') for k, v in report.items()} }")
    return report


def small_engine_check(torch, fl, rounds_mod, model, splits,
                       label: str = "resnet_t",
                       bn_mean_bound: bool = False) -> dict:
    """Two rounds of ``sync_full_fedavg_fsfl`` on a reduced model on
    the CPU, then on the card with each round teacher-forced from the
    CPU's: its client outputs (levels, reconstructions, BN state,
    persistent state) and the server state it starts from.  The card's
    wire, aggregation, server step and evaluation on the ResNet's trees:
    ``up_bytes`` equal, the server state after each round within 2 ulps of
    the CPU's (the mean over the clients sums in another order), an ulp
    taken of the larger of the value and the server's value before the
    round (a weight and its update can cancel), test accuracy within one
    test image.  With ``bn_mean_bound`` the server's BN state, a mean of
    the clients' rows and nothing more, may also part by twice the float32
    error bound of such a mean, ``(k - 1) u sum|x_i| / k + u |mean|``: the
    MobileNet's head BN means cancel across clients, and an ulp of the
    mean is no bound there."""
    from repro_torch.tree import sorted_items, tree_map
    s = fl.get_scenario("sync_full_fedavg_fsfl")
    outs = []
    train0 = rounds_mod.LocalTrain.train_cohort

    def cpu_train(self, idx, batch_idx, server):
        out = train0(self, idx, batch_idx, server)
        outs.append((list(idx), out))
        return out

    def card_train(self, idx, batch_idx, server):
        want_idx, out = outs[len(recs["cuda"])]
        if list(idx) != want_idx:
            fail(f"{label} engine check: cohort {list(idx)} on the card, "
                 f"{want_idx} on the CPU")
        out = tree_map(lambda t: t.cuda(), out)
        self.state = out.persistent
        return out

    recs, servers = {"cpu": [], "cuda": []}, {"cpu": [], "cuda": []}
    for device, train in (("cpu", cpu_train), ("cuda", card_train)):
        eng = fl.FederatedEngine(model, fl.build_protocol(s, SMALL_ROUNDS),
                                 splits, engine_cfg=fl.build_engine(s),
                                 device=device)
        rounds_mod.LocalTrain.train_cohort = train
        if device == "cpu":
            servers["initial"] = tree_map(lambda t: t.clone(), eng.server)
        try:
            for r in range(SMALL_ROUNDS):
                if device == "cuda" and r:
                    eng.server = tree_map(lambda t: t.cuda(),
                                          servers["cpu"][r - 1])
                recs[device].append(eng.run(1).records[0])
                servers[device].append(tree_map(lambda t: t.cpu(),
                                                eng.server))
        finally:
            rounds_mod.LocalTrain.train_cohort = train0
    worst, n_test = 0.0, len(splits.test_y)
    for r, (a, b) in enumerate(zip(recs["cpu"], recs["cuda"]), 1):
        if b.up_bytes != a.up_bytes or abs(b.test_acc - a.test_acc) > (
                1 / n_test + 1e-6):
            fail(f"{label} engine check round {r}: up_bytes {b.up_bytes} "
                 f"and test_acc {b.test_acc} on the card, {a.up_bytes} and "
                 f"{a.test_acc} on the CPU")
        before = servers["cpu"][r - 2] if r > 1 else servers["initial"]
        rows = dict(sorted_items(outs[r - 1][1].bn_state))
        for part in ("params", "scales", "bn_state"):
            card = dict(sorted_items(getattr(servers["cuda"][r - 1], part)))
            prev = dict(sorted_items(getattr(before, part)))
            for path, v in sorted_items(getattr(servers["cpu"][r - 1],
                                                part)):
                ulp = torch.pow(2.0, torch.floor(torch.log2(torch.maximum(
                    v.abs(), prev[path].abs()).clamp_min(1e-38))) - 23)
                if bn_mean_bound and part == "bn_state":
                    k, u = rows[path].shape[0], 2.0 ** -24
                    ulp = torch.maximum(ulp, (
                        (k - 1) * u * rows[path].abs().sum(0) / k
                        + u * v.abs()))
                ulps = float(((card[path] - v).abs() / ulp).max())
                worst = max(worst, ulps)
                if ulps > 2.0:
                    fail(f"{label} engine check round {r}: server "
                         f"{part}/{path} {ulps:.3g} ulps off the CPU's")
    out = {"up_bytes": [x.up_bytes for x in recs["cuda"]],
           "test_acc": [x.test_acc for x in recs["cuda"]],
           "server_ulps": worst}
    print(f"  {label} engine on the card, each round from the CPU's server "
          f"and client outputs: up_bytes {out['up_bytes']} equal, test_acc "
          f"{out['test_acc']}, the server within {worst:.3g} ulps of the "
          f"CPU's")
    return out


def small_own_training(torch, fl, rounds_mod, model, splits,
                       label: str = "resnet_t") -> dict:
    """A reduced model's own client training on the card against the
    CPU: 2 rounds of ``sync_full_fedavg_fsfl`` on the CPU, then on the card
    (cuDNN deterministic) with round 2 started from the CPU's server and
    clients' state after round 1, held together round by round by
    ``forced_round_check``; fails on any failure it reports.  The clients
    counted apart a round are printed against ``MAX_COUNTED``; float32
    training on these networks does not keep it between any two summation
    orders, so the count is reported, and the cap is held by the CPU's
    float64 comparison with the reference
    (tests/test_torch_cnn_families.py, tests/test_torch_mobilenet.py)."""
    name = "sync_full_fedavg_fsfl"
    cfg = fl.build_protocol(fl.get_scenario(name), SMALL_ROUNDS)
    cpu_log = record_small_run(torch, fl, rounds_mod, name, "cpu", model,
                               splits)[1]
    with deterministic_cudnn(torch):
        card_log = record_small_run(torch, fl, rounds_mod, name, "cuda",
                                    model, splits, forced=cpu_log)[1]
    rounds, failures = forced_round_check(torch, cfg, cpu_log, card_log)
    counted = [len(r["counted"]) for r in rounds]
    print(f"  {label} own training on the card against the CPU, each round "
          f"from the CPU's state: clients counted apart {counted} a round "
          f"(compare_small_runs allows {MAX_COUNTED}: "
          f"{'kept' if max(counted) <= MAX_COUNTED else 'NOT kept'}; "
          f"every other bound held)")
    print_forced(f"{label} card against CPU", rounds)
    if failures:
        fail(f"{label} own training: " + "; ".join(failures))
    return {"counted": counted,
            "causes": [{c["client"]: c["causes"] for c in r["counted"]}
                       for r in rounds],
            "flips": [r["flips"] for r in rounds],
            "params_off": [r["params_off"] for r in rounds]}


# ------------------------------------------------------------ slice 11

MOBILENET_LEAVES, MOBILENET_WEIGHTS = 62, 21   # mobilenetv2_small(20, 3)
MOBILENET_DEPTHWISE = 6          # its (mid, 1, 3, 3) views: rows of 9


def mobilenet_leaves(torch, models, proj_only: bool = False):
    """(params leaf shapes, scales entries) of ``mobilenetv2_small(20,
    3)`` in the form ``int8_leaves`` takes: a leaf's shape where it
    carries a scale vector, ``()`` where a scalar placeholder, under the
    default predicate or the paper's projection-only one."""
    from repro_torch.core import scaling
    params, _ = models.mobilenetv2_small(20, 3).init(
        torch.Generator().manual_seed(0))
    pred = (models.mobilenet_proj_only_predicate if proj_only
            else scaling.default_predicate)
    scales = scaling.init_scales(params, pred)
    shapes = [tuple(v.shape) for d in params.values() for v in d.values()]
    return shapes, [sh if s.ndim else () for sh, s in zip(
        shapes, (s for d in scales.values() for s in d.values()))]


def mobilenet_int8_bytes(torch, comms, models, proj_only: bool
                         ) -> tuple[int, int]:
    """The v1 int8-blockscale sizes of ``mobilenetv2_small``'s messages,
    from the codec on the CPU: a client's payload (its scales under the
    predicate) and the params-only broadcast."""
    from repro_torch.core import quant, scaling
    from repro_torch.tree import tree_map
    params, _ = models.mobilenetv2_small(20, 3).init(
        torch.Generator().manual_seed(0))
    scales = scaling.init_scales(params, (
        models.mobilenet_proj_only_predicate if proj_only
        else scaling.default_predicate))
    codec = comms.get_codec("int8-blockscale")
    zeros = tree_map(torch.zeros_like, params)
    up = comms.WireSpec(
        params=comms.shape_template(params),
        scales=comms.shape_template(scales),
        fine_mask=comms.path_fine_mask(params),
        step_size=quant.STEP_SIZE_UNI, fine_step_size=quant.STEP_SIZE_FINE)
    down = comms.WireSpec(params=comms.shape_template(params), scales=None,
                          fine_mask=None, step_size=quant.STEP_SIZE_BI,
                          fine_step_size=quant.STEP_SIZE_FINE)
    payload = codec.encode(comms.ClientUpdate(
        None, None, zeros, tree_map(torch.zeros_like, scales)), up)
    broadcast = codec.encode(comms.ClientUpdate(None, None, zeros, None),
                             down)
    return len(payload), len(broadcast)


def slice11_kernel_phase(torch, dc, la, da, rs, models):
    """Every grouped kernel against its plain version on the leaves of
    ``mobilenetv2_small(20, 3)``: the int8 encode of a message (62 params
    and 62 scales entries) under the default and the projection-only
    predicate and of a cohort of 4, two launches each, bitwise;
    ``level_assign_leaves`` on a client's 62 leaves and
    ``delta_apply_leaves`` on a broadcast's 62, bitwise, one launch each;
    ``row_stats_leaves`` on the 21 weight views (the 6 depthwise ones rows
    of 9) within rtol 1e-6, bitwise to one-view launches, one launch.
    ``scaled_matmul`` at its ``fc`` shape (N = 20, K = 128) is the ResNet's
    and held there.  Each kernel is then timed on these inputs.  Returns
    (checks, timings)."""
    gen = torch.Generator().manual_seed(11)
    shapes, s_default = mobilenet_leaves(torch, models)
    _, s_proj = mobilenet_leaves(torch, models, proj_only=True)
    if len(shapes) != MOBILENET_LEAVES:
        fail(f"{len(shapes)} mobilenetv2_small leaves")
    checks, timings = 0, {}
    for what, s_shapes, k, timed in (
            ("a mobilenetv2_small message", s_default, 1, "message"),
            ("a mobilenetv2_small message, projection-only scales", s_proj,
             1, "message_proj_only"),
            ("a mobilenetv2_small cohort of 4", s_default, 4, "cohort")):
        p, s = int8_leaves(torch, gen, shapes, s_shapes, k)
        dc.reset_counters()
        checks += encode_compare(torch, dc, p, s, k > 1, what)
        launches, entries = sum(dc.LAUNCHES.values()), len(p) + len(s)
        if launches != 2:
            fail(f"int8_encode_leaves made {launches} launches for {what} "
                 f"({entries} entries)")
        sizes = [math.prod(sh) for sh in shapes]
        s_sizes = [t.shape[1] if t.ndim > 1 else 1 for t in s]
        timings[f"int8_encode_{timed}"] = dict(
            **kernel_times(torch, lambda p=p, s=s, k=k:
                           dc.int8_encode_leaves(p, s, 0.0, 128,
                                                 batched=k > 1),
                           lambda p=p, s=s: dc.int8_encode_leaves_plain(
                               p, s, 0.0, 128)),
            bound=encode_bound_ms(sizes, s_sizes, k, 128),
            entries=entries, rows=k, launches=launches,
            scale_elements=sum(s_sizes))
    d, r, th, steps = la_leaf_inputs(torch, gen, shapes)
    la_group_compare(torch, la, d, r, th, steps)
    checks += 1
    n = sum(x.numel() for x in d)
    timings["level_assign"] = dict(
        **kernel_times(torch, lambda: la.level_assign_leaves(d, r, th, steps),
                       lambda: la.level_assign_leaves_plain(d, r, th, steps)),
        bound=la_bound_ms(n), elements=n, leaves=len(d))
    sizes = [math.prod(sh) for sh in shapes]
    ws = [(0.1 * torch.randn(sh, generator=gen)).cuda() for sh in shapes]
    qs = [torch.randint(-127, 128, (m,), generator=gen,
                        dtype=torch.int8).cuda() for m in sizes]
    ss = [(1e-3 * torch.rand(-(-m // 128), generator=gen) + 1e-6).cuda()
          for m in sizes]
    for coef in (1.0, -1.0):
        da.reset_counters()
        got = da.delta_apply_leaves(ws, qs, ss, coef)
        if da.LAUNCHES["delta_apply"] != 1:
            fail(f"delta_apply_leaves made {da.LAUNCHES['delta_apply']} "
                 f"launches for {len(ws)} leaves")
        want = da.delta_apply_leaves_plain(ws, qs, ss, coef, 128)
        torch.cuda.synchronize()
        if not all(bits_equal(torch, g, w) for g, w in zip(got, want)):
            fail(f"delta_apply_leaves disagrees with its plain version on "
                 f"the mobilenetv2_small leaves (coef {coef})")
        checks += 1
    timings["delta_apply"] = dict(
        **kernel_times(torch, lambda: da.delta_apply_leaves(ws, qs, ss, -1.0),
                       lambda: da.delta_apply_leaves_plain(ws, qs, ss, -1.0,
                                                           128)),
        bound=da_bound_ms(sum(sizes)), elements=sum(sizes), leaves=len(ws))
    views = [(1e-3 * torch.randn((sh[0], math.prod(sh[1:])),
                                 generator=gen)).cuda()
             for sh in shapes if len(sh) >= 2]
    rows9 = sum(v.shape[1] == 9 for v in views)
    if len(views) != MOBILENET_WEIGHTS or rows9 != MOBILENET_DEPTHWISE:
        fail(f"mobilenetv2_small has {len(views)} weight views, {rows9} of "
             f"rows of 9")
    rs.reset_counters()
    got = rs.row_stats_leaves(views)
    if rs.LAUNCHES["row_stats"] != 1:
        fail(f"row_stats_leaves made {rs.LAUNCHES['row_stats']} launches for "
             f"the {len(views)} mobilenetv2_small views")
    worst = 0.0
    for v, g in zip(views, got):
        if not bits_equal(torch, g, rs.row_stats(v)):
            fail(f"row_stats_leaves differs from a one-view launch at "
                 f"{tuple(v.shape)}")
        worst = max(worst, rs_compare(torch, rs, v))
        checks += 1
    timings["row_stats"] = dict(
        **kernel_times(torch, lambda: rs.row_stats_leaves(views),
                       lambda: rs.row_stats_leaves_plain(views)),
        bound=(sum(rs_bound_ms(*v.shape)[0] for v in views),
               rs_bound_ms(*views[0].shape)[1]),
        views=len(views), library_ms=time_ms(torch, lambda: [
            torch.linalg.vector_norm(v, 1, dim=1) for v in views]))
    print(f"kernel phase: mobilenetv2_small, int8_encode_leaves on 124 "
          f"entries (both predicates, a cohort of 4) bitwise in two launches; "
          f"level_assign_leaves and delta_apply_leaves on {MOBILENET_LEAVES} "
          f"leaves bitwise in one launch; row_stats_leaves on "
          f"{MOBILENET_WEIGHTS} views ({rows9} of rows of 9) in one launch, "
          f"max relative difference {worst:.3g}")
    for name, t in timings.items():
        print(f"  {name} on mobilenetv2_small's inputs: kernel {t['ms']:.4f} "
              f"ms (whole wrapper call {t['call_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms"
              + (f", library {t['library_ms']:.4f} ms"
                 if "library_ms" in t else "")
              + f", bound {t['bound'][0]:.6f} ms ({t['bound'][1]})")
    return checks, timings


def slice11_paths(torch, mods, fl, fsfl, rounds_mod, codecs_mod, comms,
                  data, models, vgg_splits, rounds_out):
    """Paths M to O at full width, 6,400 images over 8 clients, batch 32:

    * M: ``mobilenetv2_small(20, 3)`` on VOC-like data, 2 rounds of
      ``run_federated`` (fsfl, FedAvg, nnc-cabac): 1 ``level_assign`` and
      55/51 ``scaled_matmul`` launches a round (one dense layer);
    * N: the MobileNet with the paper's projection-only scales
      (``mobilenet_proj_only_predicate``), int8-blockscale on both legs,
      cohorts of 4, the device cohort encode, 1 round: the cohort's 124
      entries in 2 ``int8_encode_leaves`` launches, the broadcast's 62 in
      1, 2 ``delta_apply``, 2 ``level_assign``, 55/51 ``scaled_matmul``;
      payloads of the codec's sizes, and the server's params bitwise the
      host decode of the broadcast plus the params before;
    * O: ``cabac_fast_pool_k8`` (the batched uplink over a forkserver pool
      of 2) and ``stream_ingest_k8`` at ``vgg11_thinned`` width, the first
      round of each as the main path plans 2: 1 ``level_assign`` and
      110/102 ``scaled_matmul``; up bytes those of
      ``sync_full_fedavg_fsfl``'s first round; the pool's 2 tasks; the
      streaming aggregate bitwise the CPU's float64 fold of the same
      decoded payloads and, against the gather's float32 mean of them
      (``Aggregate``), within that mean's error bound ``(k - 1) u
      sum|x_i| / k + u |mean|``; the v1 BN mean bitwise."""
    la, rs, da, dc, sm = mods
    voc = full_width_splits(torch, data, data.synthetic.VOC_LIKE)
    out = {}
    cfg = fl.build_protocol(fl.get_scenario("sync_full_fedavg_fsfl"), 2)
    out["M"] = run_path(
        torch, mods, rounds_mod, "path M mobilenetv2_small voc_like",
        lambda: fsfl.run_federated(models.mobilenetv2_small(20, 3), cfg, voc,
                                   2, device="cuda"),
        {"level_assign": 1, **sm_per_round(8, 1)}, 8, 1, rounds_out)

    up, down = mobilenet_int8_bytes(torch, comms, models, proj_only=True)
    launch0 = dc._launch
    tables = capture_calls(dc, "_launch", 100,
                           lambda a, k: (len(a[0]), a[0][0].shape[0]))
    payloads, applied, restore = spy_broadcasts(codecs_mod, rounds_mod)
    proj = fl.Scenario("mobilenet_proj_int8_bidi_k4", cohort_size=4,
                       codec="int8-blockscale", device_encode=True,
                       bidirectional=True, protocol_overrides=(
                           ("scale_predicate",
                            models.mobilenet_proj_only_predicate),))
    try:
        out["N"] = run_path(
            torch, mods, rounds_mod,
            "path N mobilenetv2_small proj-only int8 both legs",
            lambda: fl.run_scenario(proj, rounds=1,
                                    model=models.mobilenetv2_small(20, 3),
                                    splits=voc, device="cuda"),
            {"level_assign": 2, "delta_apply": 2, "delta_compress": 1,
             "delta_compress_batch": 2, **sm_per_round(4, 1)}, 4, 1,
            rounds_out, up=4 * up, down=4 * down)
    finally:
        restore()
        dc._launch = launch0
    want_tables = [(2 * MOBILENET_LEAVES, 4), (MOBILENET_LEAVES, 1)]
    if tables != want_tables:
        fail(f"path N: int8 encodes (entries, rows) {tables}, expected "
             f"{want_tables}")
    out["N"].update(encodes=tables, payload_bytes=up, broadcast_bytes=down,
                    leaves_checked=check_broadcast_applies(
                        codecs_mod, "path N", payloads, applied, 1))
    out["O"] = path_o(torch, mods, rounds_mod, fl, models, vgg_splits,
                      rounds_out)
    return out


def path_o(torch, mods, rounds_mod, fl, models, splits, rounds_out) -> dict:
    """Path O (see ``slice11_paths``)."""
    from repro_torch.fl.async_buffer import TreeAccumulator
    from repro_torch.tree import sorted_items
    first_up = next(r[4] for r in rounds_out
                    if r[0] == "sync_full_fedavg_fsfl" and r[1] == 1)
    want = {"level_assign": 1, **sm_per_round(8)}
    out, engines = {}, []
    init0 = fl.FederatedEngine.__init__

    def init(self, *a, **kw):
        init0(self, *a, **kw)
        engines.append(self)

    fl.FederatedEngine.__init__ = init
    folds = []
    fold0 = rounds_mod.SyncScheduler._fold_streaming

    def fold(self, contribs, survivors, clients):
        server = self.eng.server
        agg, kept = fold0(self, contribs, survivors, clients)
        folds.append((server, [contribs[i] for i in kept], agg))
        return agg, kept

    rounds_mod.SyncScheduler._fold_streaming = fold
    def first_round(name):
        # the main path's protocol, planned for 2 rounds (its linear scale
        # schedule), and its first round
        s = fl.get_scenario(name)
        return fl.FederatedEngine(
            models.vgg11_thinned(), fl.build_protocol(s, 2), splits,
            engine_cfg=fl.build_engine(s), device="cuda").run(1)

    try:
        for name in ("cabac_fast_pool_k8", "stream_ingest_k8"):
            out[name] = run_path(
                torch, mods, rounds_mod, f"path O {name}",
                lambda name=name: first_round(name), want, 8, 2, rounds_out,
                up=first_up)
    finally:
        fl.FederatedEngine.__init__ = init0
        rounds_mod.SyncScheduler._fold_streaming = fold0
    pool = engines[0].uplink
    if pool.pool_tasks != 2:
        fail(f"path O: cabac_fast_pool_k8 made {pool.pool_tasks} pool "
             f"tasks in a round, expected 2 (one a worker)")
    if len(folds) != 1 or len(folds[0][1]) != 8:
        fail(f"path O: stream_ingest_k8 folded {len(folds)} rounds")
    eng = engines[1]
    server0, contribs, agg = folds[0]
    decoded = eng.uplink.codec.decode_batch([c.payload for c in contribs],
                                            eng.uplink.spec)
    gather = rounds_mod.Aggregate(eng.device)([rounds_mod.Contribution(
        client=c.client, delta_params=d.params, delta_scales=d.scales,
        bn_state=c.bn_state) for c, d in zip(contribs, decoded)])
    # the gather's float32 mean of k terms errs by at most (k - 1) u
    # sum|x_i| / k, and its last rounding u |mean| (u = 2^-24); the
    # float64 fold is exact to one rounding
    u, k = 2.0 ** -24, len(decoded)
    report = {"share_of_gather_bound": 0.0, "elements_apart_from_gather": 0}
    for part, trees in (("params", [d.params for d in decoded]),
                        ("scales", [d.scales for d in decoded])):
        a = dict(sorted_items(getattr(agg, f"delta_{part}")))
        b = dict(sorted_items(getattr(gather, f"delta_{part}")))
        for path, w in b.items():
            v = a[path]
            mass = sum(torch.as_tensor(dict(sorted_items(t))[path]).abs()
                       for t in trees).to(w.device)
            bound = (k - 1) * u * mass / k + u * w.abs()
            report["elements_apart_from_gather"] += int((v != w).sum())
            share = float(((v - w).abs() / bound.clamp_min(1e-45)).max())
            report["share_of_gather_bound"] = max(
                report["share_of_gather_bound"], share)
    for path, v in sorted_items(agg.bn_state):
        if not bits_equal(torch, v, dict(sorted_items(gather.bn_state))[path]):
            fail(f"path O: the streaming round's v1 BN mean of {path} is not "
                 f"the gather's")
    if report["share_of_gather_bound"] > 1.0:
        fail(f"path O: the streaming aggregate is "
             f"{report['share_of_gather_bound']:.3g} of the float32 error "
             f"bound off the gather's")
    host = {k: TreeAccumulator("cpu") for k in ("params", "scales")}
    for d in decoded:
        host["params"].add(d.params)
        host["scales"].add(d.scales)
    for part, acc in host.items():
        want_tree = dict(sorted_items(acc.mean()))
        for path, v in sorted_items(getattr(agg, f"delta_{part}")):
            if not bits_equal(torch, v.cpu(), want_tree[path]):
                fail(f"path O: the card's streaming fold of {part}/{path} "
                     f"is not the CPU's float64 fold of the same payloads")
    print(f"  path O: the cohort's nnc payloads in 2 forkserver tasks; the "
          f"streaming aggregate bitwise the CPU's float64 fold, "
          f"{report['elements_apart_from_gather']} elements apart from "
          f"the float32 gather mean, within "
          f"{report['share_of_gather_bound']:.3g} of its error bound; the "
          f"v1 BN mean bitwise")
    out["stream_vs_gather"] = report
    out["pool_tasks"] = pool.pool_tasks
    return out


def conv_route(torch, model, splits) -> dict:
    """The device kernels of one training step of ``model`` (forward and
    backward on 32 images, the port's cuDNN settings), from a
    ``torch.profiler`` trace: which route its convolutions took, the
    depthwise ones included.  Returns {kernel name: launches} of the
    kernels whose name mentions a convolution."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import resolve_device
    from repro_torch.tree import tree_map
    resolve_device("cuda")
    params, state = model.init(torch.Generator().manual_seed(0), "cuda")
    params = tree_map(lambda t: t.requires_grad_(True), params)
    x = splits.client_x[0][:32].cuda()
    y = splits.client_y[0][:32].cuda()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits, _ = model.apply(params, state, x, train=True)
        F.cross_entropy(logits, y).backward()
        torch.cuda.synchronize()
    names = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and any(
                w in e.key.lower() for w in ("conv", "depthwise", "dgrad",
                                             "wgrad", "implicit")):
            names[e.key[:120]] = e.count
    return names


def small_mobilenet_setting(torch, data, models):
    """The reduced MobileNet ``make_mobilenet("mobilenet_t", 20, 3,
    blocks=((16, 1), (24, 2)), expand=1)`` (a residual block, a stride-2
    depthwise block, a residual block), the one of
    tests/test_torch_mobilenet.py, on ``small_resnet_setting``'s 1,280
    VOC-like images."""
    _, splits = small_resnet_setting(torch, data, models)
    return models.make_mobilenet("mobilenet_t", 20, 3,
                                 blocks=((16, 1), (24, 2)), expand=1), splits


def refuse(reason: str) -> int:
    """No result: the reason on stderr, and a last line ``{"ok": false}``
    that names it."""
    print(f"chip_smoke: {reason}", file=sys.stderr)
    print(json.dumps({"ok": False, "error": reason}))
    return 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return refuse("no CUDA device is visible")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return refuse(f"no src/repro_torch beside {Path(__file__).name}: "
                      f"run it from the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import comms, data, fl, models
    from repro_torch.comms import codecs as codecs_mod
    from repro_torch.comms import device as device_mod
    from repro_torch.comms import stages as stages_mod
    from repro_torch.core import fsfl
    from repro_torch.core import protocol as protocol_mod
    from repro_torch.core import sparsify as sparsify_mod
    from repro_torch.fl import rounds as rounds_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import delta_apply as da
    from repro_torch.kernels import delta_compress as dc
    from repro_torch.kernels import level_assign as la
    from repro_torch.kernels import row_stats as rs
    from repro_torch.kernels import scaled_matmul as sm
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
    checks = (kernel_phase(torch, dc) + encode_kernel_phase(torch, dc, models)
              + la_kernel_phase(torch, la, models)
              + slice3_kernel_phase(torch, da, rs, models)
              + slice6_kernel_phase(torch, da, rs, models)
              + sm_kernel_phase(torch, sm))
    s10_checks, s10_timings = slice10_kernel_phase(torch, dc, la, da, rs, sm,
                                                   models)
    s11_checks, s11_timings = slice11_kernel_phase(torch, dc, la, da, rs,
                                                   models)
    s12_checks, s12_timings = cohort_kernel_phase(torch, sm, la, models)
    checks += s10_checks + s11_checks + s12_checks
    t1 = phase("kernel phase", t1)
    splits = full_width_splits(torch, data)
    rounds_out = []

    # the paper's main path: nnc-cabac, all 8 clients, level_assign and
    # scaled_matmul
    sm_captured, sm_originals = capture_sm(sm)
    la_captured = capture_calls(
        stages_mod, "level_assign_leaves", 1,
        lambda a, k: ([x.clone() for x in a[0]], [x.clone() for x in a[1]],
                      a[2].clone(), list(a[3])))
    cohorts = []
    orig_cohort = checked_cohort_encode(torch, codecs_mod, comms, row,
                                        tree_map, cohorts)
    mods = (la, rs, da, dc, sm)
    la_launches = nnc_slice_phase(torch, mods, rounds_mod, fl, fsfl, models,
                                  splits, rounds_out, cohorts)
    codecs_mod.NncCabacCodec.encode_cohort = orig_cohort
    stages_mod.level_assign_leaves = la.level_assign_leaves
    for d, fn in sm_originals.items():
        setattr(sm, d, fn)
    t1 = phase("nnc slice phase", t1)

    # the int8 uplink
    captured, original = capture_encodes(torch, device_mod)
    launches = int8_slice_phase(torch, mods, rounds_mod, fl, models, splits,
                                rounds_out)
    device_mod.int8_encode_leaves = original
    t1 = phase("int8 slice phase", t1)

    # slice 3: bidirectional compression (paths A, B and C)
    a_launches = path_a(torch, mods, rounds_mod, fl, fsfl, models, splits,
                        rounds_out)
    t1 = phase("path A (bidirectional, nnc-cabac)", t1)
    rs_launches, rs_captured = path_b(torch, mods, rounds_mod, sparsify_mod,
                                      protocol_mod, fsfl, models, splits,
                                      rounds_out)
    t1 = phase("path B (bidirectional, fsfl_dyn)", t1)
    da_launches, da_captured, c_checked = path_c(
        torch, mods, rounds_mod, fl, codecs_mod, models, splits, rounds_out)
    t1 = phase("path C (bidirectional, int8)", t1)

    # slice 8: partial updates, wire schema v2 and the channel
    d_out = path_d(torch, la, sm, fl, codecs_mod, models, splits,
                   rounds_out)
    t1 = phase("path D (partial updates, nnc-cabac)", t1)
    e_out = path_e(torch, dc, la, sm, fl, codecs_mod, device_mod, models,
                   splits, rounds_out)
    t1 = phase("path E (partial, int8, v2, lossy channel)", t1)
    bn_out = bnwire_round(torch, la, sm, fl, codecs_mod, models, splits,
                          rounds_out)
    t1 = phase("bnwire_v2_full round", t1)

    # slice 9: buffered async (paths F and H) and the FedOpt engine on a
    # dirichlet split (path G)
    f_out = async_path(torch, la, sm, fl, models, splits, rounds_out,
                       "async_b4_fsfl", 2)
    t1 = phase("path F (async_b4_fsfl)", t1)
    g_out = path_g(torch, la, sm, fl, data, models, rounds_out)
    t1 = phase("path G (noniid_dir1_k4_fedyogi)", t1)
    h_out = async_path(torch, la, sm, fl, models, splits, rounds_out,
                       "async_windowed_b4", 1)
    t1 = phase("path H (async_windowed_b4)", t1)

    # slice 10: the paper's ResNet on VOC-like data and VGG16 on X-ray-like
    # data (paths I to L)
    s10 = slice10_paths(torch, mods, fl, fsfl, rounds_mod,
                        codecs_mod, sparsify_mod, protocol_mod, data, models,
                        rounds_out)
    t1 = phase("paths I to L (resnet18_small, vgg16_tiny)", t1)

    # slice 11: MobileNetV2 (paths M, N) and the host uplink (path O)
    s11 = slice11_paths(torch, mods, fl, fsfl, rounds_mod, codecs_mod, comms,
                        data, models, splits, rounds_out)
    t1 = phase("paths M to O (mobilenetv2_small, the host uplink)", t1)

    # slice 12: the executors (serial beside batched, sharded on the mesh
    # of the visible devices)
    s12 = slice12_paths(torch, mods, rounds_mod, fl, models, splits,
                        rounds_out)
    t1 = phase("executors (exec_serial_k4, sharded_cohort_full)", t1)

    # slice 13: the executor gap one step at a time, and the population
    # axis (the cohort kernels at K = 32, virtual clients through the
    # sharded store, churn, adaptive windows)
    steps = step_check(torch, fl, models, splits)
    t1 = phase("step check (exec_serial_k4, one step at a time)", t1)
    s13_checks, s13_timings = cohort_kernel_phase(
        torch, sm, la, models, cohort=POP_COHORT,
        sm_shapes=((32, 128, 128), (32, 10, 128), (120, 128, 128)),
        la_models=(("vgg11_thinned", VGG_LEAVES),))
    checks += s13_checks
    s13 = population_paths(torch, mods, rounds_mod, fl, models, splits,
                           rounds_out)
    t1 = phase("population axis (pop_100k_diurnal, memory against "
               "sharded, pop_1m_lazy_k32, churn_midround_async)", t1)

    timings = main_path_kernels(torch, dc, device_mod, captured)
    la_timing = la_main_path(torch, la, la_captured)
    da_timing = da_main_path(torch, da, da_captured)
    rs_timing = rs_main_path(torch, rs, rs_captured)
    sm_timing = sm_main_path(torch, sm, sm_captured)
    t1 = phase("main-path buffers", t1)
    cpu_runs = {}
    small = {name: small_input_check(torch, fl, rounds_mod, name, cpu_runs)
             for name in SMALL_SCENARIOS}
    model_t, splits_t = small_resnet_setting(torch, data, models)
    resnet_t = {
        "model": small_model_check(torch, model_t, splits_t),
        "engine": small_engine_check(torch, fl, rounds_mod, model_t,
                                     splits_t),
        "own_training": small_own_training(torch, fl, rounds_mod, model_t,
                                           splits_t)}
    model_m, splits_m = small_mobilenet_setting(torch, data, models)
    mobilenet_t = {
        "model": small_model_check(torch, model_m, splits_m, "mobilenet_t",
                                   floor_share=1e-5),
        "engine": small_engine_check(torch, fl, rounds_mod, model_m,
                                     splits_m, "mobilenet_t",
                                     bn_mean_bound=True),
        "own_training": small_own_training(torch, fl, rounds_mod, model_m,
                                           splits_m, "mobilenet_t")}
    t1 = phase("small-input checks", t1)
    repeat = {}
    for name in REPEATED:
        repeat[name], failures = repeat_small_runs(torch, fl, rounds_mod,
                                                   name)
        print(f"repeatability {name}: two card runs, {repeat[name]}")
        if failures:
            fail("; ".join(failures))
    for label, model_r, splits_r in (("resnet_t", model_t, splits_t),
                                     ("mobilenet_t", model_m, splits_m)):
        label = f"{label} sync_full_fedavg_fsfl"
        repeat[label], failures = repeat_small_runs(
            torch, fl, rounds_mod, "sync_full_fedavg_fsfl", model_r, splits_r)
        print(f"repeatability {label}: two card runs, {repeat[label]}")
        if failures:
            fail("; ".join(failures))
    routes = conv_route(torch, model_m, splits_m)
    depthwise = [k for k in routes if "depthwise" in k.lower()]
    route = "ATen's own kernels" if depthwise else "cuDNN"
    print(f"  mobilenet_t's convolutions on the card (one training step): "
          f"{len(routes)} kernels, the depthwise ones on {route}")
    for k, v in sorted(routes.items()):
        print(f"    {v:4d} x {k}")
    mobilenet_t["conv_kernels"] = routes
    t1 = phase("repeatability", t1)
    # one profiled round (path C: 4 clients, host and device activity, the
    # coder's spans): the profiler's processing took 69-97 s a round, and
    # paths A's and B's device-only profiles are dropped to keep
    # the run's time
    bidi_int8 = fl.Scenario("bidi_int8_k4", cohort_size=4,
                            codec="int8-blockscale", bidirectional=True)
    prof = {
        "bidi_int8_k4": profile_round(
            torch, lambda: fl.run_scenario(
                bidi_int8, rounds=1, model=models.vgg11_thinned(),
                splits=splits, device="cuda"),
            "bidi_int8_k4 (path C)", ("delta_apply", "int8_encode"))}
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
            "call_ms": t["call_ms"], "shape": t["shape"],
            "leaves": t["entries"], "body_bytes": t["body"],
            "per_warp": t["per_warp"], "per_warp_ms": t["per_warp_ms"],
            "pad_cat_route_ms": t["old_route_ms"],
            "one_buffer_ms": t["one_buffer_ms"],
            "one_buffer_bound_ms": t["one_buffer_bound"][0],
            "int8_rows_host_ms": t["rows_host_ms"],
            "pad_cat_int8_rows_host_ms": t["old_rows_host_ms"],
            "device_ops": t["ops"], "pad_cat_device_ops": t["old_ops"]})
        if launches[name] < 1:
            fail(f"{name} was not launched on the main path")
    def s10_launches(path, key):
        return path_total(s10[path], key)

    def s11_launches(path, key):
        return path_total(s11[path], key)

    for k, part in zip(kernels, ("cohort", "message")):
        kernel = ("delta_compress_batch" if part == "cohort"
                  else "delta_compress")
        k.update({"launches_path_k": s10_launches("K", kernel),
                  "launches_path_n": s11_launches("N", kernel),
                  "resnet18_small": s10_timings[f"int8_encode_{part}"],
                  "mobilenetv2_small": s11_timings[f"int8_encode_{part}"]})
    kernels[1]["mobilenetv2_small_proj_only"] = s11_timings[
        "int8_encode_message_proj_only"]
    e_kernel = e_out["kernel"]
    kernels[0].update({
        "launches_path_e": e_out["launches"]["delta_compress_batch"],
        "path_e_entries": e_out["entries"][0],
        "path_e_shape": e_out["shape"], "path_e_ms": e_kernel["ms"],
        "path_e_plain_ms": e_kernel["plain_ms"],
        "path_e_call_ms": e_kernel["call_ms"],
        "path_e_bound_ms": e_kernel["bound"][0],
        "path_e_bound_by": e_kernel["bound"][1]})

    kernels.append({
        "name": "level_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/level_assign.cu",
        "replaces": "src/repro/kernels/level_assign.py:46",
        "launches": la_launches["sync_full_fedavg_fsfl"], "max_abs_err": 0.0,
        "ms": la_timing["ms"], "plain_ms": la_timing["plain_ms"],
        "bound_ms": la_timing["bound"][0], "bound_by": la_timing["bound"][1],
        "library_ms": None, "call_ms": la_timing["call_ms"],
        "leaves": VGG_LEAVES, "rows": COHORT,
        "elements": la_timing["elements"],
        "per_client_launches_ms": la_timing["per_client_ms"],
        "per_client_launches_call_ms": la_timing["per_client_call_ms"],
        "cohort_kernel_phase": s12_timings["level_assign"],
        "cohort_32_kernel_phase": s13_timings["level_assign"],
        "launches_pop_100k_diurnal": path_total(s13["pop_100k_diurnal"],
                                                "level_assign"),
        "launches_bidirectional_path_a":
            a_launches["run_federated bidirectional"],
        "launches_path_d": d_out["level_assign"],
        "launches_path_e": e_out["launches"]["level_assign"],
        "launches_path_f": f_out["level_assign"],
        "launches_path_g": g_out["level_assign"],
        "launches_path_h": h_out["level_assign"],
        **{f"launches_path_{p.lower()}": s10_launches(p, "level_assign")
           for p in ("I", "J", "K")},
        **{f"launches_path_{p.lower()}": s11_launches(p, "level_assign")
           for p in ("M", "N")},
        "launches_path_o": {n: path_total(s11["O"][n], "level_assign")
                            for n in ("cabac_fast_pool_k8",
                                      "stream_ingest_k8")},
        "resnet18_small": s10_timings["level_assign"],
        "mobilenetv2_small": s11_timings["level_assign"]})
    if la_launches["sync_full_fedavg_fsfl"] < 1:
        fail("level_assign was not launched on the main path")
    kernels.append({
        "name": "delta_apply", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_apply.cu",
        "replaces": "src/repro/kernels/delta_compress.py:150",
        "launches": da_launches, "max_abs_err": 0.0,
        "ms": da_timing["ms"], "plain_ms": da_timing["plain_ms"],
        "bound_ms": da_timing["bound"][0], "bound_by": da_timing["bound"][1],
        "library_ms": None, "call_ms": da_timing["call_ms"],
        "leaves": VGG_LEAVES, "elements": da_timing["elements"],
        "per_leaf_launches_ms": da_timing["per_leaf_ms"],
        "per_leaf_launches_call_ms": da_timing["per_leaf_call_ms"],
        "launches_path_k": s10_launches("K", "delta_apply"),
        "launches_path_n": s11_launches("N", "delta_apply"),
        "resnet18_small": s10_timings["delta_apply"],
        "mobilenetv2_small": s11_timings["delta_apply"]})
    kernels.append({
        "name": "row_stats", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_stats.cu",
        "replaces": "src/repro/kernels/row_stats.py:28",
        "launches": rs_launches, "max_abs_err": rs_timing["max_abs_err"],
        "max_rel_err": rs_timing["max_rel"],
        "ms": rs_timing["ms"], "plain_ms": rs_timing["plain_ms"],
        "bound_ms": rs_timing["bound"][0], "bound_by": rs_timing["bound"][1],
        "library_ms": rs_timing["library_ms"],
        "library_per_view_ms": rs_timing["library_per_view_ms"],
        "call_ms": rs_timing["call_ms"], "shapes": rs_timing["shapes"],
        "per_leaf_launches_ms": rs_timing["per_leaf_ms"],
        "per_leaf_launches_call_ms": rs_timing["per_leaf_call_ms"],
        "keep_mask_near_tie_flips": rs_timing["flips"],
        "launches_path_l": s10_launches("L", "row_stats"),
        "resnet18_small": s10_timings["row_stats"],
        "mobilenetv2_small": s11_timings["row_stats"]})
    main_sm = SM_RUNS["sync_full_fedavg_fsfl"]
    runs = {label: dict(r) for label, r in SM_RUNS.items()}
    # the main path's most frequent shape: the train step's (32, 128) x
    # (128, 128) product of the first dense layer, and the weight step's
    # backward there (dx and dw)
    fwd = sm_timing["forward"]
    first = next((r for r in fwd if r["mnk"] == [32, 128, 128]), fwd[0])
    kernels.append({
        "name": "scaled_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scaled_matmul.cu",
        "replaces": "src/repro/kernels/scaled_matmul.py:37",
        "launches": main_sm["forward"],
        "max_abs_err": max(r["max_abs_err"] for r in fwd),
        "max_share_of_error_bound": max(r["bound_share"] for r in fwd),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound"][0], "bound_by": first["bound"][1],
        "library_ms": first["library_ms"], "call_ms": first["call_ms"],
        "mnk": first["mnk"], "batch": first["batch"],
        "main_path_shapes": [{k: r[k] for k in (
            "shapes", "mnk", "batch", "ms", "plain_ms", "library_ms",
            "call_ms", "bound")} for r in fwd],
        "launches_per_path": {label: r["forward"]
                              for label, r in runs.items()},
        "cohort_kernel_phase": [dict(k_mnk=r["k_mnk"], **r["forward"])
                                for r in s12_timings["scaled_matmul"]],
        "cohort_32_kernel_phase": [dict(k_mnk=r["k_mnk"], **r["forward"])
                                   for r in s13_timings["scaled_matmul"]],
        "resnet18_small": s10_timings["scaled_matmul"]})
    bwd = sm_timing["backward"]
    first = next((r for r in bwd if r["mnk"] == [32, 128, 128]
                  and r["grads"] == ["dx", "dw"]), bwd[0])
    kernels.append({
        "name": "scaled_matmul_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scaled_matmul.cu",
        "replaces": "src/repro/kernels/scaled_matmul.py:37",
        "launches": main_sm["backward"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd),
        "max_share_of_error_bound": max(r["bound_share"] for r in bwd),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound"][0], "bound_by": first["bound"][1],
        "library_ms": first["library_ms"], "call_ms": first["call_ms"],
        "mnk": first["mnk"], "batch": first["batch"],
        "grads": first["grads"],
        "main_path_calls": [{k: r[k] for k in (
            "shapes", "mnk", "batch", "grads", "ms", "plain_ms",
            "library_ms", "call_ms", "bound", "alone")} for r in bwd],
        "launches_per_path": {label: r["backward"]
                              for label, r in runs.items()},
        "cohort_kernel_phase": [dict(k_mnk=r["k_mnk"], **r["backward_dx_dw"])
                                for r in s12_timings["scaled_matmul"]],
        "cohort_32_kernel_phase": [
            dict(k_mnk=r["k_mnk"], **r["backward_dx_dw"])
            for r in s13_timings["scaled_matmul"]],
        "resnet18_small": s10_timings["scaled_matmul_backward"]})
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on its path")
    print(json.dumps({"summary": {
        "build_s": build_s, "phase_s": phases,
        "total_s": time.time() - t_start, "random_input_checks": checks,
        "rounds [scenario, round, test_acc, train_loss, up_bytes, wall_s"
        "(, down_bytes)]": rounds_out,
        "main_path_buffers": {
            **{n: {"kept": t["kept"], "ties": t["ties"]}
               for n, t in timings.items()},
            "level_assign": {"kept": la_timing["kept"],
                             "ties": la_timing["ties"]},
            "row_stats": {"keep_mask_near_tie_flips": rs_timing["flips"],
                          "topk_near_tie_leaves": rs_timing["topk_flips"]}},
        "device_encoded_nnc_payloads": cohorts,
        "path_c_leaves_checked_against_host_decode": c_checked,
        "path_d_partial_fc_k4": {k: v for k, v in d_out.items()},
        "path_e_partial_int8_v2_lossy_k4": {
            k: v for k, v in e_out.items() if k != "kernel"},
        "bnwire_v2_full": bn_out, "path_f_async_b4_fsfl": f_out,
        "path_g_noniid_dir1_k4_fedyogi": g_out,
        "path_h_async_windowed_b4": h_out,
        "paths_i_to_l": s10, "resnet_t_small_input": resnet_t,
        "paths_m_to_o": s11, "mobilenet_t_small_input": mobilenet_t,
        "executors": s12,
        "step_check": {"verdict": steps["verdict"],
                       "factor": steps["factor"], "steps": steps["steps"]},
        "population": s13,
        "repeatability": repeat,
        "small_input_card_vs_cpu": small, "profiled_rounds": prof}}))
    print(json.dumps({"kernels": kernels}))
    print(f"device: {dev}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
