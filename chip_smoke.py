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
   each run twice to the same bits;
4. slice phase at full width: the paper's ``vgg11_thinned`` on 6,400
   synthetic CIFAR-like images over 8 clients, FSFL (fixed sparsity 0.9),
   batch 32 (17 local steps).  The launch counters are set to 0 before
   and read after each path, and a path whose kernel was not launched
   the expected number of times fails.  Every path runs the dense layers
   on ``scaled_matmul``: 866 forward and 816 backward launches a round
   over 8 clients (434 and 408 over cohorts of 4), the backward computing
   dx, dw, ds 816, 272, 544 times:

   * the paper's main path: 2 rounds of ``sync_full_fedavg_fsfl`` through
     ``run_federated`` (all 8 clients, FedAvg, nnc-cabac; ``level_assign``
     once per client over its 28 leaves, 8 launches a round), then 1
     round of
     ``device_encode_cabac``, whose device-encoded payloads are held byte
     for byte against the host encode of the same levels;
   * the int8 uplink: 1 round each of ``device_encode_int8`` and
     ``codec_int8_k4`` (cohorts of 4) through ``run_scenario``;
   * bidirectional compression (§5.2).  Path A: 2 rounds of
     ``run_federated(bidirectional=True)`` and 1 of ``bidi_sync_full``
     (nnc-cabac both legs, ``level_assign`` on both: 9 a round).  Path
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
     and goes on the wire; 4 ``level_assign`` a round), the frozen server
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

   Each kernel is then held against its plain version on copies of the
   first buffers its path gave it (``int8_encode_leaves``: the first
   message's and the first cohort's leaves, each copy at its leaf's
   offset mod 16, the bodies also held against the pad/cat/assemble
   route on the one-entry launch: pad, concatenate, one single-buffer
   launch of the same kernel, assemble; timed at every ``per_warp``,
   with that route on the device, its one-entry launch alone, the whole
   ``int8_rows`` call of both routes on the host's clock, and the device operations of one encode of each, from a
   ``torch.profiler`` trace, one kernel and one copy required of the
   grouped route; ``level_assign``: the first client's 28 leaves, in one
   grouped launch and in the 28 one-leaf launches it replaces;
   ``delta_apply``: the first downlink's residual (coef -1) and the
   server's apply (+1), each over the 28 leaves in one grouped launch and
   in the 28 one-leaf launches it replaces; ``row_stats``: the first
   client's 10 weight views, in one grouped launch and in 10 one-view
   launches (bitwise equal), with the Eq. 3 keep masks and 50%
   ``topk_rows`` indices compared and any flip away from a near-tie
   failing, and ``torch.linalg.vector_norm`` (the row sum of ``|w|``) as
   its library yardstick; ``scaled_matmul``: the forward at each shape
   and the backward at each shape and subset of gradients the main path
   gave it, each run twice to the same bits) and timed there with CUDA
   events (median of 50 launches after warm-up, L2 flushed before each, a
   spin kernel ahead) beside the plain version, the bound and, for
   ``scaled_matmul``, ``torch.mm`` and a multiply (the backward: the sum
   of those of its gradients, and each gradient alone).  Then a
   small-input check per uplink and for ``bidi_sync_full``: the tiny
   scenario VGG, 2 rounds with 3 local
   steps per client, with cuDNN's deterministic algorithms, gives the
   same bytes and nearly the same model on the card as the plain path on
   the CPU, with the clients' discrete decisions counted apart
   (``compare_small_runs``); and two card runs of ``bidi_sync_full`` with
   the port's own cuDNN selection give the same payloads and server
   state, bit for bit (``repeat_small_runs``);
5. a JSON summary of the run (build, rounds, profiles), a JSON line with
   every ported kernel's launches and times, the device line, and the
   final ``{"ok": true, ...}`` line: the figures a reader needs sit in the
   last lines of the output.

Between 4 and 5 one more round of path C (4 clients, host and device
activity), one of ``bidi_sync_full`` and one of path B (8 clients, device
activity only, which the profiler processes in about a minute) run under
``torch.profiler`` to print where a round's time goes: device-busy
share, the kernels that take the most device time, and the host time in
the coder's spans.  The profiler's own host overhead makes those rounds
slower than the unprofiled ones.

It imports nothing of the JAX package.  Without CUDA, or without the
repository's ``src/`` beside it, it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
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
# host spans of the coding stack (repro_torch.runtime.span)
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


def int8_slice_phase(torch, dc, la, sm, fl, models, splits, rounds_out):
    launches = {}
    for scenario, rounds, kernel, per_round in (
            ("device_encode_int8", 1, "delta_compress_batch", 1),
            ("codec_int8_k4", 1, "delta_compress", 4)):
        for mod in (dc, la, sm):
            mod.reset_counters()
        res = fl.run_scenario(scenario, rounds=rounds,
                              model=models.vgg11_thinned(), splits=splits,
                              device="cuda")
        torch.cuda.synchronize()
        counts = dict(dc.LAUNCHES)
        la_count = la.LAUNCHES["level_assign"]
        check_sm(sm, scenario, 4, rounds)
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
        if la_count != 4 * rounds:       # one a client
            fail(f"{scenario}: level_assign launched {la_count} times, "
                 f"expected {4 * rounds}")
        check_server(torch, scenario, res.server)
        launches[kernel] = counts[kernel]
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


def nnc_slice_phase(torch, la, sm, fl, fsfl, models, splits, rounds_out,
                    checked: list):
    """The paper's main path: 2 rounds of sync_full_fedavg_fsfl through
    run_federated, then 1 round of device_encode_cabac."""
    launches = {}
    for scenario, rounds in (("sync_full_fedavg_fsfl", 2),
                             ("device_encode_cabac", 1)):
        s = fl.get_scenario(scenario)
        cfg = fl.build_protocol(s, rounds)
        la.reset_counters()
        sm.reset_counters()
        if scenario == "sync_full_fedavg_fsfl":
            res = fsfl.run_federated(models.vgg11_thinned(), cfg, splits,
                                     rounds, device="cuda")
        else:
            res = fl.run_scenario(scenario, rounds=rounds,
                                  model=models.vgg11_thinned(),
                                  splits=splits, device="cuda")
        torch.cuda.synchronize()
        count = la.LAUNCHES["level_assign"]
        check_sm(sm, scenario, splits.num_clients, rounds)
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
              f"({count / rounds:.0f} a round, one a client)")
        if count != splits.num_clients * rounds:
            fail(f"{scenario}: level_assign launched {count} times, "
                 f"expected {splits.num_clients * rounds}")
        check_server(torch, scenario, res.server)
        launches[scenario] = count
    if not checked:
        fail("device_encode_cabac encoded no cohort on the device")
    print(f"  device_encode_cabac: {sum(len(c) for c in checked)} "
          f"device-encoded payloads byte-equal to the host encode")
    return launches


def la_main_path(torch, la, captured) -> dict:
    """level_assign against its plain version on the buffers the main path
    gave it (the first client's 28 leaves), bitwise, then timed: the one
    grouped launch of this design, and the 28 launches of one (1, n) call a
    leaf that it replaces."""
    if len(captured) != 1 or len(captured[0][0]) != VGG_LEAVES:
        fail(f"the main path gave level_assign_leaves {len(captured)} "
             f"calls, expected one of {VGG_LEAVES} leaves")
    d, r, th, steps = captured[0]
    la_group_compare(torch, la, d, r, th, steps)
    kept = ties = 0
    for dd, rr, theta, step in zip(d, r, th, steps):
        carried = dd + rr
        x = torch.where(carried.abs() >= theta, carried, 0.0) / step
        kept += int((x != 0).sum())
        ties += int((x - x.floor() == 0.5).sum())
    n = sum(x.numel() for x in d)
    # the design before: one launch a leaf, theta and step as device
    # scalars (the step tensors made once, as quant.f32 did)
    per_leaf = [(dd.reshape(1, -1), rr.reshape(1, -1), th[i],
                 torch.tensor(steps[i], dtype=torch.float32, device="cuda"))
                for i, (dd, rr) in enumerate(zip(d, r))]

    def chain():
        return [la.level_assign(*c) for c in per_leaf]

    # the chain enqueues 28 wrapper calls (about 2 ms of host time): a
    # 20 ms spin keeps the card waiting until all are queued
    out = dict(**kernel_times(torch,
                              lambda: la.level_assign_leaves(d, r, th, steps),
                              lambda: la.level_assign_leaves_plain(
                                  d, r, th, steps)),
               bound=la_bound_ms(n), elements=n, kept=kept, ties=ties,
               per_leaf_ms=time_ms(torch, chain, spin=40_000_000),
               per_leaf_call_ms=time_ms(torch, chain, host_ahead=False))
    print(f"  level_assign on the main path's 28 leaves ({n} elements): "
          f"bitwise, {kept} kept elements with a nonzero quotient, {ties} "
          f"exact half-way ties; one grouped launch {out['ms']:.4f} ms "
          f"(whole wrapper call {out['call_ms']:.4f} ms), 28 launches as "
          f"before {out['per_leaf_ms']:.4f} ms (wrapper calls "
          f"{out['per_leaf_call_ms']:.4f} ms), plain {out['plain_ms']:.4f} "
          f"ms, bound {out['bound'][0]:.5f} ms ({out['bound'][1]})")
    return out


SMALL_ROUNDS = 2
SMALL_SAMPLES = 1280     # 3 local steps per client on the tiny VGG
SMALL_SCENARIOS = ("sync_full_fedavg_fsfl", "device_encode_int8",
                   "bidi_sync_full")
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


def record_small_run(torch, fl, rounds_mod, name: str, device: str):
    """One run of scenario ``name`` on the tiny scenario VGG with 1,280
    samples (3 local steps per client) for 2 rounds on ``device``, with
    each round's discrete decisions kept on the host: per client its params
    and scale levels, the kept Eq. 4 sub-epoch (``scale_epoch``, 0 for
    none), its decoded scale delta as the server aggregates it, and the
    gradient and update of each of its scale steps; the broadcast's
    reconstruction where there is a downlink; the server's state after the
    round.  Returns (RunResult, the per-round log, the number of test
    images)."""
    from repro_torch.core import protocol as protocol_mod
    from repro_torch.fl import executors
    from repro_torch.tree import items

    def host(tree):
        return {path: torch.as_tensor(v).detach().cpu()
                for path, v in items(tree)}

    def is_scales(tree):
        return all(v.ndim <= 1 for _, v in items(tree))

    s = fl.get_scenario(name)
    model, splits = fl.default_setting(s.num_clients, n_samples=SMALL_SAMPLES)
    log, steps = [], []     # steps: per client trained, its scale steps
    intake0 = rounds_mod.Uplink.intake
    step0 = rounds_mod.ServerStep.__call__
    compress0 = rounds_mod.Downlink.compress
    bind0 = executors.SerialExecutor.bind
    grad0 = protocol_mod._grad_tree
    apply0 = protocol_mod.apply_updates

    def bind(self, client_round):
        def traced(*args):
            steps.append([])
            return client_round(*args)
        bind0(self, traced)

    def grad_tree(loss, tree):
        grads = grad0(loss, tree)
        if is_scales(tree):
            steps[-1].append({"grad": host(grads)})
        return grads

    def apply_updates(params, updates):
        if is_scales(params):
            steps[-1][-1]["update"] = host(updates)
        return apply0(params, updates)

    def intake(self, out, clients):
        contribs = intake0(self, out, clients)
        if len(steps) != len(clients):
            raise RuntimeError(f"{len(steps)} clients trained, "
                               f"{len(clients)} in the cohort")
        decoded = [host(c.delta_scales) for c in contribs]
        log.append({"clients": list(clients),
                    "params": host(out.levels_params),
                    "scales": host(out.levels_scales),
                    "scale_epoch": out.metrics["scale_epoch"].cpu(),
                    "scale_delta": {p: torch.stack([d[p] for d in decoded])
                                    for p in decoded[0]},
                    "scale_steps": list(steps), "down": {}})
        steps.clear()
        return contribs

    def server_step(self, server, agg, downlink, receivers, transmit):
        new, down = step0(self, server, agg, downlink, receivers, transmit)
        log[-1]["server_params"] = host(new.params)
        log[-1]["server_scales"] = host(new.scales)
        return new, down

    def compress(self, updates, receivers, transmit):
        broadcast, down = compress0(self, updates, receivers, transmit)
        if broadcast.recon is not None:
            log[-1]["down"] = host(broadcast.recon)
        return broadcast, down

    patches = [(rounds_mod.Uplink, "intake", intake, intake0),
               (rounds_mod.ServerStep, "__call__", server_step, step0),
               (rounds_mod.Downlink, "compress", compress, compress0),
               (executors.SerialExecutor, "bind", bind, bind0),
               (protocol_mod, "_grad_tree", grad_tree, grad0),
               (protocol_mod, "apply_updates", apply_updates, apply0)]
    for owner, attr, new, _ in patches:
        setattr(owner, attr, new)
    try:
        res = fl.run_scenario(name, rounds=SMALL_ROUNDS, model=model,
                              splits=splits, device=device)
    finally:
        for owner, attr, _, old in patches:
            setattr(owner, attr, old)
    return res, log, len(splits.test_y)


def scale_event(base_steps, run_steps) -> tuple[int | None, list[float]]:
    """The first scale step (0-based) at which the two runs' scale
    gradients part by more than ``GRAD_EVENT`` of their norm in some leaf,
    or None; and that ratio at every step."""
    ratios = []
    for a, b in zip(base_steps, run_steps, strict=True):
        ratios.append(max(
            (float((b["grad"][path] - g).norm() / g.norm().clamp_min(1e-30))
             for path, g in a["grad"].items() if g.ndim == 1), default=0.0))
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


def compare_small_runs(torch, cfg, name: str, base, base_log, run, run_log,
                       n_test: int) -> tuple[dict, list[str]]:
    """Hold ``run`` and its recorded decisions (``record_small_run``)
    against ``base`` and its own; returns (counts, failures).

    Convolutions sum in another order in cuDNN than on the CPU, and a
    client's training may then take another discrete decision.  Those are
    counted apart, per round and per client, and bounded by what they move:

    * a params level that crosses a rounding boundary moves the server's
      mean by at most one quantization step, a top-k flip by that client's
      whole update (``flips``): every server param within one quantization
      step except at most 5 flips, and at most 34 (0.5%) params off by more
      than 1e-6;
    * a client whose scale levels lie more than one level apart is counted
      apart only for a discrete cause found in its record: another kept
      sub-epoch (the Eq. 4 accept decision), a top-k flip in its params, or
      a scale step at which the two runs' scale gradients part by more than
      ``GRAD_EVENT`` of their norm (a max-pool or ReLU routing the backward
      another way).  At most 1 such client a round.  Its two decoded scale
      deltas may lie apart by no more than its scale steps can move them
      from the cause on (``scale_cap``, plus one fine step), and that
      difference over the cohort size is taken out of the server's scales;
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
            topk = rounding = 0
            for path, v in lb["params"].items():
                a, b = v[i], lr["params"][path][i]
                topk += int(((a == 0) != (b == 0)).sum())
                rounding += int(((a != b) & (a != 0) & (b != 0)).sum())
            level_diff = [(v[i] - lr["scales"][path][i]).abs()
                          for path, v in lb["scales"].items()]
            widest = int(max(float(d.max()) for d in level_diff))
            epochs = (int(lb["scale_epoch"][i]), int(lr["scale_epoch"][i]))
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
                for p, d in diff.items():
                    d_scales[p] = d_scales[p] - d / k
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
    flips = int((dp > cfg.step_size * 1.01).sum())
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
                                          card, card_log, n_test)
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
                sub: int = SCALE_SUBEPOCHS) -> tuple[dict, dict]:
    """``scaled_matmul`` launches (forward, backward) and products per
    direction of ``rounds`` FSFL rounds over ``clients`` clients: each of
    the 2 dense layers runs forward in every weight step, scale step and
    validation pass (``sub`` + 1) and in the server's evaluation, and one
    backward launch in every step computing dx, with dw in the weight
    steps and ds in the scale steps."""
    per = {"forward": 2 * (steps + sub * steps + sub + 1),
           "dx": 2 * (steps + sub * steps), "dw": 2 * steps,
           "ds": 2 * sub * steps}
    calls = {d: rounds * (clients * n + (2 if d == "forward" else 0))
             for d, n in per.items()}
    return {"forward": calls["forward"], "backward": calls["dx"]}, calls


SM_RUNS: dict[str, dict] = {}    # scaled_matmul launches per path run


def check_sm(sm, label: str, clients: int, rounds: int) -> dict:
    """The path's ``scaled_matmul`` launches and products per direction,
    read after it ran, against ``sm_expected``; kept in ``SM_RUNS``."""
    got, calls = dict(sm.LAUNCHES), dict(sm.CALLS)
    want, want_calls = sm_expected(clients, rounds)
    SM_RUNS[label] = got
    print(f"  {label} launches: scaled_matmul {got} "
          f"({ {d: n // rounds for d, n in got.items()} } a round), "
          f"products {calls}")
    if got != want or calls != want_calls:
        fail(f"{label}: scaled_matmul launched {got} computing {calls}, "
             f"expected {want} computing {want_calls}")
    return got


# what each direction reads, of x (M, K), w (N, K), s (N,) and dy (M, N)
SM_READS = {"forward": ("x", "w", "s"), "dx": ("dy", "w", "s"),
            "dw": ("dy", "x", "s"), "ds": ("dy", "x", "w")}


def sm_bound_ms(directions, m: int, n: int, k: int) -> tuple[float, str]:
    """Least time of one ``scaled_matmul`` launch computing ``directions``:
    the operands they read, each once, and their outputs written once
    (float32), against 2 M N K multiply-adds a direction and its scaling,
    over the card's float32 rate outside the tensor cores."""
    sizes = {"x": m * k, "w": n * k, "s": n, "dy": m * n}
    outputs = {"forward": m * n, "dx": m * k, "dw": n * k, "ds": n}
    extra = {"forward": m * n, "dx": m * n, "dw": n * k, "ds": 2 * m * n}
    reads = set().union(*(SM_READS[d] for d in directions))
    t_bytes = 4 * (sum(sizes[r] for r in reads) + sum(
        outputs[d] for d in directions)) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(2 * m * n * k + extra[d] for d in directions) / (
        F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_dims(direction: str, a, b) -> tuple[int, int, int]:
    """(M, N, K) of a direction's first two operands: x (M, K) and w (N, K)
    for the forward, else dy (M, N) and w (N, K) or x (M, K)."""
    if direction == "forward":
        return a.shape[0], b.shape[0], a.shape[1]
    return a.shape[0], a.shape[1], b.shape[1]


SM_PLAIN = {"forward": "scaled_matmul_plain", "dx": "dx_plain",
            "dw": "dw_plain", "ds": "ds_plain"}


def sm_err_bound(torch, direction: str, a, b, c):
    """The float32 error bound of kernel against plain, 2 (R + 2) u times
    the sum of the absolute products, computed in float64: R is the depth
    of the sums, K or M products, and M + K for ds, a sum over M of dy
    times a sum over K."""
    a, b, c = (t.double().abs() for t in (a, b, c))
    u = 2.0 ** -24
    if direction == "forward":       # x, w, s
        return 2 * (a.shape[1] + 2) * u * (a @ (b * c[:, None]).T)
    if direction == "dx":            # dy, w, s
        return 2 * (a.shape[1] + 2) * u * ((a * c) @ b)
    if direction == "dw":            # dy, x, s
        return 2 * (a.shape[0] + 2) * u * ((a * c).T @ b)
    return 2 * (a.shape[0] + b.shape[1] + 2) * u * torch.sum(
        a * (b @ c.T), dim=0)        # dy, x, w


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


def sm_kernel_phase(torch, sm) -> int:
    """Each direction of ``scaled_matmul`` against its plain version on
    random inputs at the main path's shapes (M = 32, 120, 960 against the
    (128, 128) and (10, 128) dense weights) and ragged ones, and the
    backward for every subset of its gradients there, each twice; returns
    the number of checks."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(m, n, 128) for m in (32, 120, 960) for n in (128, 10)] + [
        (1, 1, 1), (5, 3, 7), (33, 129, 130), (17, 16, 32), (70, 33, 65)]
    worst, checks = dict.fromkeys(sm.DIRECTIONS + ("backward",), 0.0), 0
    for m, n, k in shapes:
        x = torch.randn((m, k), generator=gen).cuda()
        w = (torch.randn((n, k), generator=gen) / math.sqrt(k)).cuda()
        s = (0.8 + 0.4 * torch.rand(n, generator=gen)).cuda()
        dy = torch.randn((m, n), generator=gen).cuda()
        for d, args in (("forward", (x, w, s)), ("dx", (dy, w, s)),
                        ("dw", (dy, x, s)), ("ds", (dy, x, w))):
            worst[d] = max(worst[d], sm_compare(torch, sm, d, *args)[1])
            checks += 1
        for flags in SM_SUBSETS:
            worst["backward"] = max(worst["backward"], sm_backward_check(
                torch, sm, dy, x, w, s, flags)[1])
            checks += 1
    print(f"kernel phase: {checks} scaled_matmul-vs-plain comparisons (4 "
          f"directions and the backward for {len(SM_SUBSETS)} subsets of "
          f"its gradients, twice to the same bits, at {len(shapes)} "
          f"shapes), within the float32 error bound; largest share of it "
          f"used: { {d: round(v, 4) for d, v in worst.items()} }")
    return checks


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


SM_LIBRARY = {   # one PyTorch call for each function, timed beside
    "forward": lambda torch, x, w, s: torch.mm(x, w.t()).mul_(s),
    "dx": lambda torch, dy, x, w, s: torch.mm(dy * s, w),
    "dw": lambda torch, dy, x, w, s: torch.mm(dy.t(), x).mul_(s[:, None]),
    "ds": lambda torch, dy, x, w, s: torch.mm(x, w.t()).mul_(dy).sum(0)}


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
        t = kernel_times(torch, lambda: sm.forward(x, w, s),
                         lambda: sm.scaled_matmul_plain(x, w, s))
        t["library_ms"] = time_ms(
            torch, lambda: SM_LIBRARY["forward"](torch, x, w, s))
        fwd.append(dict(shapes=[list(sa), list(sb)], mnk=[m, n, k],
                        max_abs_err=err, bound_share=share,
                        bound=sm_bound_ms(("forward",), m, n, k), **t))
        r = fwd[-1]
        print(f"  scaled_matmul forward {sa} x {sb} on the main path's "
              f"buffer: {err:.3g} off its plain version ({share:.3f} of "
              f"the float32 error bound); kernel {r['ms']:.4f} ms (whole "
              f"wrapper call {r['call_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, torch.mm and a multiply "
              f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms "
              f"({r['bound'][1]})")
    bwd = []
    plains = {"dx": lambda dy, x, w, s: sm.dx_plain(dy, w, s),
              "dw": lambda dy, x, w, s: sm.dw_plain(dy, x, s),
              "ds": lambda dy, x, w, s: sm.ds_plain(dy, x, w)}
    for (sdy, sw, flags), (dy, x, w, s, _) in captured["backward"].items():
        err, share = sm_backward_check(torch, sm, dy, x, w, s, flags)
        asked = [d for d, f in zip(SM_GRADS, flags) if f]
        m, n, k = dy.shape[0], dy.shape[1], w.shape[1]
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
                bound=sm_bound_ms((d,), m, n, k))
        bwd.append(dict(shapes=[list(sdy), list(sw)], mnk=[m, n, k],
                        grads=asked, max_abs_err=err, bound_share=share,
                        bound=sm_bound_ms(asked, m, n, k), alone=alone,
                        **t))
        r = bwd[-1]
        print(f"  scaled_matmul backward {'+'.join(asked)} dy {sdy}, w {sw} "
              f"on the main path's buffers: {err:.3g} off the plain "
              f"versions ({share:.3f} of the float32 error bound); one "
              f"launch {r['ms']:.4f} ms (whole wrapper call "
              f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"torch.mm calls {r['library_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.6f} ms ({r['bound'][1]}); alone: " + ", ".join(
                  f"{d} {a['ms']:.4f} ms (torch.mm {a['library_ms']:.4f})"
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


def bidi_records(torch, scenario, res, splits, rounds_out, clients) -> None:
    for rec in res.records:
        print(f"  {scenario} round {rec.round}: test_acc={rec.test_acc:.4f} "
              f"train_loss={rec.train_loss:.4f} up_bytes={rec.up_bytes} "
              f"down_bytes={rec.down_bytes} "
              f"sparsity={rec.update_sparsity:.4f} wall_s={rec.wall_s:.3f}")
        rounds_out.append([scenario, rec.round, rec.test_acc,
                           rec.train_loss, rec.up_bytes, rec.wall_s,
                           rec.down_bytes])
        if not (math.isfinite(rec.train_loss) and 0.0 <= rec.test_acc <= 1.0
                and rec.up_bytes > 0 and rec.down_bytes > 0):
            fail(f"{scenario}: bad round record {rec}")
        if len(rec.participants) != clients:
            fail(f"{scenario}: {len(rec.participants)} participants")
    check_server(torch, scenario, res.server)


def path_a(torch, la, sm, fl, fsfl, models, splits, rounds_out) -> dict:
    """Path A, the paper's bidirectional setting: 2 rounds of
    run_federated(bidirectional=True) with fsfl, then 1 round of
    bidi_sync_full; nnc-cabac on both legs, level_assign on both."""
    launches = {}
    for scenario, rounds in (("run_federated bidirectional", 2),
                             ("bidi_sync_full", 1)):
        cfg = fl.build_protocol(fl.get_scenario("bidi_sync_full"), rounds)
        la.reset_counters()
        sm.reset_counters()
        if scenario == "bidi_sync_full":
            res = fl.run_scenario(scenario, rounds=rounds,
                                  model=models.vgg11_thinned(),
                                  splits=splits, device="cuda")
        else:
            res = fsfl.run_federated(models.vgg11_thinned(), cfg, splits,
                                     rounds, bidirectional=True,
                                     device="cuda")
        torch.cuda.synchronize()
        count = la.LAUNCHES["level_assign"]
        check_sm(sm, scenario, splits.num_clients, rounds)
        bidi_records(torch, scenario, res, splits, rounds_out,
                     splits.num_clients)
        want = (splits.num_clients + 1) * rounds
        print(f"  {scenario} launches: level_assign {count} "
              f"({count / rounds:.0f} a round: one a client and one on "
              f"the downlink)")
        if count != want:
            fail(f"{scenario}: level_assign launched {count} times, "
                 f"expected {want}")
        launches[scenario] = count
    return launches


def fsfl_dyn_config(protocol_mod, rounds: int):
    """The reference's Fig. 4 setting (benchmarks/compression.py,
    ``fsfl_dyn``): Eqs. 2+3 thresholds, no fixed rate, error feedback,
    scaling."""
    return protocol_mod.ProtocolConfig(
        name="fsfl_dyn", method="sparse", delta=1.0, gamma=1.0,
        batch_size=32, local_lr=2e-3, error_feedback=True, scaling=True,
        scale_lr=2e-2, scale_subepochs=2, total_rounds=rounds)


def path_b(torch, rs, sm, sparsify_mod, protocol_mod, fsfl, models, splits,
           rounds_out):
    """Path B, the adaptive Eqs. 2+3 setting, bidirectional: 2 rounds of
    run_federated(bidirectional=True) with fsfl_dyn; row_stats once per
    client and on the downlink, each launch over the 10 weight views.
    Returns (launches, the first client's captured row_stats views)."""
    rounds = 2
    captured = capture_calls(sparsify_mod, "row_stats_leaves", 1,
                             lambda a, k: [w.clone() for w in a[0]])
    rs.reset_counters()
    sm.reset_counters()
    res = fsfl.run_federated(models.vgg11_thinned(),
                             fsfl_dyn_config(protocol_mod, rounds), splits,
                             rounds, bidirectional=True, device="cuda")
    torch.cuda.synchronize()
    count = rs.LAUNCHES["row_stats"]
    check_sm(sm, "fsfl_dyn bidirectional", splits.num_clients, rounds)
    sparsify_mod.row_stats_leaves = rs.row_stats_leaves
    bidi_records(torch, "fsfl_dyn bidirectional", res, splits, rounds_out,
                 splits.num_clients)
    want = (splits.num_clients + 1) * rounds
    print(f"  fsfl_dyn bidirectional launches: row_stats {count} "
          f"({count / rounds:.0f} a round: one per client and one on the "
          f"downlink, each over {VGG_WEIGHTS} weight views)")
    if count != want:
        fail(f"fsfl_dyn: row_stats launched {count} times, expected {want}")
    return count, captured


def path_c(torch, da, dc, la, sm, fl, rounds_mod, codecs_mod, models,
           splits, rounds_out):
    """Path C, the int8 broadcast: cohorts of 4, int8-blockscale on both
    legs; the server's params after each apply are held bitwise against
    the host decode of the broadcast payload plus the old params.
    Returns (delta_apply launches, the first downlink's captured residual
    and apply calls, checked leaves)."""
    from repro_torch.tree import items, sorted_items
    rounds = 2
    captured = capture_calls(rounds_mod, "delta_apply_leaves", 2,
                             lambda a, k: tuple([x.clone() for x in col]
                                                for col in a[:3]) + (a[3],))
    payloads = []
    orig_sections = codecs_mod.Int8BlockScaleCodec.device_sections

    def device_sections(self, payload, spec, device):
        payloads.append((payload, spec))
        return orig_sections(self, payload, spec, device)

    applied = []
    orig_apply = rounds_mod.Broadcast.apply

    def apply(self, params):
        out = orig_apply(self, params)
        if self.int8 is not None:
            applied.append(({k: v.cpu() for k, v in items(params)},
                            {k: v.cpu() for k, v in items(out)}))
        return out

    codecs_mod.Int8BlockScaleCodec.device_sections = device_sections
    rounds_mod.Broadcast.apply = apply
    for mod in (da, dc, la, sm):
        mod.reset_counters()
    res = fl.run_simulation(
        models.vgg11_thinned(),
        fl.build_protocol(fl.get_scenario("codec_int8_k4"), rounds), splits,
        rounds, engine=fl.EngineConfig(
            sampling=fl.SamplingConfig(cohort_size=4),
            codec="int8-blockscale", bidirectional=True), device="cuda")
    torch.cuda.synchronize()
    counts = {"delta_apply": da.LAUNCHES["delta_apply"],
              **dc.LAUNCHES, "level_assign": la.LAUNCHES["level_assign"]}
    check_sm(sm, "int8 bidirectional k4", 4, rounds)
    codecs_mod.Int8BlockScaleCodec.device_sections = orig_sections
    rounds_mod.Broadcast.apply = orig_apply
    rounds_mod.delta_apply_leaves = da.delta_apply_leaves
    bidi_records(torch, "int8 bidirectional k4", res, splits, rounds_out, 4)
    for rec in res.records:
        if rec.up_bytes != 4 * PAYLOAD_BYTES:
            fail(f"int8 bidirectional: up_bytes {rec.up_bytes}")
        if rec.down_bytes != 4 * DOWN_PAYLOAD_BYTES:
            fail(f"int8 bidirectional: down_bytes {rec.down_bytes} != "
                 f"{4 * DOWN_PAYLOAD_BYTES}")
    print(f"  int8 bidirectional k4 launches: {counts}")
    want = {"delta_apply": 2 * rounds, "delta_compress":
            5 * rounds, "delta_compress_batch": 0,
            "level_assign": 5 * rounds}
    if counts != want:
        fail(f"int8 bidirectional: launches {counts}, expected {want}")
    if len(applied) != rounds or len(payloads) != rounds:
        fail(f"int8 bidirectional: {len(applied)} applies and "
             f"{len(payloads)} broadcast payloads in {rounds} rounds")
    checked = 0
    for (before, after), (payload, spec) in zip(applied, payloads):
        decoded = dict(sorted_items(codecs_mod.Int8BlockScaleCodec()
                                    ._decode_body(payload, spec).params))
        for path, w in before.items():
            want_np = w.numpy() + decoded[path]
            if not (after[path].numpy().view("int32")
                    == want_np.view("int32")).all():
                fail(f"int8 bidirectional: server param {path} is not the "
                     f"host decode plus add")
            checked += 1
    print(f"  int8 bidirectional: the server's params after {rounds} "
          f"applies bitwise equal to the host decode plus add "
          f"({checked} leaves)")
    return counts["delta_apply"], captured, checked


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
    if count != 4 * rounds:
        fail(f"{label}: level_assign launched {count} times, expected "
             f"{4 * rounds}")
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
            "level_assign": 4 * rounds}
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
    if la.LAUNCHES["level_assign"] != splits.num_clients:
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


def repeat_small_runs(torch, fl, rounds_mod, name: str):
    """Two runs of scenario ``name`` on the tiny VGG on the card, with the
    algorithms the port selects (no context of this script's around them):
    every payload put on the wire, up and down, and the server's params,
    scales and BN state must be equal bit for bit.  Returns (report,
    failures)."""
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
            res = record_small_run(torch, fl, rounds_mod, name, "cuda")[0]
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
    report = {"payloads": len(pay_a), "payload_bytes": sum(map(len, pay_a)),
              "bytes": bytes_a, "server_leaves": len(state_a),
              "cudnn_deterministic": torch.backends.cudnn.deterministic,
              "cudnn_benchmark": torch.backends.cudnn.benchmark}
    return report, failures


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
    la_launches = nnc_slice_phase(torch, la, sm, fl, fsfl, models, splits,
                                  rounds_out, cohorts)
    codecs_mod.NncCabacCodec.encode_cohort = orig_cohort
    stages_mod.level_assign_leaves = la.level_assign_leaves
    for d, fn in sm_originals.items():
        setattr(sm, d, fn)
    t1 = phase("nnc slice phase", t1)

    # the int8 uplink
    captured, original = capture_encodes(torch, device_mod)
    launches = int8_slice_phase(torch, dc, la, sm, fl, models, splits,
                                rounds_out)
    device_mod.int8_encode_leaves = original
    t1 = phase("int8 slice phase", t1)

    # slice 3: bidirectional compression (paths A, B and C)
    a_launches = path_a(torch, la, sm, fl, fsfl, models, splits, rounds_out)
    t1 = phase("path A (bidirectional, nnc-cabac)", t1)
    rs_launches, rs_captured = path_b(torch, rs, sm, sparsify_mod,
                                      protocol_mod, fsfl, models, splits,
                                      rounds_out)
    t1 = phase("path B (bidirectional, fsfl_dyn)", t1)
    da_launches, da_captured, c_checked = path_c(
        torch, da, dc, la, sm, fl, rounds_mod, codecs_mod, models, splits,
        rounds_out)
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

    timings = main_path_kernels(torch, dc, device_mod, captured)
    la_timing = la_main_path(torch, la, la_captured)
    da_timing = da_main_path(torch, da, da_captured)
    rs_timing = rs_main_path(torch, rs, rs_captured)
    sm_timing = sm_main_path(torch, sm, sm_captured)
    t1 = phase("main-path buffers", t1)
    cpu_runs = {}
    small = {name: small_input_check(torch, fl, rounds_mod, name, cpu_runs)
             for name in SMALL_SCENARIOS}
    t1 = phase("small-input checks", t1)
    repeat, failures = repeat_small_runs(torch, fl, rounds_mod,
                                         "bidi_sync_full")
    print(f"repeatability bidi_sync_full: two card runs, {repeat}")
    if failures:
        fail("; ".join(failures))
    t1 = phase("repeatability", t1)
    bidi_int8 = fl.Scenario("bidi_int8_k4", cohort_size=4,
                            codec="int8-blockscale", bidirectional=True)
    prof = {
        "bidi_int8_k4": profile_round(
            torch, lambda: fl.run_scenario(
                bidi_int8, rounds=1, model=models.vgg11_thinned(),
                splits=splits, device="cuda"),
            "bidi_int8_k4 (path C)", ("delta_apply", "int8_encode")),
        "bidi_sync_full": profile_round(
            torch, lambda: fl.run_scenario(
                "bidi_sync_full", rounds=1, model=models.vgg11_thinned(),
                splits=splits, device="cuda"),
            "bidi_sync_full (path A, device activity only)",
            ("level_assign",),
            host=False),
        "fsfl_dyn_bidirectional": profile_round(
            torch, lambda: fsfl.run_federated(
                models.vgg11_thinned(), fsfl_dyn_config(protocol_mod, 1),
                splits, 1, bidirectional=True, device="cuda"),
            "fsfl_dyn bidirectional (path B, device activity only)",
            ("row_stats",), host=False)}
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
        "leaves": VGG_LEAVES, "elements": la_timing["elements"],
        "per_leaf_launches_ms": la_timing["per_leaf_ms"],
        "per_leaf_launches_call_ms": la_timing["per_leaf_call_ms"],
        "launches_bidirectional_path_a":
            a_launches["run_federated bidirectional"],
        "launches_path_d": d_out["level_assign"],
        "launches_path_e": e_out["launches"]["level_assign"]})
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
        "per_leaf_launches_call_ms": da_timing["per_leaf_call_ms"]})
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
        "keep_mask_near_tie_flips": rs_timing["flips"]})
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
        "mnk": first["mnk"],
        "main_path_shapes": [{k: r[k] for k in (
            "shapes", "mnk", "ms", "plain_ms", "library_ms", "call_ms",
            "bound")} for r in fwd],
        "launches_per_path": {label: r["forward"]
                              for label, r in runs.items()}})
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
        "mnk": first["mnk"], "grads": first["grads"],
        "main_path_calls": [{k: r[k] for k in (
            "shapes", "mnk", "grads", "ms", "plain_ms", "library_ms",
            "call_ms", "bound", "alone")} for r in bwd],
        "launches_per_path": {label: r["backward"]
                              for label, r in runs.items()}})
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
        "bnwire_v2_full": bn_out, "repeatability_bidi_sync_full": repeat,
        "small_input_card_vs_cpu": small, "profiled_rounds": prof}}))
    print(json.dumps({"kernels": kernels}))
    print(f"device: {dev}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
