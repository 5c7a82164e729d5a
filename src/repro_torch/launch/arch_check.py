"""Checks of the transformer family's serving path, shared by the tests and
``chip_smoke.py``'s transformer phase.

The comparison rules:

* floating tensors (hidden states, logits, caches, recurrent states) hold
  within ``TOL`` of the reference tensor's largest magnitude
  (:func:`rel_gap`);
* a greedy token may differ only where the reference's top two logits at
  that position lie within that bound of each other (a tie); such
  positions are counted apart (:func:`token_misses`).
"""
from __future__ import annotations

import contextlib
import io
import time

import numpy as np
import torch

from repro_torch.configs import all_configs, get, make_inputs
from repro_torch.launch import serve
from repro_torch.models import decode, frontend, transformer
from repro_torch.models.common import UNSHARDED
from repro_torch.models.transformer import SINGLE
from repro_torch.obs.trace import device_trace
from repro_torch.tree import leaves, tree_map

TOL = 1e-4          # card against CPU, of the largest |x| (the CPU parity
                    # tests hold the reference to a tighter 2e-5)


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def rel_gap(ref, got) -> float:
    """max |ref - got| over max |ref| (0 for two zero tensors)."""
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    diff = float(np.max(np.abs(ref - got))) if ref.size else 0.0
    return diff / scale if scale > 0 else diff


def token_misses(ref_logits, ref_tokens, got_tokens,
                 tol: float = TOL) -> tuple[list, list]:
    """Positions where ``got_tokens`` parts from ``ref_tokens`` ->
    ``(ties, misses)``: a tie is a position whose reference top-two
    logits lie within ``tol`` of the logits' largest magnitude; every
    other parting is a miss.  ``ref_logits`` (..., V), tokens (...)."""
    lg = _np(ref_logits)
    ref_t = np.asarray(_np(ref_tokens), np.int64)
    got_t = np.asarray(_np(got_tokens), np.int64)
    bound = tol * float(np.max(np.abs(lg)))
    top2 = np.sort(lg, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    ties, misses = [], []
    for idx in zip(*np.nonzero(ref_t != got_t)):
        (ties if gap[idx] <= bound else misses).append(
            (tuple(int(i) for i in idx), int(ref_t[idx]), int(got_t[idx]),
             float(gap[idx])))
    return ties, misses


# ------------------------------------------------------------ on the card

FULL_TOL = 1e-3     # full-width prefill against replay, of the largest |x|

# full-width runs: (arch, batch, S, S0); S and S0 are multiples of the
# prefill chunk (512 for attention, 128 for SSD).  gemma2-2b's replay
# crosses its 4096-token window, recurrentgemma-9b's its 2048 window and
# runs its 2 tail layers, whisper-small runs its 1536-frame encoder.
FULL_WIDTH = (("gemma2-2b", 1, 4608, 4096),
              ("mamba2-370m", 1, 1024, 768),
              ("recurrentgemma-9b", 1, 2560, 2048),
              ("whisper-small", 1, 1024, 512))


def _timed(fn, device: str = "cuda"):
    """(fn's result, its ms between two CUDA events; on the CPU, where a
    rehearsal runs, the host clock's)."""
    if device == "cpu":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def card_vs_cpu(arch: str, device: str = "cuda") -> dict:
    """The reduced config at batch 2, seq 64 (params drawn on the CPU)
    through ``forward_full`` on the CPU and on the card: the card's final
    hidden states within ``TOL`` of the CPU's, its greedy tokens at every
    position the CPU's but at ties.  Raises where they part."""
    cfg = get(arch).reduced()
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    batch_d = make_inputs(torch.Generator().manual_seed(1), cfg, 2, 64)
    keys = ("enc_embeds", "patch_embeds", "patch_positions",
            "mrope_positions")
    out = {}
    for dev in ("cpu", device):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch_d.items()}
        with torch.inference_mode():
            x, _, _ = transformer.forward_full(
                p, b["tokens"], cfg, SINGLE, UNSHARDED,
                **{k: b.get(k) for k in keys})
            logits = transformer.head_logits(x, p, cfg)
        out[dev] = (x.cpu(), logits.cpu(), torch.argmax(logits, -1).cpu())
    gap = rel_gap(out["cpu"][0], out[device][0])
    logit_gap = rel_gap(out["cpu"][1], out[device][1])
    ties, misses = token_misses(out["cpu"][1], out["cpu"][2], out[device][2])
    rec = {"hidden_gap": gap, "logit_gap": logit_gap, "ties": len(ties),
           "misses": len(misses), "positions": int(out["cpu"][2].numel())}
    if gap > TOL or logit_gap > TOL or misses or len(ties) > 1:
        raise AssertionError(f"{arch} reduced, card against CPU: {rec}")
    return rec


def full_width_check(cfg, batch: int, S: int, S0: int,
                     device: str = "cuda") -> dict:
    """A config drawn on the card: ``prefill(S)``'s last-position
    logits and greedy token against ``prefill(S0)`` then ``decode_step``
    over tokens S0..S-1 (teacher-forced), within ``FULL_TOL``; with the
    prefill and per-token decode times (CUDA events), the peak memory and
    one profiled decode step's launches and device-busy share."""
    on_card = device != "cpu"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    gen = torch.Generator(device=device).manual_seed(0)
    params = transformer.init_params(gen, cfg)
    n_params = sum(t.numel() for t in leaves(params))
    tokens = torch.randint(0, cfg.vocab, (batch, S), generator=gen,
                           device=device, dtype=torch.int32)
    extras = {}
    if cfg.family == "encdec":
        extras["enc_embeds"] = frontend.audio_embeds(
            gen, batch, cfg.encoder_ctx, cfg.d_model, cfg.dtype)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.time() - t0

    with torch.inference_mode():
        (x0, cache), s0_ms = _timed(lambda: decode.prefill_hidden(
            params, tokens[:, :S0], cfg, SINGLE, UNSHARDED, S, **extras),
            device)
        del x0
        (xs, _), prefill_ms = _timed(lambda: decode.prefill_hidden(
            params, tokens, cfg, SINGLE, UNSHARDED, S, **extras), device)
        want = transformer.head_logits(xs[:, -1], params, cfg)
        del xs

        def replay():
            c = cache
            for i in range(S0, S):
                x, c = decode.decode_hidden(params, c, tokens[:, i], cfg,
                                            SINGLE, UNSHARDED)
            return x, c

        (x, cache), replay_ms = _timed(replay, device)
        got = transformer.head_logits(x, params, cfg)
        busy_ms = launches = step_ms = whole = None
        if on_card:
            # one more step under the profiler: launches, busy share
            busy_ms, launches, step_ms, whole = _profiled_step(
                lambda: decode.decode_hidden(
                    params, cache, torch.argmax(got, -1), cfg, SINGLE,
                    UNSHARDED))
    peak = torch.cuda.max_memory_allocated() if on_card else None

    logit_gap = rel_gap(want, got)
    t_want = torch.argmax(want, -1)
    ties, misses = token_misses(want, t_want, torch.argmax(got, -1),
                                FULL_TOL)
    rec = {"arch": cfg.name, "params": n_params, "batch": batch, "S": S,
           "S0": S0, "init_s": init_s, "prefill_ms": prefill_ms,
           "prefill_s0_ms": s0_ms, "decode_ms_per_token":
               replay_ms / (S - S0), "replay_steps": S - S0,
           "peak_bytes": peak, "logit_gap": logit_gap,
           "token": t_want.tolist(), "ties": len(ties),
           "misses": len(misses), "profiled_step_ms": step_ms,
           "launches_per_token": launches, "busy_ms": busy_ms,
           "trace_whole": whole,
           "busy_share": busy_ms / step_ms if on_card else None}
    del params, cache, x, got, want
    if on_card:
        torch.cuda.empty_cache()
    if logit_gap > FULL_TOL or misses:
        raise AssertionError(f"{cfg.name}, prefill against replay: {rec}")
    return rec


def _profiled_step(step):
    """(device-busy ms, device operations, wall ms, whole) of one
    ``step`` under ``torch.profiler`` (``obs.trace.device_trace``, three
    sessions at most: ``whole`` is false where each dropped records, and
    the readings are then lower bounds; raises where none kept any)."""
    rows, wall_ms, _, whole = device_trace(step, tries=3, need_all=False)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in rows if dev_us(e) > 0]
    return (sum(dev_us(e) for e in events) / 1e3,
            sum(e.count for e in events), wall_ms, whole)


def transformer_phase(device_line: str) -> dict:
    """``chip_smoke.py``'s transformer phase: ``serve --arch`` on the card
    for every registered id, each reduced config card against CPU, and the
    full-width prefill-against-replay runs with their readings, each
    printed beside the card's name and power limit.  Raises on any
    failed check; launches none of the port's CUDA kernels."""
    out = {"serve": {}, "card_vs_cpu": {}, "full_width": []}
    for arch in all_configs():
        with contextlib.redirect_stdout(io.StringIO()):
            lines = serve.main(["--arch", arch, "--steps", "8",
                                "--device", "cuda"])
        out["serve"][arch] = lines
        print(f"transformer serve --arch {arch} --device cuda: "
              f"{' '.join(lines)}")
    for arch in all_configs():
        rec = card_vs_cpu(arch)
        out["card_vs_cpu"][arch] = rec
        print(f"transformer {arch} reduced, card against CPU: hidden "
              f"{rec['hidden_gap']:.3g}, logits {rec['logit_gap']:.3g} of "
              f"the largest, tokens {rec['positions'] - rec['ties']}/"
              f"{rec['positions']} equal, {rec['ties']} at ties")
    for arch, batch, S, S0 in FULL_WIDTH:
        rec = full_width_check(get(arch), batch, S, S0)
        out["full_width"].append(rec)
        busy = (f"{rec['launches_per_token']} launches/token, device busy "
                f"{100 * rec['busy_share']:.1f}% of "
                f"{rec['profiled_step_ms']:.2f} ms"
                + ("" if rec["trace_whole"] else
                   " (lower bounds: the profiler dropped records)"))
        print(f"transformer {arch} full width ({rec['params'] / 1e9:.3f} B "
              f"params, batch {batch}): prefill(S={S}) "
              f"{rec['prefill_ms']:.1f} ms, decode "
              f"{rec['decode_ms_per_token']:.3f} ms/token over "
              f"{S - S0} replayed tokens, peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB, {busy}; prefill "
              f"against replay {rec['logit_gap']:.3g} of the largest logit, "
              f"token {rec['token']} ({rec['ties']} at ties) "
              f"[{device_line}]")
    return out
