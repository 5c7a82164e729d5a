"""Serving launcher.  Port of ``repro.launch.serve``.

Two front doors share this entry point:

* **FL ingest server** (default, no ``--arch``): every argument goes to
  ``repro_torch.launch.ingest_serve``, the decode-and-accumulate uplink
  pipeline serving a cohort of encoded payloads (payloads/s and MB/s).

      PYTHONPATH=src python -m repro_torch.launch.serve --k 32 --device cpu

* **Transformer prefill and decode** (``--arch <id>``): the reduced config
  of any registered architecture, random weights from seed 0, a batched
  prefill, then greedy decode steps; one ``seq{b}:`` line a sequence.

      PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
          --steps 8 [--batch 2] [--prompt-len 16] [--device cuda|cpu] \\
          [--trace-out FILE]

  ``--trace-out`` writes the ``serve.prefill`` and ``serve.decode_step``
  spans as Chrome trace-event JSON (https://ui.perfetto.dev opens it).
  ``--device`` defaults to ``cuda`` and raises without a GPU.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import obs
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import resolve_device


def serve_tokens(cfg, params, prompts, steps: int, extras=None) -> list:
    """Batched prefill of ``prompts`` (B, S), then ``steps - 1`` greedy
    decode steps -> ``steps`` token tensors (B,), the reference's loop
    (``repro.launch.serve``).  Runs where ``params`` and ``prompts`` live;
    the cache holds ``S + steps`` positions."""
    from repro_torch.models import decode as decode_lib
    from repro_torch.models.common import UNSHARDED
    from repro_torch.models.transformer import SINGLE

    extras = extras or {}
    B, S = prompts.shape
    with torch.inference_mode():
        with obs_trace.span("serve.prefill", arch=cfg.name, batch=B,
                            prompt_len=S):
            nxt, cache = decode_lib.prefill(params, prompts, cfg, SINGLE,
                                            UNSHARDED, S + steps, **extras)
        toks = [nxt]
        for i in range(steps - 1):
            with obs_trace.span("serve.decode_step", step=i):
                nxt, cache = decode_lib.decode_step(params, cache, nxt, cfg,
                                                    SINGLE, UNSHARDED)
            toks.append(nxt)
    return toks


def arch_setting(arch: str, batch: int, prompt_len: int, device):
    """The reduced config, its params (seed 0), extras (seed 1) and
    prompts (seed 2), drawn on the CPU and moved to ``device``, so one
    setting is the same on every device."""
    from repro_torch.configs import get, make_inputs
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    cfg = get(arch).reduced()

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    params = tree_map(lambda t: t.to(device),
                      transformer.init_params(gen(0), cfg))
    extras = {}
    if cfg.family == "encdec":
        extras["enc_embeds"] = make_inputs(
            gen(1), cfg, batch, prompt_len)["enc_embeds"].to(device)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=gen(2), dtype=torch.int32).to(device)
    return cfg, params, extras, prompts


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not any(a == "--arch" or a.startswith("--arch=") for a in argv):
        from repro_torch.launch import ingest_serve
        return ingest_serve.main(argv)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--trace-out", default=None,
                    help="write prefill/decode spans as Chrome trace-event "
                         "JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tel = obs.make_telemetry("trace" if args.trace_out else "off")
    cfg, params, extras, prompts = arch_setting(args.arch, args.batch,
                                                args.prompt_len, dev)
    with tel.activate():
        toks = serve_tokens(cfg, params, prompts, args.steps, extras)
    lines = [f"seq{b}: {[int(t[b]) for t in toks]}"
             for b in range(args.batch)]
    for line in lines:
        print(line)
    if args.trace_out:
        n = tel.export_chrome_trace(args.trace_out)
        print(f"trace: {args.trace_out} ({n} events)")
    return lines


if __name__ == "__main__":
    main()
