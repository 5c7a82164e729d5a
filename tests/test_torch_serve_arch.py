"""``serve --arch``: the port's serve loop fed the reference's params and
prompts gives the reference loop's tokens (``repro.launch.serve``: batched
prefill, then greedy ``decode_step``s) for a dense, an ssm and a hybrid
architecture; the launcher runs every registered id on the CPU, prints one
``seq`` line a sequence, traces its spans, and without ``--device`` asks
for CUDA.

Token rule: equal to the reference's, except that the first parting may
fall at a tie (the reference's top two logits within 2e-5 of their
largest magnitude, the CPU parity bound of ``test_torch_decode.py``); the
sequences are not compared past it, and at most one such tie is allowed
a run.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_configs, make_inputs
from repro.models import decode as rd
from repro.models import transformer as rt
from repro.models.common import UNSHARDED as R_CTX
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.launch.arch_check import token_misses

STEPS, BATCH, PROMPT = 6, 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_serve(cfg):
    """``repro.launch.serve``'s loop (lines 51-74) -> params, extras,
    prompts, tokens and, per step, the logits its tokens came from."""
    params = rt.init_params(jax.random.PRNGKey(0), cfg, rt.SINGLE)
    extras = {}
    if cfg.family == "encdec":
        extras["enc_embeds"] = make_inputs(jax.random.PRNGKey(1), cfg, BATCH,
                                           PROMPT)["enc_embeds"]
    prompts = jax.random.randint(jax.random.PRNGKey(2), (BATCH, PROMPT), 0,
                                 cfg.vocab)
    logits = []
    orig = rt.greedy_token

    def recording(x, p, cfg_, ctx):
        head = p.get("lm_head", p["embed"])
        logits.append(np.asarray(rt.common.softcap(
            (x @ head.T).astype(np.float32), cfg_.final_softcap)))
        return orig(x, p, cfg_, ctx)

    rt.greedy_token = recording
    try:
        nxt, cache = rd.prefill(params, prompts, cfg, rt.SINGLE, R_CTX,
                                PROMPT + STEPS, **extras)
        toks = [nxt]
        for _ in range(STEPS - 1):
            nxt, cache = rd.decode_step(params, cache, nxt, cfg, rt.SINGLE,
                                        R_CTX)
            toks.append(nxt)
    finally:
        rt.greedy_token = orig
    return params, extras, prompts, toks, logits


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_serve_loop_matches_the_reference(arch):
    cfg_r, cfg_p = all_configs()[arch].reduced(), pconfigs.get(arch).reduced()
    params, extras, prompts, toks, logits = reference_serve(cfg_r)
    pp = convert.transformer_params(jax.tree.map(np.asarray, params), cfg_p)
    got = serve.serve_tokens(cfg_p, pp, torch.as_tensor(np.array(prompts)),
                             STEPS, {k: torch.as_tensor(np.array(v))
                                     for k, v in extras.items()})
    assert len(got) == STEPS
    for i, (r, g) in enumerate(zip(toks, got)):
        ties, misses = token_misses(logits[i], r, g, 2e-5)
        assert not misses, (i, misses)
        if ties:
            assert len(ties) == 1, ties
            break


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_serve_arch_runs_on_the_cpu(arch, capsys):
    lines = serve.main(["--arch", arch, "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out == lines and len(lines) == 2
    vocab = pconfigs.get(arch).reduced().padded_vocab(1)
    for b, line in enumerate(lines):
        head, toks = line.split(":", 1)
        toks = json.loads(toks)
        assert head == f"seq{b}" and len(toks) == 3
        assert all(0 <= x < vocab for x in toks)


def test_serve_arch_is_the_same_on_every_run(capsys):
    args = ["--arch", "qwen2-vl-72b", "--steps", "4", "--device", "cpu"]
    assert serve.main(args) == serve.main(args)


def test_serve_arch_defaults_to_cuda(capsys):
    if torch.cuda.is_available():
        assert len(serve.main(["--arch", "gemma2-2b", "--steps", "2"])) == 2
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "gemma2-2b", "--steps", "2"])


def test_serve_arch_trace_out(tmp_path, capsys):
    path = tmp_path / "serve.trace.json"
    serve.main(["--arch", "mamba2-370m", "--steps", "3", "--device", "cpu",
                "--trace-out", str(path)])
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"]
    assert names.count("serve.prefill") == 1
    assert names.count("serve.decode_step") == 2
    assert "trace:" in capsys.readouterr().out


@pytest.mark.parametrize("arch,S,S0", [("gemma2-2b", 256, 128),
                                       ("mamba2-370m", 256, 128),
                                       ("recurrentgemma-9b", 256, 128),
                                       ("whisper-small", 256, 128)])
def test_card_phase_rehearsal_on_the_cpu(arch, S, S0):
    """``chip_smoke.py``'s transformer phase at reduced size on the CPU:
    prefill(S) against prefill(S0) and a replay of S - S0 decode steps
    past the reduced window (64), and the card-against-CPU comparison with
    the CPU on both sides."""
    from repro_torch.launch import arch_check
    rec = arch_check.full_width_check(pconfigs.get(arch).reduced(), 1, S, S0,
                                      device="cpu")
    assert rec["logit_gap"] <= arch_check.FULL_TOL and rec["misses"] == 0
    assert rec["replay_steps"] == S - S0 and rec["peak_bytes"] is None
    assert arch_check.card_vs_cpu(arch, device="cpu")["hidden_gap"] == 0.0
