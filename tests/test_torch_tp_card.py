"""Transformer tensor parallelism on the card: jobs of two and four
workers sharing one CUDA device (gloo, host-staged collectives), at
reduced size, each case run on the CPU and then on the card in the same
workers on the same shards, the card held to the CPU (within 1e-4 of the
largest magnitude, the greedy steps fed the CPU run's tokens, tokens
equal but at ties of the CPU's logits), every rank's replicated outputs
the same bits.  Marked ``gpu``; they skip where no CUDA device is visible
(this file imports no JAX).  One unmarked test rehearses the card
phase's driver on the CPU."""
import pytest
import torch

from repro_torch.launch import tp_check


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's half of a card "
                    "against CPU comparison)")


def _case(arch, over=None):
    return {"name": arch, "arch": arch, "reduced": True, "over": over or {},
            "seq": 32, "feed": 8, "greedy": 8, "batch_size": 2, "seed": 0,
            "draw": "cpu", "runs": ["cpu", "cuda"], "force_first": True,
            "keep_logits": True}


TP2 = ["gemma2-2b", "whisper-small", "recurrentgemma-9b", "mamba2-370m",
       "mixtral-8x22b", "qwen2-vl-72b"]
TP4 = [("gemma2-2b", {}), ("recurrentgemma-9b", {}),
       ("mixtral-8x22b", {"moe_impl": "ep_a2a"})]


def _held(cases, tp):
    results = tp_check.spawn_job(cases, tp)
    for case in cases:
        tp_check.ranks_agree(results, case["name"])
        cpu, card = results[0][case["name"]]
        rec = tp_check.hold(cpu, card, tp_check.CARD_TOL,
                            f"{case['name']} tp {tp}")
        assert rec["misses"] == 0


@pytest.mark.gpu
def test_two_workers_on_the_card_against_the_cpu(cuda):
    _held([_case(a) for a in TP2], 2)


@pytest.mark.gpu
def test_four_workers_on_the_card_against_the_cpu(cuda):
    _held([_case(a, over) for a, over in TP4], 4)


def test_card_phase_rules_rehearsed_on_the_cpu(one_thread):
    """``tp_check.run_tp_cases``, the card phase's driver, on the CPU at
    reduced size: one case of each yardstick (against tp = 1 with the
    greedy steps forced from it, against the CPU run of the same
    workers, and two runs bit for bit), each rank agreeing, with the
    readings the phase prints."""
    base = {"seq": 16, "feed": 16, "greedy": 4, "seed": 0, "reduced": True}
    cases = [dict(base, name="gemma2-2b", arch="gemma2-2b", runs=["cuda"],
                  against="tp1"),
             dict(base, name="recurrentgemma-9b", arch="recurrentgemma-9b",
                  runs=["cpu", "cuda"], draw="cpu", force_first=True,
                  keep_logits=True, against="cpu"),
             dict(base, name="mamba2-370m", arch="mamba2-370m",
                  runs=["cuda", "cuda"], against="repeat")]
    recs = tp_check.run_tp_cases(cases, 2, "CPU rehearsal", device="cpu")
    assert [r["name"] for r in recs] == [c["name"] for c in cases]
    assert recs[0]["misses"] == recs[1]["misses"] == 0
    assert recs[2]["repeat"] == "bit for bit"
    assert recs[0]["collectives_per_token"] == 7       # 1 + 2 x 2 + 2
    assert all(r["tp1_ms_per_token"] for r in (recs[0], recs[2]))
