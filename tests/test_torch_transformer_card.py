"""The transformer family on the card: each reduced architecture's
``forward_full`` on CUDA against the CPU on the same params (within 1e-4
of the largest magnitude, tokens equal but at ties), and the full-width
prefill-against-replay check of gemma2-2b at a short replay, and
``obs.trace.device_trace`` on two operations.  Marked
``gpu``; they skip where no CUDA device is visible (this file imports no
JAX, so it runs on a machine without it)."""
import pytest
import torch

from repro_torch.configs import all_configs, get
from repro_torch.launch import arch_check


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's half of a card "
                    "against CPU comparison)")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_reduced_card_against_cpu(arch, cuda):
    rec = arch_check.card_vs_cpu(arch)
    assert rec["hidden_gap"] <= arch_check.TOL and rec["misses"] == 0


@pytest.mark.gpu
def test_full_width_gemma2_prefill_against_replay(cuda):
    rec = arch_check.full_width_check(get("gemma2-2b"), 1, 1024, 512)
    assert rec["logit_gap"] <= arch_check.FULL_TOL and rec["misses"] == 0


@pytest.mark.gpu
def test_device_trace_keeps_every_record_of_a_whole_session(cuda):
    """``obs.trace.device_trace`` on two operations (a kernel and a copy):
    a session it calls whole holds both."""
    from repro_torch.obs.trace import device_trace
    x = torch.ones(1 << 20, device="cuda")
    rows, _, _, whole = device_trace(lambda: x.add_(1).cpu())
    assert whole and sum(e.count for e in rows) == 2
