"""FSFL host orchestration: the paper's main path.

Port of ``repro.core.fsfl``.  ``run_federated`` configures the engine for
full participation, a FedAvg server with lr 1, the sync scheduler and wire
schema v1 with the ``"auto"`` codec (nnc-cabac for quantizing protocols),
and runs ``rounds`` rounds.  The clients train as one cohort, in one
batched call a round (the vmap executor, the engine's default).
With ``bidirectional`` the server's update is compressed for the broadcast
too (§5.2), quantized with ``down_step_size``.
"""
from __future__ import annotations

from repro_torch.core import quant as quant_lib
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.data.federated import FederatedSplits
from repro_torch.fl.engine import (EngineConfig, RoundRecord,  # noqa: F401
                                   RunResult, measure_update_bytes,
                                   run_simulation)
from repro_torch.fl.sampling import SamplingConfig
from repro_torch.fl.server_opt import ServerOptConfig
from repro_torch.models.cnn import CNNModel

__all__ = ["RoundRecord", "RunResult", "measure_update_bytes",
           "run_federated"]


def run_federated(model: CNNModel, cfg: ProtocolConfig,
                  splits: FederatedSplits, rounds: int, *, seed: int = 42,
                  measure_bytes: bool = True, bidirectional: bool = False,
                  down_step_size: float = quant_lib.STEP_SIZE_BI,
                  init_state=None, plan=None, device=None,
                  verbose: bool = False) -> RunResult:
    """All clients, FedAvg server, sync rounds, on ``device`` (CUDA unless
    ``"cpu"`` is asked for).  ``seed`` draws the initial state and batch
    orders; ``init_state``/``plan`` fix them instead (see
    ``repro_torch.fl.engine.FederatedEngine``)."""
    engine = EngineConfig(
        sampling=SamplingConfig(cohort_size=None),
        server_opt=ServerOptConfig(name="fedavg", lr=1.0),
        mode="sync",
        bidirectional=bidirectional,
        down_step_size=down_step_size,
        measure_bytes=measure_bytes)
    return run_simulation(model, cfg, splits, rounds, seed=seed,
                          engine=engine, init_state=init_state, plan=plan,
                          device=device, verbose=verbose)
