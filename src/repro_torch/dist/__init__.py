"""``repro_torch.dist``: the multi-process federated runtime.

Port of ``repro.dist`` on ``torch.distributed``: a :class:`DistContext`
starts the process group (gloo, host collectives) and describes the
topology, the engine's ``executor="dist"`` backend
(``repro_torch.fl.executors.DistExecutor``) splits the cohort's blocks
across every process's devices, and :class:`CrossHostClientStore`
partitions persistent client state, so each process keeps only the
clients its blocks train, with a handoff when sampling moves a client
from one process to another.

The engine stays one SPMD program: every process runs the same
scheduler, uplink and aggregation on the same generator draws, so the
records agree bit for bit across processes and with the single-process
sharded run on the same block layout (``tests/test_torch_dist.py``,
``python -m repro_torch.launch.dist_smoke``).
"""
from repro_torch.dist.context import (DistConfig, DistContext, get_context,
                                      init_from_env)
from repro_torch.dist.state import CrossHostClientStore

__all__ = [
    "DistConfig",
    "DistContext",
    "CrossHostClientStore",
    "get_context",
    "init_from_env",
]
