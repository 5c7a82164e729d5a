"""Streaming aggregation ingest: decode payloads straight into running
weighted accumulators (O(1) server memory in the cohort size).

Port of ``repro.fl.ingest``; ``fl.rounds`` puts it behind
``EngineConfig.ingest = "streaming"`` for both schedulers.
"""
from repro_torch.fl.ingest.stream import (IngestConfig, IngestResult,
                                          IngestStats, RejectedPayload,
                                          StreamingIngest)

__all__ = ["IngestConfig", "IngestResult", "IngestStats", "RejectedPayload",
           "StreamingIngest"]
