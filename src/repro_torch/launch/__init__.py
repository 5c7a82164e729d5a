"""Launchers of the port: the meshes, the multi-process runtime's smoke,
and the serving front doors.

Port of ``repro.launch`` as far as the federated engine and the
transformer's serving path go:

* ``launch.mesh``: the transformer's process mesh (``make_mesh``,
  ``make_production_mesh``), the cohort mesh of the sharded executor and
  the multi-process one of the dist executor;
* ``launch.dist_smoke``: runs itself as a parent and two workers of a
  ``torch.distributed`` job and checks that their records are equal;
* ``launch.ingest_serve`` and ``launch.serve``: the FL ingest server (the
  streaming decode-and-accumulate pipeline of ``fl.ingest``, reporting
  payloads/s and MB/s); ``serve --arch`` is the transformer family's
  prefill and greedy decode (``models.decode``), at tp = 1;
* ``launch.arch_check``: the transformer family's comparison rules and
  the card phase of ``chip_smoke.py`` (card against CPU, full-width
  prefill against replay, timings);
* ``launch.tp_check``: tensor-parallel jobs (one worker a shard of the
  ``model`` axis) and the tp phase of ``chip_smoke.py``.

``require_dist()`` guards the entry points that need ``repro_torch.dist``
and fails with an actionable message where it is absent or broken.
"""
from __future__ import annotations

DIST_MISSING_MSG = (
    "the `repro_torch.dist` runtime failed to import; this entry point "
    "needs it (the torch.distributed multi-process cohort runtime: see "
    "ROADMAP.md and src/repro_torch/dist/).  The single-process federated "
    "engine (repro_torch.fl.run_scenario, repro_torch.core.fsfl."
    "run_federated) runs without it."
)


def require_dist():
    """Import and return ``repro_torch.dist``; SystemExit with a friendly
    message where the runtime is absent or broken in this checkout."""
    try:
        import repro_torch.dist
    except ImportError:
        raise SystemExit(DIST_MISSING_MSG) from None
    return repro_torch.dist
