"""Serving launcher.

Port of ``repro.launch.serve``'s FL front door: without ``--arch`` every
argument goes to ``repro_torch.launch.ingest_serve`` (the
decode-and-accumulate uplink pipeline serving a cohort of encoded
payloads, reporting payloads/s and MB/s).

    PYTHONPATH=src python -m repro_torch.launch.serve --k 32 --device cpu

``--arch <id>`` is the reference's transformer prefill and decode, which
belongs to the transformer family and raises ``runtime.not_ported``.
"""
from __future__ import annotations

import sys

from repro_torch.runtime import not_ported

# the port-queue item serve --arch waits on (ROADMAP.md)
TRANSFORMER_ITEM = "transformer family"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if any(a == "--arch" or a.startswith("--arch=") for a in argv):
        raise not_ported("serve --arch (transformer prefill and decode)",
                         TRANSFORMER_ITEM)
    from repro_torch.launch import ingest_serve
    return ingest_serve.main(argv)


if __name__ == "__main__":
    main()
