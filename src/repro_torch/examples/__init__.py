"""The port's example entry points, each the twin of the same-named
script under the repository's ``examples/``:

* ``quickstart``: FedAvg against FSFL on a small CNN, 2 clients;
* ``federated_cifar``: the Table-2 pipeline on the thinned VGG11 (or a
  small VGG), or any registered scenario, and a checkpoint of the server;
* ``multipod_train``: a multi-process job of the dist executor, held bit
  for bit against one process's sharded run on the same block layout;
* ``serve_decode``: the FL ingest server's two decode engines against
  the gather mean.

Each runs on CUDA unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
