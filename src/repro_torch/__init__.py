"""PyTorch/CUDA port of the FSFL federated-learning system.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``repro_torch/core/sparsify.py`` ports ``repro/core/sparsify.py``)
and never imports it.  Parameters are nested ``dict[str, dict[str, Tensor]]``
trees keyed like the reference's pytrees (``conv0/w``, ``bn3/gamma``), so the
wire order of the codecs is the same sorted path order.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:
``repro_torch.fl.run_scenario`` for a named scenario and
``repro_torch.fl.run_simulation`` for an explicit model, protocol and split.
"""
