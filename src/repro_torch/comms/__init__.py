"""Wire side of the port: graph stages, codecs and the device encode."""
from repro_torch.comms import codecs as _codecs  # noqa: F401  (registers)
from repro_torch.comms.codec import (ClientUpdate, Codec, Decoded, LeafSpec,
                                     WireSpec, check_batch_clients,
                                     get_codec, rebuild_tree, register_codec,
                                     resolve_codec, shape_template,
                                     sorted_items)
from repro_torch.comms.stages import path_fine_mask

__all__ = ["ClientUpdate", "Codec", "Decoded", "LeafSpec", "WireSpec",
           "check_batch_clients", "get_codec", "path_fine_mask",
           "rebuild_tree", "register_codec", "resolve_codec",
           "shape_template", "sorted_items"]
