"""Wire side of the port: graph stages, codecs, the device encode and the
channel model."""
from repro_torch.coding.errors import CorruptPayloadError
from repro_torch.comms import codecs as _codecs  # noqa: F401  (registers)
from repro_torch.comms.channel import ChannelConfig, ChannelModel
from repro_torch.comms.codec import (ClientUpdate, Codec, Decoded,
                                     FlatDecoded, LeafSpec, WireSpec,
                                     check_batch_clients, flatten_decoded,
                                     get_codec, list_codecs, make_send_mask,
                                     rebuild_tree, register_codec,
                                     resolve_codec, shape_template,
                                     sorted_items, unflatten_decoded)
from repro_torch.comms.stages import UpstreamStages, path_fine_mask

__all__ = ["ChannelConfig", "ChannelModel", "ClientUpdate", "Codec",
           "CorruptPayloadError", "Decoded", "FlatDecoded", "LeafSpec",
           "UpstreamStages", "WireSpec", "check_batch_clients",
           "flatten_decoded", "get_codec", "list_codecs", "make_send_mask",
           "path_fine_mask", "rebuild_tree", "register_codec",
           "resolve_codec", "shape_template", "sorted_items",
           "unflatten_decoded"]
