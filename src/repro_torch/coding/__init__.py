"""DeepCABAC/NNC-style host codec for quantized differential updates
(port of ``repro.coding``: numpy, byte-identical to the reference)."""
from repro_torch.coding.errors import CorruptPayloadError
from repro_torch.coding.nnc import (decode_tree, decode_tree_batch,
                                    encode_tree, encode_tree_batch,
                                    encoded_bytes, shapes_of)

__all__ = ["CorruptPayloadError", "decode_tree", "decode_tree_batch",
           "encode_tree", "encode_tree_batch", "encoded_bytes", "shapes_of"]
