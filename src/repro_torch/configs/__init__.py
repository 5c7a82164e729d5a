from repro_torch.configs.base import (SHAPES, all_configs, get, input_specs,
                                      long_variant, make_inputs,
                                      supports_shape)

__all__ = ["SHAPES", "all_configs", "get", "input_specs", "long_variant",
           "make_inputs", "supports_shape"]
