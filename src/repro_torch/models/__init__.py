from repro_torch.models.cnn import (CNNModel, make_mobilenet, make_resnet,
                                   make_vgg, mobilenet_proj_only_predicate,
                                   mobilenetv2_small, resnet18_small,
                                   vgg11_thinned, vgg16_tiny)

__all__ = ["CNNModel", "make_mobilenet", "make_resnet", "make_vgg",
           "mobilenet_proj_only_predicate", "mobilenetv2_small",
           "resnet18_small", "vgg11_thinned", "vgg16_tiny"]
