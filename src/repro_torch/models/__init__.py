from repro_torch.models.cnn import (CNNModel, make_resnet, make_vgg,
                                   resnet18_small, vgg11_thinned, vgg16_tiny)

__all__ = ["CNNModel", "make_resnet", "make_vgg", "resnet18_small",
           "vgg11_thinned", "vgg16_tiny"]
