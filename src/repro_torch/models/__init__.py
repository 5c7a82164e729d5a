from repro_torch.models.cnn import CNNModel, make_vgg, vgg11_thinned

__all__ = ["CNNModel", "make_vgg", "vgg11_thinned"]
