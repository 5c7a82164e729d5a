"""The paper's own architecture: thinned VGG11 for CIFAR10 (Table 1/2)."""
from repro_torch.models import vgg11_thinned


def make(num_classes: int = 10):
    return vgg11_thinned(num_classes=num_classes)
