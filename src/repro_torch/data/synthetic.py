"""Deterministic synthetic image datasets, port of ``repro.data.synthetic``.

Class-conditional mixtures: each class owns smooth random prototypes; a
sample is prototype + noise, randomly flipped horizontally, then the whole
set is normalised.  Drawn with a ``torch.Generator`` on the CPU, so a seed
gives the same images on every device (the numbers differ from the
reference's ``jax.random`` draws; parity runs pass the reference's arrays
through ``FederatedSplits.from_numpy`` instead).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ImageTask:
    name: str
    num_classes: int
    channels: int
    size: int = 32
    prototypes_per_class: int = 4
    noise: float = 0.35


CIFAR_LIKE = ImageTask("cifar_like", 10, 3)
VOC_LIKE = ImageTask("voc_like", 20, 3)
XRAY_LIKE = ImageTask("xray_like", 2, 1)


def _smooth_prototypes(gen: torch.Generator, task: ImageTask) -> torch.Tensor:
    """Low-frequency random prototypes (P, H, W, C) in [-1, 1]."""
    p = task.num_classes * task.prototypes_per_class
    coarse = torch.randn((p, task.channels, 8, 8), generator=gen)
    protos = F.interpolate(coarse, size=(task.size, task.size),
                           mode="bilinear", align_corners=False)
    return torch.tanh(protos * 1.5).permute(0, 2, 3, 1)


def make_image_dataset(gen: torch.Generator, task: ImageTask,
                       num_samples: int):
    """-> (images (N, H, W, C) float32 normalised, labels (N,) int64)."""
    protos = _smooth_prototypes(gen, task)
    labels = torch.randint(0, task.num_classes, (num_samples,), generator=gen)
    which = torch.randint(0, task.prototypes_per_class, (num_samples,),
                          generator=gen)
    base = protos[labels * task.prototypes_per_class + which]
    imgs = base + task.noise * torch.randn(base.shape, generator=gen)
    flip = torch.rand((num_samples,), generator=gen) < 0.5
    imgs = torch.where(flip[:, None, None, None], imgs.flip(2), imgs)
    imgs = (imgs - imgs.mean()) / (imgs.std(correction=0) + 1e-6)
    return imgs.to(torch.float32), labels


def make_markov_lm(gen: torch.Generator, vocab: int, num_seqs: int,
                   seq_len: int, branching: int = 4):
    """Order-1 Markov token sequences: each token has ``branching`` likely
    successors, a learnable LM task with a floor of about
    log2(``branching``) bits a token.  -> ``(inputs, targets)``, both
    (num_seqs, seq_len) int64, the inputs the targets shifted right by one
    behind each sequence's start token."""
    successors = torch.randint(0, vocab, (vocab, branching), generator=gen)
    start = torch.randint(0, vocab, (num_seqs,), generator=gen)
    choice = torch.randint(0, branching, (num_seqs, seq_len), generator=gen)
    return _markov_walk(successors, start, choice)


def _markov_walk(successors: torch.Tensor, start: torch.Tensor,
                 choice: torch.Tensor):
    """Walk each sequence from ``start``: token t is
    ``successors[token t-1, choice[:, t]]``."""
    tok, toks = start, []
    for t in range(choice.shape[1]):
        tok = successors[tok, choice[:, t]]
        toks.append(tok)
    toks = torch.stack(toks, dim=1)
    inputs = torch.cat([start[:, None], toks[:, :-1]], dim=1)
    return inputs, toks
