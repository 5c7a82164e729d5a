"""Federated data handling: client splits and batching.

Port of ``repro.data.federated``: the IID split and the dirichlet
(non-IID) partition.  ``FederatedSplits`` holds per-client arrays stacked
on a leading client axis plus a shared test set;
``FederatedSplits.from_numpy`` takes the reference's arrays as they are so
both packages train on the same data.  ``dirichlet_partition`` draws from
numpy's ``default_rng(seed)`` in the reference's order, so one integer seed
gives the reference's client index sets bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch



@dataclasses.dataclass
class FederatedSplits:
    client_x: torch.Tensor      # (C, n_train, H, W, C)
    client_y: torch.Tensor      # (C, n_train) int64
    client_val_x: torch.Tensor  # (C, n_val, ...)
    client_val_y: torch.Tensor  # (C, n_val)
    test_x: torch.Tensor
    test_y: torch.Tensor

    @property
    def num_clients(self) -> int:
        return self.client_x.shape[0]

    @property
    def n_train(self) -> int:
        return self.client_x.shape[1]

    @classmethod
    def from_numpy(cls, client_x, client_y, client_val_x, client_val_y,
                   test_x, test_y, device="cpu") -> "FederatedSplits":
        def xs(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        def ys(a):
            return torch.tensor(np.asarray(a).astype(np.int64), device=device)

        return cls(xs(client_x), ys(client_y), xs(client_val_x),
                   ys(client_val_y), xs(test_x), ys(test_y))

    def to(self, device) -> "FederatedSplits":
        return FederatedSplits(*(getattr(self, f.name).to(device)
                                 for f in dataclasses.fields(self)))


def dirichlet_partition(labels, num_clients: int, alpha: float,
                        seed: int) -> np.ndarray:
    """Row indices into ``labels`` for equal client shards, client after
    client, each shard's core following a per-class dirichlet(``alpha``)
    draw.

    Every class is spread over the clients by a dirichlet draw; each client
    keeps up to ``len(labels) // num_clients`` of its draw (shuffled before
    truncation) and shortfalls are filled from a shuffled pool of the
    over-quota leftovers.  The draws follow ``np.random.default_rng(seed)``
    in the reference's order."""
    rng = np.random.default_rng(int(seed))
    labels = np.asarray(labels)
    classes = int(labels.max()) + 1
    client_of = np.zeros(len(labels), np.int64)
    for c in range(classes):
        idx = np.nonzero(labels == c)[0]
        probs = rng.dirichlet([alpha] * num_clients)
        client_of[idx] = rng.choice(num_clients, len(idx), p=probs)
    per = len(labels) // num_clients
    by_client = [rng.permutation(np.nonzero(client_of == c)[0])
                 for c in range(num_clients)]
    kept = [ids[:per] for ids in by_client]
    leftover = rng.permutation(np.concatenate([ids[per:]
                                               for ids in by_client]))
    filled, used = [], 0
    for t in kept:
        need = per - len(t)
        if need > 0:
            t = np.concatenate([t, leftover[used:used + need]])
            used += need
        filled.append(t)
    return np.concatenate(filled)


def split_federated(gen: torch.Generator, x: torch.Tensor, y: torch.Tensor,
                    num_clients: int, train_frac: float = 0.7,
                    val_frac: float = 0.15,
                    dirichlet_alpha: float | None = None) -> FederatedSplits:
    """Random partition into equal client shards plus a test set: IID, or
    by label with ``dirichlet_partition`` (its seed drawn from ``gen``)."""
    n = x.shape[0]
    perm = torch.randperm(n, generator=gen).to(x.device)
    x, y = x[perm], y[perm]
    n_test = int(n * (1.0 - train_frac - val_frac))
    test_x, test_y = x[:n_test], y[:n_test]
    rest_x, rest_y = x[n_test:], y[n_test:]
    if dirichlet_alpha is not None:
        seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
        sel = torch.as_tensor(dirichlet_partition(
            rest_y.cpu().numpy(), num_clients, dirichlet_alpha, seed),
            device=x.device)
        rest_x, rest_y = rest_x[sel], rest_y[sel]
    per = rest_x.shape[0] // num_clients
    cx = rest_x[: per * num_clients].reshape((num_clients, per)
                                             + tuple(x.shape[1:]))
    cy = rest_y[: per * num_clients].reshape(num_clients, per)
    n_val = max(1, int(cx.shape[1] * val_frac / (train_frac + val_frac)))
    return FederatedSplits(
        client_x=cx[:, n_val:], client_y=cy[:, n_val:],
        client_val_x=cx[:, :n_val], client_val_y=cy[:, :n_val],
        test_x=test_x, test_y=test_y)


def epoch_batches(gen: torch.Generator, n: int,
                  batch_size: int) -> torch.Tensor:
    """Shuffled batch index matrix (num_batches, batch_size) for one epoch."""
    perm = torch.randperm(n, generator=gen)
    num_batches = n // batch_size
    return perm[: num_batches * batch_size].reshape(num_batches, batch_size)


def client_epoch_batches(gen: torch.Generator, num_clients: int, n: int,
                         batch_size: int) -> torch.Tensor:
    """(C, num_batches, batch_size) independent shuffles per client."""
    return torch.stack([epoch_batches(gen, n, batch_size)
                        for _ in range(num_clients)])


def host_batch_iterator(x, y, batch_size: int, seed: int = 0
                        ) -> Iterator[tuple]:
    """Endless ``(x, y)`` batches on the host for a launcher's training
    loop: each pass over the data a fresh permutation from numpy's
    ``default_rng(seed)`` (the reference's draws, so the same batches),
    the tail short of a batch dropped.  ``x`` and ``y`` are numpy arrays
    or tensors."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            yield x[idx], y[idx]
