"""Sparsification of differential updates (paper §3, Eqs. 2 and 3).

Port of ``repro.core.sparsify``:

* unstructured (Eq. 2): Gaussian-approximation threshold
  ``theta_u = max(|mean - delta*std|, |mean + delta*std|) >= step/2`` with
  the population std (``correction=0``, as ``jnp.std``);
* structured (Eq. 3): rows whose mean ``|dw|`` falls below
  ``gamma * mean(scores)`` are zeroed;
* fixed rate: top-k by magnitude (unstructured, thresholded by value so
  ties cannot matter) or by row score (structured, ties broken by
  ``(-score, index)`` as ``lax.top_k`` does).

Row scores come from the ``row_stats`` kernel: ``sparsify_tree`` scores
every leaf of two or more dimensions in one ``row_stats_leaves`` call
(one launch per tree on the card), then sparsifies each leaf by its own
scores exactly as ``sparsify`` does alone.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.row_stats import row_stats, row_stats_leaves
from repro_torch.tree import items, leaves, rebuild, tree_map


@dataclasses.dataclass(frozen=True)
class SparsifyConfig:
    delta: float = 1.0          # Eq. 2 threshold shift
    gamma: float = 1.0          # Eq. 3 threshold shift
    step_size: float = 4.88e-4  # lower clamp for theta_u
    unstructured: bool = True
    structured: bool = True
    fixed_sparsity: float | None = None  # e.g. 0.96 keeps 4%


# ------------------------------------------------------------ Eq. 2

def unstructured_threshold(dw: torch.Tensor, delta: float,
                           step_size: float) -> torch.Tensor:
    mean = torch.mean(dw)
    std = torch.std(dw, correction=0)
    theta = torch.maximum(torch.abs(mean - delta * std),
                          torch.abs(mean + delta * std))
    return torch.clamp(theta, min=step_size / 2.0)


def sparsify_unstructured(dw: torch.Tensor, delta: float = 1.0,
                          step_size: float = 4.88e-4) -> torch.Tensor:
    theta = unstructured_threshold(dw, delta, step_size)
    return torch.where(torch.abs(dw) >= theta, dw, 0.0)


# ------------------------------------------------------------ Eq. 3

def row_scores(dw: torch.Tensor) -> torch.Tensor:
    """Mean ``|dw|`` per output slice (dim 0), shape (M,).

    A leaf of two or more dimensions goes through the ``row_stats`` kernel
    on its ``(M, -1)`` view (its plain version on a CPU tensor)."""
    if dw.ndim == 0:
        return torch.abs(dw)[None]
    if dw.ndim == 1:
        return torch.mean(torch.abs(dw.reshape(dw.shape[0], -1)), dim=1)
    return row_stats(dw.reshape(dw.shape[0], -1))


def structured_threshold(dw: torch.Tensor, gamma: float) -> torch.Tensor:
    return gamma * torch.mean(row_scores(dw))


def structured_keep_mask(dw: torch.Tensor, gamma: float = 1.0,
                         scores: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean (M,) mask of kept rows under Eq. 3 (``scores``:
    ``row_scores(dw)`` where the caller has them)."""
    if scores is None:
        scores = row_scores(dw)
    return scores >= gamma * torch.mean(scores)


def sparsify_structured(dw: torch.Tensor, gamma: float = 1.0,
                        scores: torch.Tensor | None = None) -> torch.Tensor:
    if dw.ndim == 0:
        return dw
    keep = structured_keep_mask(dw, gamma, scores)
    keep = keep.reshape((-1,) + (1,) * (dw.ndim - 1))
    return torch.where(keep, dw, 0.0)


# ------------------------------------------------------------ fixed rate

def keep_count(n: int, sparsity: float, minimum: int = 1) -> int:
    """Static number of kept elements (Python ``round``: half to even)."""
    return max(minimum, int(round(n * (1.0 - sparsity))))


def topk_threshold(dw: torch.Tensor, sparsity: float) -> torch.Tensor:
    """The k-th largest ``|dw|`` at fixed sparsity, a 0-d tensor on
    ``dw``'s device."""
    flat = torch.abs(dw.reshape(-1))
    k = keep_count(flat.shape[0], sparsity)
    return torch.topk(flat, k).values[-1]


def topk_mask_unstructured(dw: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Magnitude top-k mask at fixed sparsity; keeps every ``|dw|`` at or
    above the k-th largest, exactly as the reference thresholds."""
    return torch.abs(dw) >= topk_threshold(dw, sparsity)


def sparsify_topk_unstructured(dw: torch.Tensor,
                               sparsity: float) -> torch.Tensor:
    return torch.where(topk_mask_unstructured(dw, sparsity), dw, 0.0)


def topk_rows(dw: torch.Tensor, sparsity: float,
              scores: torch.Tensor | None = None):
    """Top-k rows by mean-``|.|`` score -> (values, sorted int32 indices).

    A stable descending sort orders tied scores by index, which is the
    order ``lax.top_k`` picks them in.  ``scores``: ``row_scores(dw)``
    where the caller has them."""
    if dw.ndim < 1:
        raise ValueError("topk_rows needs a tensor with a row axis")
    if scores is None:
        scores = row_scores(dw)
    k = keep_count(dw.shape[0], sparsity)
    order = torch.sort(scores, descending=True, stable=True).indices
    idx = torch.sort(order[:k]).values
    return dw[idx], idx.to(torch.int32)


def scatter_rows(values: torch.Tensor, indices: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """Inverse of :func:`topk_rows`: dense tensor, zeros elsewhere."""
    out = torch.zeros((num_rows,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out[indices.long()] = values
    return out


# ------------------------------------------------------------ pipeline

def sparsify(dw: torch.Tensor, cfg: SparsifyConfig,
             scores: torch.Tensor | None = None) -> torch.Tensor:
    """Apply the configured sparsification (dense out, mask semantics).
    ``scores``: ``row_scores(dw)`` where the caller has them."""
    out = dw
    if cfg.fixed_sparsity is not None:
        if cfg.structured and out.ndim >= 2:
            vals, idx = topk_rows(out, cfg.fixed_sparsity, scores)
            out = scatter_rows(vals, idx, out.shape[0])
        elif cfg.unstructured:
            out = sparsify_topk_unstructured(out, cfg.fixed_sparsity)
        return out
    if cfg.structured and out.ndim >= 2:
        out = sparsify_structured(out, cfg.gamma, scores)
    if cfg.unstructured:
        out = sparsify_unstructured(out, cfg.delta, cfg.step_size)
    return out


def one_threshold(cfg: SparsifyConfig) -> bool:
    """Whether ``cfg`` sparsifies every leaf by one threshold on ``|dw|``:
    fixed-rate top-k or Eq. 2, without the structured (row) stage."""
    return cfg.unstructured and not cfg.structured


def leaf_threshold(dw: torch.Tensor, cfg: SparsifyConfig,
                   cohort: bool = False) -> torch.Tensor:
    """theta of a one-threshold config (:func:`one_threshold`) as a 0-d
    tensor on ``dw``'s device: ``sparsify(dw, cfg)`` is
    ``where(|dw| >= theta, dw, 0)``.  With ``cohort``, ``dw`` leads with
    the cohort axis and theta is (K,), each row's own: the k-th largest
    magnitude of every row in one ``topk`` (a selection, so the value of a
    row's own), or Eq. 2 row by row."""
    if not one_threshold(cfg):
        raise ValueError("the structured stage has no single threshold")
    if cohort:
        if cfg.fixed_sparsity is not None:
            flat = torch.abs(dw.reshape(dw.shape[0], -1))
            k = keep_count(flat.shape[1], cfg.fixed_sparsity)
            return torch.topk(flat, k, dim=1).values[:, -1]
        return torch.stack([unstructured_threshold(d, cfg.delta,
                                                   cfg.step_size)
                            for d in dw])
    if cfg.fixed_sparsity is not None:
        return topk_threshold(dw, cfg.fixed_sparsity)
    return unstructured_threshold(dw, cfg.delta, cfg.step_size)


def sparsify_tree(tree, cfg: SparsifyConfig):
    """:func:`sparsify` at every leaf; with the structured stage, the row
    scores of all leaves of two or more dimensions come from one
    ``row_stats_leaves`` call."""
    if not cfg.structured:
        return tree_map(lambda x: sparsify(x, cfg), tree)
    pairs = items(tree)
    rows = [(path, x) for path, x in pairs if x.ndim >= 2]
    scores = dict(zip((path for path, _ in rows), row_stats_leaves(
        [x.reshape(x.shape[0], -1) for _, x in rows])))
    return rebuild(tree, {path: sparsify(x, cfg, scores.get(path))
                          for path, x in pairs})


def sparsity_of(x: torch.Tensor) -> torch.Tensor:
    return torch.mean((x == 0).to(torch.float32))


def tree_sparsity(tree) -> torch.Tensor:
    ls = leaves(tree)
    zeros = sum(torch.sum(leaf == 0) for leaf in ls)
    total = sum(leaf.numel() for leaf in ls)
    return zeros.to(torch.float32) / total
