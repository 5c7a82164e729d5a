"""Federated communication protocols (paper §3-4, Algorithm 1).

Port of ``repro.core.protocol``.  One communication epoch for one client:

  1. start from the server state,
  2. train W locally with Adam on the round's batches (scales S frozen;
     under partial updates, ``trainable_predicate``, the gradients of the
     frozen leaves are zero, so Adam moves them by exactly 0),
  3. differential update + error feedback (Eq. 5) + sparsification +
     uniform quantization (``comms.stages``; with one threshold per leaf,
     one fused ``level_assign`` kernel launch over all the leaves),
  4. filter-scale sub-epochs on the sparsely updated model (W and BN
     frozen), keeping the best sub-epoch under ``perf >= best_perf``,
  5. fine quantization of the scale delta.

The reference's ``lax.scan`` loops are plain Python loops here, and
gradients come from ``torch.autograd.grad`` over the leaves of the
parameter dict.

``client_round`` trains one client.  ``client_round.cohort`` trains a
cohort of K clients at once (the reference's ``jax.vmap`` of it, written
with the cohort as an explicit leading axis of every tree): the model runs
the clients side by side (``models.cnn``), the loss is the sum of the
clients' mean losses, so each client's gradient is its own, Adam keeps a
step count per client, one ``level_assign`` launch covers the cohort's
leaves, and the Eq. 4 accept rule is a per-client ``torch.where`` with no
host sync.  Per client it is the same protocol as ``client_round``, up to
the summation order of the batched convolutions and products.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.comms import stages as stages_lib
from repro_torch.core import delta as delta_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import scaling as scaling_lib
from repro_torch.core import sparsify as sparsify_lib
from repro_torch.models.cnn import CNNModel
from repro_torch.optim import adam, apply_updates, sgd
from repro_torch.optim import schedule as schedule_lib
from repro_torch.tree import (leaves, map_with_path, per_row, row, stack,
                              tree_map)


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    name: str = "fsfl"
    # --- compression ---
    method: str = "sparse"            # "none" | "sparse" | "ternary"
    quantize: bool = True
    step_size: float = quant_lib.STEP_SIZE_UNI
    fine_step_size: float = quant_lib.STEP_SIZE_FINE
    delta: float = 1.0                # Eq. 2
    gamma: float = 1.0                # Eq. 3
    fixed_sparsity: float | None = None
    structured: bool = True
    unstructured: bool = True
    error_feedback: bool = False      # Eq. 5
    # --- scaling (the paper's contribution) ---
    scaling: bool = False
    scale_subepochs: int = 2          # E
    scale_lr: float = 1e-3
    scale_optimizer: str = "adam"     # "adam" | "sgd"
    scale_schedule: str = "none"      # "none" | "linear" | "cawr"
    scale_predicate: Callable | None = None
    # --- local training ---
    local_lr: float = 1e-3
    local_optimizer: str = "adam"
    batch_size: int = 64
    # --- partial updates (VGG16_partial) ---
    trainable_predicate: Callable | None = None
    # --- misc ---
    total_rounds: int = 15


class ClientPersistent(NamedTuple):
    """Per-client state that persists across rounds."""
    residual: Any
    opt_state: Any
    scale_opt_state: Any
    sched_step: torch.Tensor


class ServerState(NamedTuple):
    params: Any
    scales: Any
    bn_state: Any


class RoundOutput(NamedTuple):
    levels_params: Any        # int32 levels (level-codec input)
    levels_scales: Any
    recon_delta_params: Any   # dequantized reconstruction
    recon_delta_scales: Any
    bn_state: Any
    persistent: ClientPersistent
    metrics: Any


class RoundSteps:
    """The local steps a client round is made of, shared by
    ``client_round`` and its cohort form: ``w_step`` (one Adam step of W),
    ``s_step`` (one step of the scales) and ``masks`` (the trainable and
    scale masks of a params tree).  A round calls them through this
    object, so replacing an attribute records or alters every step of
    both routes."""

    def __init__(self, w_step: Callable, s_step: Callable, masks: Callable):
        self.w_step, self.s_step, self.masks = w_step, s_step, masks


def _grad_tree(loss: torch.Tensor, tree: Any) -> Any:
    """d loss / d every leaf of ``tree`` (leaves require grad), as a tree."""
    grads = iter(torch.autograd.grad(loss, leaves(tree)))
    return tree_map(lambda _: next(grads), tree)


def _requiring_grad(tree: Any) -> Any:
    return tree_map(lambda x: x.detach().requires_grad_(True), tree)


def trainable_mask(params: Any, predicate: Callable | None) -> Any:
    """Bool tree over params: the leaves local training may move (paths
    as the scale and fine masks name them, ``conv0/w``, ``fc1/b``)."""
    if predicate is None:
        return tree_map(lambda _: True, params)
    return map_with_path(lambda path, leaf: bool(predicate(path, leaf)),
                         params)


def _mask_tree(tree: Any, mask: Any) -> Any:
    return tree_map(lambda x, m: x if m else torch.zeros_like(x), tree, mask)


def make_protocol(model: CNNModel, cfg: ProtocolConfig, steps_per_round: int):
    """Builds ``(init, client_round, evaluate)`` for one client."""
    w_opt = (adam(cfg.local_lr) if cfg.local_optimizer == "adam"
             else sgd(cfg.local_lr, momentum=0.9))

    sub_steps = steps_per_round  # scale sub-epoch reuses the round's batches
    if cfg.scale_schedule == "none":
        s_sched = schedule_lib.constant(cfg.scale_lr)
    elif cfg.scale_schedule == "linear":
        s_sched = schedule_lib.linear(
            cfg.scale_lr,
            cfg.total_rounds * cfg.scale_subepochs * max(sub_steps, 1))
    else:
        s_sched = schedule_lib.cawr(
            cfg.scale_lr, period=max(cfg.scale_subepochs * sub_steps, 1))
    s_opt = (adam(s_sched) if cfg.scale_optimizer == "adam"
             else sgd(s_sched, momentum=0.9))

    up_stages = stages_lib.UpstreamStages(
        method=cfg.method, quantize=cfg.quantize,
        sparsify=sparsify_lib.SparsifyConfig(
            delta=cfg.delta, gamma=cfg.gamma, step_size=cfg.step_size,
            unstructured=cfg.unstructured, structured=cfg.structured,
            fixed_sparsity=cfg.fixed_sparsity),
        quant=quant_lib.QuantConfig(step_size=cfg.step_size,
                                    fine_step_size=cfg.fine_step_size),
        ternary_sparsity=cfg.fixed_sparsity or 0.96)

    scale_pred = cfg.scale_predicate or scaling_lib.default_predicate

    # ------------------------------------------------------------- losses

    # one client's trees and images, or a cohort's (every leaf and the
    # images lead with K; the loss is then (K,), each client's mean)

    def logits_fn(params, scales, bn_state, x, train):
        # Eq. 4: the conv leaves are scaled here; the dense layers apply
        # their scales inside the product (scaled_matmul)
        scaled = scaling_lib.apply_scales_tree(params, scales,
                                               cohort=x.ndim == 5)
        return model.apply(scaled, bn_state, x, train=train, scales=scales)

    def loss_fn(params, scales, bn_state, x, y, train):
        logits, new_bn = logits_fn(params, scales, bn_state, x, train)
        logp = F.log_softmax(logits, dim=-1)
        if y.ndim == 1:
            return torch.mean(-logp.gather(1, y[:, None])[:, 0]), new_bn
        return torch.mean(-logp.gather(2, y[..., None])[..., 0], dim=1), new_bn

    @torch.no_grad()
    def accuracy(params, scales, bn_state, x, y):
        logits, _ = logits_fn(params, scales, bn_state, x, train=False)
        hits = (torch.argmax(logits, -1) == y).to(torch.float32)
        return torch.mean(hits) if y.ndim == 1 else torch.mean(hits, dim=1)

    # ------------------------------------------------------------- init

    def init(gen: torch.Generator, device="cpu"):
        params, bn_state = model.init(gen, device)
        scales = scaling_lib.init_scales(params, scale_pred)
        persistent = ClientPersistent(
            residual=tree_map(torch.zeros_like, params),
            opt_state=w_opt.init(params),
            scale_opt_state=s_opt.init(scaling_lib.init_scales(params,
                                                               scale_pred)),
            sched_step=torch.zeros((), dtype=torch.int32,
                                   device=torch.device(device)))
        return ServerState(params, scales, bn_state), persistent

    # ------------------------------------------------------------- steps

    # one local step, of one client (its loss a scalar) or of a cohort
    # (every leaf and the images lead with K, the loss (K,) and its sum
    # differentiated, so each client's gradient is its own)

    def _grad(loss, tree):
        return _grad_tree(loss if loss.ndim == 0 else torch.sum(loss), tree)

    def w_step(params, scales0, bn, opt_state, x, y, t_mask):
        """One Adam step of W on the batch ``x, y`` (S frozen, BN in
        training mode) -> (params, bn, opt_state, loss, grads)."""
        with torch.enable_grad():
            p_req = _requiring_grad(params)
            loss, new_bn = loss_fn(p_req, scales0, bn, x, y, True)
            grads = _grad(loss, p_req)
        if t_mask is not None:
            grads = _mask_tree(grads, t_mask)
        upd, opt_state = w_opt.update(grads, opt_state, params)
        return (apply_updates(params, upd),
                tree_map(torch.Tensor.detach, new_bn), opt_state,
                loss.detach(), grads)

    def s_step(params_hat, scales, bn1, sopt, x, y, s_mask):
        """One step of the scales S on the batch (BN frozen, train=False;
        W frozen by construction) -> (scales, scale_opt_state, grads)."""
        with torch.enable_grad():
            s_req = _requiring_grad(scales)
            loss, _ = loss_fn(params_hat, s_req, bn1, x, y, False)
            g = _mask_tree(_grad(loss, s_req), s_mask)
        upd, sopt = s_opt.update(g, sopt, scales)
        return apply_updates(scales, upd), sopt, g

    def masks(params):
        """(trainable mask or None, scale mask) of one client's params."""
        return ((None if cfg.trainable_predicate is None
                 else trainable_mask(params, cfg.trainable_predicate)),
                scaling_lib.scale_mask(params, scale_pred))

    # both routes take their steps through this namespace, so a check can
    # record the states a round steps from (``chip_smoke.step_check``)
    steps = RoundSteps(w_step, s_step, masks)

    # ------------------------------------------------------------- round

    def client_round(server: ServerState, persistent: ClientPersistent,
                     train_x, train_y, val_x, val_y,
                     batch_idx) -> RoundOutput:
        params0, scales0, bn0 = server
        t_mask, s_mask = steps.masks(params0)
        fine_mask = stages_lib.path_fine_mask(params0)

        # ---- 2. local training of W (S frozen) --------------------------
        params, bn, opt_state = params0, bn0, persistent.opt_state
        losses = []
        for idx in batch_idx:
            params, bn, opt_state, loss, _ = steps.w_step(
                params, scales0, bn, opt_state, train_x[idx], train_y[idx],
                t_mask)
            losses.append(loss)
        params1, bn1 = params, bn

        # ---- 3. codec stages: delta + error feedback + sparsify + quant --
        raw_delta = stages_lib.extract_delta(params1, params0)
        if cfg.error_feedback and up_stages.fused:
            # one level_assign launch over the leaves (bitwise the chain
            # below)
            levels, recon_delta, new_residual, update_sparsity = (
                up_stages.compress_carry(raw_delta, persistent.residual,
                                         fine_mask))
        else:
            carried = stages_lib.carry_residual(
                raw_delta, persistent.residual, cfg.error_feedback)
            levels, recon_delta, sparse_delta = up_stages.compress(
                carried, fine_mask)
            new_residual = stages_lib.new_residual(
                carried, recon_delta, cfg.error_feedback,
                persistent.residual)
            update_sparsity = sparsify_lib.tree_sparsity(sparse_delta)
        # the sparsely updated model that S-training sees (Alg. 1 line 11)
        params_hat = delta_lib.tree_add(params0, recon_delta)

        # ---- 4. scaling-factor sub-epochs (Alg. 1 lines 13-19) ----------
        perf0 = accuracy(params_hat, scales0, bn1, val_x, val_y)
        best_perf = perf0
        scales1, sopt = scales0, persistent.scale_opt_state
        best_epoch = 0   # the kept sub-epoch (1-based); 0: none improved
        if cfg.scaling:
            scales = best_s = scales0
            for epoch in range(1, cfg.scale_subepochs + 1):
                for idx in batch_idx:
                    scales, sopt, _ = steps.s_step(
                        params_hat, scales, bn1, sopt, train_x[idx],
                        train_y[idx], s_mask)
                perf = accuracy(params_hat, scales, bn1, val_x, val_y)
                if bool(perf >= best_perf):
                    best_s, best_perf, best_epoch = scales, perf, epoch
            scales1 = best_s  # == scales0 if no sub-epoch improved

        # ---- 5. quantize the S delta (fine step size) --------------------
        s_delta = delta_lib.tree_sub(scales1, scales0)
        s_levels, s_recon = stages_lib.quantize_scales_delta(
            s_delta, cfg.fine_step_size)

        metrics = {
            "train_loss": torch.mean(torch.stack(losses)),
            "val_acc_unscaled": perf0,
            "val_acc": best_perf,
            "update_sparsity": update_sparsity,
            # the Eq. 4 accept decision, a discrete event that parity
            # checks count apart
            "scale_epoch": torch.tensor(float(best_epoch),
                                        device=perf0.device),
        }
        return RoundOutput(
            levels_params=levels, levels_scales=s_levels,
            recon_delta_params=recon_delta, recon_delta_scales=s_recon,
            bn_state=bn1,
            persistent=ClientPersistent(
                new_residual, opt_state, sopt,
                persistent.sched_step + cfg.scale_subepochs * sub_steps),
            metrics=metrics)

    # ------------------------------------------------------------- cohort

    def cohort_round(servers: ServerState, persistent: ClientPersistent,
                     train_x, train_y, val_x, val_y,
                     batch_idx) -> RoundOutput:
        """``client_round`` for K clients at once: ``servers`` and
        ``persistent`` are stacked trees (every leaf leads with K, each
        row that client's server snapshot and state), the data (K, n, ...)
        and ``batch_idx`` (K, steps, batch).  Returns the stacked
        ``RoundOutput``."""
        params0, scales0, bn0 = servers
        k = train_x.shape[0]
        template = row(params0, 0)        # masks read one client's shapes
        t_mask, s_mask = steps.masks(template)
        fine_mask = stages_lib.path_fine_mask(template)
        rows = torch.arange(k, device=train_x.device)[:, None]

        # ---- 2. local training of W (S frozen) --------------------------
        params, bn, opt_state = params0, bn0, persistent.opt_state
        losses = []
        for t in range(batch_idx.shape[1]):
            idx = batch_idx[:, t]
            params, bn, opt_state, loss, _ = steps.w_step(
                params, scales0, bn, opt_state, train_x[rows, idx],
                train_y[rows, idx], t_mask)
            losses.append(loss)
        params1, bn1 = params, bn

        # ---- 3. codec stages: delta + error feedback + sparsify + quant --
        raw_delta = stages_lib.extract_delta(params1, params0)
        if cfg.error_feedback and up_stages.fused:
            # one level_assign launch over the cohort's leaves
            levels, recon_delta, new_residual, update_sparsity = (
                up_stages.compress_carry_cohort(raw_delta,
                                                persistent.residual,
                                                fine_mask))
        else:
            # the unfused chain (structured rows, ternary, none), client
            # by client
            per = []
            for i in range(k):
                res_i = row(persistent.residual, i)
                carried = stages_lib.carry_residual(
                    row(raw_delta, i), res_i, cfg.error_feedback)
                lv, rec, sparse = up_stages.compress(carried, fine_mask)
                per.append((lv, rec, stages_lib.new_residual(
                    carried, rec, cfg.error_feedback, res_i),
                    sparsify_lib.tree_sparsity(sparse)))
            levels, recon_delta, new_residual, update_sparsity = (
                stack(list(part)) for part in zip(*per))
        params_hat = delta_lib.tree_add(params0, recon_delta)

        # ---- 4. scaling-factor sub-epochs, the accept rule per client ----
        perf0 = accuracy(params_hat, scales0, bn1, val_x, val_y)
        best_perf = perf0
        scales1, sopt = scales0, persistent.scale_opt_state
        best_epoch = torch.zeros_like(perf0)
        if cfg.scaling:
            scales = best_s = scales0
            for epoch in range(1, cfg.scale_subepochs + 1):
                for t in range(batch_idx.shape[1]):
                    idx = batch_idx[:, t]
                    scales, sopt, _ = steps.s_step(
                        params_hat, scales, bn1, sopt, train_x[rows, idx],
                        train_y[rows, idx], s_mask)
                perf = accuracy(params_hat, scales, bn1, val_x, val_y)
                better = perf >= best_perf
                best_s = tree_map(
                    lambda new, old: torch.where(per_row(better, new), new,
                                                 old), scales, best_s)
                best_perf = torch.where(better, perf, best_perf)
                best_epoch = torch.where(better, float(epoch), best_epoch)
            scales1 = best_s

        # ---- 5. quantize the S delta (fine step size) --------------------
        s_delta = delta_lib.tree_sub(scales1, scales0)
        s_levels, s_recon = stages_lib.quantize_scales_delta(
            s_delta, cfg.fine_step_size)

        metrics = {
            "train_loss": torch.mean(torch.stack(losses), dim=0),
            "val_acc_unscaled": perf0,
            "val_acc": best_perf,
            "update_sparsity": update_sparsity,
            "scale_epoch": best_epoch,
        }
        return RoundOutput(
            levels_params=levels, levels_scales=s_levels,
            recon_delta_params=recon_delta, recon_delta_scales=s_recon,
            bn_state=bn1,
            persistent=ClientPersistent(
                new_residual, opt_state, sopt,
                persistent.sched_step + cfg.scale_subepochs * sub_steps),
            metrics=metrics)

    def evaluate(server: ServerState, x, y):
        return accuracy(server.params, server.scales, server.bn_state, x, y)

    client_round.cohort = cohort_round
    client_round.steps = steps
    return init, client_round, evaluate


# --------------------------------------------------------------------------
# Named baseline configurations (Table 2 rows)
# --------------------------------------------------------------------------

def baseline_configs(fixed_sparsity: float = 0.96,
                     **common) -> dict[str, ProtocolConfig]:
    return {
        "fedavg": ProtocolConfig(name="fedavg", method="none", quantize=False,
                                 **common),
        "fedavg_nnc": ProtocolConfig(name="fedavg_nnc", method="none",
                                     **common),
        "stc": ProtocolConfig(name="stc", method="ternary",
                              error_feedback=True,
                              fixed_sparsity=fixed_sparsity, structured=False,
                              **common),
        "eqs23": ProtocolConfig(name="eqs23", method="sparse",
                                error_feedback=True, structured=False,
                                fixed_sparsity=fixed_sparsity, **common),
        "stc_scaled": ProtocolConfig(name="stc_scaled", method="ternary",
                                     error_feedback=True, scaling=True,
                                     fixed_sparsity=fixed_sparsity,
                                     structured=False, **common),
        "fsfl": ProtocolConfig(name="fsfl", method="sparse", scaling=True,
                               error_feedback=True, structured=False,
                               fixed_sparsity=fixed_sparsity, **common),
    }
