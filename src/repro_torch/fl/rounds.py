"""Round-lifecycle stages: the paper's Algorithm 1 as composable objects.

Port of ``repro.fl.rounds`` (sync scheduling, gather ingest):

    CohortPlan -> LocalTrain -> Uplink -> Aggregate -> ServerStep
    (-> Downlink) -> Evaluate

With a channel model the sync scheduler advances a simulated clock by each
round's slowest transfer and drops uploads; under error feedback a dropped
client's decoded delta goes back into its residual (Eq. 5).

``Uplink`` puts every cohort member's update on the wire and aggregates
only what decodes: per client through ``Codec.encode_batch`` (for
``int8-blockscale`` one kernel launch per client; the level codecs take
the cohort's levels to the host first), or, under
``EngineConfig.device_encode``, through ``Codec.encode_cohort`` (one
device program and one device-to-host copy per cohort).

``Downlink`` compresses the server's update for the broadcast (§5.2) with
its own error feedback and puts it through the same codec; ``ServerStep``
applies the decoded broadcast.  With ``int8-blockscale`` the apply and the
downlink's residual are ``delta_apply_leaves`` calls on the payload's int8
levels and block scales, one kernel launch per broadcast each.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import comms
from repro_torch.comms import device as comms_device
from repro_torch.comms import stages as stages_lib
from repro_torch.comms.codec import bn_tree
from repro_torch.comms.codecs import Int8BlockScaleCodec
from repro_torch.core import delta as delta_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import sparsify as sparsify_lib
from repro_torch.core.protocol import ProtocolConfig, ServerState
from repro_torch.data.federated import client_epoch_batches
from repro_torch.fl.executors import ClientExecutor
from repro_torch.fl.sampling import (EmptyCohortError, SamplingConfig,
                                     sample_cohort)
from repro_torch.fl.server_opt import server_update
from repro_torch.kernels.delta_apply import delta_apply_leaves
from repro_torch.optim import apply_updates
from repro_torch.runtime import span
from repro_torch.tree import items, rebuild, row, sorted_items, tree_map

# ---------------------------------------------------------------- tree utils


def tree_mean0(tree: Any) -> Any:
    """Mean over the leading (client) axis."""
    return tree_map(lambda x: torch.mean(x, dim=0), tree)


def stack_trees(trees: list[Any], device: torch.device) -> Any:
    """Stack per-client trees (tensors or decoded numpy) on ``device``."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.tensor(x, device=device)  # decoded, read-only numpy

    return tree_map(lambda *ls: torch.stack([leaf(x) for x in ls]), *trees)


def raw_bytes_per_client(params: Any) -> int:
    """float32 bytes of one uncompressed copy of ``params``."""
    return 4 * sum(leaf.numel() for _, leaf in items(params))


# ---------------------------------------------------------------- contracts

@dataclasses.dataclass
class Contribution:
    """One decoded client message plus its metadata."""
    client: int
    delta_params: Any
    delta_scales: Any
    bn_state: Any
    payload_bytes: int = 0
    metrics: dict[str, float] | None = None


@dataclasses.dataclass
class AggregatedRound:
    delta_params: Any
    delta_scales: Any
    bn_state: Any


@dataclasses.dataclass
class RoundIntake:
    """A scheduler's hand-off for ONE aggregation: every charged upload,
    the indices of those that aggregate (channel drops leave out clients
    without refunding their bytes), how many clients receive the following
    broadcast, and the simulated clock after the round."""
    contributions: list[Contribution]
    survivors: list[int]
    receivers: int = 0
    sim_time: float = 0.0


# ---------------------------------------------------------------- cohort plan

class CohortPlan:
    """Stage 1: who participates (materialized uniform draws)."""

    def __init__(self, sampling: SamplingConfig, num_clients: int):
        self.sampling = sampling
        self.num_clients = num_clients
        self.full = sampling.is_full(num_clients)

    def select(self, gen: torch.Generator) -> np.ndarray:
        if self.full:
            return np.arange(self.num_clients)
        return sample_cohort(gen, self.num_clients, self.sampling)


# ---------------------------------------------------------------- local train

class LocalTrain:
    """Stage 2: run ``client_round`` over a cohort.

    Per-client persistent state is one client-stacked tree on the device
    (the reference's in-memory store): the single-client template is
    repeated over the clients, gathered by cohort index before the round
    and scattered back after it."""

    def __init__(self, client_round, splits, persistent0, num_clients: int,
                 batch_size: int, executor: ClientExecutor):
        self.executor = executor
        self.executor.bind(client_round)
        self.splits = splits
        self.batch_size = batch_size
        self.n_train = splits.n_train
        self.state = tree_map(
            lambda x: x.expand((num_clients,) + tuple(x.shape)).clone(),
            persistent0)

    def batches(self, gen: torch.Generator, k: int) -> torch.Tensor:
        return client_epoch_batches(gen, k, self.n_train, self.batch_size)

    def train_cohort(self, idx: np.ndarray, batch_idx: torch.Tensor,
                     server: ServerState):
        """One barrier round over the cohort ``idx`` -> stacked RoundOutput."""
        if len(idx) == 0:
            raise EmptyCohortError("train_cohort received an empty cohort")
        dev = self.splits.client_x.device
        sel = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=dev)
        s = self.splits
        pers = tree_map(lambda x: x[sel], self.state)
        out = self.executor.run_shared(
            server, pers, s.client_x[sel], s.client_y[sel],
            s.client_val_x[sel], s.client_val_y[sel], batch_idx.to(dev))

        def scatter(full, rows):
            full[sel] = rows
            return full

        self.state = tree_map(scatter, self.state, out.persistent)
        return out

    def reinject_residual(self, client: int, delta: Any) -> None:
        """A dropped upload must not break Eq. 5: put the lost (decoded)
        delta back into that client's residual, ``residual + delta``, so
        its mass goes out again (the scale-delta section has no residual
        and stays lost)."""
        def add(r, d):
            r[client] = r[client] + torch.tensor(np.asarray(d, np.float32),
                                                 device=r.device)
            return r

        tree_map(add, self.state.residual, delta)


# ---------------------------------------------------------------- uplink

class Uplink:
    """Stage 3: the wire.  Encode each participant's update, decode it back;
    the engine aggregates the DECODED reconstructions, so ``payload_bytes``
    are lengths of payloads that provably decode."""

    def __init__(self, cfg: ProtocolConfig, engine_cfg, server: ServerState):
        self.transmit = engine_cfg.measure_bytes
        self.codec = comms.resolve_codec(engine_cfg.codec, cfg.quantize)
        send_mask = None
        if engine_cfg.up_predicate is not None:
            send_mask = comms.make_send_mask(server.params,
                                             engine_cfg.up_predicate)
        self.spec = comms.WireSpec(
            params=comms.shape_template(server.params),
            scales=comms.shape_template(server.scales),
            fine_mask=comms.path_fine_mask(server.params),
            step_size=cfg.step_size,
            fine_step_size=cfg.fine_step_size,
            ternary=(cfg.method == "ternary"),
            send_mask=send_mask,
            bn=(comms.shape_template(server.bn_state)
                if engine_cfg.wire_schema == 2 else None),
            version=engine_cfg.wire_schema)
        self.device_encode = engine_cfg.device_encode

    def _metric_rows(self, out, k: int) -> list[dict[str, float]]:
        host = {name: v.detach().cpu().numpy() for name, v in
                out.metrics.items()}
        return [{name: float(v[i]) for name, v in host.items()}
                for i in range(k)]

    def intake(self, out, clients: list[int]) -> list[Contribution]:
        """Stacked cohort RoundOutput -> one Contribution per client."""
        k = len(clients)
        metrics = self._metric_rows(out, k)
        if not self.transmit:
            return [Contribution(
                client=c, delta_params=row(out.recon_delta_params, i),
                delta_scales=row(out.recon_delta_scales, i),
                bn_state=row(out.bn_state, i), metrics=metrics[i])
                for i, c in enumerate(clients)]
        payloads = None
        if self.device_encode:
            payloads = self.codec.encode_cohort(out, self.spec,
                                                clients=clients)
        if payloads is None:
            lv_p, lv_s = out.levels_params, out.levels_scales
            if "levels" in self.codec.needs:   # host coders read numpy
                lv_p, lv_s = tree_map(torch.Tensor.cpu, (lv_p, lv_s))
            bn = comms_device.bn_rows(out.bn_state, self.spec, k)
            payloads = self.codec.encode_batch([comms.ClientUpdate(
                row(lv_p, i), row(lv_s, i), row(out.recon_delta_params, i),
                row(out.recon_delta_scales, i),
                bn=None if bn is None else bn_tree(bn[i], self.spec))
                for i in range(k)], self.spec, clients=clients)
        decs = self.codec.decode_batch(payloads, self.spec, clients=clients)
        # under v2 the BN statistics are what the payload carried
        return [Contribution(
            client=c, delta_params=dec.params, delta_scales=dec.scales,
            bn_state=(dec.bn if self.spec.version == 2
                      else row(out.bn_state, i)),
            payload_bytes=len(p), metrics=metrics[i])
            for i, (c, p, dec) in enumerate(zip(clients, payloads, decs))]


# ---------------------------------------------------------------- aggregate

class Aggregate:
    """Stage 4: the plain mean of the survivors' contributions."""

    def __init__(self, device: torch.device):
        self.device = device

    def __call__(self, contribs: list[Contribution]) -> AggregatedRound:
        if not contribs:
            raise ValueError("cannot aggregate zero contributions")

        def mean(trees):
            return tree_mean0(stack_trees(trees, self.device))

        return AggregatedRound(
            delta_params=mean([c.delta_params for c in contribs]),
            delta_scales=mean([c.delta_scales for c in contribs]),
            bn_state=mean([c.bn_state for c in contribs]))


# ---------------------------------------------------------------- server step

class ServerStep:
    """Stage 5: fold one AggregatedRound into the server state.

    The aggregated delta is a pseudo-gradient for the server optimizer;
    the resulting update is what the Downlink may compress before it is
    applied (the broadcast quantity, §5.2)."""

    def __init__(self, opt):
        self.opt = opt
        self.state = None

    def init(self, params: Any) -> None:
        self.state = self.opt.init(params)

    def __call__(self, server: ServerState, agg: AggregatedRound,
                 downlink: "Downlink", receivers: int,
                 transmit: bool) -> tuple[ServerState, int]:
        updates, self.state = server_update(self.opt, self.state,
                                            agg.delta_params, server.params)
        down_bytes = 0
        with span("downlink"):
            if downlink.active:
                broadcast, down_bytes = downlink.compress(updates, receivers,
                                                          transmit)
                params = broadcast.apply(server.params)
            else:
                params = apply_updates(server.params, updates)
        return ServerState(
            params=params,
            scales=delta_lib.tree_add(server.scales, agg.delta_scales),
            bn_state=agg.bn_state), down_bytes


# ---------------------------------------------------------------- downlink

@dataclasses.dataclass
class Broadcast:
    """The decoded server->clients update.

    ``recon`` is its float32 tree on the device; for ``int8-blockscale``
    it is ``None`` and ``int8`` maps each leaf's path to its wire int8
    levels and float32 block scales (device views of the payload), which
    :meth:`apply` adds without building a float reconstruction."""
    recon: Any = None
    int8: dict[str, tuple[torch.Tensor, torch.Tensor]] | None = None
    block: int = Int8BlockScaleCodec.block

    def apply(self, params: Any) -> Any:
        """``params + recon``: ``apply_updates``, or one
        ``delta_apply_leaves`` call (coef +1) over the leaves."""
        if self.int8 is None:
            return apply_updates(params, self.recon)
        return apply_int8_tree(params, self.int8, 1.0, self.block)


def apply_int8_tree(tree: Any, sections: dict, coef: float,
                    block: int) -> Any:
    """``w + coef * q * scale`` at every leaf of ``tree``, with ``q`` and
    ``scale`` from the leaf's payload section: one ``delta_apply_leaves``
    call over the leaves in wire order."""
    pairs = sorted_items(tree)
    out = delta_apply_leaves([w for _, w in pairs],
                             [sections[path][0] for path, _ in pairs],
                             [sections[path][1] for path, _ in pairs],
                             coef, block=block)
    return rebuild(tree, {path: o for (path, _), o in zip(pairs, out)})


def apply_int8(w: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
               coef: float, block: int) -> torch.Tensor:
    """``w + coef * q * scale`` for one leaf of any shape; ``q`` may carry
    the wire's padding past ``w.numel()``."""
    return delta_apply_leaves([w], [q], [scales], coef, block=block)[0]


class Downlink:
    """Stage 6: bidirectional server->clients compression with error
    feedback (§5.2).

    It works on the server *update* (the quantity broadcast): Eq. 5 carry
    of its own residual, sparsification by the protocol's rules, uniform
    quantization with ``step_size`` (``STEP_SIZE_BI``) on every leaf (no
    fine mask), then the uplink's codec as a params-only message.  The
    engine applies the DECODED broadcast and ``down_bytes`` is
    ``receivers * len(payload)``.

    Routes, as the uplink's (``comms.stages.UpstreamStages``): with one
    threshold per leaf the carry, threshold, levels and the level codecs'
    new residual come from one ``level_assign`` launch over the leaves; the
    structured stage takes the unfused chain, whose Eq. 3 scores come from
    one ``row_stats`` launch over the weight leaves.  With
    ``int8-blockscale`` the payload re-quantizes ``levels * step`` per
    block (``delta_compress``, theta 0) and the new residual is ``carried -
    q * scale`` (one ``delta_apply_leaves`` launch, coef -1).
    """

    def __init__(self, cfg: ProtocolConfig, step_size: float, params0: Any,
                 codec, bidirectional: bool):
        self.active = bidirectional and cfg.method != "none"
        self.codec = codec
        self.stages = stages_lib.UpstreamStages(
            method="sparse", quantize=True,
            sparsify=sparsify_lib.SparsifyConfig(
                delta=cfg.delta, gamma=cfg.gamma, step_size=step_size,
                unstructured=cfg.unstructured, structured=cfg.structured,
                fixed_sparsity=cfg.fixed_sparsity),
            quant=quant_lib.QuantConfig(step_size=step_size,
                                        fine_step_size=cfg.fine_step_size))
        self.spec = comms.WireSpec(
            params=comms.shape_template(params0), scales=None,
            fine_mask=None, step_size=step_size,
            fine_step_size=cfg.fine_step_size)
        self.coarse = tree_map(lambda _: False, params0)
        self.residual = tree_map(torch.zeros_like, params0)
        self.last_payload_bytes = 0

    def compress(self, updates: Any, receivers: int,
                 transmit: bool) -> tuple[Broadcast, int]:
        with span("downlink.compress", receivers=receivers):
            carried = delta_lib.tree_add(updates, self.residual)
            if self.stages.fused:
                lv, recon, carry, _ = self.stages.compress_carry(
                    updates, self.residual, self.coarse)
            else:
                lv, recon, _ = self.stages.compress(carried, self.coarse)
                carry = delta_lib.tree_sub(carried, recon)
            if not transmit:
                self.residual = carry
                return Broadcast(recon=recon), 0
            payload = self.codec.encode(comms.ClientUpdate(
                levels_params=lv, levels_scales=None, recon_params=recon,
                recon_scales=None), self.spec)
            self.last_payload_bytes = len(payload)
            down = receivers * len(payload)
            dev = items(updates)[0][1].device
            if isinstance(self.codec, Int8BlockScaleCodec):
                sections = self.codec.device_sections(payload, self.spec,
                                                      dev)
                self.residual = apply_int8_tree(carried, sections, -1.0,
                                                self.codec.block)
                return Broadcast(int8=sections,
                                 block=self.codec.block), down
            decoded = tree_map(lambda x: torch.tensor(x, device=dev),
                               self.codec.decode(payload, self.spec).params)
            # a level codec decodes to exactly levels * step, so the
            # fused chain's carry is the residual; other codecs may not
            lossless_levels = "levels" in self.codec.needs
            self.residual = (carry if lossless_levels else
                             delta_lib.tree_sub(carried, decoded))
            return Broadcast(recon=decoded), down


# ---------------------------------------------------------------- evaluate

class Evaluate:
    """Stage 7: server-side test accuracy."""

    def __init__(self, evaluate_fn, test_x, test_y):
        self._eval = evaluate_fn
        self.test_x, self.test_y = test_x, test_y

    def __call__(self, server: ServerState) -> float:
        return float(self._eval(server, self.test_x, self.test_y))


# ---------------------------------------------------------------- scheduler

class SyncScheduler:
    """Cohort barrier: one cohort per aggregation, everyone against the
    same server snapshot.

    Cohorts and batch orders come from the scheduler's ``torch.Generator``,
    or, for runs held against the reference, from ``plan``: one
    ``(cohort indices, (K, steps, batch) batch indices)`` pair per round,
    as numpy arrays.

    With a channel model the simulated clock advances by the round's
    slowest ``down + up`` transfer (the download is the last broadcast's
    size, read before this round's server step); each upload is then
    dropped or not by its (round, client) draw.  Dropped bytes stay
    charged, only the survivors aggregate, the whole cohort receives the
    broadcast, and under error feedback each lost client's decoded delta
    goes back into its residual."""

    def bind(self, engine, gen: torch.Generator, plan=None) -> None:
        self.eng = engine
        self.gen = gen
        self.plan = None if plan is None else list(plan)
        self.round_idx = 0
        self.sim_clock = 0.0

    def next_round(self) -> RoundIntake:
        eng = self.eng
        self.round_idx += 1
        if self.plan is not None:
            if self.round_idx > len(self.plan):
                raise ValueError(f"the plan covers {len(self.plan)} rounds; "
                                 f"round {self.round_idx} was asked for")
            idx, bidx = self.plan[self.round_idx - 1]
            idx = np.asarray(idx)
            bidx = torch.tensor(np.asarray(bidx), dtype=torch.long)
        else:
            idx = eng.cohort.select(self.gen)
            bidx = (eng.local_train.batches(self.gen, len(idx)) if len(idx)
                    else None)
        clients = [int(c) for c in idx]
        try:
            out = eng.local_train.train_cohort(idx, bidx, eng.server)
        except EmptyCohortError:
            # a zero-size cohort: an all-drop round, with no contributions
            # and no server step (the engine skips it without survivors);
            # the clock moves 1 s, one step of the reference's 96-step day
            self.sim_clock += 1.0
            return RoundIntake([], [], receivers=0, sim_time=self.sim_clock)
        contribs = eng.uplink.intake(out, clients)
        cohort = len(clients)
        lost: list[int] = []
        chan = eng.channel
        if eng.uplink.transmit and chan is not None:
            sizes = [c.payload_bytes for c in contribs]
            self.sim_clock += chan.round_time(
                clients, sizes, eng.broadcast_ref_bytes(), self.round_idx)
            lost = [i for i in range(cohort)
                    if chan.dropped(self.round_idx, clients[i])]
        if lost and eng.protocol_cfg.error_feedback:
            for i in lost:
                eng.local_train.reinject_residual(clients[i],
                                                  contribs[i].delta_params)
        return RoundIntake(contribs,
                           [i for i in range(cohort) if i not in lost],
                           receivers=cohort, sim_time=self.sim_clock)

    def log_line(self, rec, intake: RoundIntake) -> str:
        line = (f"round {rec.round:3d} acc={rec.test_acc:.3f} "
                f"cohort={len(intake.survivors)}/{len(intake.contributions)} "
                f"up={rec.up_bytes / 1e6:.3f}MB "
                f"down={rec.down_bytes / 1e6:.3f}MB "
                f"sparsity={rec.update_sparsity:.3f}")
        if self.eng.channel is not None:
            line += f" t_sim={rec.sim_time_s:.2f}s"
        return line


SCHEDULERS = {"sync": SyncScheduler}
