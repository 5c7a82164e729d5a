"""Round-lifecycle stages: the paper's Algorithm 1 as composable objects.

Port of ``repro.fl.rounds`` (sync and buffered-async scheduling, gather
ingest):

    CohortPlan -> LocalTrain -> Uplink -> Aggregate -> ServerStep
    (-> Downlink) -> Evaluate

Two scheduling policies drive the same stage instances:

* ``SyncScheduler``, the cohort barrier.  With a channel model it
  advances a simulated clock by each round's slowest transfer and drops
  uploads; under error feedback a dropped client's decoded delta goes
  back into its residual (Eq. 5).
* ``BufferedAsyncScheduler``, FedBuff: M clients train concurrently
  against the server version each started from, and the buffer
  aggregates with staleness weights once B updates have landed; clients
  whose simulated finish times fall in one dispatch window train in one
  executor call (``LocalTrain.train_window``).

``Uplink`` puts every cohort member's update on the wire and aggregates
only what decodes: per client through ``Codec.encode``/``decode``, or,
with ``uplink_batch``, through ``Codec.encode_batch``/``decode_batch``
(for ``int8-blockscale`` one kernel launch per client either way; the
level codecs take the cohort's levels to the host first), or, under
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
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from repro_torch import comms
from repro_torch.comms import device as comms_device
from repro_torch.comms import pool as comms_pool
from repro_torch.comms import stages as stages_lib
from repro_torch.comms.codecs import Int8BlockScaleCodec
from repro_torch.core import delta as delta_lib
from repro_torch.core import prand
from repro_torch.core import quant as quant_lib
from repro_torch.core import sparsify as sparsify_lib
from repro_torch.core.protocol import ProtocolConfig, ServerState
from repro_torch.data.federated import client_epoch_batches, epoch_batches
from repro_torch.fl.async_buffer import (client_latencies, load_call_saving,
                                         normalized_staleness_weights,
                                         weighted_mean_trees)
from repro_torch.fl.executors import ClientExecutor
from repro_torch.fl.sampling import (EmptyCohortError, SamplingConfig,
                                     sample_available, sample_cohort,
                                     stream_cohort)
from repro_torch.fl.server_opt import server_update
from repro_torch.kernels.delta_apply import delta_apply_leaves
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import span
from repro_torch.optim import apply_updates
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


def client_slice(tree: Any, i: int) -> Any:
    """Client ``i``'s row of a stacked tree, as host numpy arrays."""
    return tree_map(lambda x: x[i].detach().cpu().numpy(), tree)


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
    staleness: int = 0           # server versions elapsed while training
    arrival_time: float = 0.0    # simulated seconds (async)
    metrics: dict[str, float] | None = None
    # streaming ingest: the wire bytes, not yet decoded (``delta_params``
    # and, under v1, ``bn_state`` are then the device rows, for Eq. 5
    # re-injection and the v1 BN mean)
    payload: bytes | None = None


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
    broadcast, the simulated clock after the round, and the aggregation
    weights (None: the plain mean; async: the normalised FedBuff
    staleness weights).  ``preagg`` is streaming ingest's hand-off: the
    survivors already folded (``fl.ingest``), so the engine skips
    ``Aggregate``."""
    contributions: list[Contribution]
    survivors: list[int]
    receivers: int = 0
    sim_time: float = 0.0
    weights: np.ndarray | None = None
    preagg: AggregatedRound | None = None


# ---------------------------------------------------------------- cohort plan

class CohortPlan:
    """Stage 1: who participates.  Two regimes:

    * **materialized**: uniform or weighted draws over the explicit index
      range, from the scheduler's generator (full participation draws
      nothing);
    * **streaming**, with a population axis or a traffic model: the
      hash-based :func:`~repro_torch.fl.sampling.stream_cohort`, a pure
      function of ``(stream_seed, round)``, availability-filtered by the
      traffic model's diurnal curve; it draws nothing from a generator and
      never enumerates the population."""

    def __init__(self, sampling: SamplingConfig, num_clients: int, *,
                 streaming: bool = False, traffic=None):
        self.sampling = sampling
        self.num_clients = num_clients
        self.full = sampling.is_full(num_clients)
        self.streaming = streaming or traffic is not None
        self.traffic = traffic

    def select(self, gen: torch.Generator) -> np.ndarray:
        with span("cohort_plan.select", full=self.full):
            if self.full:
                return np.arange(self.num_clients)
            return sample_cohort(gen, self.num_clients, self.sampling)

    def select_stream(self, round_idx: int, now: float) -> np.ndarray:
        """The streaming regime's cohort: hash-drawn, availability-
        filtered.  With a traffic model the draw is not strict: an
        availability trough may give a short (even empty) cohort, and the
        scheduler advances its clock and draws again."""
        with span("cohort_plan.select_stream", round=round_idx):
            accept = None
            if self.traffic is not None:
                traffic, t = self.traffic, now
                accept = lambda ids: traffic.available(ids, t, round_idx)
            if self.full:
                ids = np.arange(self.num_clients, dtype=np.int64)
                if accept is not None:
                    ids = ids[np.asarray(accept(ids), bool)]
                return ids
            weight_fn = None
            if (self.sampling.strategy == "weighted"
                    and self.sampling.weights is not None):
                w = np.asarray(self.sampling.weights, np.float64)
                peak = w.max()
                weight_fn = lambda ids: w[ids] / peak
            return stream_cohort(
                self.sampling.stream_seed, round_idx, self.num_clients,
                self.sampling.effective_size(self.num_clients),
                weight_fn=weight_fn, accept_fn=accept,
                strict=accept is None)

    def select_available(self, gen: torch.Generator, available: np.ndarray,
                         k: int) -> np.ndarray:
        """An async dispatch draw of ``k`` clients from the idle set."""
        with span("cohort_plan.select_available", k=k):
            return sample_available(gen, available, k, self.sampling)


# ---------------------------------------------------------------- local train

class LocalTrain:
    """Stage 2: run ``client_round`` over a cohort.

    Per-client persistent state lives in a client-state store
    (``fl.population``: the device tree in memory, or sharded on the host
    with spill-to-disk), and client data comes through a view (the real
    splits, or a virtual population hashed onto them).  A cohort's rows
    are gathered from both before the round and its state scattered back
    after it; under full participation a dense store hands the executor
    its whole tree and takes the new one back."""

    def __init__(self, client_round, data, store, batch_size: int,
                 executor: ClientExecutor):
        self.executor = executor
        self.executor.bind(client_round)
        self.splits = data          # a SplitsView (the arrays pass through)
        self.store = store
        self.batch_size = batch_size
        self.n_train = data.n_train

    @property
    def state(self):
        """The whole client-stacked state (dense stores only)."""
        return self.store.state

    @state.setter
    def state(self, state) -> None:
        self.store.set_state(state)

    def batches(self, gen: torch.Generator, k: int) -> torch.Tensor:
        return client_epoch_batches(gen, k, self.n_train, self.batch_size)

    def _run(self, idx, batch_idx: torch.Tensor, servers: list):
        """Rows ``idx`` through the executor, row i against ``servers[i]``
        (one shared snapshot takes ``run_shared``); their persistent state
        written back -> stacked RoundOutput in ``idx`` order.  Every client
        in order (full participation) on a dense store runs on the whole
        stacked state, without a gather."""
        n = self.store.num_clients
        whole = (self.store.dense and len(idx) == n
                 and np.array_equal(np.asarray(idx), np.arange(n)))
        if whole:
            cx, cy, cvx, cvy = self.splits.all()
            pers = self.store.state
        else:
            cx, cy, cvx, cvy = self.splits.gather(idx)
            pers = self.store.gather(idx)
        args = (pers, cx, cy, cvx, cvy, batch_idx.to(cx.device))
        if all(srv is servers[0] for srv in servers[1:]):
            out = self.executor.run_shared(servers[0], *args)
        else:
            out = self.executor.run_stacked(servers, *args)
        if whole:
            self.store.set_state(out.persistent)
        else:
            self.store.scatter(idx, out.persistent)
        self._record_update_metrics(out)
        return out

    def _record_update_metrics(self, out) -> None:
        """Per-leaf sparsity of the cohort's reconstructed update and the
        mean Eq. 5 residual norm, as gauges; nothing (and no device read)
        without a metrics registry."""
        m = obs_metrics.get_registry()
        if not m.enabled:
            return
        with span("local_train.metrics"):
            for path, leaf in sorted_items(out.recon_delta_params):
                m.gauge(f"update.sparsity.{path}",
                        float((leaf == 0).double().mean()))
            for path, leaf in sorted_items(out.persistent.residual):
                flat = leaf.reshape(leaf.shape[0], -1).double()
                m.gauge(f"residual.norm.{path}",
                        float(torch.linalg.vector_norm(flat, dim=1).mean()))

    def train_cohort(self, idx: np.ndarray, batch_idx: torch.Tensor,
                     server: ServerState):
        """One barrier round over the cohort ``idx`` -> stacked
        RoundOutput."""
        if len(idx) == 0:
            raise EmptyCohortError("train_cohort received an empty cohort")
        with span("local_train.cohort", n=len(idx)):
            return self._run(idx, batch_idx, [server])

    def train_window(self, batch_idx: torch.Tensor, clients: list[int],
                     servers: list[ServerState]):
        """One async dispatch window in one executor call: row i trains
        ``clients[i]`` with its own batch order ``batch_idx[i]`` against
        the server snapshot ``servers[i]`` it was dispatched with."""
        if len(clients) == 0:
            raise EmptyCohortError("train_window received an empty window")
        with span("local_train.window", n=len(clients)):
            return self._run(clients, batch_idx, servers)

    def reinject_residual(self, client: int, delta: Any) -> None:
        """A dropped upload must not break Eq. 5: put the lost (decoded)
        delta back into that client's residual, ``residual + delta``, so
        its mass goes out again (the scale-delta section has no residual
        and stays lost)."""
        def as_tensor(d, like):
            if isinstance(d, torch.Tensor):
                return d.to(like.device)
            return torch.tensor(np.asarray(d, np.float32), device=like.device)

        if self.store.dense:
            def add(r, d):
                r[client] = r[client] + as_tensor(d, r)
                return r

            tree_map(add, self.store.state.residual, delta)
            return
        rows = self.store.gather([client])
        self.store.scatter([client], rows._replace(residual=tree_map(
            lambda r, d: r + as_tensor(d, r)[None], rows.residual, delta)))


# ---------------------------------------------------------------- uplink

def host_rows(trees: list[Any], k: int) -> list[list[Any]]:
    """Client rows of stacked trees (leading axis ``k``) as numpy, in ONE
    device-to-host copy: every leaf's rows, viewed as 32-bit words, go
    into one buffer that crosses once, and each client's leaves are numpy
    views of it (the tensors' own bits).  ``None`` trees stay ``None``.
    Returns, per tree, one tree of numpy leaves per client."""
    leaves_by_tree = [None if t is None else sorted_items(t) for t in trees]
    flat = [leaf for ls in leaves_by_tree if ls is not None
            for _, leaf in ls]
    if not flat:
        return [None if t is None else [t] * k for t in trees]
    words = [leaf.reshape(k, -1).contiguous().view(torch.int32)
             for leaf in flat]
    block = (torch.cat(words, dim=1) if len(words) > 1 else words[0]).cpu()
    block = block.numpy()
    out, col, width = [], 0, iter(w.shape[1] for w in words)
    for tree, ls in zip(trees, leaves_by_tree):
        if ls is None:
            out.append(None)
            continue
        views = {}
        for path, leaf in ls:
            n = next(width)
            np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
            views[path] = (block[:, col:col + n].view(np_dtype)
                           .reshape((k,) + tuple(leaf.shape[1:])))
            col += n
        out.append([rebuild(tree, {p: v[i] for p, v in views.items()})
                    for i in range(k)])
    return out


def account_sections(prefix: str, codec, spec, payload: bytes) -> None:
    """One payload's counters: ``<prefix>.payloads`` and the per-section
    bytes ``<prefix>.section.<name>.bytes`` (``Codec.payload_sections``);
    nothing without a registry."""
    m = obs_metrics.get_registry()
    if not m.enabled:
        return
    m.count(f"{prefix}.payloads", 1)
    for sec, n in codec.payload_sections(payload, spec).items():
        m.count(f"{prefix}.section.{sec}.bytes", n)


class Uplink:
    """Stage 3: the wire.  Encode each participant's update, decode it back;
    the engine aggregates the DECODED reconstructions, so ``payload_bytes``
    are lengths of payloads that provably decode.

    Host coders (``Codec.host_coder``) read the cohort's trees as numpy:
    they reach the host in one copy (``host_rows``); a device coder reads
    the device rows.  Per-client round trips share no codec state, so
    ``uplink_workers > 1`` fans them out over a pool, ``"thread"`` (numpy
    releases the GIL; any codec) or ``"process"`` (host coders only: a
    ``forkserver`` pool that preloads ``repro_torch.comms``; never
    ``fork``, since the parent may hold a CUDA context).  Process workers
    take and return numpy, never tensors.  ``uplink_batch=True`` splits the
    cohort into at most ``workers`` contiguous chunks, one pool task each
    through ``Codec.encode_batch``/``decode_batch`` (process workers
    return ``comms.FlatDecoded``).  Results come back in submission order,
    so payloads are byte-identical to the serial route.  ``pool_tasks``
    counts the submissions.

    Under ``EngineConfig.device_encode`` the cohort is encoded by
    ``Codec.encode_cohort`` on the device.  Under streaming ingest the
    intake only encodes: contributions carry their payloads, and the
    scheduler folds the survivors through ``fl.ingest``."""

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
        self.workers = engine_cfg.uplink_workers
        self.executor_kind = engine_cfg.uplink_executor
        self.batch = engine_cfg.uplink_batch
        self.streaming = engine_cfg.ingest == "streaming"
        if (self.workers > 1 and self.executor_kind == "process"
                and not self.codec.host_coder):
            raise ValueError(
                f"codec {self.codec.name!r} encodes on the device; process "
                "workers code host numpy arrays: use uplink_executor="
                "'thread' or a host codec")
        self._ex = None
        self.pool_tasks = 0

    # -- device -> host ----------------------------------------------------

    def fetch(self, out, k: int) -> list[comms.ClientUpdate]:
        """One ``ClientUpdate`` a client: numpy rows in one copy for a host
        coder (only the trees it reads; BN under schema v2), or device
        rows for a device coder."""
        need_levels = "levels" in self.codec.needs
        need_recon = "recon" in self.codec.needs or self.spec.ternary
        trees = [out.levels_params if need_levels else None,
                 out.levels_scales if need_levels else None,
                 out.recon_delta_params if need_recon else None,
                 out.recon_delta_scales if need_recon else None,
                 out.bn_state if self.spec.version == 2 else None]
        with span("uplink.fetch"):
            if self.codec.host_coder:
                rows = host_rows(trees, k)
            else:
                rows = [None if t is None else [row(t, i) for i in range(k)]
                        for t in trees]
        return [comms.ClientUpdate(*(None if r is None else r[i]
                                     for r in rows[:4]),
                                   bn=None if rows[4] is None else rows[4][i])
                for i in range(k)]

    # -- wire round trips --------------------------------------------------

    def _account_payload(self, payload: bytes) -> None:
        account_sections("uplink", self.codec, self.spec, payload)

    def _account_opaque(self, sizes: list[int]) -> None:
        """Process-pool results: the workers never see the parent's
        registry, so only the payload totals are counted."""
        m = obs_metrics.get_registry()
        if not m.enabled:
            return
        m.count("uplink.payloads", len(sizes))
        m.count("uplink.section.opaque.bytes", sum(sizes))

    def _roundtrip(self, upd: comms.ClientUpdate):
        with span("uplink.roundtrip"):
            payload = self.codec.encode(upd, self.spec)
            self._account_payload(payload)
            return len(payload), self.codec.decode(payload, self.spec)

    def _roundtrip_batch(self, chunk: list[comms.ClientUpdate],
                         clients: list[int] | None):
        with span("uplink.roundtrip_batch", n=len(chunk)):
            payloads = self.codec.encode_batch(chunk, self.spec,
                                               clients=clients)
            for p in payloads:
                self._account_payload(p)
            decs = self.codec.decode_batch(payloads, self.spec,
                                           clients=clients)
            return [(len(p), d) for p, d in zip(payloads, decs)]

    def _executor(self):
        if self._ex is None:
            if self.executor_kind == "thread":
                self._ex = ThreadPoolExecutor(self.workers)
            else:
                ctx = multiprocessing.get_context("forkserver")
                ctx.set_forkserver_preload(["repro_torch.comms"])
                self._ex = ProcessPoolExecutor(
                    self.workers, mp_context=ctx,
                    initializer=comms_pool.init,
                    initargs=(self.codec, self.spec))
        return self._ex

    def roundtrip_all(self, upds: list[comms.ClientUpdate],
                      clients: list[int] | None = None):
        """Encode and decode every update -> ``(payload bytes, Decoded)``
        pairs in submission order.  Without ``uplink_batch``, one
        ``_roundtrip`` a client (in a pool task each with ``workers > 1``);
        with it, one batch call over the cohort, or one a contiguous chunk
        with ``workers > 1``."""
        comms.check_batch_clients(clients, len(upds), "updates")
        pooled = self.workers > 1 and len(upds) > 1
        if not self.batch and not pooled:
            return [self._roundtrip(u) for u in upds]
        if not pooled:
            return self._roundtrip_batch(upds, clients)
        ex = self._executor()
        thread = self.executor_kind == "thread"
        if not self.batch:
            self.pool_tasks += len(upds)
            results = list(ex.map(self._roundtrip if thread
                                  else comms_pool.roundtrip, upds))
            if not thread:
                self._account_opaque([n for n, _ in results])
            return results
        bounds = np.array_split(np.arange(len(upds)),
                                min(self.workers, len(upds)))
        chunks = [([upds[i] for i in b],
                   None if clients is None else [clients[i] for i in b])
                  for b in bounds if len(b)]
        self.pool_tasks += len(chunks)
        if thread:
            futs = [ex.submit(self._roundtrip_batch, ch, cl)
                    for ch, cl in chunks]
            return [r for f in futs for r in f.result()]
        futs = [ex.submit(comms_pool.roundtrip_chunk, ch, cl)
                for ch, cl in chunks]
        results = [(n, comms.unflatten_decoded(flat, self.spec))
                   for f in futs for n, flat in f.result()]
        self._account_opaque([n for n, _ in results])
        return results

    def close(self) -> None:
        if self._ex is not None:
            self._ex.shutdown()
            self._ex = None

    # -- device cohort encode ----------------------------------------------

    def _device_payloads(self, out, clients: list[int]):
        """The cohort's payloads from ``Codec.encode_cohort``, or None where
        the codec has no device route; ``uplink.kernel_dispatches`` counts
        the device programs it took."""
        before = comms_device.dispatch_count()
        with span("uplink.device_encode", n=len(clients),
                  codec=self.codec.name):
            payloads = self.codec.encode_cohort(out, self.spec,
                                                clients=clients)
        m = obs_metrics.get_registry()
        if m.enabled:
            m.count("uplink.kernel_dispatches",
                    comms_device.dispatch_count() - before)
        return payloads

    # -- RoundOutput -> Contributions --------------------------------------

    def _metric_rows(self, out, k: int) -> list[dict[str, float]]:
        host = {name: v.detach().cpu().numpy() for name, v in
                out.metrics.items()}
        return [{name: float(v[i]) for name, v in host.items()}
                for i in range(k)]

    def intake(self, out, clients: list[int]) -> list[Contribution]:
        """Stacked cohort RoundOutput -> one Contribution per client."""
        with span("uplink.intake", n=len(clients), transmit=self.transmit):
            return self._intake(out, clients)

    def _intake(self, out, clients: list[int]) -> list[Contribution]:
        k = len(clients)
        metrics = self._metric_rows(out, k)
        if not self.transmit:
            return [Contribution(
                client=c, delta_params=row(out.recon_delta_params, i),
                delta_scales=row(out.recon_delta_scales, i),
                bn_state=row(out.bn_state, i), metrics=metrics[i])
                for i, c in enumerate(clients)]
        if self.streaming:
            return self._intake_streaming(out, clients, metrics)
        results = None
        if self.device_encode:
            payloads = self._device_payloads(out, clients)
            if payloads is not None:
                for p in payloads:
                    self._account_payload(p)
                results = [(len(p), d) for p, d in zip(
                    payloads, self.codec.decode_batch(payloads, self.spec,
                                                      clients=clients))]
        if results is None:
            results = self.roundtrip_all(self.fetch(out, k), clients)
        # under v2 the BN statistics are what the payload carried
        return [Contribution(
            client=c, delta_params=dec.params, delta_scales=dec.scales,
            bn_state=(dec.bn if self.spec.version == 2
                      else row(out.bn_state, i)),
            payload_bytes=nbytes, metrics=metrics[i])
            for i, (c, (nbytes, dec)) in enumerate(zip(clients, results))]

    def _intake_streaming(self, out, clients: list[int],
                          metrics) -> list[Contribution]:
        """Encode-only intake for streaming ingest: each contribution
        carries its payload and, for Eq. 5 re-injection after a drop or a
        quarantine, its device reconstruction row (bitwise the decoded
        tree for the level codecs); under v1 also its device BN row."""
        payloads = None
        if self.device_encode:
            payloads = self._device_payloads(out, clients)
        if payloads is None:
            with span("uplink.encode_batch", n=len(clients)):
                payloads = self.codec.encode_batch(
                    self.fetch(out, len(clients)), self.spec,
                    clients=clients)
        for p in payloads:
            self._account_payload(p)
        return [Contribution(
            client=c, delta_params=row(out.recon_delta_params, i),
            delta_scales=None,
            bn_state=(None if self.spec.version == 2
                      else row(out.bn_state, i)),
            payload_bytes=len(p), payload=p, metrics=metrics[i])
            for i, (c, p) in enumerate(zip(clients, payloads))]


# ---------------------------------------------------------------- aggregate

class Aggregate:
    """Stage 4: the plain mean of the survivors' contributions, or, with
    weights (the async buffer's), their weighted mean.

    The weighted mean folds each tree as the reference folds it, which
    depends on where the reference holds that tree: a decoded payload tree
    (params and scales on the wire; BN under schema v2) is host numpy
    there and folds in float64 (``TreeAccumulator``), while schema v1's BN
    rows and the no-wire reconstructions stay on its device and fold as a
    float32 ``sum(w_i * l_i)``.  ``transmit`` and ``bn_on_wire`` say which
    applies; where the port's tensors live does not matter."""

    def __init__(self, device: torch.device, transmit: bool = True,
                 bn_on_wire: bool = False):
        self.device = device
        self.host_deltas = transmit
        self.host_bn = transmit and bn_on_wire

    def __call__(self, contribs: list[Contribution],
                 weights: np.ndarray | None = None) -> AggregatedRound:
        if not contribs:
            raise ValueError("cannot aggregate zero contributions")
        with span("aggregate", n=len(contribs),
                  weighted=weights is not None):
            return self._mean(contribs, weights)

    def _mean(self, contribs: list[Contribution],
              weights: np.ndarray | None) -> AggregatedRound:
        if weights is None:
            def mean(trees, host):
                return tree_mean0(stack_trees(trees, self.device))
        else:
            def mean(trees, host):
                return weighted_mean_trees(trees, weights, host=host,
                                           device=self.device)

        return AggregatedRound(
            delta_params=mean([c.delta_params for c in contribs],
                              self.host_deltas),
            delta_scales=mean([c.delta_scales for c in contribs],
                              self.host_deltas),
            bn_state=mean([c.bn_state for c in contribs], self.host_bn))


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
        with span("server_step"):
            return self._step(server, agg, downlink, receivers, transmit)

    def _step(self, server, agg, downlink, receivers, transmit):
        updates, self.state = server_update(self.opt, self.state,
                                            agg.delta_params, server.params)
        down_bytes = 0
        with span("downlink", active=downlink.active):
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
            # the one payload, before the fan-out ``downlink.bytes`` counts
            account_sections("downlink", self.codec, self.spec, payload)
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
        with span("evaluate"):
            return float(self._eval(server, self.test_x, self.test_y))


# ---------------------------------------------------------------- scheduler

class RoundScheduler:
    """Policy deciding who trains when and what one aggregation consumes.

    A scheduler is bound to a :class:`~repro_torch.fl.engine.
    FederatedEngine` and drives the engine's own ``CohortPlan``,
    ``LocalTrain`` and ``Uplink``; it never aggregates or steps the server
    itself: it returns a :class:`RoundIntake`, and the engine runs
    ``Aggregate``, ``ServerStep``, ``Downlink`` and ``Evaluate``."""

    def bind(self, engine, gen: torch.Generator, plan=None) -> None:
        raise NotImplementedError

    def next_round(self) -> RoundIntake:
        raise NotImplementedError

    def log_line(self, rec, intake: RoundIntake) -> str:
        """The verbose line of one aggregation, from its record and
        intake: the reference's line, field for field."""
        raise NotImplementedError


class SyncScheduler(RoundScheduler):
    """Cohort barrier: one cohort per aggregation, everyone against the
    same server snapshot.

    Cohorts and batch orders come from the scheduler's ``torch.Generator``,
    or, for runs held against the reference, from ``plan``: one
    ``(cohort indices, (K, steps, batch) batch indices)`` pair per round,
    as numpy arrays.  In the streaming regime (a population axis or a
    traffic model) the cohort is the hash draw
    ``CohortPlan.select_stream``, whatever the plan says (a planned cohort
    that differs raises); an availability trough that gives no client
    advances the clock one step of the trace's 96 a day and draws again.

    With a channel model the simulated clock advances by the round's
    slowest ``down + up`` transfer (the download is the last broadcast's
    size, read before this round's server step); with a traffic model too
    each participant's compute latency joins its legs, and without a
    channel the clock waits for the slowest computer.  Each upload is then
    dropped or not by its (round, client) draw.  A traffic model's churn
    coin loses a participant mid-round: treated as a drop, but its bytes
    are not charged (it never uploaded).  Dropped bytes stay charged, only
    the survivors aggregate, the whole cohort receives the broadcast, and
    under error feedback each lost client's decoded delta goes back into
    its residual."""

    def bind(self, engine, gen: torch.Generator, plan=None) -> None:
        self.eng = engine
        self.gen = gen
        self.plan = None if plan is None else list(plan)
        self.round_idx = 0
        self.sim_clock = 0.0
        self.churned_total = 0

    def _day_step(self) -> float:
        traffic = self.eng.traffic
        return (traffic.cfg.day_s if traffic is not None else 96.0) / 96.0

    def _select_cohort(self) -> np.ndarray:
        """The streaming cohort; the clock advances through empty
        availability troughs (at most 1000 steps)."""
        for _ in range(1000):
            idx = self.eng.cohort.select_stream(self.round_idx,
                                                self.sim_clock)
            if len(idx):
                return idx
            self.sim_clock += self._day_step()
        raise RuntimeError(
            "sync scheduler stalled: no client passed the availability "
            "filter after 1000 clock advances; the traffic trace is "
            "pathologically thin")

    def next_round(self) -> RoundIntake:
        eng = self.eng
        self.round_idx += 1
        planned = None
        if self.plan is not None:
            if self.round_idx > len(self.plan):
                raise ValueError(f"the plan covers {len(self.plan)} rounds; "
                                 f"round {self.round_idx} was asked for")
            planned = self.plan[self.round_idx - 1]
        if eng.cohort.streaming:
            idx = self._select_cohort()
            if planned is not None and not np.array_equal(
                    np.asarray(planned[0]), idx):
                raise ValueError(f"planned cohort {list(planned[0])} is not "
                                 f"the streamed one {idx.tolist()}")
        elif planned is not None:
            idx = np.asarray(planned[0])
        else:
            idx = eng.cohort.select(self.gen)
        if planned is not None:
            bidx = torch.tensor(np.asarray(planned[1]), dtype=torch.long)
        else:
            bidx = (eng.local_train.batches(self.gen, len(idx)) if len(idx)
                    else None)
        clients = [int(c) for c in idx]
        cohort = len(clients)
        try:
            out = eng.local_train.train_cohort(idx, bidx, eng.server)
        except EmptyCohortError:
            # a zero-size cohort: an all-drop round, with no contributions
            # and no server step (the engine skips it without survivors);
            # the clock moves one step of a 96-step day
            self.sim_clock += self._day_step()
            return RoundIntake([], [], receivers=0, sim_time=self.sim_clock)
        contribs = eng.uplink.intake(out, clients)

        traffic = eng.traffic
        lost: list[int] = []
        if traffic is not None and traffic.cfg.churn_rate > 0.0:
            for i in range(cohort):
                if traffic.churned(clients[i], self.round_idx):
                    lost.append(i)
                    contribs[i].payload_bytes = 0     # never uploaded
            self.churned_total += len(lost)
        chan = eng.channel
        if eng.uplink.transmit and chan is not None:
            sizes = [c.payload_bytes for c in contribs]
            ref = eng.broadcast_ref_bytes()
            if traffic is None:
                self.sim_clock += chan.round_time(clients, sizes, ref,
                                                  self.round_idx)
            else:
                self.sim_clock += max(
                    (chan.down_time(c, ref, self.round_idx)
                     + traffic.latency(c)
                     + chan.up_time(c, n, self.round_idx)
                     for c, n in zip(clients, sizes)), default=0.0)
            lost.extend(i for i in range(cohort)
                        if i not in lost
                        and chan.dropped(self.round_idx, clients[i]))
        elif traffic is not None:
            # no channel: the barrier waits for the slowest computer
            self.sim_clock += max((traffic.latency(c) for c in clients),
                                  default=0.0)
        if lost and eng.protocol_cfg.error_feedback:
            for i in lost:
                eng.local_train.reinject_residual(clients[i],
                                                  contribs[i].delta_params)
        survivors = [i for i in range(cohort) if i not in lost]
        for c in contribs:
            c.arrival_time = self.sim_clock
        preagg = None
        if eng.streaming_ingest:
            preagg, survivors = self._fold_streaming(contribs, survivors,
                                                     clients)
        return RoundIntake(contribs, survivors, receivers=cohort,
                           sim_time=self.sim_clock, preagg=preagg)

    def _fold_streaming(self, contribs: list[Contribution],
                        survivors: list[int], clients: list[int]):
        """Decode and fold the survivors' payloads in cohort order
        (``fl.ingest``).  A corrupt payload is quarantined: out of the
        survivors (its bytes stay charged, as a drop's) and, under error
        feedback, its client's device reconstruction goes back into its
        residual (Eq. 5).  Under v1 the BN state is the same device mean
        as ``Aggregate``'s.  -> (AggregatedRound or None, survivors)."""
        eng = self.eng
        ing = eng.make_ingest()
        for i in survivors:
            ing.submit(contribs[i].client, contribs[i].payload)
        res = ing.finish()
        if res.rejected:
            rej = {survivors[r.seq] for r in res.rejected}
            survivors = [i for i in survivors if i not in rej]
            if eng.protocol_cfg.error_feedback:
                for i in sorted(rej):
                    eng.local_train.reinject_residual(
                        clients[i], contribs[i].delta_params)
        if not survivors:
            return None, survivors
        bn = (res.bn if eng.uplink.spec.version == 2 else tree_mean0(
            stack_trees([contribs[i].bn_state for i in survivors],
                        eng.device)))
        return AggregatedRound(delta_params=res.delta_params,
                               delta_scales=res.delta_scales,
                               bn_state=bn), survivors

    def log_line(self, rec, intake: RoundIntake) -> str:
        line = (f"round {rec.round:3d} acc={rec.test_acc:.3f} "
                f"cohort={len(intake.survivors)}/{len(intake.contributions)} "
                f"up={rec.up_bytes / 1e6:.3f}MB "
                f"sparsity={rec.update_sparsity:.3f}")
        if self.eng.channel is not None or self.eng.traffic is not None:
            line += f" t_sim={rec.sim_time_s:.2f}s"
        if self.churned_total:
            line += f" churned={self.churned_total}"
        return line


@dataclasses.dataclass
class AsyncPlan:
    """The draws of an async run held against the reference: the client
    latency vector (seconds), each ``select_available`` draw in order
    (sorted client arrays), each trained member's ``(steps, batch)`` batch
    indices in training order, and, for the streaming regime, the seed of
    its hash-keyed latencies (the reference draws it from a JAX key)."""
    latencies: np.ndarray | None
    draws: list
    batches: list
    lat_seed: int | None = None


@dataclasses.dataclass
class _InFlight:
    client: int
    start_version: int
    server: ServerState
    finish: float
    seq: int = 0     # the dispatch counter, which keys the churn coin (a
                     # client dispatched again draws a fresh one)


class BufferedAsyncScheduler(RoundScheduler):
    """FedBuff buffer: M concurrent clients, one aggregation every B
    arrivals with staleness weights; per-client latencies drive a
    simulated clock.

    Completions pop in dispatch windows: every in-flight client whose
    finish time lies within ``AsyncConfig.dispatch_window`` of the earliest
    finisher trains in ONE executor call (``LocalTrain.train_window``),
    each row against the server snapshot it started from.
    ``dispatch_window=0`` pops exactly one completion, ties broken by
    client id; ``adaptive_window`` takes finishers in (finish, client)
    order while each one's gap to the one before is at most the per-call
    saving (``call_saving_s``, or ``load_call_saving()``'s default).
    Contributions enter the buffer in ``(arrival_time, client)`` order and
    the clock is clamped so that recorded arrivals never go backwards; a
    window that overfills the buffer aggregates the whole buffer.  The
    replacements of a window are dispatched at the top of the next pop,
    so those that follow an aggregation train from the newest server
    version.  Staleness is the engine's ``version`` (which rises only
    after a round with survivors) less the version a client started from.

    With a channel a dispatch starts after ``down_time`` of the current
    broadcast (``broadcast_ref_bytes``) and an arrival is the finish time
    plus ``up_time`` of the payload; async has no drops.

    In the streaming regime (a population axis or a traffic model) there
    are no per-client arrays: replacements are hash draws
    (``stream_cohort``) that exclude the in-flight set, and latencies come
    from the traffic model or a lognormal keyed by client on
    ``prand``.  A draw short in an availability trough is made up at the
    next pop; with nobody in flight the clock advances one step of the
    trace's 96 a day.  The traffic model's churn coin, keyed by dispatch,
    drops a finisher before it uploads: its slot frees and a replacement
    is queued; after 1000 fully churned windows in a row the buffer so far
    is aggregated (an all-drop round when empty).

    Latencies (or the streaming latency seed), replacement draws and
    batch orders come from the scheduler's ``torch.Generator``, or, held
    against the reference, from an :class:`AsyncPlan`."""

    def bind(self, engine, gen: torch.Generator, plan=None) -> None:
        self.eng = engine
        self.gen = gen
        self.plan = plan
        self._draws = None if plan is None else list(plan.draws)
        self._batches = None if plan is None else list(plan.batches)
        acfg = engine.async_cfg
        self.acfg = acfg
        self.traffic = engine.traffic
        self.stream = engine.cohort.streaming
        self.concurrency = min(acfg.concurrency, engine.num_clients)
        self.now = 0.0
        self.seq = 0       # dispatches issued (the churn coin's key)
        self.draws = 0     # stream_cohort calls (the sampling key)
        self.churned_total = 0
        self.saving = 0.0
        if acfg.adaptive_window:
            self.saving = (acfg.call_saving_s if acfg.call_saving_s
                           is not None else load_call_saving())
        self.in_flight: list[_InFlight] = []
        if self.stream:
            self.latency = None
            if plan is not None and plan.lat_seed is not None:
                self.lat_seed = int(plan.lat_seed)
            else:
                self.lat_seed = int(torch.randint(0, 2 ** 31 - 1, (),
                                                  generator=gen))
            self.busy: set[int] = set()
            for c in self._stream_draw(self.concurrency):
                self._launch(int(c))
        else:
            self.latency = (np.asarray(plan.latencies) if plan is not None
                            else client_latencies(gen, engine.num_clients,
                                                  acfg))
            self.available = set(range(engine.num_clients))
            for c in self._draw(self.concurrency):
                self.available.discard(c)
                self.in_flight.append(_InFlight(
                    c, 0, engine.server,
                    self._dispatch_delay(c) + float(self.latency[c]),
                    seq=self._next_seq()))
        self.pending_dispatch = 0
        self.batch_sizes: list[int] = []   # executor-call window sizes

    # -- dispatch plumbing -------------------------------------------------

    def _next_seq(self) -> int:
        s = self.seq
        self.seq += 1
        return s

    def _draw(self, k: int) -> list[int]:
        available = np.array(sorted(self.available))
        if self._draws is None:
            idx = self.eng.cohort.select_available(self.gen, available, k)
        else:
            if not self._draws:
                raise ValueError("the async plan has no draw left")
            idx = np.asarray(self._draws.pop(0))
            if (len(idx) != min(k, len(available))
                    or not set(idx.tolist()) <= self.available):
                raise ValueError(f"planned draw {idx.tolist()} is not {k} "
                                 f"of the idle clients {available.tolist()}")
        return [int(c) for c in idx]

    def _batch_rows(self, n: int) -> torch.Tensor:
        if self._batches is None:
            lt = self.eng.local_train
            return torch.stack([epoch_batches(self.gen, lt.n_train,
                                              lt.batch_size)
                                for _ in range(n)])
        if len(self._batches) < n:
            raise ValueError("the async plan has no batch order left")
        rows = [self._batches.pop(0) for _ in range(n)]
        return torch.tensor(np.stack(rows), dtype=torch.long)

    def _dispatch_delay(self, client: int) -> float:
        """The model-download leg of a dispatch (with a channel only)."""
        if self.eng.channel is None:
            return 0.0
        return self.eng.channel.down_time(client,
                                          self.eng.broadcast_ref_bytes())

    def _lat(self, client: int) -> float:
        """Simulated compute seconds of one dispatch of ``client``."""
        if self.traffic is not None:
            return self.traffic.latency(client)
        if self.latency is not None:
            return float(self.latency[client])
        # streaming without traffic: the AsyncConfig lognormal, keyed by
        # client, whatever the population's size or order
        if self.acfg.latency_sigma == 0.0:
            return self.acfg.latency_mean
        z = float(prand.normal(self.lat_seed, prand.TAG_LATENCY, client))
        return self.acfg.latency_mean * float(np.exp(
            self.acfg.latency_sigma * z))

    def _stream_draw(self, k: int) -> np.ndarray:
        """One streaming replacement draw (not strict: a trough may give
        fewer than ``k``; the caller queues the rest)."""
        if k <= 0:
            return np.empty(0, np.int64)
        eng = self.eng
        accept = None
        if self.traffic is not None:
            traffic, now, rd = self.traffic, self.now, self.draws
            accept = lambda ids: traffic.available(ids, now, rd)
        idx = stream_cohort(
            eng.engine_cfg.sampling.stream_seed, self.draws,
            eng.num_clients, k, accept_fn=accept, exclude=self.busy,
            strict=False)
        self.draws += 1
        return idx

    def _launch(self, client: int) -> None:
        self.busy.add(client)
        self.in_flight.append(_InFlight(
            client, self.eng.version, self.eng.server,
            self.now + self._dispatch_delay(client) + self._lat(client),
            seq=self._next_seq()))

    def _dispatch_one(self) -> None:
        eng = self.eng
        (nxt,) = self._draw(1)
        self.available.discard(nxt)
        self.in_flight.append(_InFlight(
            nxt, eng.version, eng.server,
            self.now + self._dispatch_delay(nxt) + float(self.latency[nxt]),
            seq=self._next_seq()))

    def _dispatch(self, n: int) -> int:
        """Dispatch up to ``n`` replacements -> how many launched (all
        ``n`` but in an availability trough)."""
        if n <= 0:
            return 0
        if not self.stream:
            for _ in range(n):
                self._dispatch_one()
            return n
        idx = self._stream_draw(n)
        for c in idx:
            self._launch(int(c))
        return len(idx)

    def _free(self, client: int) -> None:
        if self.stream:
            self.busy.discard(client)
        else:
            self.available.add(client)

    def _pop_window(self) -> list[_InFlight]:
        """The in-flight clients finishing within ``dispatch_window`` of the
        earliest finisher, in (finish, client) order; exactly one with a
        window of 0; with ``adaptive_window`` the finishers in that order
        while each one's gap to the one before is at most the per-call
        saving."""
        key = (lambda f: (f.finish, f.client))
        if self.acfg.adaptive_window:
            order = sorted(self.in_flight, key=key)
            window = [order[0]]
            for e in order[1:]:
                if e.finish - window[-1].finish > self.saving:
                    break
                window.append(e)
        elif self.acfg.dispatch_window <= 0.0:
            window = [min(self.in_flight, key=key)]
        else:
            t0 = min(f.finish for f in self.in_flight)
            window = sorted((f for f in self.in_flight
                             if f.finish <= t0 + self.acfg.dispatch_window),
                            key=key)
        for e in window:
            self.in_flight.remove(e)
        return window

    def _intake_of(self, buffer: list[Contribution]) -> RoundIntake:
        if self.eng.streaming_ingest:
            return self._flush_streaming(buffer)
        w = (normalized_staleness_weights([b.staleness for b in buffer],
                                          self.acfg.staleness_exponent)
             if buffer else None)
        return RoundIntake(buffer, list(range(len(buffer))),
                           receivers=self.concurrency, sim_time=self.now,
                           weights=w)

    def next_round(self) -> RoundIntake:
        eng = self.eng
        buffer: list[Contribution] = []
        stalls = churn_stalls = 0
        while True:
            self.pending_dispatch -= self._dispatch(self.pending_dispatch)
            if not self.in_flight:
                # every slot waits out an availability trough (the
                # traffic-gated streaming regime only)
                stalls += 1
                if stalls > 1000:
                    raise RuntimeError(
                        "async scheduler stalled: no client passed the "
                        "availability filter after 1000 clock advances")
                self.now += (self.traffic.cfg.day_s / 96.0
                             if self.traffic is not None else 1.0)
                continue
            stalls = 0
            window = self._pop_window()
            if self.traffic is not None and self.traffic.cfg.churn_rate > 0.0:
                kept = []
                for e in window:
                    if self.traffic.churned(e.client, e.seq):
                        # the dispatch vanishes before it uploads: its slot
                        # frees and a replacement is queued
                        self.churned_total += 1
                        self._free(e.client)
                        self.pending_dispatch += 1
                    else:
                        kept.append(e)
                window = kept
                if not window:
                    churn_stalls += 1
                    if churn_stalls > 1000:
                        return self._intake_of(buffer)
                    continue
            churn_stalls = 0
            clients = [e.client for e in window]
            out = eng.local_train.train_window(
                self._batch_rows(len(window)), clients,
                [e.server for e in window])
            self.batch_sizes.append(len(window))
            obs_metrics.observe("async.batch_size", len(window))
            contribs = eng.uplink.intake(out, clients)
            for e, c in zip(window, contribs):
                c.staleness = eng.version - e.start_version
                c.arrival_time = e.finish + (
                    eng.channel.up_time(e.client, c.payload_bytes)
                    if eng.channel is not None else 0.0)
                self._free(e.client)
            contribs.sort(key=lambda c: (c.arrival_time, c.client))
            for c in contribs:
                self.now = max(self.now, c.arrival_time)
                c.arrival_time = self.now
            buffer.extend(contribs)
            self.pending_dispatch += len(window)
            if len(buffer) >= self.acfg.buffer_size:
                return self._intake_of(buffer)

    def _flush_streaming(self, buffer: list[Contribution]) -> RoundIntake:
        """Decode at flush: fold the buffered payloads in buffer order with
        the FedBuff staleness weights: the weights, trees and fold order
        of the gather path's ``weighted_mean_trees``, so the aggregate is
        bitwise the gather's when every payload decodes.  A corrupt
        payload drops its entry (async has no residual to re-inject; its
        bytes stay charged), the weights renormalise over the rest and
        the fold runs again.  Under v1 the BN state is the gather's
        device fold of the rows."""
        eng = self.eng
        keep = list(range(len(buffer)))
        while keep:
            w = normalized_staleness_weights(
                [buffer[i].staleness for i in keep],
                self.acfg.staleness_exponent)
            ing = eng.make_ingest()
            for j, i in enumerate(keep):
                ing.submit(buffer[i].client, buffer[i].payload, weight=w[j])
            res = ing.finish()
            if not res.rejected:
                break
            rej = {keep[r.seq] for r in res.rejected}
            keep = [i for i in keep if i not in rej]
        if not keep:
            return RoundIntake(buffer, [], receivers=self.concurrency,
                               sim_time=self.now)
        bn = (res.bn if eng.uplink.spec.version == 2 else weighted_mean_trees(
            [buffer[i].bn_state for i in keep], w, host=False,
            device=eng.device))
        preagg = AggregatedRound(delta_params=res.delta_params,
                                 delta_scales=res.delta_scales, bn_state=bn)
        return RoundIntake(buffer, keep, receivers=self.concurrency,
                           sim_time=self.now, weights=w, preagg=preagg)

    def log_line(self, rec, intake: RoundIntake) -> str:
        line = (f"agg {rec.round:3d} acc={rec.test_acc:.3f} "
                f"t_sim={rec.sim_time_s:.2f}s "
                f"staleness={[c.staleness for c in intake.contributions]} "
                f"up={rec.up_bytes / 1e6:.3f}MB")
        if self.churned_total:
            line += f" churned={self.churned_total}"
        return line


SCHEDULERS = {"sync": SyncScheduler, "async": BufferedAsyncScheduler}
