"""The port's engine against the reference's where no training decides
the outcome: a zero-size cohort, and the ``RunResult`` helpers.

* ``SamplingConfig(cohort_size=0)``: the reference's ``SyncScheduler``
  catches ``EmptyCohortError`` and records an all-drop round (participants
  ``()``, no bytes, no server step, NaN client metrics).  The port, from
  the reference's initial state and on its data, records the same round;
  its server state is the initial one, so its test accuracy equals the
  reference's within one image (convolutions sum in another order).
* ``final_acc`` (NaN with no records), ``rounds_to_acc``,
  ``bytes_to_acc``, ``metric_series`` and ``mean_metric`` give the
  reference's answers on the same records, NaN rounds included.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.core.protocol import make_protocol as ref_make_protocol
from repro.fl import engine as ref_engine
from repro.fl import scenarios as ref_scenarios
from repro.fl.sampling import SamplingConfig as RefSampling
from repro_torch import convert
from repro_torch.data.federated import FederatedSplits
from repro_torch.fl import engine, scenarios
from repro_torch.fl.sampling import SamplingConfig
from repro_torch.models import cnn


def test_zero_size_cohort_is_an_all_drop_round_as_in_the_reference():
    rounds = 2
    s = ref_scenarios.get_scenario("codec_int8_k4")
    cfg = ref_scenarios.build_protocol(s, rounds)
    model, splits = ref_scenarios.default_setting(8)
    ref_cfg = dataclasses.replace(ref_scenarios.build_engine(s),
                                  sampling=RefSampling(cohort_size=0))
    ref = ref_engine.FederatedEngine(model, cfg, splits,
                                     jax.random.PRNGKey(42), ref_cfg)
    ref_recs = ref.run(rounds).records

    k_init, _ = jax.random.split(jax.random.PRNGKey(42))
    init, _, _ = ref_make_protocol(model, cfg, 1)
    server0, pers0 = jax.device_get(init(k_init))
    port_s = scenarios.get_scenario("codec_int8_k4")
    port = engine.FederatedEngine(
        cnn.make_vgg("vgg_scenario", [8, 16, 32], 10, 3, dense_width=16,
                     pool_after=(0, 1, 2)),
        scenarios.build_protocol(port_s, rounds),
        FederatedSplits.from_numpy(*jax.device_get(
            (splits.client_x, splits.client_y, splits.client_val_x,
             splits.client_val_y, splits.test_x, splits.test_y))),
        engine_cfg=dataclasses.replace(scenarios.build_engine(port_s),
                                       sampling=SamplingConfig(cohort_size=0)),
        init_state=convert.initial_state(server0, pers0), device="cpu")
    params0 = {m: {n: v.clone() for n, v in d.items()}
               for m, d in port.server.params.items()}
    res = port.run(rounds)

    assert len(res.records) == len(ref_recs) == rounds
    for r, p in zip(ref_recs, res.records):
        assert p.round == r.round
        assert p.participants == r.participants == ()
        assert (p.up_bytes, p.down_bytes, p.cum_bytes) == (
            r.up_bytes, r.down_bytes, r.cum_bytes) == (0, 0, 0)
        for name in ("mean_val_acc", "update_sparsity", "train_loss"):
            assert math.isnan(getattr(p, name)) and math.isnan(
                getattr(r, name)), name
        assert abs(p.test_acc - r.test_acc) <= 1 / len(splits.test_y) + 1e-6
    for m, d in res.server.params.items():
        for n, v in d.items():
            assert torch.equal(v, params0[m][n])


def _records(module, rows):
    fields = {f.name for f in dataclasses.fields(module.RoundRecord)}
    return [module.RoundRecord(**{k: v for k, v in row.items()
                                  if k in fields}) for row in rows]


ROWS = [
    dict(round=1, test_acc=0.25, up_bytes=900, down_bytes=100, cum_bytes=1000,
         mean_val_acc=0.3, update_sparsity=0.9, train_loss=2.1, wall_s=1.0,
         participants=(0, 1)),
    dict(round=2, test_acc=0.25, up_bytes=0, down_bytes=0, cum_bytes=1000,
         mean_val_acc=float("nan"), update_sparsity=float("nan"),
         train_loss=float("nan"), wall_s=0.5, participants=()),
    dict(round=3, test_acc=0.5, up_bytes=800, down_bytes=0, cum_bytes=1800,
         mean_val_acc=0.55, update_sparsity=0.88, train_loss=1.7, wall_s=1.1,
         participants=(2,)),
    dict(round=4, test_acc=0.45, up_bytes=700, down_bytes=50, cum_bytes=2550,
         mean_val_acc=0.5, update_sparsity=0.91, train_loss=1.5, wall_s=0.9,
         participants=(0, 3)),
]


@pytest.mark.parametrize("n_rows", [0, 1, 2, 4])
def test_run_result_helpers_match_reference(n_rows):
    ref = ref_engine.RunResult("x", _records(ref_engine, ROWS[:n_rows]))
    port = engine.RunResult("x", _records(engine, ROWS[:n_rows]))
    if n_rows == 0:
        assert math.isnan(port.final_acc) and math.isnan(ref.final_acc)
    else:
        assert port.final_acc == ref.final_acc
    for target in (0.0, 0.25, 0.3, 0.5, 0.9):
        assert port.rounds_to_acc(target) == ref.rounds_to_acc(target)
        assert port.bytes_to_acc(target) == ref.bytes_to_acc(target)
    for name in ("test_acc", "mean_val_acc", "update_sparsity", "train_loss",
                 "up_bytes", "wall_s", "no_such_field"):
        assert port.metric_series(name) == ref.metric_series(name), name
        a, b = port.mean_metric(name), ref.mean_metric(name)
        assert a == b or (math.isnan(a) and math.isnan(b)), name
    assert np.isnan(port.mean_metric("no_such_field"))
