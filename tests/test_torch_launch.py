"""The port's serving launchers (``repro_torch.launch.ingest_serve``,
``launch.serve``) and its ``require_dist`` against the reference's, on
the CPU:

* ``synthetic_cohort``: levels and reconstructions bit for bit the
  reference's for the same ``k``, ``density`` and ``seed``, the same raw
  byte count, and the same wire schema;
* the port's ``encode_batch`` of that cohort: payloads byte-equal to the
  reference codec's (nnc-cabac and exp-Golomb);
* ``serve_cohort``: the folded means bit for bit the reference's float64
  fold of the same payloads, with the vectorized and the speculative
  decoder, inline and on a decode thread;
* ``main(["--k", "4", "--rounds", "1", "--device", "cpu"])`` returns
  stats with 4 accepted payloads; ``serve.main`` without ``--arch``
  delegates every argument to it;
* ``require_dist`` returns ``repro_torch.dist``, and exits with
  ``DIST_MISSING_MSG`` (which names it) where it cannot be imported.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from repro import comms as ref_comms
from repro.fl.ingest import IngestConfig as RefIngestConfig
from repro.launch import ingest_serve as ref_serve
from repro_torch import comms, launch
from repro_torch.fl.ingest import IngestConfig
from repro_torch.launch import ingest_serve, serve
from repro_torch.tree import sorted_items


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree) -> dict:
    return {p: np.asarray(v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else v)
            for p, v in sorted_items(tree)}


def _bitwise(got, want) -> None:
    got, want = _flat(got), _flat(jax.device_get(want))
    assert got.keys() == want.keys()
    for p, v in want.items():
        assert got[p].dtype == v.dtype, p
        assert got[p].shape == v.shape, p
        assert got[p].tobytes() == v.tobytes(), p


COHORTS = [(4, 0.04, 0), (3, 0.2, 5), (6, 0.01, 1)]


@pytest.mark.parametrize("k,density,seed", COHORTS)
def test_synthetic_cohort_bitwise_the_reference(k, density, seed):
    upds, spec, raw = ingest_serve.synthetic_cohort(k, density, seed)
    ref_upds, ref_spec, ref_raw = ref_serve.synthetic_cohort(k, density,
                                                             seed)
    assert raw == ref_raw and len(upds) == len(ref_upds) == k
    for u, r in zip(upds, ref_upds):
        for part in ("levels_params", "levels_scales", "recon_params",
                     "recon_scales"):
            _bitwise(getattr(u, part), getattr(r, part))
    assert spec.ternary and ref_spec.ternary
    assert (spec.step_size, spec.fine_step_size) == (
        ref_spec.step_size, ref_spec.fine_step_size)
    assert {p: s.shape for p, s in sorted_items(spec.params)} == {
        p: tuple(s.shape) for p, s in sorted_items(ref_spec.params)}
    assert _flat(spec.fine_mask) == _flat(ref_spec.fine_mask)


@pytest.mark.parametrize("codec", ["nnc-cabac", "golomb"])
def test_encode_batch_bytes_equal_the_reference(codec):
    upds, spec, _ = ingest_serve.synthetic_cohort(5)
    ref_upds, ref_spec, _ = ref_serve.synthetic_cohort(5)
    got = comms.get_codec(codec).encode_batch(upds, spec,
                                              clients=list(range(5)))
    want = ref_comms.get_codec(codec).encode_batch(ref_upds, ref_spec,
                                                   clients=list(range(5)))
    assert [bytes(p) for p in got] == [bytes(p) for p in want]


@pytest.mark.parametrize("workers", [0, 1])
@pytest.mark.parametrize("engine", ["vectorized", "speculative"])
def test_serve_cohort_fold_bitwise_the_reference(engine, workers):
    k = 6
    upds, spec, _ = ingest_serve.synthetic_cohort(k, seed=2)
    ref_upds, ref_spec, _ = ref_serve.synthetic_cohort(k, seed=2)
    codec, ref_codec = comms.get_codec("nnc-cabac"), ref_comms.get_codec(
        "nnc-cabac")
    payloads = codec.encode_batch(upds, spec, clients=list(range(k)))
    res = ingest_serve.serve_cohort(
        codec, payloads, spec,
        IngestConfig(chunk=4, workers=workers, decode_engine=engine))
    ref = ref_serve.serve_cohort(
        ref_codec, payloads, ref_spec,
        RefIngestConfig(chunk=4, workers=workers, decode_engine=engine))
    assert res.accepted == ref.accepted == k and not res.rejected
    _bitwise(res.delta_params, ref.delta_params)
    _bitwise(res.delta_scales, ref.delta_scales)
    assert res.weight_sum == ref.weight_sum
    assert res.stats.bytes == ref.stats.bytes == sum(len(p)
                                                      for p in payloads)


def test_main_serves_the_cohort_on_the_cpu(capsys):
    stats = ingest_serve.main(["--k", "4", "--rounds", "1", "--device",
                               "cpu"])
    assert stats.accepted == 4 and stats.payloads == 4
    assert stats.payloads_per_s > 0 and stats.mb_per_s > 0
    assert "best:" in capsys.readouterr().out


def test_main_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ingest_serve.main(["--k", "2", "--rounds", "1"])


def test_serve_without_arch_delegates_to_ingest_serve(monkeypatch):
    seen = []
    monkeypatch.setattr(ingest_serve, "main",
                        lambda argv: seen.append(list(argv)) or "stats")
    argv = ["--k", "4", "--engine", "speculative", "--device", "cpu"]
    assert serve.main(argv) == "stats"
    assert seen == [argv]


def test_serve_front_door_runs_end_to_end():
    stats = serve.main(["--k", "3", "--rounds", "1", "--device", "cpu",
                        "--codec", "golomb"])
    assert stats.accepted == 3


def test_require_dist(monkeypatch):
    import repro_torch.dist
    assert launch.require_dist() is repro_torch.dist
    assert "repro_torch.dist" in launch.DIST_MISSING_MSG
    monkeypatch.setitem(sys.modules, "repro_torch.dist", None)
    with pytest.raises(SystemExit) as e:
        launch.require_dist()
    assert str(e.value) == launch.DIST_MISSING_MSG
