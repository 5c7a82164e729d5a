"""The port's architecture registry against the reference's: the same ten
names, every field of every config (the dtype as its torch twin), the
dimensions pinned as ``tests/test_arch_smoke.py`` pins them, ``reduced()``,
``long_variant``, ``supports_shape``, ``LONG_OK``, ``SHAPES``, the input
specs of every (arch, shape) pair, ``make_inputs``'s shapes and dtypes, and
``init_params``'s tree for the full configs against ``jax.eval_shape`` of
the reference's (no allocation on either side)."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as rbase
from repro.configs import all_configs as r_all
from repro.models import transformer as rt
import repro_torch.configs.base as pbase
from repro_torch import configs as pconfigs
from repro_torch.models import transformer as pt

NAMES = sorted(r_all())
DTYPES = {jnp.float32: torch.float32, jnp.int32: torch.int32}


def fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(out["dtype"]).replace("torch.", "").replace(
        "<class 'jax.numpy.", "").rstrip("'>")
    return out


def test_same_names_in_the_same_order():
    assert list(pconfigs.all_configs()) == list(r_all())
    assert pbase.ARCH_MODULES == rbase.ARCH_MODULES
    assert pbase.LONG_OK == rbase.LONG_OK
    assert {k: dataclasses.asdict(v) for k, v in pbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()}


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_and_reduced(name):
    ref, got = r_all()[name], pconfigs.get(name)
    assert fields(got) == fields(ref)
    assert fields(got.reduced()) == fields(ref.reduced())
    assert fields(pconfigs.long_variant(got)) == fields(
        rbase.long_variant(ref))
    for cfg, rcfg in ((got, ref), (got.reduced(), ref.reduced())):
        assert cfg.layer_windows() == rcfg.layer_windows()
        assert cfg.padded_vocab(1) == rcfg.padded_vocab(1)
        assert dataclasses.asdict(cfg.attn_spec(1, False)) == \
            dataclasses.asdict(rcfg.attn_spec(1, False))
        for spec in ("moe_spec", "ssm_spec", "rglru_spec"):
            assert dataclasses.asdict(getattr(cfg, spec)()) == \
                dataclasses.asdict(getattr(rcfg, spec)())
    assert got.dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_input_specs_and_supported_shapes(name):
    ref, got = r_all()[name], pconfigs.get(name)
    for shape in rbase.SHAPES:
        assert pconfigs.supports_shape(got, shape) == \
            rbase.supports_shape(ref, shape)
        r_specs = rbase.input_specs(ref, shape)
        p_specs = pconfigs.input_specs(got, shape)
        assert list(p_specs) == list(r_specs)
        for k, s in r_specs.items():
            assert p_specs[k] == (s.shape, DTYPES[s.dtype.type]), (shape, k)


def test_exact_assigned_dimensions():
    """``tests/test_arch_smoke.py``'s pins on the port's configs."""
    cfgs = pconfigs.all_configs()
    expect = {
        "whisper-small": (12, 768, 12, 12, 3072, 51865),
        "dbrx-132b": (40, 6144, 48, 8, 10752, 100352),
        "gemma2-9b": (42, 3584, 16, 8, 14336, 256000),
        "mixtral-8x22b": (56, 6144, 48, 8, 16384, 32768),
        "qwen2-vl-72b": (80, 8192, 64, 8, 29568, 152064),
        "internlm2-1.8b": (24, 2048, 16, 8, 8192, 92544),
        "recurrentgemma-9b": (38, 4096, 16, 1, 12288, 256000),
        "mistral-large-123b": (88, 12288, 96, 8, 28672, 32768),
        "gemma2-2b": (26, 2304, 8, 4, 9216, 256000),
    }
    for name, (L, d, h, kv, ff, v) in expect.items():
        c = cfgs[name]
        assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
                c.vocab) == (L, d, h, kv, ff, v), name
    m = cfgs["mamba2-370m"]
    assert (m.n_layers, m.d_model, m.vocab, m.ssm_d_state) == (48, 1024,
                                                                50280, 128)
    assert cfgs["dbrx-132b"].n_experts == 16 and cfgs["dbrx-132b"].top_k == 4
    assert cfgs["mixtral-8x22b"].n_experts == 8 and \
        cfgs["mixtral-8x22b"].top_k == 2
    for cfg in cfgs.values():
        r = cfg.reduced()
        assert r.n_layers <= 3 and r.d_model <= 512 and r.n_experts <= 4


def test_get_loads_the_ports_module():
    cfg = pconfigs.get("gemma2-2b")
    mod = importlib.import_module("repro_torch.configs.gemma2_2b")
    assert cfg is mod.CONFIG and isinstance(cfg, pt.ArchConfig)
    assert mod.__name__.startswith("repro_torch.configs.")
    assert pconfigs.get("internlm2-1.8b").name == "internlm2-1.8b"
    with pytest.raises(ModuleNotFoundError):
        pconfigs.get("gpt2")


def test_vgg11_cifar_is_the_ports_vgg11():
    from repro_torch.configs import vgg11_cifar
    from repro_torch.models import CNNModel
    m = vgg11_cifar.make(10)
    assert isinstance(m, CNNModel) and m.name == "vgg11_thinned"


@pytest.mark.parametrize("name", NAMES)
def test_make_inputs_shapes(name):
    ref, got = r_all()[name].reduced(), pconfigs.get(name).reduced()
    r_in = rbase.make_inputs(jax.random.PRNGKey(0), ref, 2, 16)
    p_in = pconfigs.make_inputs(torch.Generator().manual_seed(0), got, 2, 16)
    assert list(p_in) == list(r_in)
    for k, v in r_in.items():
        assert tuple(p_in[k].shape) == v.shape, k
        assert p_in[k].dtype == DTYPES[v.dtype.type], k
    if "mrope_positions" in r_in:
        np.testing.assert_array_equal(np.asarray(r_in["mrope_positions"]),
                                      p_in["mrope_positions"].numpy())
        np.testing.assert_array_equal(np.asarray(r_in["patch_positions"]),
                                      p_in["patch_positions"].numpy())
    assert int(p_in["tokens"].max()) < got.vocab


@pytest.mark.parametrize("name", NAMES)
def test_full_width_param_tree(name):
    cfg = r_all()[name]
    shapes = jax.eval_shape(lambda k: rt.init_params(k, cfg, rt.SINGLE),
                            jax.random.PRNGKey(0))
    assert pt.param_shapes(pconfigs.get(name)) == jax.tree.map(
        lambda s: tuple(s.shape), shapes)
