"""Architecture registry and input-shape specs.

Port of ``repro.configs.base``.  Shapes (global):

  train_4k     seq 4096,   batch 256  (train_step)
  prefill_32k  seq 32768,  batch 32   (serve prefill)
  decode_32k   seq 32768,  batch 128  (serve decode: ONE token, 32k KV cache)
  long_500k    seq 524288, batch 1    (long-context decode; sub-quadratic only)

``input_specs(cfg, shape)`` gives the (shape, dtype) of every model input at
the global batch, allocating nothing; ``make_inputs`` builds small concrete
inputs from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import importlib
import math

import torch

from repro_torch.models.transformer import ArchConfig

PACKAGE = "repro_torch.configs."


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_MODULES = [
    "whisper_small", "dbrx_132b", "gemma2_9b", "mixtral_8x22b",
    "qwen2_vl_72b", "internlm2_1_8b", "recurrentgemma_9b", "mamba2_370m",
    "mistral_large_123b", "gemma2_2b",
]

# long_500k applicability
LONG_OK = {"mamba2-370m", "recurrentgemma-9b", "gemma2-9b", "gemma2-2b",
           "mixtral-8x22b"}


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(
        PACKAGE + name.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    out = {}
    for m in ARCH_MODULES:
        cfg = importlib.import_module(PACKAGE + m).CONFIG
        out[cfg.name] = cfg
    return out


def long_variant(cfg: ArchConfig) -> ArchConfig:
    """SWA-only variant used for long_500k on dense archs with native
    windows (gemma2 family: global layers windowed too)."""
    if cfg.local_global_period and cfg.window:
        return dataclasses.replace(cfg, local_global_period=0,
                                   name=cfg.name + "_swa")
    return cfg


def supports_shape(cfg: ArchConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.name in LONG_OK
    return True


# ---------------------------------------------------------------------------
# input specs: (shape, dtype) at the global batch
# ---------------------------------------------------------------------------

def _sd(shape, dtype=torch.int32):
    return (tuple(shape), dtype)


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    s = SHAPES[shape_name]
    B, S = s.global_batch, s.seq_len
    dt = cfg.dtype
    if s.kind == "decode":
        # one token a sequence; the cache spec is built by the runtime
        return {"tokens": _sd((B,))}
    specs = {"tokens": _sd((B, S))}
    if s.kind == "train":
        specs["labels"] = _sd((B, S))
    if cfg.family == "encdec":
        specs["enc_embeds"] = _sd((B, cfg.encoder_ctx, cfg.d_model), dt)
    if cfg.family == "vlm":
        n_img = cfg.num_image_tokens
        specs["patch_embeds"] = _sd((B, n_img, cfg.d_model), dt)
        specs["patch_positions"] = _sd((B, n_img))
        specs["mrope_positions"] = _sd((3, B, S))
    return specs


def make_inputs(gen: torch.Generator, cfg: ArchConfig, batch: int,
                seq: int) -> dict:
    """Concrete small inputs on the generator's device."""
    from repro_torch.models import frontend
    dev = gen.device
    batch_d = {
        "tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                                device=dev, dtype=torch.int32),
        "labels": torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                                device=dev, dtype=torch.int32),
    }
    if cfg.family == "encdec":
        batch_d["enc_embeds"] = frontend.audio_embeds(
            gen, batch, cfg.encoder_ctx, cfg.d_model, cfg.dtype)
    if cfg.family == "vlm":
        n_img = min(cfg.num_image_tokens, seq - 1)
        emb, pos = frontend.vision_embeds(gen, batch, n_img, cfg.d_model,
                                          seq, cfg.dtype)
        batch_d["patch_embeds"] = emb
        batch_d["patch_positions"] = pos
        g = math.isqrt(n_img)
        batch_d["mrope_positions"] = frontend.mrope_positions(
            batch, seq, image_start=1, grid_t=1, grid_h=g,
            grid_w=max(n_img // max(g, 1), 1), device=dev)
    return batch_d
