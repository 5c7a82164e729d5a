"""Modality frontend stubs.  Port of ``repro.models.frontend``.

[audio] whisper: the mel-spectrogram and conv feature extractor is a stub;
`audio_embeds` gives the (B, n_frames, d_model) frame embeddings the
encoder consumes.

[vlm] qwen2-vl: the ViT encoder and projector is a stub; `vision_embeds`
gives pre-projected patch embeddings and the positions where they sit in
the token sequence, and `mrope_positions` builds the 3-D (temporal,
height, width) M-RoPE ids of a text+image layout.

The stubs draw from an explicit ``torch.Generator`` on its device, so their
values are not the reference's; only their shapes and dtypes are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def audio_embeds(gen: torch.Generator, batch: int, n_frames: int,
                 d_model: int, dtype=torch.float32):
    """Stub conv-frontend output: smooth random frame embeddings (coarse
    draws resized linearly, as ``jax.image.resize(..., "linear")``)."""
    coarse = torch.randn((batch, max(n_frames // 8, 1), d_model),
                         generator=gen, device=gen.device)
    x = F.interpolate(coarse.transpose(1, 2), size=n_frames, mode="linear",
                      align_corners=False).transpose(1, 2)
    return (x * 0.02).to(dtype)


def vision_embeds(gen: torch.Generator, batch: int, n_patches: int,
                  d_model: int, seq_len: int, dtype=torch.float32):
    """Stub ViT output: patch embeddings and their slot positions in the
    sequence (a contiguous image region starting at position 1)."""
    assert n_patches + 1 <= seq_len
    emb = (torch.randn((batch, n_patches, d_model), generator=gen,
                       device=gen.device) * 0.02).to(dtype)
    pos = (1 + torch.arange(n_patches, device=gen.device)).expand(
        batch, n_patches)
    return emb, pos.to(torch.int32)


def mrope_positions(batch: int, seq_len: int, image_start: int = 1,
                    grid_t: int = 1, grid_h: int = 0, grid_w: int = 0,
                    device=None):
    """(3, B, S) int32 position ids: text positions advance all three axes
    together; image patches take (t, h, w) grid coordinates offset at the
    image start."""
    n_img = grid_t * grid_h * grid_w
    base = torch.arange(seq_len, device=device)
    if n_img == 0:
        p = base.expand(batch, seq_len)
        return torch.stack([p, p, p], dim=0).to(torch.int32)
    t_ids, h_ids, w_ids = (torch.arange(n, device=device)
                           for n in (grid_t, grid_h, grid_w))
    t_ids = torch.repeat_interleave(t_ids, grid_h * grid_w)
    h_ids = torch.repeat_interleave(h_ids, grid_w).repeat(grid_t)
    w_ids = w_ids.repeat(grid_t * grid_h)
    img_span = base - image_start                         # 0.. within image
    in_img = (img_span >= 0) & (img_span < n_img)
    clip = torch.clamp(img_span, 0, n_img - 1)
    # text after the image continues from max(image positions) + 1
    after = max(grid_t, grid_h, grid_w)
    shift = torch.where(base >= image_start + n_img,
                        after + base - (image_start + n_img), base)
    out = torch.stack([torch.where(in_img, image_start + ids[clip], shift)
                       for ids in (t_ids, h_ids, w_ids)], dim=0)
    return out[:, None, :].expand(3, batch, seq_len).to(torch.int32)
