"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution (ViT stubbed) [arXiv:2409.12191]."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064,
    mrope_sections=(16, 24, 24),              # hd/2 = 64 frequency slots
    num_image_tokens=256,
    tie_embeddings=False,
    citation="arXiv:2409.12191",
)
