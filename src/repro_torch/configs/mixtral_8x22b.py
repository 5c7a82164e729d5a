"""mixtral-8x22b [moe]: 8 experts top-2, SWA [arXiv:2401.04088]."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, capacity_factor=1.25,
    window=4096,                              # sliding-window on every layer
    tie_embeddings=False,
    citation="arXiv:2401.04088",
)
