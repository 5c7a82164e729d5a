"""recurrentgemma-9b [hybrid]: RG-LRU + local attn, pattern (R,R,A) [arXiv:2402.19427]."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000, act="gelu_tanh",
    window=2048, hybrid_pattern=("R", "R", "A"),
    rglru_width=4096, embed_scale=True,
    citation="arXiv:2402.19427",
)
