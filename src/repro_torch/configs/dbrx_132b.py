"""dbrx-132b [moe]: 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352,
    n_experts=16, top_k=4, capacity_factor=1.25,
    tie_embeddings=False,
    citation="hf:databricks/dbrx-base",
)
