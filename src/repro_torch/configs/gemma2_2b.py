"""gemma2-2b [dense]: local+global alternating, logit softcap [arXiv:2408.00118]."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000, act="gelu_tanh",
    window=4096, local_global_period=2,
    attn_softcap=50.0, final_softcap=30.0, embed_scale=True,
    citation="arXiv:2408.00118",
)
