"""whisper-small [audio]: enc-dec, conv frontend stubbed [arXiv:2212.04356].

12 encoder + 12 decoder layers, d_model 768, 12 heads (MHA: kv=12), d_ff 3072,
vocab 51865, 1500 audio frames. Deviation: RoPE instead of whisper's
learned/sinusoidal positions (backbone shape exercise; noted in DESIGN.md).
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865, act="gelu",
    encoder_layers=12, encoder_ctx=1536,  # 1500 frames padded to 1536 (divisible by tp=16 and the 512 attention chunk)
    tie_embeddings=True,
    citation="arXiv:2212.04356",
)
