"""mamba2-370m [ssm]: SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, vocab=50280,
    ssm_d_state=128, ssm_head_dim=64, ssm_expand=2,
    citation="arXiv:2405.21060",
)
