"""granite-8b [dense] — llama-architecture code model. [arXiv:2405.04324]"""
from repro_torch.common.types import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    attention=AttentionKind.FULL,
    source="arXiv:2405.04324",
)
