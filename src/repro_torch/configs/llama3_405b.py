"""llama3-405b [dense] — GQA, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.common.types import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    attention=AttentionKind.FULL,
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)
