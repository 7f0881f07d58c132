"""qwen2.5-3b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B family]"""
from repro_torch.common.types import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    attention=AttentionKind.FULL,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)
