"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2. [hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.common.types import ArchConfig, AttentionKind, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(num_experts=16, top_k=2),
    attention=AttentionKind.FULL,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
