"""llama-3.2-vision-90b [vlm] — cross-attention image layers every 5th layer.

The vision frontend (ViT encoder + projector) is STUBBED per the assignment
carve-out: ``input_specs`` provides precomputed patch embeddings of shape
(batch, num_vision_tokens, d_model). [hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.common.types import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    attention=AttentionKind.FULL,
    cross_attn_every=5,           # 20 cross-attn layers out of 100
    num_vision_tokens=1601,       # 1 tile x (40x40 patches + cls), 11B-Vision card
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
