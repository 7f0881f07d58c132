"""recurrentgemma-2b [hybrid] — RG-LRU blocks + local attention, 1:2 pattern.

Pattern period 3: (rglru, rglru, local-attn). Decode state = RG-LRU hidden
state + a local-window KV cache (window 2048) => sub-quadratic, long_500k
runs natively. [arXiv:2402.19427]
"""
from repro_torch.common.types import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,                # 26 blocks; pattern rounds to 1 attn per 3
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    attention=AttentionKind.LOCAL_HYBRID,
    hybrid_period=3,
    local_window=2048,
    source="arXiv:2402.19427",
)
