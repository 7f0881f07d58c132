"""hubert-xlarge [audio] — encoder-only transformer backbone.

The conv feature extractor / mel frontend is STUBBED per the assignment
carve-out: inputs are precomputed frame embeddings (batch, frames, d_model).
Encoder-only => no decode step; decode_32k / long_500k are skipped (see
DESIGN.md §4). [arXiv:2106.07447]
"""
from repro_torch.common.types import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,               # k-means target codebook units
    attention=AttentionKind.ENCODER,
    frontend_stub_dim=1280,
    source="arXiv:2106.07447",
)
