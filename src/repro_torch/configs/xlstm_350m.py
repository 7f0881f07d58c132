"""xlstm-350m [ssm] — alternating sLSTM + mLSTM blocks, attention-free.

d_ff=0: xLSTM blocks integrate their up/down projections (pre-up-projection
mLSTM, post-up-projection sLSTM per arXiv:2405.04517); no separate MLP.
Decode carries a recurrent state (matrix memory C, normalizer n) instead of
a KV cache => long_500k runs natively (state is O(1) in sequence length).
[arXiv:2405.04517]
"""
from repro_torch.common.types import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attention=AttentionKind.RECURRENT,
    slstm_every=2,                # every 2nd block is sLSTM (1:1 mix)
    source="arXiv:2405.04517",
)
