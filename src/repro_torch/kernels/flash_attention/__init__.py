"""Flash-attention kernel: causal or full online-softmax attention
(``ops.flash_attention``)."""
