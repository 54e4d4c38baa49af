"""RWKV-6 (Finch) 3B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b; hf-verified]
32L, d_model 2560 (40 heads × 64), channel-mix d_ff 8960, vocab 65536.
``long_500k`` runs: O(1) recurrent state per layer.
"""

from ..base import LayerDesc, ModelConfig, register

RWKV6_3B = register(
    ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,  # d_model / rwkv_head_dim
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab=65536,
        pattern=(LayerDesc(mixer="rwkv6", ffn="dense"),),
        ffn_act="rwkv_cm",  # RWKV channel mixing (relu² keyed FFN + receptance)
        norm_type="layernorm",
        norm_eps=1e-5,
        rwkv_head_dim=64,
        rwkv_decay_lora=64,
        rwkv_gate_lora=64,
        source="arXiv:2404.05892",
    )
)
