"""Qwen2.5-32B — dense GQA decoder with QKV bias.

[hf:Qwen/Qwen2.5-32B; arXiv:2412.15115; hf-verified]
64L, d_model 5120, 40 heads (GQA kv=8), d_ff 27648, vocab 152064.
"""

from ..base import LayerDesc, ModelConfig, register

QWEN2_5_32B = register(
    ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab=152064,
        pattern=(LayerDesc(mixer="gqa", ffn="dense"),),
        qkv_bias=True,
        rope_theta=1_000_000.0,
        ffn_act="swiglu",
        norm_type="rmsnorm",
        norm_eps=1e-6,
        source="hf:Qwen/Qwen2.5-32B",
    )
)
