"""StarCoder2-3B — code model: GQA kv=2, RoPE, sliding window 4096,
ungated GELU MLP, LayerNorm, bias terms.

[arXiv:2402.19173; hf:bigcode/starcoder2-3b; hf-verified]
30L, d_model 3072, 24 heads (GQA kv=2), d_ff 12288, vocab 49152.
"""

from ..base import LayerDesc, ModelConfig, register

STARCODER2_3B = register(
    ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab=49152,
        pattern=(LayerDesc(mixer="gqa", ffn="dense"),),
        qkv_bias=True,
        rope_theta=100_000.0,
        sliding_window=4096,
        ffn_act="gelu",
        norm_type="layernorm",
        norm_eps=1e-5,
        tie_embeddings=True,
        source="arXiv:2402.19173",
    )
)
