"""Command-R 35B — Cohere dense decoder: parallel attn+FFN block, no bias,
tied embeddings, LayerNorm.

[hf:CohereForAI/c4ai-command-r-v01; unverified]
40L, d_model 8192, 64 heads (GQA kv=8), d_ff 22528, vocab 256000.
"""

from ..base import LayerDesc, ModelConfig, register

COMMAND_R_35B = register(
    ModelConfig(
        name="command-r-35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22528,
        vocab=256_000,
        pattern=(LayerDesc(mixer="gqa", ffn="dense"),),
        qkv_bias=False,
        rope_theta=8_000_000.0,
        ffn_act="swiglu",
        norm_type="layernorm",
        norm_eps=1e-5,
        tie_embeddings=True,
        parallel_block=True,  # x + attn(ln(x)) + ffn(ln(x))
        source="hf:CohereForAI/c4ai-command-r-v01 (unverified)",
    )
)
