"""Pixtral-12B — Mistral-Nemo text backbone + Pixtral ViT frontend (STUBBED).

[hf:mistralai/Pixtral-12B-2409; unverified]
40L, d_model 5120, 32 heads (GQA kv=8, head_dim 128), d_ff 14336,
vocab 131072. The vision frontend is a stub per the assignment:
``input_specs()`` provides precomputed patch embeddings that occupy the
first ``n_patches`` positions of the sequence.
"""

from ..base import LayerDesc, ModelConfig, register

PIXTRAL_12B = register(
    ModelConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=131072,
        pattern=(LayerDesc(mixer="gqa", ffn="dense"),),
        qkv_bias=False,
        rope_theta=1_000_000.0,
        ffn_act="swiglu",
        norm_type="rmsnorm",
        norm_eps=1e-5,
        frontend="vision_patches",
        n_patches=256,
        source="hf:mistralai/Pixtral-12B-2409 (unverified)",
    )
)
