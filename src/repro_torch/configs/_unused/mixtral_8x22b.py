"""Mixtral-8x22B — sparse MoE decoder: 8 experts, top-2 routing, GQA, SWA.

[arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1; hf-verified]
56L, d_model 6144, 48 heads (GQA kv=8), expert d_ff 16384, vocab 32768.
Sliding-window attention per the assignment spec — this makes ``long_500k``
sub-quadratic (rolling KV cache bounded by the window).
"""

from ..base import LayerDesc, ModelConfig, register

MIXTRAL_8X22B = register(
    ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=32768,
        pattern=(LayerDesc(mixer="gqa", ffn="moe"),),
        n_experts=8,
        top_k=2,
        d_ff_expert=16384,
        renorm_topk=True,
        sliding_window=4096,
        rope_theta=1_000_000.0,
        ffn_act="swiglu",
        norm_type="rmsnorm",
        norm_eps=1e-5,
        source="arXiv:2401.04088",
    )
)
