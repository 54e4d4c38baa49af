"""DeepSeek-V2 236B — MLA (multi-head latent attention) + fine-grained MoE.

[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2; hf-verified]
60L, d_model 5120, 128 heads, MLA kv_lora 512 (+64 rope), q_lora 1536,
qk_nope 128, v_head 128. MoE: 160 routed experts top-6 + 2 shared,
expert d_ff 1536; layer 0 uses a dense 12288 FFN. vocab 102400.
"""

from ..base import LayerDesc, ModelConfig, register

DEEPSEEK_V2_236B = register(
    ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,  # MLA: per-head keys reconstructed from the latent
        head_dim=128,
        d_ff=1536,  # routed expert width (assignment lists d_ff=1536)
        vocab=102_400,
        prefix=(LayerDesc(mixer="mla", ffn="dense"),),
        pattern=(LayerDesc(mixer="mla", ffn="moe"),),
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1536,
        d_ff_dense=12288,
        renorm_topk=False,  # deepseek scales by raw softmax probs
        rope_theta=10_000.0,
        ffn_act="swiglu",
        norm_type="rmsnorm",
        norm_eps=1e-6,
        source="arXiv:2405.04434",
    )
)
