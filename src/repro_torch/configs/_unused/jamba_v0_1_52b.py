"""Jamba-v0.1 52B — hybrid Mamba/attention (1:7) with MoE every 2nd layer.

[arXiv:2403.19887; hf:ai21labs/Jamba-v0.1; hf-verified]
32L, d_model 4096, 32 heads (GQA kv=8) on the attention layers,
d_ff 14336, vocab 65536. MoE: 16 experts top-2.
HF config: attn_layer_period=8, attn_layer_offset=4;
expert_layer_period=2, expert_layer_offset=1.
Mamba: d_state 16, d_conv 4, expand 2, dt_rank 256.
``long_500k`` runs: Mamba layers carry O(1) state; the 4 attention layers
use context-parallel KV.
"""

from ..base import LayerDesc, ModelConfig, register

_PATTERN = tuple(
    LayerDesc(
        mixer="gqa" if i % 8 == 4 else "mamba",
        ffn="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

JAMBA_V0_1_52B = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=65536,
        pattern=_PATTERN,  # repeats 4× to cover 32 layers
        n_experts=16,
        top_k=2,
        d_ff_expert=14336,
        d_ff_dense=14336,
        renorm_topk=True,
        rope_theta=10_000.0,  # jamba attn layers actually use no positional
        ffn_act="swiglu",
        norm_type="rmsnorm",
        norm_eps=1e-6,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
        mamba_dt_rank=256,
        source="arXiv:2403.19887",
    )
)
