"""Minitron-8B — width-pruned Nemotron-4 15B (squared-ReLU MLP, no gate).

[arXiv:2407.14679; hf:nvidia/Minitron-8B-Base; hf-verified]
32L, d_model 4096, 48→32 heads (GQA kv=8), d_ff 16384, vocab 256000.
"""

from ..base import LayerDesc, ModelConfig, register

MINITRON_8B = register(
    ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=256_000,
        pattern=(LayerDesc(mixer="gqa", ffn="dense"),),
        qkv_bias=False,
        rope_theta=10_000.0,
        ffn_act="relu2",  # nemotron family uses squared ReLU, ungated
        norm_type="layernorm",
        norm_eps=1e-5,
        source="arXiv:2407.14679",
    )
)
