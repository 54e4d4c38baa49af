"""SeamlessM4T-medium — encoder-decoder multimodal (speech/text) transformer.

[arXiv:2308.11596; hf:facebook/seamless-m4t-medium; hf-verified]
12L encoder + 12L decoder, d_model 1024, 16 heads (kv=16), d_ff 4096,
vocab 256206. The speech frontend (conformer feature extractor) is a STUB
per the assignment: ``input_specs()`` provides precomputed frame embeddings
for the encoder. Decode shapes run the text decoder with a precomputed
encoder context.
"""

from ..base import LayerDesc, ModelConfig, register

SEAMLESS_M4T_MEDIUM = register(
    ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=12,  # decoder layers
        n_encoder_layers=12,
        encdec=True,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab=256_206,
        pattern=(LayerDesc(mixer="gqa", ffn="dense"),),
        qkv_bias=True,
        rope_theta=10_000.0,
        ffn_act="gelu",
        norm_type="layernorm",
        norm_eps=1e-5,
        frontend="audio_frames",
        source="arXiv:2308.11596",
    )
)
