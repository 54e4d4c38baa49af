"""The port's LM layers, attention and SSM mixers, MoE, blocks and model
assembly (``repro._unused.models`` counterpart)."""
