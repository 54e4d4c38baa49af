"""The port's LM path, quarantined under ``_unused/`` as in the reference:
nothing on the decoder path imports it.

``models/`` (layers, attention, MoE, the SSM mixers, blocks, the LM with its
enc-dec and VLM variants), ``serve/serve_step.py`` (prefill, cached greedy
decode), ``train/`` (AdamW, gradient compression, the synthetic data
stream, checkpoints, the train step) and ``flash_attention.py`` (the CUDA
flash kernel's wrapper and plain version). It imports torch and numpy,
never JAX and nothing of ``repro``.
"""
