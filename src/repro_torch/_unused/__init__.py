"""The port's LM serving path, quarantined under ``_unused/`` as in the
reference: nothing on the decoder path imports it.

``models/`` (layers, GQA attention, blocks, the decoder-only LM),
``serve/serve_step.py`` (prefill, cached greedy decode) and
``flash_attention.py`` (the CUDA flash kernel's wrapper and plain version).
It imports torch and numpy, never JAX and nothing of ``repro``.
"""
