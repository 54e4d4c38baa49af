"""The port's LM layers, GQA attention, blocks and model assembly
(``repro._unused.models`` counterpart, decoder-only GQA path)."""
