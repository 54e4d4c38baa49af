"""Serving steps of the port's LM path (``repro._unused.serve`` counterpart)."""
