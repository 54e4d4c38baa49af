"""Serving-side helpers of the port (so far the symbol-validation errors)."""
