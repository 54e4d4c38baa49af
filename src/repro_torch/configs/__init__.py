"""Model configurations of the port's LM path (``repro.configs`` counterpart)."""
