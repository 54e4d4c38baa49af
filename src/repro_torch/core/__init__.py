"""Host-side decoder model of the port: codes, quantization, framing, engine."""
