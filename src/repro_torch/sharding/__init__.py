"""Logical-axis rules and the placement of tensors over a device mesh:
the decoder's lane axis and the LM's parameters, caches and activations."""
