"""LM cards the port has ported, quarantined under ``_unused/`` as in the
reference: nothing on the decoder path imports them."""
