"""Quantization: packed weights and the W4A8/W8A8 linear."""
