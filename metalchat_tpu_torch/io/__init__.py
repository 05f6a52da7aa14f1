"""Checkpoint reading: safetensors documents and the HF Llama loader."""
