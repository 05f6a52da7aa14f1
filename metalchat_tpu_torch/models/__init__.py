"""Llama model: prefill (`transformer.forward`) and decode (`decode.decode_step`)."""
