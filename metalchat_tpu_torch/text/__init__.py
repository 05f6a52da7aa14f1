"""Tokenizer protocol and streaming decode."""
