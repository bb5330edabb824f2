"""Tokenizers, corpora and sequence packing for the training steps."""
