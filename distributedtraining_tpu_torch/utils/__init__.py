"""Observability: the serve.* metric registry."""
