"""Serving loops of the port: the LM continuous batcher."""
