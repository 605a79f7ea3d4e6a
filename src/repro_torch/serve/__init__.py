"""Serving loops of the port: the LM continuous batcher and the SLO front
end over the index (with its fault injection)."""
