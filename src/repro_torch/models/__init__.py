"""LM scaffolding of the port: the ssm family (falcon-mamba-7b) so far."""
