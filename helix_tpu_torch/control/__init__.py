"""The node agent and the serving profiles it applies."""
