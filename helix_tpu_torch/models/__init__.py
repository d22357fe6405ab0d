"""Model configs and the Llama-family decoder."""
