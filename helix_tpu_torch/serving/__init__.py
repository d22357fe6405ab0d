"""Tokenizer, engine loop, registry and the OpenAI HTTP surface."""
