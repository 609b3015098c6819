"""The serving model: KV-cache Llama-family decoder, sampling, generate."""
