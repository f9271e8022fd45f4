"""Serving: the Serve-LLM engine (serve/llm)."""
