"""Serve-LLM: the paged-KV continuous-batching engine on PyTorch."""

from .cache import OutOfPages, PageAllocator
from .engine import (EngineConfig, LLMEngine, OutputDelta, Request,
                     SamplingParams)
from .tokenizer import ByteTokenizer, get_tokenizer

__all__ = ["ByteTokenizer", "EngineConfig", "LLMEngine", "OutOfPages",
           "OutputDelta", "PageAllocator", "Request", "SamplingParams",
           "get_tokenizer"]
