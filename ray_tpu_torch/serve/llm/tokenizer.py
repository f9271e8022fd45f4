"""Tokenizers for the LLM stack (a copy of the JAX package's
serve/llm/tokenizer.py, which imports no JAX).

The reference gets tokenizers from HF transformers at runtime (ref:
llm/_internal/serve/deployments/llm/vllm/vllm_engine.py engine init). This
image has no model downloads, so the default is a self-contained byte-level
tokenizer (UTF-8 bytes + specials); a HF tokenizer can be injected via
`LLMConfig.tokenizer` when weights/tokenizers are available locally.
"""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    """UTF-8 bytes as token ids; BOS=256, EOS=257. Needs vocab >= 258."""

    vocab_size = 258
    bos_token_id = 256
    eos_token_id = 257

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")


def get_tokenizer(spec):
    """spec: None -> ByteTokenizer; a string -> HF AutoTokenizer path/name;
    any object with encode/decode -> used as-is."""
    if spec is None:
        return ByteTokenizer()
    if isinstance(spec, str):
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(spec)

        class _HF:
            vocab_size = tok.vocab_size
            bos_token_id = tok.bos_token_id
            eos_token_id = tok.eos_token_id

            def encode(self, text, add_bos=True):
                return tok.encode(text, add_special_tokens=add_bos)

            def decode(self, ids):
                return tok.decode(ids, skip_special_tokens=True)

        return _HF()
    return spec
