"""Tokenization + chat templating for the serving surface.

A copy of ``helix_tpu/serving/tokenizer.py`` (pure Python, no JAX): the port
keeps its own so it imports nothing from the JAX package.

The reference delegates tokenization to vLLM inside its containers; here the
engine works on token ids, so the serving layer owns the text boundary:

- ``HFTokenizer`` reads a local ``tokenizer.json`` (checkpoints are mounted
  like model weights; no network fetch) with the port's pure-Python
  reader, ``serving/tokenizer_json.py``, in place of the reference's
  ``tokenizers`` runtime: same ids, same text.
- ``ByteTokenizer`` is a dependency-free UTF-8 byte fallback used by tests
  and as a safety net when a model directory ships no tokenizer.
- Chat templating implements the Llama-3 instruct wire format natively plus
  a generic fallback; template choice keys off the model name the same way
  the reference's model catalogue carries per-model metadata
  (``api/pkg/model/models.go``).
"""

from __future__ import annotations

import os
from typing import Optional, Protocol, Sequence

from helix_tpu_torch.serving.tokenizer_json import TokenizerJSON


class Tokenizer(Protocol):
    def encode(self, text: str) -> list: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    @property
    def eos_ids(self) -> tuple: ...
    @property
    def vocab_size(self) -> int: ...
    def apply_chat_template(self, messages: list, add_generation_prompt: bool = True) -> list: ...


class ByteTokenizer:
    """UTF-8 bytes + 4 specials. id = byte + 4."""

    BOS, EOS, PAD, SEP = 0, 1, 2, 3
    OFFSET = 4

    @property
    def vocab_size(self) -> int:
        return 260

    @property
    def eos_ids(self) -> tuple:
        return (self.EOS,)

    def encode(self, text: str) -> list:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        bs = bytes(
            i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256
        )
        return bs.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages, add_generation_prompt=True) -> list:
        out = [self.BOS]
        for m in messages:
            out += self.encode(f"{m['role']}: ")
            out += self.encode(_content_text(m.get("content", "")))
            out.append(self.SEP)
        if add_generation_prompt:
            out += self.encode("assistant: ")
        return out


def _content_text(content) -> str:
    """OpenAI content can be a string or a list of typed parts."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(
            p.get("text", "") for p in content if p.get("type") == "text"
        )
    return str(content)


class HFTokenizer:
    """A local ``tokenizer.json`` read by the port's own code
    (``serving/tokenizer_json.py``): the ids and text the ``tokenizers``
    package gives for the same file, without that package."""

    def __init__(self, path: str, model_name: str = ""):
        self._tok = TokenizerJSON(path)
        self.model_name = model_name
        self._eos_ids = tuple(
            i
            for t in (
                "</s>",
                "<|eot_id|>",
                "<|end_of_text|>",
                "<|endoftext|>",
                "<|im_end|>",
                "<|end|>",
            )
            if (i := self._tok.token_to_id(t)) is not None
        )

    @property
    def vocab_size(self) -> int:
        return self._tok.vocab_size

    @property
    def eos_ids(self) -> tuple:
        return self._eos_ids

    def encode(self, text: str) -> list:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def _special(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def apply_chat_template(self, messages, add_generation_prompt=True) -> list:
        name = self.model_name.lower()
        if "llama-3" in name or self._special("<|start_header_id|>") is not None:
            return self._llama3_template(messages, add_generation_prompt)
        if "qwen" in name or self._special("<|im_start|>") is not None:
            return self._chatml_template(messages, add_generation_prompt)
        # generic fallback
        ids: list = []
        for m in messages:
            ids += self.encode(
                f"{m['role']}: {_content_text(m.get('content', ''))}\n"
            )
        if add_generation_prompt:
            ids += self.encode("assistant: ")
        return ids

    def _llama3_template(self, messages, add_gen) -> list:
        """Llama-3 instruct format (header/eot special tokens)."""
        bot = self._special("<|begin_of_text|>")
        soh = self._special("<|start_header_id|>")
        eoh = self._special("<|end_header_id|>")
        eot = self._special("<|eot_id|>")
        ids = [bot] if bot is not None else []
        for m in messages:
            ids += [soh, *self.encode(m["role"]), eoh]
            ids += self.encode("\n\n" + _content_text(m.get("content", "")))
            ids.append(eot)
        if add_gen:
            ids += [soh, *self.encode("assistant"), eoh]
            ids += self.encode("\n\n")
        return ids

    def _chatml_template(self, messages, add_gen) -> list:
        ims = self._special("<|im_start|>")
        ime = self._special("<|im_end|>")
        nl = self.encode("\n")
        ids: list = []
        for m in messages:
            ids += [ims, *self.encode(m["role"]), *nl]
            ids += self.encode(_content_text(m.get("content", "")))
            ids += [ime, *nl]
        if add_gen:
            ids += [ims, *self.encode("assistant"), *nl]
        return ids


def load_tokenizer(model_dir: Optional[str], model_name: str = ""):
    """The model dir's ``tokenizer.json`` if it ships one, else the byte
    fallback."""
    if model_dir:
        p = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(p):
            return HFTokenizer(p, model_name=model_name)
    return ByteTokenizer()


class IncrementalDetokenizer:
    """Streams text from a growing token list without re-decoding garbage at
    UTF-8/multi-token boundaries: re-decodes the full sequence and emits the
    stable suffix delta."""

    def __init__(self, tokenizer):
        self.tok = tokenizer
        self.ids: list = []
        self._emitted = ""

    def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        text = self.tok.decode(self.ids)
        # hold back a trailing replacement char (possible split UTF-8 rune)
        safe = text[:-1] if text.endswith("�") else text
        delta = safe[len(self._emitted):]
        self._emitted = safe
        return delta
