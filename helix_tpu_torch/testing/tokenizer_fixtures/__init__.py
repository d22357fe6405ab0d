"""Three small ``tokenizer.json`` fixtures and the constants their checks
share (test scaffolding, not served code).

- ``llama3/tokenizer.json``: Llama-3 style: ``Split`` with the Llama-3
  pattern then ``ByteLevel(use_regex=False)``, BPE with
  ``ignore_merges``, a ``ByteLevel`` decoder and the Llama-3 special
  tokens.
- ``phi3/tokenizer.json``: Phi-3 / Llama-2 style: ``Prepend("▁")`` and
  ``Replace(" ", "▁")``, no pre-tokenizer, BPE with ``byte_fallback``
  over the 256 ``<0x00>`` ... ``<0xFF>`` tokens of the model's vocab and
  ``fuse_unk``, the decoder sequence ``Replace``, ``ByteFallback``,
  ``Fuse``, ``Strip``, and Phi-3's chat tokens.
- ``bert/tokenizer.json``: BERT / bge style: ``BertNormalizer``
  (lower case, accents stripped, CJK spaced), ``BertPreTokenizer``, the
  ``WordPiece`` model (``##`` pieces, ``[UNK]``, 100 characters a word),
  the ``WordPiece`` decoder, ``TemplateProcessing`` and BERT's five
  special tokens.  ``bert_tokenizer_json(vocab_size)`` pads its vocab
  with BERT's ``[unusedN]`` entries to a real vocab's size (30522 for
  bge-base), without ``tokenizers``.

Both are trained with the ``tokenizers`` package on source files of the
reference package (which does not change) by ``build_fixture``; a CPU
test rebuilds them and holds them equal to the committed files, and holds
the port's tokenizer to ``tokenizers`` on them.  ``DIGESTS`` are the
sha256 of the ids ``tokenizers`` gives for ``CONVERSATION`` (through
the reference's chat template) and for ``system_prompt()``; the CPU tests
assert them against ``tokenizers`` and ``chip_smoke.py`` against the
port's tokenizer on the card's machine, which has no ``tokenizers``.
"""

from __future__ import annotations

import hashlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = {"llama3": os.path.join(HERE, "llama3"),
            "phi3": os.path.join(HERE, "phi3"),
            "bert": os.path.join(HERE, "bert")}
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
# training text: sources of the reference package, which stays unchanged
CORPUS = (
    "helix_tpu/models/common.py", "helix_tpu/models/llama.py",
    "helix_tpu/models/loader.py", "helix_tpu/models/bge.py",
    "helix_tpu/ops/attention.py", "helix_tpu/ops/paged.py",
    "helix_tpu/ops/quant.py", "helix_tpu/ops/rope.py",
    "helix_tpu/serving/tokenizer.py",
)
VOCAB_SIZE = 3000
LLAMA3_SPECIALS = (
    "<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>", "<|reserved_special_token_2|>",
    "<|reserved_special_token_3|>", "<|start_header_id|>",
    "<|end_header_id|>", "<|reserved_special_token_4|>", "<|eot_id|>",
)
PHI3_SPECIALS = ("<unk>", "<s>", "</s>")
BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
PHI3_CHAT = ("<|endoftext|>", "<|assistant|>", "<|placeholder1|>",
             "<|placeholder2|>", "<|placeholder3|>", "<|placeholder4|>",
             "<|system|>", "<|end|>", "<|placeholder5|>",
             "<|placeholder6|>", "<|user|>")

# a conversation whose user turn carries a special token (the reference
# encodes it as the control token: ROADMAP C), CJK, emoji, No / Nl
# numbers and contractions
CONVERSATION = [
    {"role": "system", "content": "You are helix, a careful assistant."},
    {"role": "user", "content": "hi <|eot_id|> there: ½ of Ⅻ is 6, "
                                "世界 😀 — it's 2+2 and DON'T forget\r\n"},
    {"role": "assistant", "content": "Noted.  "},
    {"role": "user", "content": "Summarise the rules in one line."},
]
_RULES = (
    "Answer in the language of the question, and keep code fenced.",
    "Quote prices as 1,299.00 EUR or $1,299 - never both in one line.",
    "When a user writes 'don't', 'it's' or 'we'll', keep the contraction.",
    "Dates are ISO 8601 (2024-06-30T12:00:00Z); durations in seconds.",
    "Cite the section number, e.g. section 4.2.1, before you quote it.",
    "Refuse politely if the request needs data you do not have.",
    "Units: 3.35 TB/s, 989 TFLOP/s, 80 GB; never round without saying so.",
    "Names like Zoë, José and Łukasz keep their accents; so does café.",
)


def system_prompt(rules: int = 37) -> str:
    """The fixed long system prompt of the checks (~1500 tokens with
    either fixture)."""
    lines = ["You are helix, the operations assistant of a GPU fleet."]
    lines += [f"Rule {i + 1}: {_RULES[i % len(_RULES)]}"
              for i in range(rules)]
    return "\n".join(lines) + "\n"


def digest(ids) -> str:
    return hashlib.sha256(",".join(map(str, ids)).encode()).hexdigest()


# what ``tokenizers`` 0.22.2 gives (tests/test_torch_tokenizer.py)
DIGESTS = {
    "llama3": {
        "template": "f82fb116e88d18f85a775e9b0d05328c"
                    "e0a1fa2fe57bd3e9de850d51261172ee",
        "prompt": "f0474a76315227c698f382d5df7717c2"
                  "a3a49e098ce5fbda351ddd6bff8df9de"},
    "phi3": {
        "template": "0d2f2bdf28d71b96964d0bb610c807cf"
                    "27f7d5b8b4cf4e9578efbfb595c005d6",
        "prompt": "41e15fc898e45807b30bd517e8455cce"
                  "ac8a2a9d1e910fe48c7e8a83c88e500d"},
}


def _corpus() -> list:
    lines = []
    for rel in CORPUS:
        with open(os.path.join(REPO, rel), encoding="utf-8") as f:
            lines += [ln for ln in f.read().splitlines() if ln.strip()]
    return lines


def _build_bert() -> str:
    """A WordPiece vocab counted from the corpus (``tokenizers``' own
    WordPiece trainer breaks ties in hash order, so its files differ run
    to run): the specials, every character alone and as a ``##`` piece,
    then the most frequent words, word beginnings and ``##`` word endings
    (ties by the string) up to ``VOCAB_SIZE``."""
    from collections import Counter

    from tokenizers import (
        Tokenizer,
        decoders,
        models,
        normalizers,
        pre_tokenizers,
        processors,
    )

    norm = normalizers.BertNormalizer()
    pre = pre_tokenizers.BertPreTokenizer()
    words: Counter = Counter()
    for line in _corpus():
        words.update(w for w, _ in pre.pre_tokenize_str(
            norm.normalize_str(line)))

    def top(counter, n):
        return [w for w, _ in sorted(counter.items(),
                                     key=lambda kv: (-kv[1], kv[0]))][:n]

    heads: Counter = Counter()
    tails: Counter = Counter()
    for w, n in words.items():
        for k in range(2, len(w) - 1):
            heads[w[:k]] += n
            tails["##" + w[k:]] += n
    chars = sorted({c for w in words for c in w})
    vocab = list(BERT_SPECIALS) + chars + ["##" + c for c in chars]
    multi = Counter({w: c for w, c in words.items() if len(w) > 1})
    for group in (top(multi, 1400), top(heads, 400), top(tails, len(tails))):
        for w in group:
            if len(vocab) >= VOCAB_SIZE:
                break
            if w not in vocab:
                vocab.append(w)
    tok = Tokenizer(models.WordPiece(
        {w: i for i, w in enumerate(vocab)}, unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer()
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.decoder = decoders.WordPiece()
    tok.add_special_tokens(list(BERT_SPECIALS))
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[(t, tok.token_to_id(t)) for t in ("[CLS]", "[SEP]")])
    return tok.to_str()


def build_fixture(kind: str) -> str:
    """The text of fixture ``kind``'s ``tokenizer.json``, trained now
    with the ``tokenizers`` package (imported here: the port's runtime
    never needs it)."""
    from tokenizers import (
        AddedToken,
        Regex,
        Tokenizer,
        decoders,
        models,
        normalizers,
        pre_tokenizers,
        trainers,
    )

    from helix_tpu_torch.serving.tokenizer_json import LLAMA3_PATTERN

    if kind == "bert":
        return _build_bert()
    if kind == "llama3":
        tok = Tokenizer(models.BPE(ignore_merges=True))
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated",
                                 invert=False),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     trim_offsets=True, use_regex=False)])
        tok.decoder = decoders.ByteLevel()
        tok.train_from_iterator(_corpus(), trainers.BpeTrainer(
            vocab_size=VOCAB_SIZE, show_progress=False,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
        tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                                for t in LLAMA3_SPECIALS])
        return tok.to_str()
    if kind != "phi3":
        raise ValueError(f"unknown fixture {kind!r}")
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True,
                               fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    # merges are trained within "▁"-words, as sentencepiece does; the file
    # then has no pre-tokenizer, as Llama-2's and Phi-3's
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="never", split=True)
    tok.train_from_iterator(_corpus(), trainers.BpeTrainer(
        vocab_size=VOCAB_SIZE, show_progress=False,
        special_tokens=list(PHI3_SPECIALS)))
    spec = json.loads(tok.to_str())
    trained = sorted(spec["model"]["vocab"].items(), key=lambda kv: kv[1])
    names = list(PHI3_SPECIALS) + [f"<0x{b:02X}>" for b in range(256)]
    names += [t for t, _ in trained if t not in set(names)]
    spec["model"]["vocab"] = {t: i for i, t in enumerate(names)}
    spec["pre_tokenizer"] = None
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
        {"type": "ByteFallback"}, {"type": "Fuse"},
        {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(PHI3_SPECIALS)]
    added += [{"id": len(names) + k, "content": t, "single_word": False,
               "lstrip": False, "rstrip": False, "normalized": False,
               "special": True} for k, t in enumerate(PHI3_CHAT)]
    spec["added_tokens"] = added
    # a file the package reads back (it checks vocab, merges and ids)
    Tokenizer.from_str(json.dumps(spec, ensure_ascii=False))
    return json.dumps(spec, ensure_ascii=False)


def write_fixtures(out: dict | None = None) -> dict:
    """Build both fixtures into ``out`` (kind -> directory; default the
    committed ``FIXTURES``); returns kind -> path written."""
    out = out or FIXTURES
    paths = {}
    for kind, d in out.items():
        os.makedirs(d, exist_ok=True)
        paths[kind] = os.path.join(d, "tokenizer.json")
        with open(paths[kind], "w", encoding="utf-8") as f:
            f.write(build_fixture(kind))
    return paths


def bert_tokenizer_json(vocab_size: int = 30522) -> str:
    """The committed ``bert`` fixture with its vocab padded by
    ``[unused0]``, ``[unused1]``, ... to ``vocab_size`` entries (as BERT's
    own vocab reserves them); the text BERT's pre-tokenizer makes never
    reaches them, so the ids of any text are the fixture's."""
    with open(os.path.join(FIXTURES["bert"], "tokenizer.json"),
              encoding="utf-8") as f:
        spec = json.load(f)
    vocab = spec["model"]["vocab"]
    if vocab_size < len(vocab):
        raise ValueError(f"vocab_size {vocab_size} < the fixture's "
                         f"{len(vocab)}")
    for i in range(vocab_size - len(vocab)):
        vocab[f"[unused{i}]"] = len(vocab)
    return json.dumps(spec, ensure_ascii=False)
