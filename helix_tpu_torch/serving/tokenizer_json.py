"""A pure-Python reader of HuggingFace ``tokenizer.json`` files.

The port's stand-in for the ``tokenizers`` runtime, which the card's
machine does not have.  ``TokenizerJSON(path)`` encodes (as
``Tokenizer.encode(text, add_special_tokens=False).ids``) and decodes (as
``Tokenizer.decode(ids, skip_special_tokens=...)``) with the same ids and
text as that package for the components the Llama-3, Qwen-2 and
Llama-2 / Phi-3 families use:

- added tokens, split out of the text before anything else by
  leftmost-longest match (special tokens inside user text included, as
  ``tokenizers`` does), those marked ``normalized`` in the normalized
  text;
- normalizers ``NFC``, ``Prepend``, ``Replace`` (string pattern) and
  ``Sequence``;
- pre-tokenizers ``Split`` (regex, ``Isolated``), ``ByteLevel`` (with and
  without its own regex, ``add_prefix_space``), ``Metaspace`` and
  ``Sequence``;
- the ``BPE`` model: merges by rank, ``ignore_merges``, ``byte_fallback``,
  ``fuse_unk`` and ``unk_token``;
- decoders ``ByteLevel``, ``Replace``, ``ByteFallback``, ``Fuse``,
  ``Strip``, ``Metaspace`` and ``Sequence``.

Any other component or flag raises ``NotImplementedError`` naming it.
The post-processor is not read: it adds tokens only when special tokens
are asked for, which the serving path never does.

The Split patterns use ``\\p{L}`` and ``\\p{N}``, which the standard ``re``
module lacks (and ``[^\\W\\d_]`` is wrong for ``No`` / ``Nl`` characters
such as ``½`` and ``Ⅻ``), so the three patterns these families use
(Llama-3's, Qwen-2's and GPT-2's) are scanned by hand over
``unicodedata.category``, alternative by alternative as the regex engine
would try them; ``\\s`` is the Unicode ``White_Space`` set, as Oniguruma's.
BPE merges a word through a queue ordered by (rank, position), as
``tokenizers`` does, so a long word without pre-tokenization (a Phi-3
system prompt) costs O(n log n), not O(n²).
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                r"|\s+(?!\S)|\s+")

# Unicode White_Space (Oniguruma's \s)
_WHITE = frozenset(map(chr, (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
    *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))
_NL = frozenset("\r\n")
# letters a contraction's case-insensitive match accepts (Unicode simple
# case folding: U+017F LATIN SMALL LETTER LONG S folds to 's')
_FOLD = {"s": "sSſ", "t": "tT", "r": "rR", "v": "vV", "m": "mM",
         "l": "lL", "d": "dD", "e": "eE"}
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# what Rust's ``u8::from_str_radix(_, 16)`` takes in a ``<0xXX>`` token
_HEX_BYTE = re.compile(r"\+?[0-9A-Fa-f]{1,2}")
# words at most this long have their BPE result cached
_CACHE_WORD_CHARS = 256
_CACHE_ENTRIES = 100_000


def _classes(s: str) -> list:
    """Per character: 'L' letter, 'N' number, 'S' white space, 'P' other."""
    out = []
    for c in s:
        if c in _WHITE:
            out.append("S")
        else:
            k = unicodedata.category(c)[0]
            out.append(k if k in "LN" else "P")
    return out


def _contraction(s: str, i: int, fold: bool) -> int:
    """End of a contraction alternative matched at ``i`` (0: none)."""
    if s[i] != "'":
        return 0
    for tail in _CONTRACTIONS:
        j = i + 1 + len(tail)
        if j > len(s):
            continue
        if all(s[i + 1 + k] in (_FOLD[ch] if fold else ch)
               for k, ch in enumerate(tail)):
            return j
    return 0


def _run(cls: list, i: int, kind: str, limit: int | None = None) -> int:
    """End of the run of class ``kind`` starting at ``i``."""
    n = len(cls) if limit is None else min(len(cls), i + limit)
    while i < n and cls[i] == kind:
        i += 1
    return i


def _space_alternatives(s: str, cls: list, i: int, newline_alt: bool) -> int:
    """``\\s*[\\r\\n]+`` (with ``newline_alt``), then ``\\s+(?!\\S)``, then
    ``\\s+`` at ``i`` (a white-space character)."""
    j = _run(cls, i, "S")
    if newline_alt:
        for k in range(j - 1, i - 1, -1):
            if s[k] in _NL:
                return k + 1
    if j == len(s) or j - i >= 2:
        return j if j == len(s) else j - 1
    return j


def _scan_llama3(s: str, digits: int | None) -> list:
    """Matches of the Llama-3 pattern (``digits`` 3) or Qwen-2's (1)."""
    cls = _classes(s)
    out, i, n = [], 0, len(s)
    while i < n:
        c = cls[i]
        j = _contraction(s, i, fold=True)
        if not j:
            if c == "L":
                j = _run(cls, i, "L")
            elif c != "N" and s[i] not in _NL and i + 1 < n \
                    and cls[i + 1] == "L":
                j = _run(cls, i + 1, "L")
            elif c == "N":
                j = _run(cls, i, "N", digits)
            elif (c == "P" or (s[i] == " " and i + 1 < n
                               and cls[i + 1] == "P")):
                j = _run(cls, i + 1 if c == "S" else i, "P")
                while j < n and s[j] in _NL:
                    j += 1
            else:
                j = _space_alternatives(s, cls, i, newline_alt=True)
        out.append(s[i:j])
        i = j
    return out


def _scan_gpt2(s: str) -> list:
    cls = _classes(s)
    out, i, n = [], 0, len(s)
    while i < n:
        j = _contraction(s, i, fold=False)
        if not j:
            c = cls[i]
            if c != "S":
                j = _run(cls, i, c)
            elif s[i] == " " and i + 1 < n and cls[i + 1] != "S":
                j = _run(cls, i + 1, cls[i + 1])
            else:
                j = _space_alternatives(s, cls, i, newline_alt=False)
        out.append(s[i:j])
        i = j
    return out


_SCANNERS = {
    LLAMA3_PATTERN: lambda s: _scan_llama3(s, 3),
    QWEN2_PATTERN: lambda s: _scan_llama3(s, 1),
    GPT2_PATTERN: _scan_gpt2,
}


def _bytes_to_unicode() -> dict:
    """GPT-2's byte -> printable character map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


BYTE_CHAR = _bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}


def _refuse(kind: str, spec) -> None:
    raise NotImplementedError(f"tokenizer.json: {kind} {spec!r} is not "
                              "implemented by the port's tokenizer")


def _string_pattern(spec: dict, kind: str) -> str:
    pat = spec.get("pattern") or {}
    if set(pat) != {"String"}:
        _refuse(f"{kind} pattern", pat)
    return pat["String"]


# --- normalizers: str -> str -------------------------------------------


def _normalizer(spec):
    if spec is None:
        return None
    t = spec.get("type")
    if t == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def seq(s):
            for p in parts:
                s = p(s)
            return s
        return seq
    if t == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if t == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if t == "Replace":
        old, new = _string_pattern(spec, "Replace normalizer"), spec["content"]
        return lambda s: s.replace(old, new)
    _refuse("normalizer", t)


# --- pre-tokenizers: [(str, at_start)] -> [(str, at_start)] --------------


def _pre_tokenizer(spec):
    if spec is None:
        return None
    t = spec.get("type")
    if t == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(splits):
            for p in parts:
                splits = p(splits)
            return splits
        return seq
    if t == "Split":
        pat = spec.get("pattern") or {}
        if set(pat) != {"Regex"} or spec.get("behavior") != "Isolated" \
                or spec.get("invert"):
            _refuse("Split pre-tokenizer", {k: v for k, v in spec.items()
                                            if k != "type"})
        scan = _SCANNERS.get(pat["Regex"])
        if scan is None:
            _refuse("Split pattern", pat["Regex"])
        return lambda splits: [(piece, at and k == 0)
                               for s, at in splits
                               for k, piece in enumerate(scan(s))]
    if t == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space"))
        scan = _scan_gpt2 if spec.get("use_regex", True) else None

        def byte_level(splits):
            out = []
            for s, at in splits:
                if prefix and not s.startswith(" "):
                    s = " " + s
                for k, piece in enumerate(scan(s) if scan else [s]):
                    out.append(("".join(BYTE_CHAR[b]
                                        for b in piece.encode("utf-8")),
                                at and k == 0))
            return out
        return byte_level
    if t == "Metaspace":
        rep = spec["replacement"]
        scheme = spec.get("prepend_scheme", "always")
        if scheme not in ("always", "first", "never") or len(rep) != 1:
            _refuse("Metaspace pre-tokenizer", spec)
        split = spec.get("split", True)

        def metaspace(splits):
            out = []
            for s, at in splits:
                s = s.replace(" ", rep)
                if not s.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and at)):
                    s = rep + s
                if not split:
                    out.append((s, at))
                    continue
                cuts = [k for k, c in enumerate(s) if c == rep and k > 0]
                for k, (a, b) in enumerate(zip([0] + cuts, cuts + [len(s)])):
                    if b > a:
                        out.append((s[a:b], at and k == 0))
            return out
        return metaspace
    _refuse("pre-tokenizer", t)


# --- decoders: [str] -> [str] ------------------------------------------


def _byte_fallback(tokens):
    out, run = [], bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(run))
            run.clear()

    for t in tokens:
        if len(t.encode("utf-8")) == 6 and t.startswith("<0x") \
                and t.endswith(">") and _HEX_BYTE.fullmatch(t[3:5]):
            run.append(int(t[3:5], 16))
        else:
            flush()
            out.append(t)
    flush()
    return out


def _decoder(spec):
    if spec is None:
        return None
    t = spec.get("type")
    if t == "Sequence":
        parts = [_decoder(s) for s in spec["decoders"]]

        def seq(tokens):
            for p in parts:
                tokens = p(tokens)
            return tokens
        return seq
    if t == "ByteLevel":
        def byte_level(tokens):
            raw = bytearray()
            for tok in tokens:
                try:
                    raw += bytes(CHAR_BYTE[c] for c in tok)
                except KeyError:
                    raw += tok.encode("utf-8")
            return [raw.decode("utf-8", errors="replace")]
        return byte_level
    if t == "Replace":
        old, new = _string_pattern(spec, "Replace decoder"), spec["content"]
        return lambda tokens: [tok.replace(old, new) for tok in tokens]
    if t == "ByteFallback":
        return _byte_fallback
    if t == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if t == "Strip":
        ch, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens):
            out = []
            for tok in tokens:
                a = 0
                while a < min(start, len(tok)) and tok[a] == ch:
                    a += 1
                b = len(tok)
                while len(tok) - b < stop and b > a and tok[b - 1] == ch:
                    b -= 1
                out.append(tok[a:b])
            return out
        return strip
    if t == "Metaspace":
        rep = spec["replacement"]
        first = spec.get("prepend_scheme", "always") != "never"
        return lambda tokens: [
            tok.replace(rep, "" if (k == 0 and first) else " ")
            for k, tok in enumerate(tokens)]
    _refuse("decoder", t)


# --- the BPE model -------------------------------------------------------


class _BPE:
    def __init__(self, spec: dict):
        if spec.get("type") != "BPE":
            _refuse("model", spec.get("type"))
        for flag in ("dropout", "continuing_subword_prefix",
                     "end_of_word_suffix"):
            if spec.get(flag):
                _refuse(f"BPE {flag}", spec[flag])
        self.vocab = dict(spec["vocab"])
        self.ignore_merges = bool(spec.get("ignore_merges"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.fuse_unk = bool(spec.get("fuse_unk"))
        unk = spec.get("unk_token")
        self.unk_id = None
        if unk is not None:
            if unk not in self.vocab:
                raise ValueError(f"tokenizer.json: unk_token {unk!r} is not "
                                 "in the vocab")
            self.unk_id = self.vocab[unk]
        self.merges = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ") if isinstance(m, str) else m
            try:
                key = (self.vocab[a], self.vocab[b])
                self.merges[key] = (rank, self.vocab[a + b])
            except KeyError:
                raise ValueError(f"tokenizer.json: merge {m!r} names a token "
                                 "outside the vocab") from None
        self._byte_ids = {}
        if self.byte_fallback:
            for b in range(256):
                tok = f"<0x{b:02X}>"
                if tok in self.vocab:
                    self._byte_ids[b] = self.vocab[tok]
        self._cache: dict = {}

    def _symbols(self, word: str) -> list:
        """The word's first symbols (``merge_word``): one per character
        in the vocab, else its bytes' ``<0xXX>`` tokens under byte
        fallback, else the unknown token, which is added when the next
        known character (or the end) comes, consecutive ones fused into
        one with ``fuse_unk``; without an unknown token such a character
        is dropped."""
        out, pending = [], False
        for c in word:
            i = self.vocab.get(c)
            if i is not None:
                if pending:
                    out.append(self.unk_id)
                    pending = False
                out.append(i)
                continue
            if self.byte_fallback:
                bs = c.encode("utf-8")
                if all(b in self._byte_ids for b in bs):
                    out.extend(self._byte_ids[b] for b in bs)
                    continue
            if self.unk_id is not None:
                if pending and not self.fuse_unk:
                    out.append(self.unk_id)
                pending = True
        if pending:
            out.append(self.unk_id)
        return out

    def _merge(self, ids: list) -> list:
        n = len(ids)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        merges = self.merges
        heap = [(m[0], i, m[1]) for i in range(n - 1)
                if (m := merges.get((ids[i], ids[i + 1]))) is not None]
        heapq.heapify(heap)
        while heap:
            rank, i, new = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j >= n:
                continue
            m = merges.get((ids[i], ids[j]))
            if m is None or m[1] != new:
                continue          # a stale entry
            ids[i] = new
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prv[nxt[j]] = i
            p = prv[i]
            if p >= 0 and (m := merges.get((ids[p], new))) is not None:
                heapq.heappush(heap, (m[0], p, m[1]))
            k = nxt[i]
            if k < n and (m := merges.get((new, ids[k]))) is not None:
                heapq.heappush(heap, (m[0], i, m[1]))
        return [t for t, a in zip(ids, alive) if a]

    def tokenize(self, word: str) -> list:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is not None:
            return list(hit)
        out = self._merge(self._symbols(word))
        if len(word) <= _CACHE_WORD_CHARS:
            if len(self._cache) >= _CACHE_ENTRIES:
                self._cache.clear()
            self._cache[word] = tuple(out)
        return out


class TokenizerJSON:
    """Encode and decode with one ``tokenizer.json`` file."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        self.model = _BPE(spec["model"])
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.decode_chain = _decoder(spec.get("decoder"))
        self.added = {}          # content -> id
        self.specials = set()    # contents of the special added tokens
        raw_tokens, normalized_tokens = [], []
        for a in spec.get("added_tokens", []):
            for flag in ("single_word", "lstrip", "rstrip"):
                if a.get(flag):
                    _refuse(f"added token {a['content']!r} flag", flag)
            self.added[a["content"]] = a["id"]
            if a.get("special"):
                self.specials.add(a["content"])
            if a.get("normalized", not a.get("special")):
                c = a["content"]
                normalized_tokens.append(self.normalize(c)
                                         if self.normalize else c)
            else:
                raw_tokens.append(a["content"])
        self._raw_re = self._matcher(raw_tokens)
        self._norm_re = self._matcher(normalized_tokens)
        self._norm_ids = {(self.normalize(c) if self.normalize else c): i
                          for c, i in self.added.items()}
        self.id_to_token = {i: t for t, i in self.model.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})

    @staticmethod
    def _matcher(tokens):
        """Leftmost-longest matcher over ``tokens`` (an alternation tried
        longest first finds the longest token at the leftmost position)."""
        tokens = sorted({t for t in tokens if t}, key=len, reverse=True)
        if not tokens:
            return None
        return re.compile("|".join(map(re.escape, tokens)))

    @staticmethod
    def _split(text: str, matcher, ids: dict) -> list:
        """``[(piece, token id or None, starts the text)]``."""
        if matcher is None:
            return [(text, None, True)]
        out, at = [], 0
        for m in matcher.finditer(text):
            if m.start() > at:
                out.append((text[at:m.start()], None, at == 0))
            out.append((m.group(), ids[m.group()], m.start() == 0))
            at = m.end()
        if at < len(text) or not out:
            out.append((text[at:], None, at == 0))
        return out

    def token_to_id(self, token: str):
        i = self.added.get(token)
        return i if i is not None else self.model.vocab.get(token)

    @property
    def vocab_size(self) -> int:
        """``get_vocab_size()``: the model's vocab with the added tokens."""
        return len(set(self.model.vocab.values()) | set(self.added.values()))

    def encode(self, text: str) -> list:
        ids = []
        for piece, tid, start in self._split(text, self._raw_re, self.added):
            if tid is not None:
                ids.append(tid)
                continue
            if self.normalize:
                piece = self.normalize(piece)
            for sub, sid, sub_start in self._split(piece, self._norm_re,
                                                   self._norm_ids):
                if sid is not None:
                    ids.append(sid)
                    continue
                if not sub:
                    continue        # no pre-tokenizer prefixes nothing
                splits = [(sub, start and sub_start)]
                if self.pre_tokenize:
                    splits = self.pre_tokenize(splits)
                for word, _at in splits:
                    ids.extend(self.model.tokenize(word))
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        tokens = [t for i in ids
                  if (t := self.id_to_token.get(int(i))) is not None
                  and not (skip_special_tokens and t in self.specials)]
        if self.decode_chain is None:
            return " ".join(tokens)
        return "".join(self.decode_chain(tokens))
