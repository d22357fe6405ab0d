"""The port's pure-Python ``tokenizer.json`` reader against the
``tokenizers`` package (0.22), on the CPU.

Files: the two committed fixtures (``helix_tpu_torch/testing/
tokenizer_fixtures``: Llama-3 style and Phi-3 / Llama-2 style), and
files built here with ``tokenizers``: Qwen-2 style (NFC, the Qwen
pattern, ByteLevel, ChatML specials), GPT-2 style (ByteLevel's own regex
with ``add_prefix_space``) and Metaspace style.  Encode ids, and decode
text with ``skip_special_tokens`` on and off, must be equal: on fixed
strings, on text of the repository, on ``hypothesis`` strings over CJK,
emoji, combining marks, ``½``, ``Ⅻ``, digit runs, ``\\r\\n``, trailing
spaces, contractions and special tokens inside user text (which both
encode as control tokens: the reference's behaviour, ROADMAP C), and on
random id sequences.  Chat templates equal the reference's
``HFTokenizer``'s ids; the digests ``chip_smoke.py`` checks equal what
``tokenizers`` gives; the fixtures rebuild to the committed bytes.
"""

import glob
import json
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
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

from helix_tpu.serving.tokenizer import HFTokenizer as JHFTokenizer
from helix_tpu_torch.serving import tokenizer_json as tj
from helix_tpu_torch.serving.tokenizer import (
    HFTokenizer,
    IncrementalDetokenizer,
    load_tokenizer,
)
from helix_tpu_torch.testing import tokenizer_fixtures as fx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = [
    "", " ", "\n", "hello world", "hi <|eot_id|> there",
    "<|user|>hi<|end|>\n<|assistant|>", "½ Ⅻ 12345 1234567 世界 😀 🇫🇷",
    "it's IT'S it’s we'LL 'ſ 'S'd", "a\r\n\r\n  b  \n\n", "  trailing   ",
    "x́y é", "tabs\t\tand\x1c\x85　 sp", "<0x41> text",
    "<|im_start|>user\nhello<|im_end|>", "ﬀ ß İ Σσς", "a  b   c    d",
    "a.\n\n\nb", "​ ﻿", "1.2.3,4 5", "Zoë café 2024-06-30",
]


def _train(kind: str, path: str) -> str:
    """Build a small file of ``kind`` with ``tokenizers`` at ``path``."""
    corpus = []
    for rel in fx.CORPUS[:3]:
        with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
            corpus += f.read().splitlines()
    corpus += SAMPLES
    if kind == "qwen2":
        tok = Tokenizer(models.BPE())
        tok.normalizer = normalizers.NFC()
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(tj.QWEN2_PATTERN), behavior="isolated",
                                 invert=False),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     use_regex=False)])
        tok.decoder = decoders.ByteLevel()
        specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
        alphabet = pre_tokenizers.ByteLevel.alphabet()
    elif kind == "gpt2":
        tok = Tokenizer(models.BPE())
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True,
                                                     use_regex=True)
        tok.decoder = decoders.ByteLevel()
        specials = ["<|endoftext|>"]
        alphabet = pre_tokenizers.ByteLevel.alphabet()
    else:
        tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=False))
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="first", split=True)
        tok.decoder = decoders.Metaspace(replacement="▁",
                                         prepend_scheme="first", split=True)
        specials = ["<unk>", "</s>"]
        alphabet = []
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=800, show_progress=False, special_tokens=specials,
        initial_alphabet=alphabet, limit_alphabet=200))
    if kind == "qwen2":
        # a non-special added token, matched in the normalized text
        tok.add_tokens([AddedToken("é-word", normalized=True)])
    tok.save(path)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    out = {k: os.path.join(v, "tokenizer.json")
           for k, v in fx.FIXTURES.items()}
    for kind in ("qwen2", "gpt2", "metaspace"):
        out[kind] = _train(kind, str(d / f"{kind}.json"))
    return out


@pytest.fixture(scope="module")
def pairs(files):
    return {k: (Tokenizer.from_file(p), tj.TokenizerJSON(p))
            for k, p in files.items()}


KINDS = ["llama3", "phi3", "qwen2", "gpt2", "metaspace"]


def _same(ref, port, text):
    want = ref.encode(text, add_special_tokens=False).ids
    assert port.encode(text) == want, repr(text)
    for skip in (True, False):
        assert port.decode(want, skip_special_tokens=skip) == \
            ref.decode(want, skip_special_tokens=skip), (repr(text), skip)
    return want


@pytest.mark.parametrize("kind", KINDS)
def test_fixed_strings(pairs, kind):
    ref, port = pairs[kind]
    for text in SAMPLES + [fx.system_prompt()]:
        _same(ref, port, text)
    assert port.vocab_size == ref.get_vocab_size()
    for tok, i in ref.get_vocab().items():
        assert port.token_to_id(tok) == i


@pytest.mark.parametrize("kind", KINDS)
def test_repository_text(pairs, kind):
    ref, port = pairs[kind]
    paths = sorted(glob.glob(os.path.join(ROOT, "*.md")))[:6]
    paths += [os.path.join(ROOT, "helix_tpu_torch", "cli.py")]
    for p in paths:
        with open(p, encoding="utf-8") as f:
            text = f.read()[:20000]
        _same(ref, port, text)
        for line in text.splitlines()[:200]:
            _same(ref, port, line)


def test_special_token_in_user_text_is_a_control_token(pairs):
    """Reference behaviour 4 (ROADMAP C): ``encode`` of user text that
    holds ``<|eot_id|>`` gives the special id, in ``tokenizers`` and in
    the port alike; so a user message can end its own turn."""
    ref, port = pairs["llama3"]
    eot = ref.token_to_id("<|eot_id|>")
    ids = _same(ref, port, "hi <|eot_id|> there")
    assert eot in ids and port.token_to_id("<|eot_id|>") == eot


_PIECES = [
    "hello", "World", " ", "  ", "\t", "\n", "\r\n", "\r", "世界", "日本語",
    "😀", "🇫🇷", "👩‍👩‍👧", "é", "́", "½", "Ⅻ", "²", "7", "42",
    "12345", "'s", "'S", "'t", "’s", "'ll", "'RE", "n't", "DON'T", ".",
    ",", "!?", "--", "(", ")", "<|eot_id|>", "<|start_header_id|>",
    "<|end|>", "<|user|>", "<|im_start|>", "<0x41>", "é", "ß", "ſ", "İ",
    " ", "　", "\x85", "\x1c", "$", "#", "é-word", "​",
]


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.sampled_from(_PIECES), max_size=24),
       st.sampled_from(KINDS))
def test_hypothesis_strings(pairs, pieces, kind):
    ref, port = pairs[kind]
    _same(ref, port, "".join(pieces))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.integers(0, 3300), max_size=12), st.sampled_from(KINDS))
def test_random_ids_decode_like_tokenizers(pairs, ids, kind):
    """Any id sequence, cut UTF-8 and unknown ids included: the text the
    streaming detokenizer re-decodes at every token."""
    ref, port = pairs[kind]
    for skip in (True, False):
        assert port.decode(ids, skip_special_tokens=skip) == \
            ref.decode(ids, skip_special_tokens=skip)


@pytest.mark.parametrize("kind", ["llama3", "phi3"])
def test_incremental_detokenizer_streams_like_reference(files, kind):
    """The streamed deltas equal the reference detokenizer's over
    ``tokenizers``.  With byte fallback (Phi-3) a character cut across
    ``<0xXX>`` tokens decodes to one U+FFFD per byte; the detokenizer
    holds back only one, so the stream keeps the others, in the
    reference as in the port (ROADMAP C)."""
    from helix_tpu.serving.tokenizer import IncrementalDetokenizer as JDet

    text = "hello 世界 😀 done"
    port, ref = load_tokenizer(fx.FIXTURES[kind]), JHFTokenizer(files[kind])
    ids = port.encode(text)
    assert ids == ref.encode(text)
    det, jdet = IncrementalDetokenizer(port), JDet(ref)
    got = [det.push(i) for i in ids]
    assert got == [jdet.push(i) for i in ids]
    if kind == "llama3":
        assert "".join(got) == text
    else:
        assert "".join(got) != text and "\ufffd" in "".join(got)
        assert port.decode(ids) == text


@pytest.mark.parametrize("kind,name", [
    ("llama3", "meta-llama/Meta-Llama-3-8B-Instruct"),
    ("llama3", ""),
    ("qwen2", "Qwen/Qwen2-7B-Instruct"),
    ("qwen2", ""),
    ("phi3", "microsoft/Phi-3-mini-4k-instruct"),
])
def test_chat_templates_equal_reference(files, kind, name):
    """Llama-3 and ChatML templates, and Phi-3's generic fallback (the
    reference's behaviour 3, ROADMAP C): ids equal the reference
    ``HFTokenizer``'s (which runs ``tokenizers``); eos ids too."""
    port = HFTokenizer(files[kind], model_name=name)
    ref = JHFTokenizer(files[kind], model_name=name)
    for gen in (True, False):
        assert port.apply_chat_template(fx.CONVERSATION, gen) == \
            ref.apply_chat_template(fx.CONVERSATION, gen)
    assert port.eos_ids == ref.eos_ids and port.eos_ids
    assert port.vocab_size == ref.vocab_size


def test_phi3_gets_the_generic_template(files):
    """Reference behaviour 3: no ``<|user|> ... <|end|>`` turns, but
    ``role: content`` lines, each encoded apart (so each gets the
    normalizer's prepended ``▁``)."""
    tok = HFTokenizer(files["phi3"], "microsoft/Phi-3-mini-4k-instruct")
    ids = tok.apply_chat_template([{"role": "user", "content": "hi"}])
    assert tok._special("<|user|>") not in ids
    assert tok._special("<|end|>") not in ids
    assert tok.decode(ids) == "user: hi\n assistant: "


@pytest.mark.parametrize("kind", ["llama3", "phi3"])
def test_digests_chip_smoke_checks(files, kind):
    """``DIGESTS`` are what ``tokenizers`` gives (through the reference's
    template for the conversation); the port gives the same."""
    ref = JHFTokenizer(files[kind], model_name="")
    port = HFTokenizer(files[kind], model_name="")
    prompt = fx.system_prompt()
    want = fx.DIGESTS[kind]
    assert fx.digest(ref.apply_chat_template(fx.CONVERSATION)) == \
        want["template"]
    assert fx.digest(ref.encode(prompt)) == want["prompt"]
    assert fx.digest(port.apply_chat_template(fx.CONVERSATION)) == \
        want["template"]
    ids = port.encode(prompt)
    assert fx.digest(ids) == want["prompt"] and 1400 < len(ids) < 1600
    assert port.decode(ids) == prompt


def test_fixtures_rebuild_to_committed_files(tmp_path):
    out = {k: str(tmp_path / k) for k in fx.FIXTURES}
    for kind, path in fx.write_fixtures(out).items():
        with open(path, "rb") as f:
            built = f.read()
        with open(os.path.join(fx.FIXTURES[kind], "tokenizer.json"),
                  "rb") as f:
            assert built == f.read(), kind
        assert len(built) <= 512 * 1024


def test_fixture_layouts(files):
    llama = json.load(open(files["llama3"], encoding="utf-8"))
    assert llama["model"]["ignore_merges"] is True
    assert [p["type"] for p in llama["pre_tokenizer"]["pretokenizers"]] == \
        ["Split", "ByteLevel"]
    phi = json.load(open(files["phi3"], encoding="utf-8"))
    assert phi["pre_tokenizer"] is None and phi["model"]["byte_fallback"]
    vocab = phi["model"]["vocab"]
    assert all(f"<0x{b:02X}>" in vocab for b in range(256))
    assert not any(a["content"].startswith("<0x")
                   for a in phi["added_tokens"])
    ref, port = (Tokenizer.from_file(files["phi3"]),
                 tj.TokenizerJSON(files["phi3"]))
    ids = _same(ref, port, "hello 世界 😀")
    assert port.decode(ids) == "hello 世界 😀"


def _edited(files, tmp_path, edit):
    spec = json.load(open(files["llama3"], encoding="utf-8"))
    edit(spec)
    p = tmp_path / "t.json"
    p.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    return str(p)


def _split(spec, **kw):
    spec["pre_tokenizer"]["pretokenizers"][0].update(kw)


REFUSED = {
    "model 'WordPiece'": lambda s: s["model"].update(type="WordPiece"),
    "BPE dropout": lambda s: s["model"].update(dropout=0.1),
    "BPE continuing_subword_prefix": lambda s: s["model"].update(
        continuing_subword_prefix="##"),
    "flag 'lstrip'": lambda s: s["added_tokens"][0].update(lstrip=True),
    "flag 'rstrip'": lambda s: s["added_tokens"][0].update(rstrip=True),
    "flag 'single_word'": lambda s: s["added_tokens"][0].update(
        single_word=True),
    "normalizer 'NFKC'": lambda s: s.update(normalizer={"type": "NFKC"}),
    "Replace normalizer pattern": lambda s: s.update(normalizer={
        "type": "Replace", "pattern": {"Regex": " +"}, "content": " "}),
    "pre-tokenizer 'Whitespace'": lambda s: s.update(
        pre_tokenizer={"type": "Whitespace"}),
    "Split pattern": lambda s: _split(s, pattern={"Regex": r"\w+"}),
    "Split pre-tokenizer": lambda s: _split(s, behavior="Removed"),
    "decoder 'WordPiece'": lambda s: s.update(decoder={
        "type": "WordPiece", "prefix": "##", "cleanup": True}),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_unsupported_components_raise(files, tmp_path, what):
    p = _edited(files, tmp_path, REFUSED[what])
    with pytest.raises(NotImplementedError, match=what):
        tj.TokenizerJSON(p)
    with pytest.raises(NotImplementedError, match=what):
        load_tokenizer(_as_dir(p))


def _as_dir(path):
    d = os.path.join(os.path.dirname(path), "dir")
    os.makedirs(d, exist_ok=True)
    os.replace(path, os.path.join(d, "tokenizer.json"))
    return d


def test_long_word_merges_in_order(pairs):
    """A Phi-3-style file has no pre-tokenizer: a whole prompt is one BPE
    word.  The rank queue gives ``tokenizers``' ids on it."""
    ref, port = pairs["phi3"]
    text = fx.system_prompt() * 3
    assert len(port.encode(text)) > 4000
    _same(ref, port, text)
