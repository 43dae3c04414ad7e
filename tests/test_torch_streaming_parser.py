"""The port's host text modules against the JAX package's: the streaming
parser (split at every offset), the prompt formatters, and the tokenizer,
whose C trie, Python trie and the JAX tokenizer must encode the same texts to
the same ids."""

import logging
import os

import numpy as np
import pytest

from chirrup_tpu.utils import prompt_formatters as j_fmt
from chirrup_tpu.utils import streaming_parser as j_sp
from chirrup_tpu.utils.tokenizer import StreamingDecoder as JDecoder
from chirrup_tpu.utils.tokenizer import WorldTokenizer as JTokenizer
from chirrup_tpu_torch import native
from chirrup_tpu_torch.utils import prompt_formatters as fmt
from chirrup_tpu_torch.utils import streaming_parser as sp
from chirrup_tpu_torch.utils import tokenizer as tokenizer_mod
from chirrup_tpu_torch.utils.tokenizer import StreamingDecoder, WorldTokenizer

from tests.engine_fixtures import write_tiny_vocab

STREAMS = [
    "<think>reasoning here</think>answer",
    "<thinking is fun</thin</think>x",
    "hello\n\nmore text after the end",
    "a<think>b\n\nc</think>d\n\ne",
    "</think><think><think>",
    "\n\n\n<think>\n</think>\n\n",
    "plain content with no trigger at all",
    "<<think>>x<</think>",
]


def _feed(parser, chunks):
    out = []
    for ch in chunks:
        out.extend(parser.parse(ch))
    return out


@pytest.mark.parametrize("tries", ["TRIE_THINK_NO_TRIGGER", "TRIE_THINK_KEEP_TRIGGER"])
@pytest.mark.parametrize("text", STREAMS)
def test_parser_matches_jax_at_every_split(text, tries):
    for seed in ("", "Assistant:<think>"):
        for i in range(len(text) + 1):
            for chunks in ([text[:i], text[i:]], [text[:i], *text[i:]]):
                got = sp.StreamingStringParser(tries=getattr(sp, tries))
                ref = j_sp.StreamingStringParser(tries=getattr(j_sp, tries))
                got.parse(seed)
                ref.parse(seed)
                assert _feed(got, chunks) == _feed(ref, chunks), (seed, chunks)
                assert (got.current_state, got.buffer) == (ref.current_state, ref.buffer)


def test_parser_rules_match_jax():
    rules = [("a", "xy", "b", "left"), ("b", "yz", "a", "right"), ("b", "q", "c", False)]
    text = "xxyyzqxy yz"
    for i in range(len(text) + 1):
        got = sp.StreamingStringParser(rules, start_state="a")
        ref = j_sp.StreamingStringParser(rules, start_state="a")
        assert _feed(got, [text[:i], text[i:]]) == _feed(ref, [text[:i], text[i:]])
    with pytest.raises(ValueError):
        sp.build_tries([("a", "x", "b", "both")])


@pytest.mark.parametrize("messages", [
    [{"role": "system", "content": "be\n\n\nnice"}, {"role": "user", "content": " hi "},
     {"role": "assistant", "content": "yo"}],
    [{"role": "user", "content": ""}, {"role": "tool", "content": "x\n\ny"}],
    [{"role": "user", "content": None}],
])
def test_formatters_match_jax(messages):
    assert fmt.clean_openai_messages(messages) == j_fmt.clean_openai_messages(messages)
    for name in ("format_no_thinking", "format_with_thinking", "format_quick_thinking"):
        assert getattr(fmt, name)(messages) == getattr(j_fmt, name)(messages)


def _sparse_vocab(path):
    """Sparse ids, str and bytes literals, multi-byte tokens over single
    bytes (the JAX tokenizer test's vocabulary, with every byte a token)."""
    lines = ["1 'a' 1", "2 'b' 1", "3 'ab' 2", "4 'abc' 3", "5 ' ' 1", "6 'hello' 5",
             "7 b'\\xe4\\xb8' 2", "8 b'\\xad' 1", "9 '中' 3", "10 'c' 1"]
    covered = {b"a"[0], b"b"[0], b"c"[0], b" "[0], 0xAD}
    next_id = 11
    for byte in range(256):
        if byte not in covered:
            lines.append(f"{next_id} {bytes([byte])!r} 1")
            next_id += 1
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return path


def _numeric_vocab(path, size=4096):
    """Single bytes plus distinct numeric strings (chip_smoke.write_vocab's
    layout): long greedy matches over digit runs."""
    lines = [f"{b + 1} {bytes([b])!r} 1" for b in range(256)]
    lines += [f"{257 + i} {str(10 + i).encode()!r} {len(str(10 + i))}"
              for i in range(size - 257)]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return path


@pytest.fixture(params=["tiny", "sparse", "numeric"])
def vocab(request, tmp_path):
    path = str(tmp_path / "vocab.txt")
    return {"tiny": write_tiny_vocab, "sparse": _sparse_vocab,
            "numeric": _numeric_vocab}[request.param](path)


def _texts():
    rng = np.random.default_rng(0)
    texts = [b"", b"hello world the User", b"abcabc ab a\n\nAssistant:", "a中b中".encode(),
             b"1234567890 987 10 11 4095 4096", b"\x00\xff\x80 \xe4\xb8\xad"]
    texts += [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(1, 300, 12)]
    digits = rng.integers(0, 10, 400).astype(np.uint8) + ord("0")
    texts.append(digits.tobytes())
    return texts


def test_c_trie_python_trie_and_jax_agree(vocab):
    tok = WorldTokenizer(vocab)
    ref = JTokenizer(vocab)
    assert tok.trie == "c"
    for data in _texts():
        ids = ref.encode_bytes(data)
        assert tok.encode_bytes(data) == ids
        assert tok.encode_bytes_python(data) == ids
        assert tok.decode_bytes(ids) == data
    assert tok.encode("hello 中") == ref.encode("hello 中")
    assert tok.vocab_size == ref.vocab_size


def test_streaming_decoder_matches_jax(vocab):
    tok, ref = WorldTokenizer(vocab), JTokenizer(vocab)
    ids = ref.encode_bytes("x中y\xe9z".encode() + b"\xe4\xb8")
    dec, jdec = StreamingDecoder(tok), JDecoder(ref)
    assert [dec.push(t) for t in ids] == [jdec.push(t) for t in ids]
    assert dec.flush() == jdec.flush()
    assert dec.push(10 ** 6) == "" == jdec.push(10 ** 6)


def test_unknown_byte_raises_in_both_tries(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("1 'a' 1\n2 'b' 1\n3 'ab' 2", encoding="utf-8")
    tok = WorldTokenizer(str(path))
    assert tok.trie == "c"
    assert tok.encode("abba") == tok.encode_bytes_python(b"abba") == [3, 2, 1]
    with pytest.raises(ValueError):
        tok.encode("abc")
    with pytest.raises(ValueError):
        tok.encode_bytes_python(b"abc")


def test_c_trie_is_built_outside_the_sources():
    native.trie_tokenizer()
    built = os.listdir(native.BUILD_DIR)
    assert any(f.startswith("trie_tokenizer_") for f in built)
    src_dir = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_failed_build_falls_back_loudly(vocab, monkeypatch, caplog):
    def broken():
        raise RuntimeError("cc: not found")

    monkeypatch.setattr(native, "trie_tokenizer", broken)
    with caplog.at_level(logging.INFO, logger=tokenizer_mod.__name__):
        tok = WorldTokenizer(vocab)
    assert tok.trie == "python"
    assert any(r.levelno == logging.WARNING and "cc: not found" in r.getMessage()
               for r in caplog.records)
    ref = JTokenizer(vocab)
    for data in _texts()[:6]:
        assert tok.encode_bytes(data) == ref.encode_bytes(data)
