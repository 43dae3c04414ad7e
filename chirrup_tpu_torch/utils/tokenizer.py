"""RWKV "world" vocabulary tokenizer: greedy longest-match over a byte trie.

Vocabulary file format (one line per token, must be pre-sorted by the publisher):

    <id> <python-literal str-or-bytes> <byte-length>

Token id 0 is the implicit ``<|endoftext|>`` document separator and never appears in
the file. Behavioral reference: the TRIE_TOKENIZER in the upstream RWKV ecosystem
(and Albatross's utils.py, the serving engine this framework
re-implements); this is an independent implementation — a flat-dict trie with an
incremental UTF-8 streaming decoder on top. Encoding runs on the C trie
(chirrup_tpu_torch.native, built at first use); where it cannot be built the
tokenizer says so in a warning and encodes on the pure-Python trie, and
`WorldTokenizer.trie` names the one in use ("c" or "python").
"""

from __future__ import annotations

import ast
import codecs
import logging
from typing import Iterable, List, Optional

log = logging.getLogger(__name__)


class _TrieNode:
    """One byte-trie node. `children` maps next-byte -> node; `token_id` is set when
    the path from the root spells a complete token."""

    __slots__ = ("children", "token_id")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.token_id: Optional[int] = None


def parse_vocab_file(path: str) -> dict[int, bytes]:
    """Parse the world-vocab text format into {token_id: token_bytes}."""
    idx2token: dict[int, bytes] = {0: b"<|endoftext|>"}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            first_sp = line.index(" ")
            last_sp = line.rindex(" ")
            idx = int(line[:first_sp])
            literal = line[first_sp + 1 : last_sp]
            tok = ast.literal_eval(literal)
            if isinstance(tok, str):
                tok = tok.encode("utf-8")
            if not isinstance(tok, bytes):
                raise ValueError(f"vocab line {idx}: literal is not str/bytes")
            if len(tok) != int(line[last_sp + 1 :]):
                raise ValueError(f"vocab line {idx}: declared length mismatch")
            idx2token[idx] = tok
    return idx2token


class WorldTokenizer:
    """Greedy longest-match byte-level tokenizer over the RWKV world vocabulary."""

    def __init__(self, vocab_path: str):
        self.idx2token = parse_vocab_file(vocab_path)
        # token 0 is the special separator: it is emitted/consumed by id, never by text
        self.token2idx = {v: k for k, v in self.idx2token.items() if k != 0}

        self._root = _TrieNode()
        for tok, idx in self.token2idx.items():
            node = self._root
            for b in tok:
                nxt = node.children.get(b)
                if nxt is None:
                    nxt = _TrieNode()
                    node.children[b] = nxt
                node = nxt
            node.token_id = idx

        self._native = None
        self.trie = "python"
        try:
            from chirrup_tpu_torch.native import trie_tokenizer

            self._native = trie_tokenizer().NativeTrie(self.idx2token)
            self.trie = "c"
            log.info("tokenizer: C trie, %d tokens", len(self.token2idx))
        except (OSError, RuntimeError, ImportError) as exc:
            log.warning("tokenizer: the C trie could not be built (%s); encoding on "
                        "the pure-Python trie", exc)

    @property
    def vocab_size(self) -> int:
        return max(self.idx2token) + 1

    def encode_bytes(self, data: bytes) -> List[int]:
        if self._native is not None:
            return self._native.encode(data)
        return self.encode_bytes_python(data)

    def encode_bytes_python(self, data: bytes) -> List[int]:
        """Greedy longest match on the pure-Python trie (the C trie's
        reference)."""
        tokens: List[int] = []
        root = self._root
        i, n = 0, len(data)
        while i < n:
            node = root.children.get(data[i])
            if node is None:
                raise ValueError(f"byte {data[i]:#04x} at offset {i} not in vocabulary")
            j = i + 1
            best_id, best_end = node.token_id, j
            while j < n:
                node = node.children.get(data[j])
                if node is None:
                    break
                j += 1
                if node.token_id is not None:
                    best_id, best_end = node.token_id, j
            if best_id is None:
                raise ValueError(f"no token matches input at offset {i}")
            tokens.append(best_id)
            i = best_end
        return tokens

    def encode(self, text: str) -> List[int]:
        return self.encode_bytes(text.encode("utf-8"))

    def decode_bytes(self, tokens: Iterable[int]) -> bytes:
        idx2token = self.idx2token
        return b"".join(idx2token[t] for t in tokens)

    def decode(self, tokens: Iterable[int], utf8_errors: str = "strict") -> str:
        return self.decode_bytes(tokens).decode("utf-8", errors=utf8_errors)


class StreamingDecoder:
    """Incremental token->text decoder that buffers incomplete UTF-8 tails.

    The reference engine decodes each generated token independently and drops bytes of
    multi-token characters (chirrup/worker.py:496 'TODO: 处理不完整的 utf8'); this
    implementation carries partial sequences across tokens instead, so emoji and CJK
    characters that straddle token boundaries stream correctly.
    """

    def __init__(self, tokenizer: WorldTokenizer):
        self._tok = tokenizer
        self._dec = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def push(self, token: int) -> str:
        data = self._tok.idx2token.get(token)
        if data is None:
            return ""  # id not in vocab (padded head rows): emit nothing
        return self._dec.decode(data, final=False)

    def flush(self) -> str:
        return self._dec.decode(b"", final=True)
