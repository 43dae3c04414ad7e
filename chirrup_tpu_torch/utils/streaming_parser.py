"""Streaming string parser: a char-trie state machine over the decoded text stream.

Routes generated text into channels (e.g. `<think>...</think>` -> reasoning_content
vs content, `\\n\\n` -> end) while buffering partial trigger matches across chunk
boundaries. The same behaviour as the JAX package's
chirrup_tpu.utils.streaming_parser: rules are
(state, trigger, next_state, keep_trigger) with keep_trigger in
{False, "left", "right"} — drop the trigger, emit it labeled with the old state, or
emit it labeled with the new state.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple, Union

KeepTrigger = Union[bool, str]


class _Node:
    __slots__ = ("children", "is_end", "next_state", "keep_trigger")

    def __init__(self):
        self.children: Dict[str, _Node] = {}
        self.is_end = False
        self.next_state = ""
        self.keep_trigger: KeepTrigger = False


def build_tries(rules: List[Tuple[str, str, str, KeepTrigger]]) -> Dict[str, _Node]:
    by_state = defaultdict(list)
    for state, trigger, next_state, keep in rules:
        if keep not in (False, "left", "right"):
            raise ValueError("keep_trigger must be False, 'left' or 'right'")
        by_state[state].append((trigger, next_state, keep))
    tries: Dict[str, _Node] = {}
    for state, rule_list in by_state.items():
        root = tries.setdefault(state, _Node())
        for trigger, next_state, keep in rule_list:
            node = root
            for ch in trigger:
                node = node.children.setdefault(ch, _Node())
            node.is_end = True
            node.next_state = next_state
            node.keep_trigger = keep
    return tries


class StreamingStringParser:
    def __init__(self, rules=None, start_state: str = "content", tries=None):
        if tries is None and rules is None:
            raise ValueError("rules or tries must be provided")
        self.tries = tries if tries is not None else build_tries(rules)
        self.current_state = start_state
        self.current_node = self.tries.get(start_state, _Node())
        self.buffer = ""

    def parse(self, delta: str) -> List[Tuple[str, str]]:
        """Feed a chunk; returns [(text, state), ...] runs grouped by state."""
        outputs: List[Tuple[str, str]] = []
        i = 0
        while i < len(delta):
            ch = delta[i]
            nxt = self.current_node.children.get(ch)
            if nxt is not None:
                self.buffer += ch
                self.current_node = nxt
                i += 1
                if nxt.is_end:
                    if nxt.keep_trigger:
                        label = (self.current_state if nxt.keep_trigger == "left"
                                 else nxt.next_state)
                        outputs.append((self.buffer, label))
                    self.current_state = nxt.next_state
                    self.current_node = self.tries.get(self.current_state, _Node())
                    self.buffer = ""
            elif self.buffer:
                # partial trigger failed: flush it, reprocess current char
                outputs.append((self.buffer, self.current_state))
                self.buffer = ""
                self.current_node = self.tries.get(self.current_state, _Node())
            else:
                outputs.append((ch, self.current_state))
                i += 1

        groups: List[Tuple[str, str]] = []
        for text, state in outputs:
            if groups and groups[-1][1] == state:
                groups[-1] = (groups[-1][0] + text, state)
            else:
                groups.append((text, state))
        return groups


# prebuilt rule sets: the server's think-tag routing
TRIE_THINK_NO_TRIGGER = build_tries([
    ("content", "<think>", "reasoning_content", False),
    ("reasoning_content", "</think>", "content", False),
    ("content", "\n\n", "end", "right"),
])

TRIE_THINK_KEEP_TRIGGER = build_tries([
    ("content", "<think>", "reasoning_content", "right"),
    ("reasoning_content", "</think>", "content", "left"),
    ("content", "\n\n", "end", "right"),
])
