"""OpenAI chat messages -> RWKV chat-format prompt strings.

The same format as the JAX package's chirrup_tpu.utils.prompt_formatters: roles render as 'User:'/'Assistant:'/'System:', runs of
newlines inside a message squeeze to one, turns join with blank lines, and the
assistant cue optionally opens a think block ('' / '<think>' /
'<think>\\n</think>' for no/with/quick thinking).
"""

from __future__ import annotations

import re
from typing import Dict, List, Union

_ROLE_NAMES = {"user": "User", "assistant": "Assistant", "system": "System"}


def clean_openai_messages(messages: List[Union[Dict[str, str], object]]) -> str:
    parts = []
    for msg in messages:
        if not isinstance(msg, dict):
            msg = {"role": getattr(msg, "role"), "content": getattr(msg, "content")}
        role = msg.get("role", "")
        content = (msg.get("content") or "").strip()
        content = re.sub(r"\n+", "\n", content) if content else ""
        name = _ROLE_NAMES.get(role, role)
        parts.append(f"{name}: {content}")
    return "\n\n".join(parts)


def format_no_thinking(messages) -> str:
    return clean_openai_messages(messages) + "\n\nAssistant:"


def format_with_thinking(messages) -> str:
    return clean_openai_messages(messages) + "\n\nAssistant:<think>"


def format_quick_thinking(messages) -> str:
    return clean_openai_messages(messages) + "\n\nAssistant:<think>\n</think>"
