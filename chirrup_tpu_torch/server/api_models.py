"""Request and response models of the OpenAI-compatible surface plus the batch
translate / rollout extensions: the fields, defaults and bounds of the JAX
package's pydantic models (chirrup_tpu/server/api_models.py), as dataclasses
with explicit validation (the standard library only).

`Model.from_json(data)` validates a decoded JSON body as pydantic's lax mode
does: numbers, numeric strings and booleans convert where the field's type
takes them ("5" and 5.0 to an int, 1 and "yes" to a bool), a string field
takes only a string, unknown keys are ignored, and every field with `ge` /
`le` bounds is checked; anything else raises ValidationError. `to_json()`
gives the keys and values pydantic's model_dump() gives.
"""

from __future__ import annotations

import dataclasses
import math
import typing
from typing import Any, Dict, List, Optional, Union

from chirrup_tpu_torch.engine.structures import DEFAULT_SAMPLING_CONFIG, DEFAULT_STOP_TOKENS

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


class ValidationError(ValueError):
    """A request body that does not fit its model. errors: [(location,
    message)], one per wrong field."""

    def __init__(self, model: str, errors: List[tuple]):
        self.errors = errors
        lines = [f"{len(errors)} validation error{'s' if len(errors) > 1 else ''} "
                 f"for {model}"]
        for loc, msg in errors:
            lines += [loc or model, f"  {msg}"]
        super().__init__("\n".join(lines))


class _Invalid(Exception):
    """Wrong fields found so far: errors [(location, message)]."""

    def __init__(self, loc: str = "", msg: str = "", errors: Optional[List[tuple]] = None):
        super().__init__(msg)
        self.errors = errors if errors is not None else [(loc, msg)]


def field(default=dataclasses.MISSING, *, ge=None, le=None,
          default_factory=dataclasses.MISSING):
    """A dataclass field with pydantic's `ge` / `le` bounds."""
    return dataclasses.field(default=default, default_factory=default_factory,
                             metadata={"ge": ge, "le": le})


def _join(loc: str, key) -> str:
    return f"{loc}.{key}" if loc else str(key)


def _to_int(v, loc):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if math.isfinite(v) and v.is_integer():
            return int(v)
        raise _Invalid(loc, "Input should be a valid integer, got a number with a "
                            "fractional part")
    if isinstance(v, str):
        try:
            return int(v.strip())
        except ValueError:
            try:
                f = float(v.strip())
            except ValueError:
                f = math.nan
            if math.isfinite(f) and f.is_integer():
                return int(f)
        raise _Invalid(loc, "Input should be a valid integer, unable to parse string "
                            "as an integer")
    raise _Invalid(loc, "Input should be a valid integer")


def _to_float(v, loc):
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            raise _Invalid(loc, "Input should be a valid number, unable to parse "
                                "string as a number") from None
    raise _Invalid(loc, "Input should be a valid number")


def _to_bool(v, loc):
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.strip().lower() in _TRUE | _FALSE:
        return v.strip().lower() in _TRUE
    raise _Invalid(loc, "Input should be a valid boolean")


def _convert(tp, v, loc):
    """v converted to the annotation tp, or _Invalid."""
    origin = typing.get_origin(tp)
    if tp is Any:
        return v
    if origin is Union:
        args = typing.get_args(tp)
        if v is None and type(None) in args:
            return None
        last = None
        for arg in (a for a in args if a is not type(None)):
            try:
                return _convert(arg, v, loc)
            except _Invalid as exc:
                last = exc
        raise last
    if origin in (list, List):
        if not isinstance(v, list):
            raise _Invalid(loc, "Input should be a valid list")
        (item,) = typing.get_args(tp)
        return [_convert(item, x, _join(loc, i)) for i, x in enumerate(v)]
    if origin in (dict, Dict):
        if not isinstance(v, dict):
            raise _Invalid(loc, "Input should be a valid dictionary")
        return dict(v)
    if isinstance(tp, type) and issubclass(tp, Model):
        return tp._validate(v, loc)
    if tp is str:
        if not isinstance(v, str):
            raise _Invalid(loc, "Input should be a valid string")
        return v
    if tp is bool:
        return _to_bool(v, loc)
    if tp is int:
        return _to_int(v, loc)
    if tp is float:
        return _to_float(v, loc)
    raise TypeError(f"unsupported annotation {tp!r}")


@dataclasses.dataclass(kw_only=True)
class Model:
    """Base of the models: validation from JSON and the model_dump() form."""

    @classmethod
    def _validate(cls, data, loc: str = ""):
        if not isinstance(data, dict):
            raise _Invalid(loc, "Input should be a valid dictionary or instance of "
                                f"{cls.__name__}")
        hints = typing.get_type_hints(cls)
        values, errors = {}, []
        for f in dataclasses.fields(cls):
            at = _join(loc, f.name)
            if f.name not in data:
                if (f.default is dataclasses.MISSING
                        and f.default_factory is dataclasses.MISSING):
                    errors.append((at, "Field required"))
                continue
            try:
                v = _convert(hints[f.name], data[f.name], at)
                ge, le = f.metadata.get("ge"), f.metadata.get("le")
                if ge is not None and not v >= ge:
                    raise _Invalid(at, f"Input should be greater than or equal to {ge}")
                if le is not None and not v <= le:
                    raise _Invalid(at, f"Input should be less than or equal to {le}")
                values[f.name] = v
            except _Invalid as exc:
                errors += exc.errors
        if errors:
            raise _Invalid(errors=errors)
        return cls(**values)

    @classmethod
    def from_json(cls, data):
        """Validate a decoded JSON value; raises ValidationError."""
        try:
            return cls._validate(data)
        except _Invalid as exc:
            raise ValidationError(cls.__name__, exc.errors) from None

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_S = DEFAULT_SAMPLING_CONFIG


@dataclasses.dataclass(kw_only=True)
class ChatMessage(Model):
    role: str  # 'user' | 'assistant' | 'system'
    content: str
    reasoning_content: Optional[str] = None


@dataclasses.dataclass(kw_only=True)
class ChatCompletionRequest(Model):
    model: str = "rwkv-latest"
    messages: List[ChatMessage]
    stream: bool = False

    temperature: float = field(_S["temperature"], ge=0.0, le=2.0)
    top_p: float = field(_S["top_p"], ge=0.0, le=1.0)
    presence_penalty: float = field(_S["presence_penalty"], ge=0, le=2.0)
    frequency_penalty: float = field(_S["frequency_penalty"], ge=0, le=2.0)
    penalty_decay: float = field(_S["penalty_decay"], ge=0.0, le=1.0)
    max_tokens: int = field(_S["max_tokens"], ge=1)
    stop: Optional[Union[str, List[str]]] = None
    # disable ALL stop tokens (the defaults too), so generation runs to
    # max_tokens (the vLLM benchmarking extra)
    ignore_eos: bool = False

    pad_zero: bool = True  # prepend token 0 to the prompt
    use_state_cache: bool = True
    cache_prefill: bool = True


@dataclasses.dataclass(kw_only=True)
class ChatCompletionResponseChoice(Model):
    index: int
    message: ChatMessage
    finish_reason: str


@dataclasses.dataclass(kw_only=True)
class ChatCompletionResponseUsage(Model):
    prompt_tokens: int
    completion_tokens: int
    total_tokens: int


@dataclasses.dataclass(kw_only=True)
class ChatCompletionResponse(Model):
    id: str
    object: str = "chat.completion"
    created: int
    model: str
    choices: List[ChatCompletionResponseChoice]
    usage: ChatCompletionResponseUsage


@dataclasses.dataclass(kw_only=True)
class ChatCompletionStreamChoice(Model):
    index: int
    delta: Dict[str, Any]
    finish_reason: Optional[str] = None


@dataclasses.dataclass(kw_only=True)
class ChatCompletionStreamResponse(Model):
    id: str
    object: str = "chat.completion.chunk"
    created: int
    model: str
    choices: List[ChatCompletionStreamChoice]
    # on the terminal frame only: the server's token counts (frames
    # undercount tokens where think-tag routing merges runs)
    usage: Optional[ChatCompletionResponseUsage] = None


@dataclasses.dataclass(kw_only=True)
class ModelInfo(Model):
    id: str
    object: str = "model"
    created: int
    owned_by: str


@dataclasses.dataclass(kw_only=True)
class ModelsResponse(Model):
    object: str = "list"
    data: List[ModelInfo]


@dataclasses.dataclass(kw_only=True)
class ErrorResponse(Model):
    error: Dict[str, Any]


@dataclasses.dataclass(kw_only=True)
class TranslateRequest(Model):
    source_lang: str = "auto"
    target_lang: str
    text_list: List[str]
    placeholders: Optional[List[str]] = None


@dataclasses.dataclass(kw_only=True)
class TranslationResult(Model):
    text: str
    detected_source_lang: str


@dataclasses.dataclass(kw_only=True)
class TranslateResponse(Model):
    translations: List[TranslationResult]
    id: str
    created: int


@dataclasses.dataclass(kw_only=True)
class RolloutRequest(Model):
    model: str = "rwkv-latest"
    contents: List[str]
    stream: bool = False

    temperature: float = field(_S["temperature"], ge=0.0, le=2.0)
    top_p: float = field(_S["top_p"], ge=0.0, le=1.0)
    presence_penalty: float = field(_S["presence_penalty"], ge=0, le=2.0)
    frequency_penalty: float = field(_S["frequency_penalty"], ge=0, le=2.0)
    penalty_decay: float = field(_S["penalty_decay"], ge=0.0, le=1.0)
    max_tokens: int = field(_S["max_tokens"], ge=1)
    stop_tokens: List[int] = field(default_factory=lambda: list(DEFAULT_STOP_TOKENS))
    pad_zero: bool = True


@dataclasses.dataclass(kw_only=True)
class RolloutStreamChoice(Model):
    index: int
    delta: Dict[str, Any]


@dataclasses.dataclass(kw_only=True)
class RolloutStreamResponse(Model):
    id: str
    object: str = "batch.rollout.chunk"
    created: int
    model: str = "rwkv-latest"
    choices: List[RolloutStreamChoice] = field(default_factory=list)
    rollouts: Optional[List[RolloutStreamChoice]] = None
