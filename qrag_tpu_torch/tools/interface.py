"""Typed tool contracts (the port's counterpart of
``qrag_tpu.tools.interface``), with no pydantic.

`Model` is a small declarative base: fields are class annotations with
optional defaults, construction validates and coerces each value as
pydantic's lax mode does for the types the tools use (str, int, float,
bool, Optional, List, Dict[str, Any], Any), and ``model_json_schema``
emits the JSON schema pydantic emits for the same class, key for key.
`BaseToolInput` rejects unknown fields (pydantic's ``extra="forbid"``).
The MCP ``tools/list`` payload and ``Tool.get_schema`` are built from
these schemas, so they equal the reference's.
"""

from __future__ import annotations

import abc
import copy
import json
import math
import typing
from typing import Any, Callable, ClassVar, Dict, List, Optional, Tuple, Type, Union

_MISSING = object()
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


class ValidationError(ValueError):
    """Raised for input that does not fit a model; ``errors`` lists
    (field, message) pairs."""

    def __init__(self, model: str, errors: List[Tuple[str, str]]):
        self.errors = errors
        lines = "\n".join(f"{loc}\n  {msg}" for loc, msg in errors)
        super().__init__(f"{len(errors)} validation error(s) for {model}\n{lines}")


def _scalar(tp: Any) -> Callable[[Any], Any]:
    """The lax coercion of one scalar type; raises ValueError."""
    if tp is str:
        def conv(value):
            if not isinstance(value, str):
                raise ValueError("input should be a valid string")
            return value
    elif tp is bool:
        def conv(value):
            if isinstance(value, bool):
                return value
            if isinstance(value, (int, float)) and value in (0, 1):
                return bool(value)
            if isinstance(value, str) and value.strip().lower() in _TRUE | _FALSE:
                return value.strip().lower() in _TRUE
            raise ValueError("input should be a valid boolean")
    elif tp is int:
        def conv(value):
            if isinstance(value, int):
                return int(value)
            if isinstance(value, float):
                if not math.isfinite(value):
                    raise ValueError("input should be a finite number")
                if value != int(value):
                    raise ValueError("input should be a valid integer, got a fractional part")
                return int(value)
            if isinstance(value, str):
                try:
                    return int(value.strip())
                except ValueError:
                    raise ValueError("input should be a valid integer") from None
            raise ValueError("input should be a valid integer")
    elif tp is float:
        def conv(value):
            if isinstance(value, (int, float)):
                return float(value)
            if isinstance(value, str):
                try:
                    return float(value.strip())
                except ValueError:
                    raise ValueError("input should be a valid number") from None
            raise ValueError("input should be a valid number")
    else:
        raise TypeError(f"unsupported field type {tp!r}")
    return conv


def _converter(tp: Any) -> Callable[[Any], Any]:
    """A function that validates and coerces a value to ``tp`` as
    pydantic's lax mode does, returning new containers (so it also
    copies a valid value); raises ValueError with the reason."""
    origin = typing.get_origin(tp)
    if tp is Any:
        return lambda value: value
    if origin is Union:
        arms = [_converter(a) for a in typing.get_args(tp) if a is not type(None)]
        nullable = type(None) in typing.get_args(tp)

        def union(value):
            if value is None and nullable:
                return None
            reasons = []
            for arm in arms:
                try:
                    return arm(value)
                except ValueError as e:
                    reasons.append(str(e))
            raise ValueError("; ".join(reasons))

        return union
    if origin in (list, List):
        (item_tp,) = typing.get_args(tp) or (Any,)
        item = _converter(item_tp)
        exact = {item_tp} if item_tp in (str, float) else None

        def seq(value):
            if not isinstance(value, (list, tuple)):
                raise ValueError("input should be a valid list")
            if exact is not None and set(map(type, value)) <= exact:
                return list(value)  # already valid: copy at C speed
            return [item(v) for v in value]

        return seq
    if origin in (dict, Dict):
        def mapping(value):
            if not isinstance(value, dict):
                raise ValueError("input should be a valid dictionary")
            return dict(value)

        return mapping
    return _scalar(tp)


def _type_schema(tp: Any) -> Dict[str, Any]:
    origin = typing.get_origin(tp)
    if tp is Any:
        return {}
    if origin is Union:
        return {"anyOf": [_type_schema(a) for a in typing.get_args(tp)]}
    if origin in (list, List):
        (item,) = typing.get_args(tp) or (Any,)
        return {"items": _type_schema(item), "type": "array"}
    if origin in (dict, Dict):
        return {"additionalProperties": True, "type": "object"}
    return {
        str: {"type": "string"},
        int: {"type": "integer"},
        float: {"type": "number"},
        bool: {"type": "boolean"},
        type(None): {"type": "null"},
    }[tp]


class Model:
    """Declarative, validated record (the subset of pydantic's
    ``BaseModel`` the tools use)."""

    _forbid_extra: ClassVar[bool] = False
    # name -> (type, default or _MISSING, converter)
    _fields: ClassVar[Dict[str, Tuple[Any, Any, Callable[[Any], Any]]]] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = {}
        for name, tp in typing.get_type_hints(cls).items():
            if name.startswith("_") or typing.get_origin(tp) is ClassVar:
                continue
            fields[name] = (tp, getattr(cls, name, _MISSING), _converter(tp))
        cls._fields = fields

    def __init__(self, **data: Any):
        errors: List[Tuple[str, str]] = []
        if self._forbid_extra:
            errors += [(k, "extra inputs are not permitted") for k in data if k not in self._fields]
        for name, (_, default, conv) in self._fields.items():
            if name in data:
                try:
                    setattr(self, name, conv(data[name]))
                except ValueError as e:
                    errors.append((name, str(e)))
            elif default is _MISSING:
                errors.append((name, "field required"))
            else:
                setattr(self, name, copy.deepcopy(default))
        if errors:
            raise ValidationError(type(self).__name__, errors)

    def model_dump(self) -> Dict[str, Any]:
        """The fields as a dict of new containers."""
        return {name: conv(getattr(self, name)) for name, (_, _, conv) in self._fields.items()}

    @classmethod
    def model_json_schema(cls) -> Dict[str, Any]:
        props = {}
        for name, (tp, default, _) in cls._fields.items():
            prop = {**_type_schema(tp), "title": name.replace("_", " ").title()}
            if default is not _MISSING:
                prop["default"] = copy.deepcopy(default)
            props[name] = dict(sorted(prop.items()))
        schema: Dict[str, Any] = {"properties": props, "title": cls.__name__, "type": "object"}
        required = [n for n, (_, d, _) in cls._fields.items() if d is _MISSING]
        if required:
            schema["required"] = required
        if cls._forbid_extra:
            schema["additionalProperties"] = False
        return dict(sorted(schema.items()))


class BaseToolInput(Model):
    """Base for all tool inputs: unknown fields are rejected."""

    _forbid_extra: ClassVar[bool] = True


class ToolContent:
    """One piece of tool output: text, json, or a `Model` (serialized
    to json content on construction)."""

    def __init__(self, type: str = "json", text: Optional[str] = None, data: Any = None):
        if type not in ("text", "json"):
            raise ValidationError("ToolContent", [("type", "input should be 'text' or 'json'")])
        if isinstance(data, Model):
            data, type = data.model_dump(), "json"
        if type == "text" and text is None and data is not None:
            text = json.dumps(data)
        self.type, self.text, self.data = type, text, data


class ToolResponse:
    """Envelope for tool results."""

    def __init__(self, success: bool = True, error: Optional[str] = None,
                 content: Optional[List[ToolContent]] = None):
        self.success = success
        self.error = error
        self.content = list(content or [])

    @classmethod
    def from_model(cls, model: Model) -> "ToolResponse":
        return cls(content=[ToolContent(type="json", data=model)])

    @classmethod
    def from_text(cls, text: str) -> "ToolResponse":
        return cls(content=[ToolContent(type="text", text=text)])

    @classmethod
    def from_error(cls, error: str, **extra: Any) -> "ToolResponse":
        content = [ToolContent(type="json", data=extra)] if extra else []
        return cls(success=False, error=error, content=content)

    def first_json(self) -> Optional[Dict[str, Any]]:
        for c in self.content:
            if c.type == "json" and c.data is not None:
                return c.data
        return None


class Tool(abc.ABC):
    """Tool contract: ClassVar metadata + async execute."""

    name: ClassVar[str]
    description: ClassVar[str]
    input_model: ClassVar[Type[BaseToolInput]]
    output_model: ClassVar[Optional[Type[Model]]] = None

    @abc.abstractmethod
    async def execute(self, input_data: BaseToolInput) -> ToolResponse: ...

    def get_schema(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "description": self.description,
            "input": self.input_model.model_json_schema(),
            "output": (
                self.output_model.model_json_schema() if self.output_model else None
            ),
        }
