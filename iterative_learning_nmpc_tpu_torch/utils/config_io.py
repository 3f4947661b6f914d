"""YAML <-> dataclass config IO: the reference's Hydra/OmegaConf layer.

Counterpart of ``iterative_learning_nmpc_tpu/utils/config_io.py``, with the
same API and coercion:

    cfg = load_config(TrainConfig, "cfgs/train.yaml",
                      overrides=["learning_rate=1e-4", "n_epochs=50"])
    save_config(cfg, run_dir + "/config.yaml")   # provenance snapshot

Values are coerced to the declared field types; unknown keys are an error
(typo guard, the role of Hydra's struct mode).

The files are read and written by this module's own small YAML codec
(``dump_yaml`` / ``load_yaml``), on every machine: the GPU machines the port
runs on need not have PyYAML. It covers what these configs hold:

- a block mapping of plain keys to scalars: str, int, float, bool, null;
- sequences of such scalars, nested once (``SafeDaggerConfig.goals``), in
  flow style (``[a, [b, c]]``, what ``dump_yaml`` writes) or in block style
  (``- a`` / ``- - b``, what PyYAML's ``safe_dump`` writes);
- comments, single- and double-quoted strings.

Scalars resolve as PyYAML's YAML 1.1 resolver resolves them, and
``dump_yaml`` writes only forms that PyYAML's ``safe_load`` reads back to
the same values. Anything outside the subset (anchors, tags, block
scalars, nested mappings, hex or octal numbers, ...) raises ``ValueError``
naming the construct.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import datetime
import math
import os
import re
import typing
from typing import Any, Optional, Sequence, Type, TypeVar

T = TypeVar("T")

# ---------------------------------------------------------------------------
# the YAML codec

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# plain forms PyYAML resolves to something this codec does not: octal, hex,
# binary and sexagesimal numbers, timestamps, merge keys
_OTHER = re.compile(r"[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?0b[01_]+"
                    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_PLAIN_STR = re.compile(r"[A-Za-z_./][A-Za-z0-9_./\-]*")


def _scalar(text: str, where: str):
    """A plain scalar, resolved as YAML 1.1 (PyYAML) resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    m = _INF.fullmatch(text)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    if _OTHER.fullmatch(text):
        raise ValueError(f"{where}: the scalar {text!r} (octal, hex, binary, sexagesimal, "
                         "timestamp or merge key) is outside this codec's subset")
    if text[0] in "&*!|>%@`{":
        names = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
                 ">": "a block scalar", "%": "a directive", "@": "a reserved indicator",
                 "`": "a reserved indicator", "{": "a flow mapping"}
        raise ValueError(f"{where}: {names[text[0]]} ({text!r}) is outside this codec's "
                         "subset")
    return text


def _quoted(text: str, i: int, where: str):
    """The quoted string starting at text[i] -> (value, index after it)."""
    q = text[i]
    out, j = [], i + 1
    escapes = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = text[j + 1:j + 2]
            if e not in escapes:
                raise ValueError(f"{where}: the escape \\{e} is outside this codec's subset")
            out.append(escapes[e])
            j += 2
            continue
        out.append(c)
        j += 1
    raise ValueError(f"{where}: unterminated quoted string (a multi-line string is outside "
                     "this codec's subset)")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment (a '#' after whitespace, outside
    quotes)."""
    q = None
    for i, c in enumerate(text):
        if q:
            if c == q:
                q = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " [,:-"):
            q = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _flow(text: str, i: int, depth: int, where: str):
    """The flow sequence starting at text[i] == '[' -> (list, index after)."""
    if depth > 2:
        raise ValueError(f"{where}: a sequence nested more than once is outside this "
                         "codec's subset")
    out, j = [], i + 1
    while True:
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            raise ValueError(f"{where}: unterminated flow sequence")
        if text[j] == "]":
            return out, j + 1
        if text[j] == "[":
            item, j = _flow(text, j, depth + 1, where)
        elif text[j] in "'\"":
            item, j = _quoted(text, j, where)
        else:
            k = j
            while k < len(text) and text[k] not in ",]":
                k += 1
            item = _scalar(text[j:k].strip(), where)
            if isinstance(item, str) and (":" in item or "[" in item):
                raise ValueError(f"{where}: a flow mapping or odd scalar {item!r} inside a "
                                 "sequence is outside this codec's subset")
            j = k
        out.append(item)
        while j < len(text) and text[j] == " ":
            j += 1
        if j < len(text) and text[j] == ",":
            j += 1
        elif j < len(text) and text[j] != "]":
            raise ValueError(f"{where}: expected ',' or ']' in a flow sequence")


def _value(text: str, where: str, depth: int = 1):
    """An inline value: a quoted or plain scalar or a flow sequence."""
    text = text.strip()
    if not text:
        return None
    if text[0] == "[":
        v, j = _flow(text, 0, depth, where)
    elif text[0] in "'\"":
        v, j = _quoted(text, 0, where)
    else:
        return _scalar(text, where)
    if text[j:].strip():
        raise ValueError(f"{where}: unexpected text after a value: {text[j:]!r}")
    return v


def load_yaml(text: str) -> dict:
    """Parse a config file of this codec's subset -> dict (empty for an
    empty document)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tab indentation is outside this codec's subset")
        line = _strip_comment(raw)
        if not line.strip() or line.strip() in ("---", "..."):
            if line.strip() == "---" and lines:
                raise ValueError(f"line {n}: a second document is outside this codec's "
                                 "subset")
            continue
        lines.append((n, len(line) - len(line.lstrip(" ")), line.strip()))
    out: dict = {}
    i = 0
    while i < len(lines):
        n, ind, s = lines[i]
        where = f"line {n}"
        if ind != 0:
            raise ValueError(f"{where}: a nested mapping or unexpected indentation is outside "
                             "this codec's subset")
        if s.startswith("- "):
            raise ValueError(f"{where}: a top-level sequence is outside this codec's subset "
                             "(the document must be a mapping)")
        key, sep, rest = s.partition(":")
        if not sep or (rest and rest[0] != " "):
            raise ValueError(f"{where}: expected 'key: value', got {s!r}")
        key = key.strip()
        if not _KEY.fullmatch(key):
            raise ValueError(f"{where}: the key {key!r} is outside this codec's subset "
                             "(plain identifiers only)")
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        i += 1
        if rest.strip():
            out[key] = _value(rest, where)
            continue
        # a block sequence below the key (PyYAML writes it at the key's
        # indentation), or null
        items, item_ind = [], None
        while i < len(lines) and lines[i][2].startswith("-") and lines[i][2][1:2] in ("", " "):
            n2, ind2, s2 = lines[i]
            if item_ind is None:
                item_ind = ind2
            if ind2 != item_ind:
                raise ValueError(f"line {n2}: unexpected indentation in a block sequence")
            body = s2[1:].strip()
            i += 1
            if body.startswith("- ") or body == "-":
                # a nested block sequence: '- - a' then '  - b' lines
                inner = [_value(body[1:], f"line {n2}", 2)]
                while (i < len(lines) and lines[i][1] == ind2 + 2
                       and lines[i][2].startswith("- ")):
                    inner.append(_value(lines[i][2][1:], f"line {lines[i][0]}", 2))
                    i += 1
                if any(isinstance(x, list) for x in inner):
                    raise ValueError(f"line {n2}: a sequence nested more than once is outside "
                                     "this codec's subset")
                items.append(inner)
            elif re.match(r"[A-Za-z_][A-Za-z0-9_]*:( |$)", body):
                raise ValueError(f"line {n2}: a mapping inside a sequence is outside this "
                                 "codec's subset")
            else:
                items.append(_value(body, f"line {n2}", 2))
        if item_ind is None and i < len(lines) and lines[i][1] > 0:
            raise ValueError(f"line {lines[i][0]}: a nested mapping is outside this codec's "
                             "subset")
        out[key] = items if item_ind is not None else None
    return out


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        mant, e, exp = r.partition("e")
        if "." not in mant:
            mant += ".0"
        if e and exp[0] not in "+-":
            exp = "+" + exp
        return mant + (f"e{exp}" if e else "")
    if isinstance(v, str):
        if any(ord(c) < 32 for c in v):
            raise ValueError(f"the string {v!r} holds a control character: outside this "
                             "codec's subset")
        if _PLAIN_STR.fullmatch(v) and _scalar(v, "dump") == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"a value of type {type(v).__name__} ({v!r}) is outside this codec's "
                     "subset")


def _dump_value(v, depth: int = 1) -> str:
    if isinstance(v, (list, tuple)):
        if depth > 2:
            raise ValueError("a sequence nested more than once is outside this codec's subset")
        return "[" + ", ".join(_dump_value(x, depth + 1) for x in v) + "]"
    return _dump_scalar(v)


def dump_yaml(data: dict) -> str:
    """A flat mapping -> YAML text of this codec's subset (sequences in flow
    style), in the mapping's order."""
    lines = []
    for k, v in data.items():
        if not isinstance(k, str) or not _KEY.fullmatch(k):
            raise ValueError(f"the key {k!r} is outside this codec's subset")
        if isinstance(v, dict):
            raise ValueError(f"{k}: a nested mapping is outside this codec's subset")
        lines.append(f"{k}: {_dump_value(v)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# dataclass configs

def _coerce(value: Any, ftype: Any) -> Any:
    """Coerce a YAML-decoded value to a dataclass field type."""
    origin = typing.get_origin(ftype)
    if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
        return _from_dict(ftype, value)
    if origin in (list, tuple, collections.abc.Sequence) or (
        origin is None and ftype in (list, tuple)
    ):
        args = typing.get_args(ftype)
        inner = args[0] if args and args[0] is not Ellipsis else None
        items = [
            _coerce(v, inner) if inner is not None else v for v in value
        ]
        return tuple(items)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0]) if args else value
    if ftype is bool and isinstance(value, bool):
        return value
    if ftype in (int, float, str) and value is not None:
        return ftype(value)
    return value


def _from_dict(cls: Type[T], data: dict) -> T:
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}"
        )
    kwargs = {k: _coerce(v, fields[k].type) for k, v in data.items()}
    return cls(**kwargs)


def _resolve_field_types(cls) -> dict:
    """Field name -> resolved type (dataclass .type may be a string)."""
    hints = typing.get_type_hints(cls)
    return {f.name: hints.get(f.name, f.type) for f in dataclasses.fields(cls)}


def apply_overrides(cfg: T, overrides: Sequence[str]) -> T:
    """Hydra-style `key=value` overrides (dotted keys reach into nested
    dataclasses); values parsed as YAML scalars or flow sequences, then
    coerced."""
    types_cache: dict = {}

    def set_one(obj, dotted: str, raw: str):
        head, _, rest = dotted.partition(".")
        cls = type(obj)
        if cls not in types_cache:
            types_cache[cls] = _resolve_field_types(cls)
        ftypes = types_cache[cls]
        if head not in ftypes:
            raise KeyError(
                f"unknown config key '{head}' for {cls.__name__}"
            )
        if rest:
            child = set_one(getattr(obj, head), rest, raw)
            return dataclasses.replace(obj, **{head: child})
        value = _coerce(_value(raw, f"override {dotted}"), ftypes[head])
        return dataclasses.replace(obj, **{head: value})

    for ov in overrides or ():
        key, sep, raw = ov.partition("=")
        if not sep:
            raise ValueError(f"override '{ov}' is not key=value")
        cfg = set_one(cfg, key.strip(), raw.strip())
    return cfg


def load_config(
    cls: Type[T],
    path: Optional[str] = None,
    overrides: Sequence[str] = (),
) -> T:
    """Build a config: dataclass defaults <- YAML file <- overrides."""
    data = {}
    if path:
        with open(path) as f:
            data = load_yaml(f.read())
    # fill from defaults first so partial YAML files are fine
    fields = _resolve_field_types(cls)
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}"
        )
    cfg = cls(**{k: _coerce(v, fields[k]) for k, v in data.items()})
    return apply_overrides(cfg, overrides)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg, path: str) -> None:
    """YAML provenance snapshot next to a run's outputs (the role of the
    reference's pickled config)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(dump_yaml(to_dict(cfg)))


def timestamped_run_dir(root: str, name: str = "run") -> str:
    """Hydra-style `outputs/<date>/<time>_<name>` run directory
    (reference `iter_locosafedagger.yaml:10-11`)."""
    now = datetime.datetime.now()
    d = os.path.join(
        root, now.strftime("%Y-%m-%d"), now.strftime("%H-%M-%S_") + name
    )
    os.makedirs(d, exist_ok=True)
    return d
