"""The evaluation's results file (counterpart of regennet_tpu/eval/tools.py),
without PyYAML.

The evaluation writes a mapping of mappings of lists of strings (one
formatted number per seed). `save_metrics` writes exactly the text that
`yaml.dump` gives for such a dict: keys sorted, two-space indents, lists
not indented under their key, and a scalar single-quoted where YAML would
read it as something other than a string (`'0.5'`, `'1'`, `'yes'`) or
where a plain scalar is not allowed; `load_metrics` reads that text back
with every scalar a string (as yaml's BaseLoader does). Scalars are
single-line printable text.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

# PyYAML's implicit resolvers: a plain scalar matching one reads as a
# bool, float, int, null, merge key, value key or timestamp
_IMPLICIT = [re.compile(p) for p in (
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$",
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$",
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$",
    r"^(?:~|null|Null|NULL)$",
    r"^(?:<<)$",
    r"^(?:=)$",
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$",
)]


def _plain_allowed(s: str) -> bool:
    """PyYAML's emitter rules for a plain scalar in block context."""
    if not s or s[0] == " " or s[-1] == " " or s[0] in "#,[]{}&*!|>'\"%@`":
        return False
    if s[0] in "?:-" and (len(s) == 1 or s[1] == " "):
        return False
    return ": " not in s and " #" not in s and not s.endswith(":")


def _scalar(value: Any) -> str:
    s = str(value)
    if not all(" " <= ch <= "~" for ch in s):
        raise ValueError(f"only single-line printable scalars are written: {s!r}")
    if _plain_allowed(s) and not any(r.match(s) for r in _IMPLICIT):
        return s
    return "'" + s.replace("'", "''") + "'"


def _dump(obj, indent: int) -> List[str]:
    pad = " " * indent
    lines = []
    for key in sorted(obj):
        value, head = obj[key], pad + _scalar(key) + ":"
        if isinstance(value, dict):
            if value:
                lines += [head] + _dump(value, indent + 2)
            else:
                lines.append(head + " {}")
        elif isinstance(value, (list, tuple)):
            if value:
                lines += [head] + [f"{pad}- {_scalar(v)}" for v in value]
            else:
                lines.append(head + " []")
        else:
            lines.append(f"{head} {_scalar(value)}")
    return lines


def dumps(metrics: Dict) -> str:
    """The text yaml.dump gives for a dict of dicts / lists / scalars."""
    return "\n".join(_dump(metrics, 0)) + "\n" if metrics else "{}\n"


def _unquote(s: str) -> str:
    if s.startswith("'") and s.endswith("'") and len(s) >= 2:
        return s[1:-1].replace("''", "'")
    return s


def _load(lines: List[str], i: int, indent: int) -> Tuple[Dict, int]:
    out: Dict[str, Any] = {}
    pad = " " * indent
    while i < len(lines) and lines[i].startswith(pad) and lines[i][indent] != " " \
            and not lines[i].startswith(pad + "- "):
        key, _, rest = lines[i][indent:].partition(":")
        key, rest, i = _unquote(key), rest.strip(), i + 1
        if rest == "[]":
            out[key] = []
        elif rest == "{}":
            out[key] = {}
        elif rest:
            out[key] = _unquote(rest)
        elif i < len(lines) and lines[i].startswith(pad + "- "):
            items = []
            while i < len(lines) and lines[i].startswith(pad + "- "):
                items.append(_unquote(lines[i][indent + 2:]))
                i += 1
            out[key] = items
        else:
            out[key], i = _load(lines, i, indent + 2)
    return out, i


def loads(text: str) -> Dict:
    """Read what `dumps` writes; every scalar comes back a string."""
    lines = [line for line in text.splitlines() if line.strip()]
    if lines == ["{}"]:
        return {}
    out, end = _load(lines, 0, 0)
    if end != len(lines):
        raise ValueError(f"unexpected line {end + 1}: {lines[end]!r}")
    return out


def save_metrics(path, metrics):
    with open(path, "w") as f:
        f.write(dumps(metrics))


def load_metrics(path):
    with open(path, "r") as f:
        return loads(f.read())
