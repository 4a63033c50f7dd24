"""AMOS message reader (copied from ``sequence_aligner_tpu/io/amos.py``).

Parses the nested ``{TAG\\nkey:value\\n...}`` message blocks the AMOS
toolchain emits (OVL, RED, CTG streams; the inspection role of its
``message-extract`` and ``bank-report`` utilities) into plain objects.
A key with an empty value starts a multi-line value, ended by a line
holding only ``.``; its lines are joined without separators.
"""

from __future__ import annotations

from collections.abc import Iterator
from dataclasses import dataclass, field


@dataclass
class AmosMessage:
    type: str
    fields: dict[str, str] = field(default_factory=dict)
    children: list["AmosMessage"] = field(default_factory=list)

    def get_int(self, key: str, default: int = 0) -> int:
        try:
            return int(self.fields.get(key, default))
        except ValueError:
            return default


def iter_amos_messages(path_or_text: str, *, is_text: bool = False) -> Iterator[AmosMessage]:
    """The top-level messages of a file (or of its text), nested messages
    as their parents' ``children``."""
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    lines = text.splitlines()
    stack: list[AmosMessage] = []
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("{"):
            stack.append(AmosMessage(type=line[1:].strip()))
        elif line.startswith("}"):
            if stack:
                msg = stack.pop()
                if stack:
                    stack[-1].children.append(msg)
                else:
                    yield msg
        elif ":" in line and stack:
            key, val = line.split(":", 1)
            if val == "":  # a multi-line value, ended by "."
                parts: list[str] = []
                i += 1
                while i < len(lines) and lines[i] != ".":
                    parts.append(lines[i])
                    i += 1
                stack[-1].fields[key] = "".join(parts)
            else:
                stack[-1].fields[key] = val
        i += 1


def read_amos_messages(path: str, type_filter: str | None = None) -> list[AmosMessage]:
    """The top-level messages of a file, only those of ``type_filter`` if
    given."""
    return [m for m in iter_amos_messages(path)
            if type_filter is None or m.type == type_filter]
