"""Dict and ``__str__`` helpers (a copy of the JAX package's
``utils/misc.py``, numpy-free; importing it through that package pulls in
JAX)."""

from collections.abc import Mapping

__all__ = ["flatten_dict", "unflatten_dict", "recursive_update", "to_str",
           "format_class_str"]

# rendering geometry for the rich __str__ output
_INDENT = 2
_KEY_COLUMN = 24


def _walk_items(node, prefix, sep):
    for key, value in node.items():
        path = f"{prefix}{sep}{key}" if prefix else key
        if isinstance(value, Mapping):
            yield from _walk_items(value, path, sep)
        else:
            yield path, value


def flatten_dict(d, parent_key="", sep="."):
    """Flatten a nested dict into dotted keys."""
    return dict(_walk_items(d, parent_key, sep))


def unflatten_dict(d, sep="."):
    """Invert :func:`flatten_dict`."""
    result = {}
    for key, value in d.items():
        parts = key.split(sep)
        node = result
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return result


def recursive_update(d, u, skip=("asdf_library", "history")):
    """Deep-merge dict ``u`` into dict ``d`` (in place) and return it.

    Nested mappings merge recursively; scalar values overwrite. Keys in
    ``skip`` (tooling metadata in serialized trees) are ignored.
    """
    for key, value in u.items():
        if key in skip:
            continue
        if isinstance(value, Mapping):
            current = d.get(key)
            d[key] = recursive_update(
                current if isinstance(current, dict) else {}, value
            )
        else:
            d[key] = value
    return d


def _render_value(value, level):
    if isinstance(value, Mapping):
        return _render_mapping(value, level)
    if isinstance(value, float):
        return f"{value:.4g}"
    return str(value)


def _render_mapping(data, level):
    pad = " " * (_INDENT * level)
    column = max(2, _KEY_COLUMN - _INDENT * level)
    lines = [""]
    for key, value in data.items():
        lines.append(f"{pad}{key:<{column}}: {_render_value(value, level + 1)}")
    return "\n".join(lines) + "\n"


def to_str(data, level=1):
    """Render a (possibly nested) dict for ``__str__`` output."""
    return _render_value(data, level)


def format_class_str(instance):
    """Uniform rich ``__str__``: class-name heading over the rendered
    ``to_dict`` tree."""
    title = type(instance).__name__
    body = to_str(instance.to_dict())
    return f"{title}\n{'-' * len(title)}\n{body}"
