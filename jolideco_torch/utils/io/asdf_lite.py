"""Minimal ASDF reader and writer (a subset of the standard, without the
``asdf`` package; a copy of the JAX package's ``utils/io/asdf_lite.py``).

Enough of the ASDF 1.5 standard for result trees: a YAML tree whose numpy
arrays are ``!core/ndarray-1.0.0`` references into uncompressed binary
blocks after the tree. Files follow the block layout of the standard
(magic ``\\xd3BLK``, a 48-byte header with flags, compression, sizes and
md5), so they read in the ``asdf`` library too; reading supports the same
subset (inline lists and uncompressed blocks). The tree's
``asdf_library`` names this package. pyyaml is imported on the first read
or write, so that the package imports without it.
"""

import hashlib
import logging
import struct
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["write_asdf", "read_asdf"]

BLOCK_MAGIC = b"\xd3BLK"
NDARRAY_TAG = "tag:stsci.edu:asdf/core/ndarray-1.0.0"
ASDF_TAG = "tag:stsci.edu:asdf/core/asdf-1.1.0"
SOFTWARE_TAG = "tag:stsci.edu:asdf/core/software-1.0.0"

_DTYPES = {
    "float64": np.dtype("float64"),
    "float32": np.dtype("float32"),
    "int64": np.dtype("int64"),
    "int32": np.dtype("int32"),
    "int16": np.dtype("int16"),
    "uint8": np.dtype("uint8"),
    "bool8": np.dtype("bool"),
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


class _NDArrayRef:
    """Placeholder for a block-backed ndarray in the YAML tree."""

    def __init__(self, source, datatype, byteorder, shape):
        self.source = source
        self.datatype = datatype
        self.byteorder = byteorder
        self.shape = shape


def _ndarray_representer(dumper, ref):
    return dumper.represent_mapping(
        f"!{NDARRAY_TAG.split('asdf/')[-1]}",
        {
            "source": ref.source,
            "datatype": ref.datatype,
            "byteorder": ref.byteorder,
            "shape": list(ref.shape),
        },
    )


def _make_dumper():
    import yaml

    class _AsdfDumper(yaml.SafeDumper):
        pass

    _AsdfDumper.add_representer(_NDArrayRef, _ndarray_representer)
    for scalar in (np.float32, np.float64):
        _AsdfDumper.add_representer(
            scalar, lambda d, v: d.represent_float(float(v)))
    for scalar in (np.int32, np.int64):
        _AsdfDumper.add_representer(
            scalar, lambda d, v: d.represent_int(int(v)))
    _AsdfDumper.add_representer(np.bool_,
                                lambda d, v: d.represent_bool(bool(v)))
    _AsdfDumper.add_representer(np.str_,
                                lambda d, v: d.represent_str(str(v)))
    # the remaining numpy scalar types (f16, u8, i16, ...)
    _AsdfDumper.add_multi_representer(
        np.integer, lambda d, v: d.represent_int(int(v)))
    _AsdfDumper.add_multi_representer(
        np.floating, lambda d, v: d.represent_float(float(v)))
    return _AsdfDumper


# value-preserving promotions onto the block datatypes this subset
# reads back (same policy as minifits: widen, never silently lossy)
_DTYPE_PROMOTE = {
    np.dtype(np.int8): np.int16,
    np.dtype(np.uint16): np.int32,
    np.dtype(np.uint32): np.int64,
    np.dtype(np.float16): np.float32,
}


def _writable_array(node):
    dtype = node.dtype.newbyteorder("=")
    if dtype in _DTYPE_NAMES:
        return node
    promoted = _DTYPE_PROMOTE.get(dtype)
    if promoted is not None:
        return node.astype(promoted)
    if dtype == np.uint64:
        if node.size and node.max() > np.iinfo(np.int64).max:
            raise ValueError(
                "uint64 array data exceeds the int64 range"
            )
        return node.astype(np.int64)
    if dtype.kind in "cSUV":
        raise ValueError(
            f"dtype {node.dtype} has no ASDF block representation in "
            "this subset (supported: bool, (u)int8-64, float16/32/64)"
        )
    return node.astype(np.float64)


def _collect_arrays(node, blocks):
    """Replace ndarrays with block references, depth-first."""
    if isinstance(node, np.ndarray):
        node = _writable_array(node)
        dtype = node.dtype.newbyteorder("=")
        source = len(blocks)
        blocks.append(np.ascontiguousarray(node))
        return _NDArrayRef(
            source=source,
            datatype=_DTYPE_NAMES[dtype],
            byteorder="little",
            shape=node.shape,
        )
    if isinstance(node, dict):
        return {key: _collect_arrays(value, blocks) for key, value in node.items()}
    if isinstance(node, (list, tuple)):
        return [_collect_arrays(value, blocks) for value in node]
    return node


def write_asdf(tree, filename, overwrite=False):
    """Write a dict tree (possibly containing numpy arrays) to ASDF."""
    path = Path(filename)
    if path.exists() and not overwrite:
        raise OSError(f"{path} already exists!")

    blocks = []
    tree = _collect_arrays(tree, blocks)

    tree_with_meta = {
        "asdf_library": {
            "author": "jolideco-torch",
            "name": "jolideco_torch.utils.io.asdf_lite",
            "version": "0.1.0",
        },
    }
    tree_with_meta.update(tree)

    import yaml

    yaml_text = yaml.dump(
        tree_with_meta, Dumper=_make_dumper(), default_flow_style=False,
        sort_keys=False,
    )

    header = (
        "#ASDF 1.0.0\n"
        "#ASDF_STANDARD 1.5.0\n"
        "%YAML 1.1\n"
        "%TAG ! tag:stsci.edu:asdf/\n"
        "--- !core/asdf-1.1.0\n"
    )

    with path.open("wb") as fh:
        fh.write(header.encode("utf-8"))
        fh.write(yaml_text.encode("utf-8"))
        fh.write(b"...\n")
        for array in blocks:
            data = array.astype(array.dtype.newbyteorder("<")).tobytes()
            checksum = hashlib.md5(data).digest()
            # header: flags(u32) compression(4s) alloc(u64) used(u64)
            #         data(u64) checksum(16s)  => 48 bytes
            block_header = struct.pack(
                ">I4sQQQ16s", 0, b"\x00" * 4, len(data), len(data), len(data),
                checksum,
            )
            fh.write(BLOCK_MAGIC)
            fh.write(struct.pack(">H", len(block_header)))
            fh.write(block_header)
            fh.write(data)
    log.info(f"writing {path}")


def _make_loader():
    import yaml

    class _AsdfLoader(yaml.SafeLoader):
        pass

    def _construct_ndarray(loader, node):
        mapping = loader.construct_mapping(node, deep=True)
        return _NDArrayRef(
            source=mapping["source"],
            datatype=mapping["datatype"],
            byteorder=mapping.get("byteorder", "little"),
            shape=tuple(mapping.get("shape", ())),
        )

    def _construct_any(loader, tag_suffix, node):
        if isinstance(node, yaml.MappingNode):
            return loader.construct_mapping(node, deep=True)
        if isinstance(node, yaml.SequenceNode):
            return loader.construct_sequence(node, deep=True)
        return loader.construct_scalar(node)

    _AsdfLoader.add_constructor(NDARRAY_TAG, _construct_ndarray)
    _AsdfLoader.add_multi_constructor(
        "tag:stsci.edu:asdf/", _construct_any
    )
    return _AsdfLoader


def _resolve_refs(node, blocks):
    if isinstance(node, _NDArrayRef):
        data = blocks[node.source]
        dtype = _DTYPES[node.datatype]
        if node.byteorder == "big":
            dtype = dtype.newbyteorder(">")
        else:
            dtype = dtype.newbyteorder("<")
        array = np.frombuffer(data, dtype=dtype)
        return array.reshape(node.shape).astype(dtype.newbyteorder("="))
    if isinstance(node, dict):
        return {key: _resolve_refs(value, blocks) for key, value in node.items()}
    if isinstance(node, list):
        return [_resolve_refs(value, blocks) for value in node]
    return node


def read_asdf(filename):
    """Read an ASDF file written by :func:`write_asdf` (or compatible)."""
    raw = Path(filename).read_bytes()

    # split tree from blocks at the first block magic
    block_start = raw.find(BLOCK_MAGIC)
    yaml_part = raw if block_start == -1 else raw[:block_start]

    # drop '#ASDF' comment lines; keep YAML directives and document
    lines = [
        line
        for line in yaml_part.split(b"\n")
        if not line.startswith(b"#")
    ]
    yaml_text = b"\n".join(lines).decode("utf-8")

    import yaml

    tree = yaml.load(yaml_text, Loader=_make_loader())

    blocks = []
    offset = block_start
    while offset != -1 and offset < len(raw):
        if raw[offset : offset + 4] != BLOCK_MAGIC:
            break
        header_size = struct.unpack(">H", raw[offset + 4 : offset + 6])[0]
        header = raw[offset + 6 : offset + 6 + header_size]
        _, _, allocated, used, _, _ = struct.unpack(
            ">I4sQQQ16s", header[:48]
        )
        data_start = offset + 6 + header_size
        blocks.append(raw[data_start : data_start + used])
        offset = data_start + allocated

    tree = _resolve_refs(tree, blocks)
    if isinstance(tree, dict):
        tree.pop("asdf_library", None)
        tree.pop("history", None)
    return tree
